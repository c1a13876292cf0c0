"""The port's scheme registry (``repro_torch.kernels.schemes``) against the
JAX package's: the a-priori error bounds, the instruction mixes and their
validation, and the accuracy ladder on GenDot data.

Parity tiers:

* tier 1 (equal): ``error_bound`` of every built-in over a grid of (n,
  cond, eps); ``validate_instruction_mix`` accepting the same inputs (as
  equal mixes) and refusing the same ones with the same exception types;
  ``traced_dot`` / ``traced_sum``, the unit roundoffs; the ladder's
  GenDot data and each scheme's relative error at n = 8192, unroll 1,
  through the port's plain path (its dot is bitwise the reference's, so
  the errors are equal floats), and the a-priori bound and the
  reference's orderings holding.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import numerics as jnumerics
from repro.kernels import ops as jops
from repro.kernels import schemes as jschemes
from repro_torch.core import numerics
from repro_torch.kernels import ops
from repro_torch.kernels import schemes as tschemes

BUILTINS = ("naive", "kahan", "pairwise", "dot2")
LADDER_CONDS = (1e4, 1e6, 1e8, 1e10, 1e12)
LADDER_N = 8192


@pytest.mark.parametrize("name", BUILTINS)
def test_error_bound_equals_the_reference(name):
    ours = tschemes.get(name).error_bound
    theirs = jschemes.get(name).error_bound
    for n in (1, 2, 31, 32, 33, 1000, 8192, 1 << 20, 1 << 27):
        for cond in (1.0, 1e2, 1e4, 1e8, 1e12, 1e16):
            assert ours(n, cond) == theirs(n, cond), (n, cond)
            for eps in (tschemes.EPS32, tschemes.EPS64, tschemes.EPS_BF16):
                assert ours(n, cond, eps) == theirs(n, cond, eps)


def test_unit_roundoffs_equal_the_reference():
    assert (tschemes.EPS32, tschemes.EPS64, tschemes.EPS_BF16) == (
        jschemes.EPS32, jschemes.EPS64, jschemes.EPS_BF16)
    for ours, theirs in ((torch.float32, "float32"),
                         ("bfloat16", "bfloat16")):
        assert tschemes.unit_roundoff(ours) == jschemes.unit_roundoff(theirs)
    assert tschemes.unit_roundoff(torch.float64) == jschemes.EPS64
    with pytest.raises(ValueError):
        tschemes.unit_roundoff("float16")


@pytest.mark.parametrize("name", BUILTINS)
def test_traced_mixes_equal_the_reference(name):
    ours = tschemes.get(name).instruction_mix
    theirs = jschemes.get(name).instruction_mix
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.traced_dot == theirs.traced_dot
    assert ours.traced_sum == theirs.traced_sum
    assert ours.flops == theirs.flops


#: instruction_mix declarations (a mapping, or "mix" + kwargs for each
#: module's own InstructionMix, or another object)
MIX_CASES = [
    {"adds": 1, "muls": 1},
    {"adds": 4, "muls": 1, "traced_adds": 9},
    {"adds": 0, "muls": 0, "traced_sum_adds": 0},
    {"adds": 1, "muls": 1, "traced_muls": None},
    {"adds": 1},
    {"muls": 1},
    {"adds": 1, "muls": 1, "bogus": 2},
    {"adds": -1, "muls": 1},
    {"adds": 1.0, "muls": 1},
    {"adds": True, "muls": 1},
    {"adds": 1, "muls": None},
    {"adds": 1, "muls": 1, "traced_sum_adds": -2},
    {"adds": 1, "muls": 1, "traced_adds": "3"},
    ("mix", dict(adds=2, muls=1)),
    ("mix", dict(adds=2, muls=1, traced_adds=18, traced_muls=7)),
    ("mix", dict(adds=-2, muls=1)),
    ("mix", dict(adds=2, muls=1, traced_sum_adds=1.5)),
    [1, 1],
    (1, 1),
    None,
    "adds=1",
]


def _outcome(module, case):
    if isinstance(case, tuple) and case[:1] == ("mix",):
        case = module.InstructionMix(**case[1])
    try:
        mix = module.validate_instruction_mix(case, scheme_name="t")
    except (TypeError, ValueError) as err:
        return type(err)
    return dataclasses.asdict(mix)


@pytest.mark.parametrize("case", range(len(MIX_CASES)))
def test_validate_instruction_mix_like_the_reference(case):
    ours = _outcome(tschemes, MIX_CASES[case])
    assert ours == _outcome(jschemes, MIX_CASES[case])


def test_scheme_coerces_a_mapping_and_register_revalidates():
    mine = tschemes.CompensationScheme(
        name="test_torch_schemes_mine", update=tschemes.NAIVE.update,
        instruction_mix={"adds": 2, "muls": 1, "traced_sum_adds": 3},
        error_bound=tschemes.NAIVE.error_bound)
    assert mine.instruction_mix == tschemes.InstructionMix(
        adds=2, muls=1, traced_sum_adds=3)
    assert mine.instruction_mix.traced_sum == (3, 0)
    with pytest.raises(ValueError, match="unknown"):
        tschemes.CompensationScheme(
            name="bad", update=tschemes.NAIVE.update,
            instruction_mix={"adds": 1, "muls": 1, "fmas": 1},
            error_bound=tschemes.NAIVE.error_bound)
    with pytest.raises(TypeError):
        tschemes.CompensationScheme(name="bad", update=tschemes.NAIVE.update,
                                    instruction_mix=tschemes.InstructionMix(
                                        1, 1))
    object.__setattr__(mine, "instruction_mix", {"adds": -1, "muls": 1})
    with pytest.raises(ValueError, match="non-negative"):
        tschemes.register(mine)
    assert "test_torch_schemes_mine" not in tschemes.registered()


# ---------------------------------------------------------------------------
# the accuracy ladder (tests/test_schemes.py's, at n = 8192, unroll 1)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ladder(cond):
    seed = int(np.log10(cond))
    a, b, exact, achieved = numerics.gen_dot(LADDER_N, cond, seed=seed)
    ja, jb, jexact, jachieved = jnumerics.gen_dot(LADDER_N, cond, seed=seed)
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    assert (exact, achieved) == (jexact, jachieved)
    ours = {name: numerics.relative_error(float(ops.dot(
        torch.from_numpy(a), torch.from_numpy(b), scheme=name, unroll=1)),
        exact) for name in BUILTINS}
    theirs = {name: jnumerics.relative_error(float(jops.dot(
        jnp.asarray(ja), jnp.asarray(jb), scheme=name, unroll=1)), jexact)
        for name in BUILTINS}
    return ours, theirs, achieved


@pytest.mark.parametrize("cond", LADDER_CONDS)
def test_accuracy_ladder_equals_the_reference(cond):
    errs, ref_errs, achieved = _ladder(cond)
    assert errs == ref_errs
    assert errs["dot2"] <= 1e-2 * errs["kahan"], (errs, achieved)
    assert errs["dot2"] <= 1e-2 * errs["naive"], (errs, achieved)
    if achieved < 1.0 / tschemes.EPS32:
        assert errs["kahan"] <= errs["naive"], (errs, achieved)
        assert errs["pairwise"] <= errs["naive"] * 1.01, (errs, achieved)
    else:
        assert errs["kahan"] <= errs["naive"] * 3.0, (errs, achieved)


def test_ladder_dot2_two_digits_below_kahan_and_bounds_hold():
    errs, _, _ = _ladder(1e10)
    assert errs["kahan"] >= 100.0 * errs["dot2"]
    errs, _, achieved = _ladder(1e4)
    for name in BUILTINS:
        bound = tschemes.get(name).error_bound(LADDER_N, achieved)
        assert np.isfinite(bound) and 0 < errs[name] <= bound, name
