"""The port's compensated reductions vs the JAX reference.

Inputs are made from a seed with numpy and go through both packages;
the reference runs its Pallas kernels as its own tests do on the CPU (in
interpret mode). Each test names its parity tier:

* tier 1 (bitwise against the reference): the (s, c) grids and merged
  totals of dot / asum / batched_dot / batched_asum, for every built-in
  scheme, U in {1, 2, 8} and n in {0, 1, odd, 8192k + r}; bf16 inputs
  with f32 accumulate; f64 accumulate (``jax.enable_x64``); bf16
  accumulate; ``merge_accumulators`` on the reference's own grids.
* tier 2 (bitwise within the port): batched equals a loop of single
  calls; the plain oracles in ``ref`` equal the entry points.

On this CPU the kernel wrappers run their plain versions; the CUDA
kernels themselves are held against the same plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import engine as jeng
from repro.kernels import ops as jops
from repro_torch.kernels import engine as teng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import schemes as tschemes

SCHEMES = ["naive", "kahan", "pairwise", "dot2"]
UNROLLS = [1, 2, 8]
SIZES = [0, 1, 1023, 2 * 8192 + 37]


def _data(shape, seed, dtype=np.float32):
    """Normal values scaled by 2^e, e in [-8, 8): wide enough that every
    scheme's compensation term is busy, far from the subnormal range."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-8, 8, size=shape)
    return (rng.standard_normal(shape) * np.exp2(e)).astype(dtype)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_same(want, got, what):
    w, g = np.atleast_1d(_bits(want)), np.atleast_1d(_bits(got))
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype)
    assert np.array_equal(w.view(np.uint8), g.view(np.uint8)), what


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dot_and_asum_bitwise_f32(scheme, unroll):
    """Tier 1: grids and totals of dot and asum, float32, every size."""
    je = jeng.CompensatedReduction(scheme=scheme, unroll=unroll)
    te = teng.CompensatedReduction(scheme=scheme, unroll=unroll)
    for n in SIZES:
        a, b = _data((2, n), seed=n + unroll)
        what = f"{scheme} U={unroll} n={n}"
        ja = je.dot_accumulators(jnp.asarray(a), jnp.asarray(b))
        ta = te.dot_accumulators(_t(a), _t(b))
        _assert_same(ja.s, ta.s, "dot s " + what)
        _assert_same(ja.c, ta.c, "dot c " + what)
        _assert_same(ja.total(), tops.dot(_t(a), _t(b), scheme=scheme,
                                          unroll=unroll), "dot total " + what)
        ja = je.sum_accumulators(jnp.asarray(a))
        ta = te.sum_accumulators(_t(a))
        _assert_same(ja.s, ta.s, "sum s " + what)
        _assert_same(ja.c, ta.c, "sum c " + what)
        _assert_same(ja.total(), tops.asum(_t(a), scheme=scheme,
                                           unroll=unroll), "sum total " + what)
        assert te.last_path == "cpu"


@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_bitwise_and_equal_to_loop(scheme, unroll):
    """Tier 1: batched_dot / batched_asum totals equal the reference's;
    tier 2: they equal a loop of single calls within the port."""
    a, b = _data((2, 3, 8192 + 301), seed=17 * unroll)
    kw = dict(scheme=scheme, unroll=unroll)
    got = tops.batched_dot(_t(a), _t(b), **kw)
    _assert_same(jops.batched_dot(jnp.asarray(a), jnp.asarray(b), **kw), got,
                 "batched_dot")
    _assert_same(torch.stack([tops.dot(_t(x), _t(y), **kw)
                              for x, y in zip(a, b)]), got, "dot loop")
    got = tops.batched_asum(_t(a), **kw)
    _assert_same(jops.batched_asum(jnp.asarray(a), **kw), got, "batched_asum")
    _assert_same(torch.stack([tops.asum(_t(x), **kw) for x in a]), got,
                 "asum loop")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_bf16_inputs_f32_accumulate(scheme):
    """Tier 1: bf16 operands promote exactly to the f32 accumulate."""
    a, b = _data((2, 5000), seed=3)
    ja, jb = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(
        jnp.bfloat16)
    ta, tb = _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16)
    _assert_same(jops.dot(ja, jb, scheme=scheme),
                 tops.dot(ta, tb, scheme=scheme), "bf16 dot")
    _assert_same(jops.asum(ja, scheme=scheme), tops.asum(ta, scheme=scheme),
                 "bf16 asum")


@pytest.mark.parametrize("compute_dtype", ["float64", "bfloat16"])
def test_other_accumulate_dtypes_bitwise(compute_dtype):
    """Tier 1 at f64 accumulate (under ``jax.enable_x64``) and bf16
    accumulate: the reference fuses the product sites in f64 as in f32,
    and rounds every bf16 op separately; the port matches both."""
    in_dtype = np.float64 if compute_dtype == "float64" else np.float32
    a, b = _data((2, 3 * 1024 + 11), seed=29, dtype=in_dtype)
    with jax.enable_x64(compute_dtype == "float64"):
        for scheme in SCHEMES:
            kw = dict(scheme=scheme, unroll=2, compute_dtype=compute_dtype)
            je = jeng.CompensatedReduction(**kw)
            te = teng.CompensatedReduction(**kw)
            ja = je.dot_accumulators(jnp.asarray(a), jnp.asarray(b))
            ta = te.dot_accumulators(_t(a), _t(b))
            _assert_same(ja.s, ta.s, f"{compute_dtype} {scheme} dot s")
            _assert_same(ja.c, ta.c, f"{compute_dtype} {scheme} dot c")
            _assert_same(ja.total(), ta.total(), f"{compute_dtype} dot")
            ja = je.sum_accumulators(jnp.asarray(a))
            ta = te.sum_accumulators(_t(a))
            _assert_same(ja.s, ta.s, f"{compute_dtype} {scheme} sum s")
            _assert_same(ja.total(), ta.total(), f"{compute_dtype} sum")


def _subnormal_data(shape, seed, lo=-75, hi=-52):
    """Values scaled by 2^e, e in [lo, hi) (the defaults put products
    near float32's ``tiny`` = 2^-126), a fifth of them subnormal and a
    twentieth signed zeros: the data of fault C2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.integers(lo, hi,
                                                          size=shape))
    sub = rng.random(shape) < 0.2
    x[sub] = rng.standard_normal(int(sub.sum())) * np.exp2(
        rng.integers(-149, -126, size=int(sub.sum())))
    zero = rng.random(shape) < 0.05
    x[zero] = np.copysign(0.0, x[zero])
    return x.astype(np.float32)


def _bf16_values(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).astype(np.float32)


@pytest.mark.parametrize("data", ["float32", "bf16_inputs", "bf16_compute"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_subnormal_reaching_bitwise(scheme, data):
    """Tier 1 on subnormal-reaching data (C2): the reference flushes
    subnormal inputs and results, and so do the port's plain versions.
    Dot grids (products near ``tiny``) and sum grids (terms and running
    sums near ``tiny``) equal the reference's Pallas grids bit for bit,
    for float32 data, bfloat16 data with a float32 accumulate and a
    bfloat16 accumulate."""
    n = 2 * 2048 + 37
    a, b = _subnormal_data((2, n), seed=61)
    x = _subnormal_data((n,), seed=62, lo=-135, hi=-110)
    kw = dict(scheme=scheme, unroll=2)
    if data == "bf16_compute":
        kw["compute_dtype"] = "bfloat16"
    je = jeng.CompensatedReduction(**kw)
    te = teng.CompensatedReduction(**kw)
    if data == "bf16_inputs":
        a, b, x = _bf16_values(a), _bf16_values(b), _bf16_values(x)
        jin = lambda v: jnp.asarray(v).astype(jnp.bfloat16)  # noqa: E731
        tin = lambda v: _t(v).to(torch.bfloat16)  # noqa: E731
    else:
        jin, tin = jnp.asarray, _t
    ja = je.dot_accumulators(jin(a), jin(b))
    ta = te.dot_accumulators(tin(a), tin(b))
    _assert_same(ja.s, ta.s, f"dot s {scheme} {data}")
    _assert_same(ja.c, ta.c, f"dot c {scheme} {data}")
    _assert_same(ja.total(), ta.total(), f"dot {scheme} {data}")
    ja = je.sum_accumulators(jin(x))
    ta = te.sum_accumulators(tin(x))
    _assert_same(ja.s, ta.s, f"sum s {scheme} {data}")
    _assert_same(ja.c, ta.c, f"sum c {scheme} {data}")
    _assert_same(ja.total(), ta.total(), f"sum {scheme} {data}")
    assert bool((ta.s.float().abs() >= 2.0 ** -126).any())


def test_merge_bitwise_on_reference_grids():
    """Tier 1: the port's two-sum tree over the reference's own (s, c)
    grids gives the reference's totals, scalar and along a leading axis
    (non-power-of-two length)."""
    a, b = _data((2, 3 * 8192), seed=41)
    acc = jeng.CompensatedReduction(scheme="kahan").dot_accumulators(
        jnp.asarray(a), jnp.asarray(b))
    _assert_same(jeng.merge_accumulators(acc.s, acc.c),
                 teng.merge_accumulators(_t(acc.s), _t(acc.c)), "scalar")
    s, c = _data((2, 5, 3, 4), seed=43)
    c = (c * 1e-8).astype(np.float32)
    _assert_same(jeng.merge_accumulator_grids(jnp.asarray(s), jnp.asarray(c)),
                 teng.merge_accumulator_grids(_t(s), _t(c)), "grids")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_ref_oracles_equal_entry_points(scheme):
    """Tier 2: the plain oracles with rows = 8U equal ops.*."""
    a, b = _data((2, 2, 2 * 1024 + 5), seed=7)
    kw = dict(scheme=scheme, unroll=1)
    _assert_same(tops.dot(_t(a[0]), _t(b[0]), **kw),
                 tref.dot_ref(_t(a[0]), _t(b[0]), scheme, rows=8), "dot_ref")
    _assert_same(tops.asum(_t(a[0]), **kw),
                 tref.sum_ref(_t(a[0]), scheme, rows=8), "sum_ref")
    _assert_same(tops.batched_dot(_t(a), _t(b), **kw),
                 tref.batched_dot_ref(_t(a), _t(b), scheme, rows=8), "bdot")
    _assert_same(tops.batched_asum(_t(a), **kw),
                 tref.batched_sum_ref(_t(a), scheme, rows=8), "bsum")


@pytest.mark.parametrize("name", ["dot_ref", "sum_ref", "matmul_ref"])
def test_ops_ref_aliases_equal_ref(name):
    """``ops.dot_ref`` / ``sum_ref`` / ``matmul_ref`` (the reference's
    names) are the ``ref`` oracles: bitwise equal on the same inputs."""
    a, b = _data((2, 3 * 128 + 5), seed=11)
    if name == "matmul_ref":
        args = (_t(_data((5, 3 * 128), seed=12)),
                _t(_data((3 * 128, 7), seed=13)))
        kw = dict(bk=128, scheme="kahan")
    elif name == "dot_ref":
        args, kw = (_t(a[0]), _t(b[0])), dict(scheme="dot2")
    else:
        args, kw = (_t(a[0]),), dict(scheme="pairwise")
    _assert_same(getattr(tref, name)(*args, **kw),
                 getattr(tops, name)(*args, **kw), name)


def test_policy_and_runtime_scheme():
    """The ambient policy resolves unset knobs; a scheme registered at
    runtime works through every entry point (on the CPU: plain path)."""
    a, b = _data((2, 4000), seed=5)
    with tschemes.use_policy(scheme="dot2", unroll=2):
        got = tops.dot(_t(a), _t(b))
    _assert_same(tops.dot(_t(a), _t(b), scheme="dot2", unroll=2), got,
                 "policy")
    mine = tschemes.CompensationScheme(
        name="test_torch_plain_sum",
        update=lambda s, c, x, step: (s + x, c),
        instruction_mix=tschemes.InstructionMix(adds=1, muls=1),
        error_bound=tschemes.NAIVE.error_bound)
    tschemes.register(mine)
    try:
        assert mine.device_id is None
        eng = teng.CompensatedReduction(scheme="test_torch_plain_sum")
        _assert_same(eng.asum(_t(a)), tops.asum(_t(a), scheme="naive"),
                     "runtime scheme")
        assert eng.last_path == "cpu"
    finally:
        tschemes.unregister("test_torch_plain_sum")


def test_boundary_validation():
    """Unknown schemes / dtypes and malformed kernel inputs fail fast."""
    from repro_torch.kernels import kahan_dot, kahan_matmul, kahan_sum

    with pytest.raises(ValueError, match="unknown compensation scheme"):
        tops.dot(torch.ones(3), torch.ones(3), scheme="nope")
    with pytest.raises(ValueError, match="compute_dtype"):
        tops.asum(torch.ones(3), compute_dtype="float16")
    with pytest.raises(ValueError, match="equal size"):
        tops.dot(torch.ones(3), torch.ones(4))
    with pytest.raises(ValueError, match="multiple"):
        kahan_dot.dot_accumulators(torch.ones(100), torch.ones(100),
                                   scheme=tschemes.KAHAN, unroll=1)
    with pytest.raises(ValueError, match="\\[B, n\\]"):
        kahan_sum.sum_accumulators_batched(torch.ones(1024),
                                           scheme=tschemes.KAHAN, unroll=1)
    with pytest.raises(ValueError, match="mismatch"):
        teng.CompensatedReduction().matmul_accumulators(torch.ones(2, 3),
                                                        torch.ones(2, 2))
    with pytest.raises(ValueError, match="multiples"):
        kahan_matmul.matmul_accumulators(torch.ones(8, 100),
                                         torch.ones(100, 128),
                                         scheme=tschemes.KAHAN)
