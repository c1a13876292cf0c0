"""The port's logical spec trees and abstract cells vs the JAX reference:
``param_specs()``, ``cache_specs()``, ``opt_state_specs``, the abstract
trees of ``launch/specs.py`` and ``AdamWConfig.moment_dtype``.

Parity tiers:

* tier 1 (equal): every config's ``param_specs()`` equals the spec tree
  the reference's ``init`` returns (``PartitionSpec``s as tuples);
  ``opt_state_specs``; ``cache_specs()`` up to the port's two documented
  layout differences (an unstacked segment's cache leaf has a layer axis
  of 1 in front, an xLSTM's mLSTM state flattens the reference's ``[G,
  M]`` axes into one); the abstract params, optimizer state and cache
  (shapes and dtypes) against the reference's ``jax.eval_shape`` trees;
  every cell's ``model_flops``.
* tier 1 (bitwise against the jitted reference): ``apply_update`` with
  ``moment_dtype="bfloat16"`` and bf16 params over three steps, AdamW and
  KahanAdamW (the dry run's llama4 override); with float32 params the
  moments bitwise and the params within 2 float32 ulps or 2^-30 (one
  step of the reference's compiled update rounds a param otherwise, a gap
  of at most 4.7e-10 measured).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import apply_update as jax_apply_update
from repro.optim import init as jax_opt_init
from repro.optim import opt_state_specs as jax_opt_state_specs
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.core import tree as T
from repro_torch.launch import specs
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, apply_update, init, opt_state_specs

ARCHS = list(list_archs())
CPU = torch.device("cpu")


def _tuples(tree):
    """A reference spec tree with its ``PartitionSpec``s as tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, tuple):
        return type(tree)(*map(_tuples, tree)) if hasattr(tree, "_fields") \
            else tuple(map(_tuples, tree))
    return tree


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(abstract params, param specs, abstract cache, cache specs) of the
    reference's published config, through ``jax.eval_shape``."""
    model = jax_build(jax_config(arch))
    params, pspecs = jspecs.abstract_params(model)
    cache, cspecs = jspecs.abstract_cache(model, 2, 64)
    return params, _tuples(pspecs), cache, _tuples(cspecs)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    """Tier 1: every leaf's logical axes, stacked leaves under a leading
    None."""
    assert build_model(get_config(arch), CPU).param_specs() == \
        _reference(arch)[1]


def _port_layout(arch, ref_specs):
    """The reference's cache specs in the port's layout: an unstacked
    segment (a transformer's ``dense_prefix``, a hybrid's ``global_<i>``)
    gains a leading layer axis; the xLSTM mLSTM state's ``[G, M]`` axes
    are one."""
    cfg = get_config(arch)
    if cfg.xlstm is not None:
        return {"mlstm": tuple(s[1:] for s in ref_specs["mlstm"]),
                "slstm": ref_specs["slstm"]}

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        if all(isinstance(s, tuple) for s in node):
            return tuple(stack(s) for s in node)
        return (None, *node)

    model = build_model(cfg, CPU)
    segments = getattr(model, "segments", [])
    unstacked = {s.name for s in segments if not getattr(s, "scan", True)}
    return {k: stack(v) if k in unstacked else v
            for k, v in ref_specs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    """Tier 1 up to the port's layout: the same axis names on every leaf,
    the request axis "batch", "kv_seq" on pageable K/V, "kv_ring" on ring
    windows; a leading None for the layer axis."""
    got = build_model(get_config(arch), CPU).cache_specs()
    assert got == _port_layout(arch, _reference(arch)[3])


@pytest.mark.parametrize("kahan", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_reference(arch, kahan):
    """Tier 1: moments and comp shard like the params, the step is
    replicated (``P()`` is the empty tuple); no comp without kahan."""
    pspecs = build_model(get_config(arch), CPU).param_specs()
    got = opt_state_specs(pspecs, AdamWConfig(kahan=kahan))
    want = jax_opt_state_specs(_reference(arch)[1], JaxAdamWConfig(kahan=kahan))
    assert tuple(got) == (tuple(want.step), want.m, want.v, want.comp)


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in T.leaves(tree)]


def _jshapes(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_equal_reference(arch):
    """Tier 1: the abstract params (fake tensors, nothing allocated) and
    their optimizer state have the reference's leaves, shapes and dtypes
    (the port sorts dict keys as ``jax.tree`` does); the abstract cache's
    leaves hold the reference's, each with the port's layout."""
    model = build_model(get_config(arch), CPU)
    params, pspecs = specs.abstract_params(model)
    from torch._subclasses.fake_tensor import FakeTensor
    assert all(isinstance(x, FakeTensor) for x in T.leaves(params))
    jparams = _reference(arch)[0]
    assert _shapes(params) == _jshapes(jparams)
    opt = AdamWConfig(kahan=True, moment_dtype="bfloat16")
    state, _ = specs.abstract_opt_state(opt, params, pspecs)
    jstate = jax.eval_shape(
        lambda p: jax_opt_init(JaxAdamWConfig(kahan=True,
                                              moment_dtype="bfloat16"), p),
        jparams)
    assert _shapes(state.m) == _jshapes(jstate.m)
    assert _shapes(state.comp) == _jshapes(jstate.comp)
    cache, _ = specs.abstract_cache(model, 2, 64)
    got = [n for n, _ in _shapes(cache)]
    want = [n for n, _ in _jshapes(_reference(arch)[2])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g == w or g == (1, *w)
                or g == (w[0] * w[1], *w[2:])), (g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_model_flops_equal_reference(arch):
    """Tier 1: 6·N·D for a train cell, 2·N·D for a serve cell, every
    shape; a decode cell's position is the cache's last."""
    for name, shape in SHAPES.items():
        got = specs.build_cell(get_config(arch), shape)
        want = jspecs.build_cell(jax_config(arch), JSHAPES[name])
        assert got.model_flops == want.model_flops, name
        if shape.kind == "train":
            assert got.arg_specs[1:] == _tuples(want.arg_specs[1:])
        if shape.kind == "decode":
            assert got.args[3] == shape.seq_len - 1


# ---------------------------------------------------------------------------
# bf16 moments (the dry run's llama4 override)
# ---------------------------------------------------------------------------

SHAPES_OPT = {"a": (37, 19), "b": (5, 7, 3), "c": (11,), "d": (1, 6)}


def _np(shape, rng, lo, hi):
    x = rng.standard_normal(shape) * np.exp2(rng.integers(lo, hi, shape))
    return x.astype(np.float32)


def _jtree(rng, dtype, lo, hi):
    return {k: jnp.asarray(_np(s, rng, lo, hi)).astype(dtype)
            for k, s in SHAPES_OPT.items()}


def _t(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _steps(param_dtype, kahan, steps=3):
    rng = np.random.default_rng(8)
    jp = _jtree(rng, param_dtype, -4, 1)
    jcfg = JaxAdamWConfig(kahan=kahan, kahan_norm=False,
                          moment_dtype="bfloat16")
    cfg = AdamWConfig(kahan=kahan, kahan_norm=False, moment_dtype="bfloat16")
    js = jax_opt_init(jcfg, jp)
    tp = T.tree_map(_t, jax.tree.map(np.asarray, jp))
    ts = init(cfg, tp)
    step = jax.jit(jax_apply_update, static_argnums=0)
    for i in range(steps):
        g = _jtree(rng, "float32", -6, 0)
        scale = np.float32(0.5 + 0.25 * i)
        jp, js, _ = step(jcfg, jp, g, js, jnp.float32(scale))
        tp, ts, _ = apply_update(cfg, tp, T.tree_map(_t, g), ts,
                                 torch.tensor(scale))
        yield jp, js, T.tree_map(torch.clone, tp), T.tree_map(torch.clone,
                                                             ts)


def _equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), T.leaves(ttree)
    return len(jl) == len(tl) and all(
        torch.equal(_t(a), b) and _t(a).dtype == b.dtype
        for a, b in zip(jl, tl))


@pytest.mark.parametrize("kahan", [True, False])
def test_bf16_moments_bitwise_with_bf16_params(kahan):
    """Tier 1: bf16 params, m, v (stored in bf16) and comp equal the
    jitted reference's after each of three steps."""
    for jp, js, tp, ts in _steps("bfloat16", kahan):
        assert ts.m["a"].dtype == torch.bfloat16
        assert _equal(jp, tp) and _equal(js.m, ts.m) and _equal(js.v, ts.v)
        assert _equal(js.comp, ts.comp) if kahan else ts.comp is None


@pytest.mark.parametrize("kahan", [True, False])
def test_bf16_moments_with_f32_params_within_tolerance(kahan):
    """Float32 params: the bf16 moments bitwise, the params within rtol
    2^-22 (2 float32 ulps) or 2^-30 absolute (the gap measured: at most
    4.7e-10 on values up to 8)."""
    for jp, js, tp, ts in _steps("float32", kahan):
        assert _equal(js.m, ts.m) and _equal(js.v, ts.v)
        for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=2.0 ** -22, atol=2.0 ** -30)


def test_moment_dtype_refuses_others():
    with pytest.raises(ValueError, match="moment_dtype"):
        AdamWConfig(moment_dtype="float16")
