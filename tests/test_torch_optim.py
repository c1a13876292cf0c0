"""The port's optimizer slice vs the JAX reference: ``KahanAccumulator``
and the tree helpers (``repro_torch.core.kahan``), the global norms, the
LR schedule and ``apply_update`` (``repro_torch.optim``).

Parity tiers:

* tier 1 (bitwise against the reference): every ``KahanAccumulator`` op
  and ``tree_kahan_add`` at float32 and bfloat16; the column scan of
  ``tree_kahan_sq_norm`` (its (s, c) vectors, the loop that the column
  kernel reproduces) against the reference's compiled ``lax.scan`` body,
  with the fma XLA contracts; ``engine_sq_norm`` (tier-1 grids and the
  same merge tree); ``apply_update`` over three steps with bf16 and
  float32 parameters and the engine-folded norm, AdamW and KahanAdamW,
  against the jitted reference, with an exact fma wherever XLA fuses a
  product into an add and a correctly rounded square root.
* tier 3 (tolerance): ``tree_kahan_sq_norm``'s scalar within rtol 1e-6
  (its final sums of the column vectors are XLA's order there, torch's
  here), and so ``apply_update`` under it (bf16 params within one bf16
  ulp, rtol 2^-7), and with float32 parameters within rtol 1e-6;
  ``warmup_cosine`` within 1e-6 (XLA's and torch's ``cos``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kahan as JK
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import apply_update as jax_apply_update
from repro.optim import engine_sq_norm as jax_engine_sq_norm
from repro.optim import init as jax_opt_init
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch.core import kahan as TK
from repro_torch.core import tree as T
from repro_torch.kernels.kahan_columns import column_sq_accumulators
from repro_torch.optim import (
    AdamWConfig,
    OptState,
    apply_update,
    engine_sq_norm,
    global_norm,
    global_norm_ref,
    init,
    schedule,
)

DTYPES = ["float32", "bfloat16"]
SHAPES = {"a": (37, 19), "b": (5, 7, 3), "c": (11,), "d": (1, 6)}


def _np(shape, rng, lo=-6, hi=3):
    x = rng.standard_normal(shape) * np.exp2(rng.integers(lo, hi, shape))
    return x.astype(np.float32)


def _tree(rng, dtype, **kw):
    return {k: jnp.asarray(_np(s, rng, **kw)).astype(dtype)
            for k, s in SHAPES.items()}


def _t(x):
    """A JAX / numpy array as a torch tensor with the same bits."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _tt(tree):
    return T.tree_map(_t, jax.tree.map(np.asarray, tree))


def _same(j, t) -> bool:
    return torch.equal(_t(j), t) and _t(j).dtype == t.dtype


def _same_tree(jtree, ttree) -> bool:
    jl = jax.tree.leaves(jtree)
    tl = T.leaves(ttree)
    return len(jl) == len(tl) and all(_same(a, b) for a, b in zip(jl, tl))


# ---------------------------------------------------------------------------
# KahanAccumulator and the tree helpers (tier 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_kahan_accumulator_ops_bitwise(dtype):
    rng = np.random.default_rng(1)
    base = _tree(rng, dtype)
    deltas = [_tree(rng, dtype, lo=-14, hi=-6) for _ in range(4)]
    ja = JK.KahanAccumulator.init(base)
    ta = TK.KahanAccumulator.init(_tt(base))
    tz = TK.KahanAccumulator.zeros_like(_tt(base))
    jz = JK.KahanAccumulator.zeros_like(base)
    for d in deltas:
        ja, ta = ja.add(d), ta.add(_tt(d))
        jz, tz = jz.add(d), tz.add(_tt(d))
    assert _same_tree(ja.value, ta.value) and _same_tree(ja.comp, ta.comp)
    assert _same_tree(jz.value, tz.value) and _same_tree(jz.comp, tz.comp)
    # in place: the same bits
    ti = TK.KahanAccumulator.init(T.tree_map(torch.clone, _tt(base)))
    for d in deltas:
        ti.add_(_tt(d))
    assert _same_tree(ja.value, ti.value) and _same_tree(ja.comp, ti.comp)
    jm, tm = ja.merge(jz), ta.merge(tz)
    assert _same_tree(jm.value, tm.value) and _same_tree(jm.comp, tm.comp)
    assert _same_tree(jm.total(), tm.total())
    js, ts = jm.scale(1.0 / 3), tm.scale(1.0 / 3)
    assert _same_tree(js.value, ts.value) and _same_tree(js.comp, ts.comp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 3])
def test_kahan_accumulator_scale_total_in_place_bitwise(dtype, n):
    """The trainer's fold, ``scale_total_(1 / n)``, equals the
    reference's ``scale(1 / n).total()`` bit for bit and writes it into
    the accumulator's value tensors."""
    rng = np.random.default_rng(3)
    deltas = [_tree(rng, dtype, lo=-14, hi=2) for _ in range(n)]
    ja = JK.KahanAccumulator.zeros_like(deltas[0])
    ta = TK.KahanAccumulator.zeros_like(_tt(deltas[0]))
    for d in deltas:
        ja, ta = ja.add(d), ta.add_(_tt(d))
    want = ja.scale(1.0 / n).total()
    value = ta.value
    got = ta.scale_total_(1.0 / n)
    assert _same_tree(want, got)
    assert all(g is v for g, v in zip(T.leaves(got), T.leaves(value)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_kahan_add_bitwise(dtype):
    rng = np.random.default_rng(2)
    value = _tree(rng, dtype)
    comp = jax.tree.map(jnp.zeros_like, value)
    tv, tc = _tt(value), _tt(comp)
    for _ in range(5):
        d = _tree(rng, "float32", lo=-14, hi=-4)     # cast to the value's
        value, comp = JK.tree_kahan_add(value, comp, d)
        tv, tc = TK.tree_kahan_add(tv, tc, _tt(d))
    assert _same_tree(value, tv) and _same_tree(comp, tc)


def _jax_columns(g):
    """The reference's per-leaf scan (``repro/core/kahan.py:398-404``),
    compiled as it runs inside the train step."""
    def body(carry, row):
        cs, cc = carry
        return JK.kahan_step(cs, cc, row * row), None

    init = (jnp.zeros(g.shape[1:], jnp.float32),
            jnp.zeros(g.shape[1:], jnp.float32))
    return jax.jit(lambda g: jax.lax.scan(body, init, g)[0])(g)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(300, 37, 5), (2, 65), (41, 1)])
def test_column_scan_bitwise(shape, dtype):
    """Tier 1: the column loop (with one fma where XLA contracts the
    square into the step) equals the reference's compiled scan; the
    wrapper runs it on CPU tensors."""
    rng = np.random.default_rng(3)
    g = jnp.asarray(_np(shape, rng, lo=-8, hi=8)).astype(dtype)
    js, jc = _jax_columns(g.astype(jnp.float32))
    ts, tc = column_sq_accumulators(_t(g))
    assert _same(js, ts) and _same(jc, tc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lo,hi", [(-75, -52), (-140, -50)])
def test_column_scan_subnormal_bitwise(lo, hi, dtype):
    """Tier 1 on subnormal-reaching data (C2): squares that underflow
    (e in [-75, -52)) and entries from subnormal to normal (e in [-140,
    -50)), signed zeros among them; the reference's compiled scan
    flushes, and so does the port's loop."""
    rng = np.random.default_rng(-lo)
    x = _np((300, 37, 5), rng, lo=lo, hi=hi)
    x[rng.random(x.shape) < 0.05] *= -0.0
    g = jnp.asarray(x).astype(dtype)
    js, jc = _jax_columns(g.astype(jnp.float32))
    ts, tc = column_sq_accumulators(_t(g))
    assert _same(js, ts) and _same(jc, tc)
    assert bool((ts != 0).any())


def test_column_scan_needs_the_fma():
    """Without the fma the loop is NOT the reference's (the contraction
    check, as for the dot)."""
    rng = np.random.default_rng(4)
    g = jnp.asarray(_np((300, 64), rng, lo=-8, hi=8))
    js, jc = _jax_columns(g)
    s = torch.zeros(64)
    c = torch.zeros(64)
    for row in _t(g):
        s, c = TK.kahan_step(s, c, row * row)
    assert not (_same(js, s) and _same(jc, c))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_kahan_sq_norm_within_tolerance(dtype):
    rng = np.random.default_rng(5)
    tree = _tree(rng, dtype, lo=-4, hi=4)
    want = float(JK.tree_kahan_sq_norm(tree))
    got = TK.tree_kahan_sq_norm(_tt(tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_sq_norm_bitwise(dtype):
    rng = np.random.default_rng(6)
    tree = _tree(rng, dtype, lo=-4, hi=4)
    assert _same(jax_engine_sq_norm(tree), engine_sq_norm(_tt(tree)))


def test_global_norms_agree():
    rng = np.random.default_rng(7)
    tree = _tt(_tree(rng, "float32", lo=-2, hi=2))
    want = np.sqrt(sum((t.double() ** 2).sum().item()
                       for t in T.leaves(tree)))
    for kahan_norm in (True, False):
        got = float(global_norm(AdamWConfig(kahan_norm=kahan_norm), tree))
        assert abs(got - want) / want < 1e-6
    assert abs(float(global_norm_ref(tree)) - want) / want < 1e-6


# ---------------------------------------------------------------------------
# apply_update
# ---------------------------------------------------------------------------

def _run_both(dtype, kahan, kahan_norm, steps=3):
    rng = np.random.default_rng(8)
    jp = _tree(rng, dtype, lo=-4, hi=1)
    jcfg = JaxAdamWConfig(kahan=kahan, kahan_norm=kahan_norm)
    cfg = AdamWConfig(kahan=kahan, kahan_norm=kahan_norm)
    js = jax_opt_init(jcfg, jp)
    tp, ts = _tt(jp), init(cfg, _tt(jp))
    step = jax.jit(jax_apply_update, static_argnums=0)
    out = []
    for i in range(steps):
        g = _tree(rng, "float32", lo=-6, hi=0)
        scale = np.float32(0.5 + 0.25 * i)
        jp, js, jm = step(jcfg, jp, g, js, jnp.float32(scale))
        tp, ts, tm = apply_update(cfg, tp, _tt(g), ts,
                                  torch.tensor(scale))
        # the port updates in place: keep each step's copy
        out.append((jp, js, jm, T.tree_map(torch.clone, tp),
                    T.tree_map(torch.clone, ts), tm))
    return out


@pytest.mark.parametrize("kahan", [True, False])
def test_apply_update_bf16_bitwise(kahan):
    """Tier 1: with the engine-folded norm, bf16 params, m, v and comp
    equal the jitted reference's after each of three steps; grad_norm and
    lr too."""
    for jp, js, jm, tp, ts, tm in _run_both("bfloat16", kahan, False):
        assert _same_tree(jp, tp)
        assert _same_tree(js.m, ts.m) and _same_tree(js.v, ts.v)
        assert _same_tree(js.comp, ts.comp) if kahan else ts.comp is None
        assert int(js.step) == int(ts.step)
        for k in ("grad_norm", "lr"):
            assert float(jm[k]) == float(tm[k]), k


@pytest.mark.parametrize("kahan", [True, False])
def test_apply_update_bf16_kahan_norm_within_tolerance(kahan):
    """Tier 3: with the default compensated tree norm the grad norm is
    within rtol 1e-6 (its final column sums are XLA's order in the
    reference), so a clipped update may differ by one bf16 ulp: params
    within rtol 2^-7, moments within rtol 1e-5."""
    for jp, js, jm, tp, ts, tm in _run_both("bfloat16", kahan, True):
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       rtol=2 ** -7, atol=1e-6)
        for a, b in zip(jax.tree.leaves((js.m, js.v)),
                        T.leaves((ts.m, ts.v))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-12)


@pytest.mark.parametrize("kahan", [True, False])
def test_apply_update_f32_within_tolerance(kahan):
    """Float32 params. Tier 1 with the engine-folded norm: params, m, v,
    comp and grad_norm equal the jitted reference's after each of three
    steps (the tolerance is zero: the port divides by ``c1 * (sqrt(vhat)
    + eps)`` as XLA rewrites it, fuses the weight decay's product into its
    add, and takes a correctly rounded square root). Tier 3 under the
    compensated tree norm, whose scalar differs within rtol 1e-6: params
    within rtol 1e-6, the moments bitwise."""
    for jp, js, jm, tp, ts, tm in _run_both("float32", kahan, False):
        assert _same_tree(jp, tp)
        assert _same_tree(js.m, ts.m) and _same_tree(js.v, ts.v)
        assert _same_tree(js.comp, ts.comp) if kahan else ts.comp is None
        assert float(jm["grad_norm"]) == float(tm["grad_norm"])
    for jp, js, jm, tp, ts, tm in _run_both("float32", kahan, True):
        for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-12)
        assert _same_tree(js.m, ts.m) and _same_tree(js.v, ts.v)


TINY32 = float(np.finfo(np.float32).tiny)


def _underflows(exact: np.ndarray) -> int:
    """How many exact (float64) results lie strictly between zero and
    ``tiny``: the reference flushes each of them."""
    a = np.abs(exact)
    return int(((a > 0) & (a < TINY32)).sum())


def _subnormal_grads(shape, rng):
    """Gradients whose update reaches float32's subnormal range: entries
    from subnormal up to 2^-20 (the global norm stays below the clip, so
    the clip scale is exactly 1) and signed zeros. ``g * (1 - b1)``,
    ``g * g`` and its ``* (1 - b2)`` underflow for many of them."""
    n = int(np.prod(shape))
    sign = rng.choice([-1.0, 1.0], n)
    g = sign * rng.random(n) * np.exp2(rng.integers(-149, -20, n))
    g[rng.random(n) < 0.05] = 0.0
    g[rng.random(n) < 0.05] = -0.0
    return g.reshape(shape).astype(np.float32)


def _subnormal_params(shape, rng, dtype):
    """Parameters from subnormal to 2^0, signed zeros among them: the
    weight decay's term and ``-lr * dir`` of the small ones underflow."""
    n = int(np.prod(shape))
    sign = rng.choice([-1.0, 1.0], n)
    p = sign * (1 + rng.random(n)) * np.exp2(rng.integers(-149, 0, n))
    p[rng.random(n) < 0.05] *= -0.0
    return jnp.asarray(p.reshape(shape).astype(np.float32)).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kahan", [True, False])
def test_apply_update_subnormal_bitwise(dtype, kahan):
    """Tier 1 on subnormal-reaching data (C2): params and grads reach
    float32's subnormal range, and so do the step's products (checked on
    the data); params, m, v, comp and grad_norm equal the jitted
    reference's after each of three steps (the engine-folded norm),
    AdamW and KahanAdamW, float32 and bf16 params."""
    rng = np.random.default_rng(9)
    jp = {k: _subnormal_params(s, rng, dtype) for k, s in SHAPES.items()}
    jcfg = JaxAdamWConfig(kahan=kahan, kahan_norm=False)
    cfg = AdamWConfig(kahan=kahan, kahan_norm=False)
    js = jax_opt_init(jcfg, jp)
    tp = _tt(jp)
    ts = init(cfg, tp)
    step = jax.jit(jax_apply_update, static_argnums=0)
    flat_p = np.concatenate([np.asarray(v, np.float64).reshape(-1)
                             for v in jax.tree.leaves(jp)])
    # the weight decay's product of the small params underflows
    assert _underflows(flat_p * np.float32(cfg.weight_decay)) > 0
    for i in range(3):
        g = {k: _subnormal_grads(s, rng) for k, s in SHAPES.items()}
        flat = np.concatenate([v.reshape(-1) for v in g.values()])
        flat = flat.astype(np.float64)
        assert _underflows(flat * np.float32(1 - cfg.b1)) > 0
        assert _underflows(flat * flat) > 0
        scale = np.float32(0.5 + 0.25 * i)
        jp, js, jm = step(jcfg, jp, g, js, jnp.float32(scale))
        tp, ts, tm = apply_update(cfg, tp, _tt(g), ts, torch.tensor(scale))
        assert _same_tree(jp, tp), i
        assert _same_tree(js.m, ts.m) and _same_tree(js.v, ts.v), i
        assert _same_tree(js.comp, ts.comp) if kahan else ts.comp is None
        assert float(jm["grad_norm"]) == float(tm["grad_norm"])


@pytest.mark.parametrize("shape,scalar", [
    ((3, (1 << 21) + 5), "a"),        # one row a slice, three slices
    ((3, (1 << 21) + 5), "b"),
    ((2, 2048, 1100), None),          # 3-D, both factors tensors
    ((4096, 1025), "a"),              # 4092 rows a slice, a ragged last
])
def test_fused_slices_equal_one_fma(shape, scalar):
    """Above ``_FMA_CHUNK`` elements (an OLMo-1B embedding or stacked
    layer leaf) ``_fused`` runs the exact fma slice by slice along the
    leading axis: bitwise the one-call ``fma`` of the whole tensor, with
    a scalar factor on either side."""
    from repro_torch.optim import adamw

    assert int(np.prod(shape)) > adamw._FMA_CHUNK
    g = torch.Generator().manual_seed(11)
    a, b, c = (torch.randn(shape, generator=g) for _ in range(3))
    if scalar == "a":
        a = -3e-4
    elif scalar == "b":
        b = 0.95
    full = lambda x: (x if isinstance(x, torch.Tensor)  # noqa: E731
                      else torch.tensor(x, dtype=c.dtype))
    want = TK.fma(full(a), full(b), c)
    assert torch.equal(adamw._fused(a, b, c), want)


def test_init_and_state_structure():
    params = {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
              "n": {"b": torch.zeros(5)}}
    st = init(AdamWConfig(), params)
    assert isinstance(st, OptState) and st.step.dtype == torch.int32
    assert T.leaves(st.m)[0].dtype == torch.float32
    assert T.leaves(st.comp)[1].dtype == torch.bfloat16
    assert init(AdamWConfig(kahan=False), params).comp is None


def test_grad_clip_scales_the_update():
    cfg = AdamWConfig(lr=1.0, kahan=False, weight_decay=0.0, grad_clip=1.0)
    p = {"w": torch.zeros(4)}
    _, _, m = apply_update(cfg, p, {"w": torch.full((4,), 100.0)},
                           init(cfg, p))
    assert float(m["grad_norm"]) == 200.0


def test_warmup_cosine_at_a_few_steps():
    for step in (0, 1, 5, 10, 37, 99, 100, 150):
        got = float(schedule.warmup_cosine(step, warmup=10, total=100))
        want = float(jax_warmup_cosine(step, warmup=10, total=100))
        assert abs(got - want) <= 1e-6, (step, got, want)
    got = schedule.warmup_cosine(torch.tensor(3, dtype=torch.int32),
                                 warmup=1, total=4)
    assert got.dtype == torch.float32
    assert schedule.constant(7) == 1.0
