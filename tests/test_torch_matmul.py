"""The port's matmul slice vs the JAX reference, on the CPU.

The reference runs its Pallas matmul kernels in interpret mode, as its own
tests do; the port's wrappers run their plain version (the CUDA kernel is
held against the same plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Inputs come from
numpy seeds and go through both packages. Parity tiers:

* tier 3 (tolerance against the reference). Both sides fold the same
  K-blocks with the same scheme update, but each forms a block product in
  its own order: the port as one ascending chain of rounded products and
  adds, XLA's ``dot_general`` in its own. So the results agree within
  ``1e-6 * (|a| @ |b|)`` elementwise in float32 (measured: at most 1.7e-7
  of that scale, at M = 1). Model logits with ``kahan_matmul``: the
  reference's own routing tolerance, rtol = atol = 1e-3
  (``tests/test_engine_routing.py``); greedy tokens EXACT. Gradients:
  within the same matmul tolerance.
  In bfloat16 and float64 compute (the card's B-9 instantiations) the
  raw grids are held against the reference's Pallas kernel in the same
  dtype: bfloat16 within ``1e-2 * (|a| @ |b|)`` (ROADMAP's tier 3 for
  bfloat16 matmul: the port rounds each of a block's products and adds
  to bfloat16, XLA's ``dot_general`` sums in its own order and width),
  float64 within ``2 * (block_k + steps) * 2^-53 * (|a| @ |b|)``: each
  side's worst case is one rounding a product and an add in a block
  product of ``block_k`` terms and one an add in the fold over ``steps``
  K-blocks (measured: 5.3e-3 of that scale in bfloat16; none in float64,
  where XLA on the CPU happens to sum a block in the same ascending
  order).
* tier 2 (bitwise within the port): batched equals a loop of single
  calls; an output row is the same whatever M is; the oracle
  ``ref.matmul_ref`` equals the engine; the backward equals the
  compensated products of ``(g, bᵀ)`` and ``(aᵀ, g)``; solo equals
  interleaved serving with ``kahan_matmul``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.kernels import ops as jops
from repro.kernels import schemes as jschemes
from repro.models import build_model as jax_build
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels import engine as teng
from repro_torch.kernels import kahan_matmul as tkm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import schemes as tschemes
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    Request,
    SamplingParams,
)

CPU = torch.device("cpu")
SCHEMES = ["naive", "kahan", "pairwise", "dot2"]
MATMUL_RTOL = 1e-6            # of (|a| @ |b|), elementwise
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
SMOKE_BLOCKS = (64, 128, 128)


def _operands(seed, m, k, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if dtype == "bfloat16":
        # values representable in bf16, so both sides see the same inputs
        a = torch.from_numpy(a).bfloat16().float().numpy()
        b = torch.from_numpy(b).bfloat16().float().numpy()
    return a, b


def _assert_close_to_scale(got, want, a, b):
    scale = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= MATMUL_RTOL * scale).all(), (err / scale).max()


# (m, k, n) and how the blocks are set: explicit on the call, the policy's
# defaults, or an ambient use_policy(blocks=...)
CASES = [((1, 300, 200), "explicit"), ((40, 1100, 300), "policy"),
         ((8, 1536, 256), "use_policy")]


@pytest.mark.parametrize("operands", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_matmul_within_tolerance_of_reference(scheme, case, operands):
    """Tier 3: B5 through ``ops.matmul`` vs the reference's, float32
    compute, ragged M, N, K, float32 or bf16 operands (the port keeps bf16
    and widens it where it reads it; the reference promotes first)."""
    (m, k, n), blocks = case
    a, b = _operands(m + k, m, k, n, operands)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if operands == "bfloat16":
        ta, tb = ta.bfloat16(), tb.bfloat16()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    kw = {}
    if blocks == "explicit":
        kw = dict(block_m=8, block_n=128, block_k=128)
    if blocks == "use_policy":
        with tschemes.use_policy(blocks=(64, 128, 256)):
            got = tops.matmul(ta, tb, scheme=scheme)
        with jschemes.use_policy(blocks=(64, 128, 256)):
            want = jops.matmul(ja, jb, scheme=scheme)
    else:
        got = tops.matmul(ta, tb, scheme=scheme, **kw)
        want = jops.matmul(ja, jb, scheme=scheme, **kw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _assert_close_to_scale(got.numpy(), want, a, b)


def _one_product_blocks(rng, m, k, block_k, lo, hi):
    """[m, k] with one nonzero a row in each K-block of ``block_k``
    columns: each block product is one rounded product in any order, so
    the port's grids can be held bit for bit against the reference's
    (whose ``dot`` orders a dense block its own way)."""
    a = np.zeros((m, k), np.float32)
    for blk in range(0, k, block_k):
        cols = rng.integers(blk, min(blk + block_k, k), size=m)
        a[np.arange(m), cols] = (rng.standard_normal(m) * np.exp2(
            rng.integers(lo, hi, size=m)))
    return a


@pytest.mark.parametrize("operands", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_subnormal_reaching_grids_bitwise(scheme, operands):
    """Tier 1 on subnormal-reaching data (C2): products that underflow
    and subnormal operands, on K-blocks of one product a row, so that
    only the flushing of each product and of the scheme's fold across
    the blocks is compared. The (s, c) grids and the product equal the
    reference's Pallas grids bit for bit, at M 3 and 37."""
    rng = np.random.default_rng(7)
    k, n, bk = 3 * 128 + 37, 130, 128
    blocks = dict(block_m=64, block_n=128, block_k=bk)
    for m in (3, 37):
        a = _one_product_blocks(rng, m, k, bk, -75, -52)
        b = (rng.standard_normal((k, n)) * np.exp2(
            rng.integers(-75, -52, size=(k, n)))).astype(np.float32)
        b[rng.random((k, n)) < 0.2] *= np.float32(2.0 ** -70)
        if operands == "bfloat16":
            a = torch.from_numpy(a).bfloat16().float().numpy()
            b = torch.from_numpy(b).bfloat16().float().numpy()
        jdt = jnp.bfloat16 if operands == "bfloat16" else jnp.float32
        tdt = getattr(torch, operands)
        je = jeng_matmul(scheme)
        te = teng.CompensatedReduction(scheme=scheme)
        ja = je.matmul_accumulators(jnp.asarray(a).astype(jdt),
                                    jnp.asarray(b).astype(jdt), **blocks)
        ta = te.matmul_accumulators(torch.from_numpy(a).to(tdt),
                                    torch.from_numpy(b).to(tdt), **blocks)
        for w, g in ((ja.s, ta.s), (ja.c, ta.c)):
            w = np.asarray(w)
            assert w.shape == tuple(g.shape)
            assert np.array_equal(w.view(np.uint32),
                                  g.numpy().view(np.uint32)), (scheme, m)
        assert bool((ta.s.abs() > 0).any())


def jeng_matmul(scheme):
    from repro.kernels.engine import CompensatedReduction

    return CompensatedReduction(scheme=scheme)


@pytest.mark.parametrize("batched", [False, True], ids=["B5", "B6"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_wrapper_grids_within_tolerance_of_reference_kernel(scheme,
                                                           batched):
    """Tier 3 at the kernel boundary: the wrappers' raw (s, c) grids on
    padded operands vs the reference's Pallas kernels (interpret mode):
    s, c and s + c each within ``1e-6 * (|a| @ |b|)``."""
    from repro.kernels import kahan_matmul as jkm

    rng = np.random.default_rng(17)
    a = rng.standard_normal((2, 16, 1024)).astype(np.float32)
    b = rng.standard_normal((2, 1024, 256)).astype(np.float32)
    kw = dict(block_m=16, block_n=128, block_k=256)
    jkw = dict(kw, scheme=jschemes.get(scheme), interpret=True)
    if batched:
        got = tkm.matmul_accumulators_batched(
            torch.from_numpy(a), torch.from_numpy(b),
            scheme=tschemes.get(scheme), **kw)
        want = jkm.matmul_accumulators_batched(jnp.asarray(a),
                                               jnp.asarray(b), **jkw)
    else:
        a, b = a[:1], b[:1]
        got = [g[None] for g in tkm.matmul_accumulators(
            torch.from_numpy(a[0]), torch.from_numpy(b[0]),
            scheme=tschemes.get(scheme), **kw)]
        want = [w[None] for w in jkm.matmul_accumulators(
            jnp.asarray(a[0]), jnp.asarray(b[0]), **jkw)]
    for i in range(a.shape[0]):
        for g, w in zip([*got, got[0] + got[1]],
                        [*want, want[0] + want[1]]):
            _assert_close_to_scale(g[i].numpy(), np.asarray(w)[i], a[i],
                                   b[i])


BF16_MATMUL_RTOL = 1e-2


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float64"])
@pytest.mark.parametrize("batched", [False, True], ids=["B5", "B6"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_wrapper_grids_in_bfloat16_and_float64_vs_reference_kernel(
        scheme, batched, compute_dtype):
    """Tier 3 at the kernel boundary in bfloat16 and float64 compute:
    the wrappers' raw (s, c) grids at M 37 (the M > 8 tiles on the card)
    and M 5 (the rows path), 4 K-blocks of 128, vs the reference's Pallas
    kernels in the same dtype (interpret mode; float64 under
    ``jax.enable_x64``): s, c and s + c each within the module's stated
    tolerance, the grids in the compute dtype."""
    from repro.kernels import kahan_matmul as jkm

    rng = np.random.default_rng(19)
    block_k, steps = 128, 4
    tdt, jdt = getattr(torch, compute_dtype), getattr(jnp, compute_dtype)
    rtol = (BF16_MATMUL_RTOL if compute_dtype == "bfloat16"
            else 2 * (block_k + steps) * 2.0 ** -53)
    kw = dict(block_m=8, block_n=128, block_k=block_k)
    for m in (37, 5):
        a = rng.standard_normal((2, m, steps * block_k))
        b = rng.standard_normal((2, steps * block_k, 256))
        if compute_dtype == "bfloat16":
            a, b = (torch.from_numpy(x).bfloat16().double().numpy()
                    for x in (a, b))
        if not batched:
            a, b = a[:1], b[:1]
        ta, tb = (torch.from_numpy(x).to(tdt) for x in (a, b))
        with jax.enable_x64(compute_dtype == "float64"):
            ja, jb = (jnp.asarray(x).astype(jdt) for x in (a, b))
            jkw = dict(kw, scheme=jschemes.get(scheme), interpret=True,
                       compute_dtype=jdt, block_m=m)
            tkw = dict(kw, scheme=tschemes.get(scheme), compute_dtype=tdt)
            if batched:
                got = tkm.matmul_accumulators_batched(ta, tb, **tkw)
                want = jkm.matmul_accumulators_batched(ja, jb, **jkw)
            else:
                got = [g[None] for g in tkm.matmul_accumulators(
                    ta[0], tb[0], **tkw)]
                want = [w[None] for w in jkm.matmul_accumulators(
                    ja[0], jb[0], **jkw)]
            want = [np.asarray(w) for w in want]
        assert all(g.dtype == tdt for g in got)
        assert all(w.dtype.name == compute_dtype for w in want)
        for i in range(a.shape[0]):
            scale = np.abs(a[i]) @ np.abs(b[i])
            for g, w in zip([*got, got[0] + got[1]],
                            [*want, want[0] + want[1]]):
                err = np.abs(g[i].double().numpy() - w[i].astype(np.float64))
                assert (err <= rtol * scale).all(), (m, (err / scale).max())


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16,
                                           torch.float64])
def test_forced_plans_are_the_kernels_own(compute_dtype):
    """The plans a caller may force on the kernel's M > 8 path
    (``fitting_plans``), pinned by hand: the tile heights of the dtype's
    instantiations (32, 64 and 128 rows; 32 and 64 in float64) times
    cluster splits 1 to min(K-blocks, 8), split 1 alone where the batch
    fills grid z, none at M <= 8. ``_launch`` refuses any other before it
    runs; on CPU tensors every fitting plan gives the plain version's
    grids."""
    heights = (32, 64) if compute_dtype == torch.float64 else (32, 64, 128)
    assert tkm.TILE_ROWS[compute_dtype] == heights
    assert tkm.fitting_plans(1, 64, 2048, 512, compute_dtype) == tuple(
        (h, s) for h in heights for s in (1, 2, 3, 4))
    assert tkm.fitting_plans(4, 300, 20 * 128, 128, compute_dtype) == tuple(
        (h, s) for h in heights for s in range(1, 9))
    assert tkm.fitting_plans(65535, 9, 1024, 256, compute_dtype) == tuple(
        (h, 1) for h in heights)
    assert tkm.fitting_plans(1, 8, 2048, 512, compute_dtype) == ()
    rng = np.random.default_rng(23)
    a = torch.from_numpy(rng.standard_normal((1, 12, 256))).to(compute_dtype)
    b = torch.from_numpy(rng.standard_normal((1, 256, 40))).to(compute_dtype)
    kw = dict(scheme=tschemes.KAHAN, block_m=8, block_n=40, block_k=128,
              compute_dtype=compute_dtype,
              counter=tkm.matmul_accumulators_batched)
    want = tkm.matmul_plain(a, b, scheme=tschemes.KAHAN, block_k=128,
                            compute_dtype=compute_dtype)
    for plan in tkm.fitting_plans(1, 12, 256, 128, compute_dtype):
        got = tkm._launch(a, b, plan=plan, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), plan
    bad = [(48, 1), (64, 0), (64, 3), (32, 9), (0, 1)]
    if compute_dtype == torch.float64:
        bad.append((128, 1))
    for plan in bad:
        with pytest.raises(ValueError, match="plan"):
            tkm._launch(a, b, plan=plan, **kw)
    with pytest.raises(ValueError, match="plan"):
        tkm._launch(a[:, :8], b, plan=(32, 1), **kw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_matmul_within_tolerance_of_reference(scheme):
    """Tier 3: B6 through ``ops.batched_matmul`` vs the reference's."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 20, 700)).astype(np.float32)
    b = rng.standard_normal((3, 700, 150)).astype(np.float32)
    got = tops.batched_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              scheme=scheme, block_k=256)
    want = jops.batched_matmul(jnp.asarray(a), jnp.asarray(b),
                               scheme=scheme, block_k=256)
    assert got.shape == (3, 20, 150)
    for i in range(3):
        _assert_close_to_scale(got[i].numpy(), np.asarray(want)[i], a[i],
                               b[i])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_equals_loop_and_rows_invariant_to_m_bitwise(scheme):
    """Tier 2 within the port: the batched grid equals a loop of single
    calls, and every row of an M = 37 call equals the M = 1 call of that
    row, to the bit (the block product's order does not depend on M)."""
    a, b = _operands(3, 37, 600, 130)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    full = tops.matmul(ta, tb, scheme=scheme, block_k=256)
    for i in (0, 5, 36):
        assert torch.equal(full[i:i + 1],
                           tops.matmul(ta[i:i + 1], tb, scheme=scheme,
                                       block_k=256))
    stack = torch.stack([ta[:8], ta[8:16], ta[16:24]])
    bstack = torch.stack([tb, tb.flip(0), tb * 2])
    batched = tops.batched_matmul(stack, bstack, scheme=scheme, block_k=256)
    for i in range(3):
        assert torch.equal(batched[i], tops.matmul(stack[i], bstack[i],
                                                   scheme=scheme,
                                                   block_k=256))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_oracle_and_accumulators_equal_engine_bitwise(scheme):
    """Tier 2: the oracle ``ref.matmul_ref`` (and its batched form) equals
    ``ops.matmul`` at the same K-block; the engine's accumulator grids are
    the padded ``[M_pad, N_pad]`` pair whose finalized slice is the
    result."""
    a, b = _operands(11, 13, 900, 70)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tops.matmul(ta, tb, scheme=scheme, block_k=256)
    assert torch.equal(got, tref.matmul_ref(ta, tb, 256, scheme))
    assert torch.equal(tref.batched_matmul_ref(ta[None], tb[None], 256,
                                               scheme)[0], got)
    eng = teng.CompensatedReduction(scheme=scheme)
    acc = eng.matmul_accumulators(ta, tb, block_k=256)
    assert acc.s.shape == (16, 128) and eng.last_path == "cpu"
    assert torch.equal((acc.s + acc.c)[:13, :70], got)


@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_unpadded_rows_equal_padded_call_bitwise(scheme, m, monkeypatch):
    """Tier 2: ``ops.matmul`` builds one engine per call and hands the
    kernel wrapper its M rows as they are (no pad of M: the kernel masks
    rows past M); the result equals the first M rows of the same call on
    operands zero-padded to 8 rows, bit for bit."""
    a, b = _operands(20 + m, m, 700, 130)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    rows, engines = [], []
    launch = tkm.matmul_accumulators
    init = teng.CompensatedReduction.__post_init__

    def spy(x, y, **kw):
        rows.append(x.shape[0])
        return launch(x, y, **kw)

    def counting_init(self):
        engines.append(self)
        init(self)

    monkeypatch.setattr(tkm, "matmul_accumulators", spy)
    monkeypatch.setattr(teng.CompensatedReduction, "__post_init__",
                        counting_init)
    got = tops.matmul(ta, tb, scheme=scheme, block_k=256)
    assert rows == [m] and len(engines) == 1
    padded = torch.cat([ta, ta.new_zeros((8 - m, ta.shape[1]))])
    want = tops.matmul(padded, tb, scheme=scheme, block_k=256)
    assert rows == [m, 8]
    assert got.shape == (m, 130) and torch.equal(got, want[:m])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_no_autograd_node_without_grad_bitwise(scheme, monkeypatch):
    """Without a gradient to track (plain tensors, or ``torch.no_grad()``)
    ``ops.matmul`` launches directly, never entering the autograd
    Function, and its result has no ``grad_fn``; with one it goes through
    the Function. All three are equal bit for bit."""
    a, b = _operands(4, 5, 600, 70)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    kw = dict(scheme=scheme, block_k=256)
    entered = []
    forward = teng._CompensatedMatmul.forward

    def counting_forward(ctx, *args):
        entered.append(1)
        return forward(ctx, *args)

    monkeypatch.setattr(teng._CompensatedMatmul, "forward",
                        staticmethod(counting_forward))
    plain = tops.matmul(ta, tb, **kw)
    ga, gb = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    with torch.no_grad():
        no_grad = tops.matmul(ga, gb, **kw)
    assert entered == []
    tracked = tops.matmul(ga, gb, **kw)
    assert entered == [1]
    assert plain.grad_fn is None and no_grad.grad_fn is None
    assert tracked.grad_fn is not None
    assert torch.equal(plain, no_grad) and torch.equal(plain, tracked)


def test_kahan_beats_naive_on_long_k():
    """Accuracy against float64 (the reference's
    ``tests/test_kernels.py:79``): over a long K (256 K-blocks of 128),
    compensated accumulation across K-blocks beats naive float32
    accumulation."""
    rng = np.random.default_rng(9)
    m, k, n = 8, 1 << 15, 128
    a = (rng.standard_normal((m, k)) * 10).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 10).astype(np.float32)
    exact = tref.matmul_exact_f64(a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    kw = dict(block_m=8, block_n=128, block_k=128)
    kah = tops.matmul(ta, tb, scheme="kahan", **kw).double().numpy()
    nai = tops.matmul(ta, tb, scheme="naive", **kw).double().numpy()
    assert np.abs(kah - exact).max() <= np.abs(nai - exact).max()


def test_gradcheck_float64_and_backward_through_the_kernel():
    """``torch.autograd.gradcheck`` of ``ops.matmul`` in float64 over
    several K-blocks; the backward equals the compensated products of
    ``(g, bᵀ)`` and ``(aᵀ, g)`` at the forward's blocks, bitwise (tier 2),
    and the reference's gradients within the matmul tolerance (tier 3)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((6, 40))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((40, 9))).requires_grad_()
    fn = lambda x, y: tops.matmul(x, y, scheme="kahan",  # noqa: E731
                                  compute_dtype=torch.float64, block_k=16)
    assert torch.autograd.gradcheck(fn, (a, b))

    a32, b32 = _operands(6, 12, 300, 20)
    g = np.random.default_rng(8).standard_normal((12, 20)).astype(np.float32)
    ta = torch.from_numpy(a32).requires_grad_()
    tb = torch.from_numpy(b32).requires_grad_()
    out = tops.matmul(ta, tb, scheme="kahan", block_k=128)
    out.backward(torch.from_numpy(g))
    tg = torch.from_numpy(g)
    kw = dict(scheme="kahan", block_k=128)
    assert torch.equal(ta.grad, tops.matmul(tg, tb.detach().T, **kw))
    assert torch.equal(tb.grad, tops.matmul(ta.detach().T, tg, **kw))
    jda, jdb = jax.vjp(lambda x, y: jops.matmul(x, y, scheme="kahan",
                                                block_k=128),
                       jnp.asarray(a32), jnp.asarray(b32))[1](jnp.asarray(g))
    _assert_close_to_scale(ta.grad.numpy(), jda, g, b32.T)
    _assert_close_to_scale(tb.grad.numpy(), jdb, a32.T, g)


# ---------------------------------------------------------------------------
# The model and the serving engine with kahan_matmul
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmo_weights():
    """JAX-initialised OLMo-1B smoke weights in both packages."""
    jcfg = jax_smoke("olmo-1b")
    jparams, _ = jax_build(jcfg).init(jax.random.key(0))
    cfg = get_smoke("olmo-1b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params)


@pytest.mark.parametrize("kahan_attention", [False, True])
def test_model_prefill_and_greedy_decode_vs_reference(olmo_weights,
                                                      kahan_attention):
    """Tier 3: the smoke OLMo model with ``kahan_matmul`` (and optionally
    ``kahan_attention``) vs the JAX model under ``use_policy(blocks=(64,
    128, 128))``: prefill logits within rtol = atol = 1e-3 and four greedy
    decode tokens exact; on CPU tensors nothing launches."""
    knobs = dict(kahan_matmul=True, kahan_attention=kahan_attention)
    jmodel = jax_build(olmo_weights["jcfg"].replace(**knobs))
    model = build_model(olmo_weights["cfg"].replace(**knobs), CPU)
    jparams, params = olmo_weights["jparams"], olmo_weights["params"]
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (1, 21)).astype(np.int32)
    before = teng.launch_counts()
    with jschemes.use_policy(scheme="kahan", blocks=SMOKE_BLOCKS), \
            tschemes.use_policy(scheme="kahan", blocks=SMOKE_BLOCKS):
        jcache, _ = jmodel.init_cache(1, 32)
        jlog, jcache = jmodel.prefill(jparams,
                                      {"tokens": jnp.asarray(toks)}, jcache)
        cache = model.init_cache(1, 32)
        log, cache = model.prefill(params, torch.from_numpy(
            toks.astype(np.int64)), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **MODEL_TOL)
        for pos in range(21, 25):
            tok = int(jnp.argmax(jlog[0]))
            assert int(log[0].argmax()) == tok, pos
            jlog, jcache = jmodel.decode_step(
                jparams, jcache, jnp.asarray([tok], jnp.int32),
                jnp.int32(pos))
            log = model.decode_step(params, cache, torch.tensor([tok]), pos)
    assert int(log[0].argmax()) == int(jnp.argmax(jlog[0]))
    assert teng.launch_counts() == before


SPEC = [(9, 4), (14, 3), (5, 5)]
ARRIVALS = [0, 1, 2]


def _requests(cfg, temperature=0.0):
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, (p,)),
                    request_id=i, sampling=SamplingParams(
                        temperature=temperature, max_new_tokens=n,
                        seed=3 + i))
            for i, (p, n) in enumerate(SPEC)]


def _ec(**kw):
    base = dict(max_slots=2, max_len=24, track_stats=True, prefill_chunk=4,
                prefill_mode="flash",
                policy=Policy(scheme="kahan", blocks=SMOKE_BLOCKS))
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def matmul_engine(olmo_weights):
    cfg = olmo_weights["cfg"].replace(kahan_matmul=True,
                                      kahan_attention=True)
    return dict(cfg=cfg, model=build_model(cfg, CPU),
                params=olmo_weights["params"])


def _serve(s, ec, requests, arrivals=None):
    return InferenceEngine(s["cfg"], ec, model=s["model"],
                           params=s["params"]).run(requests, arrivals)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_serving_solo_vs_interleaved_bitwise(matmul_engine, temperature):
    """Tier 2: with ``kahan_matmul`` (and flash prefill) a request alone
    emits bitwise the same tokens and telemetry as interleaved."""
    reqs = _requests(matmul_engine["cfg"], temperature)
    inter = _serve(matmul_engine, _ec(), reqs, ARRIVALS)
    for req in reqs:
        solo = _serve(matmul_engine, _ec(), [req])[req.request_id]
        assert solo.tokens == inter[req.request_id].tokens
        assert solo.telemetry == inter[req.request_id].telemetry
        assert len(solo.tokens) == req.sampling.max_new_tokens


def test_decode_tick_runs_under_engine_policy(matmul_engine):
    """The engine's contract (ROADMAP section C): the decode step runs
    under the engine's Policy, as prefill chunks do, not under the
    caller's ambient one. A runtime-registered scheme
    counts its ``update`` calls (CPU tensors run it): as the ambient
    policy it is never called while an engine with scheme naive serves;
    as the engine's policy under an ambient naive one, its decode ticks
    call it for every K-block of every projection."""
    calls = []
    naive = tschemes.get("naive")

    def counting_update(s, c, x, step):
        calls.append(step)
        return naive.update(s, c, x, step)

    mine = tschemes.register(tschemes.CompensationScheme(
        name="test_torch_matmul_counting", update=counting_update,
        instruction_mix=tschemes.InstructionMix(adds=1, muls=1),
        error_bound=tschemes.NAIVE.error_bound))
    cfg = matmul_engine["cfg"]
    try:
        reqs = _requests(cfg)[:1]
        with tschemes.use_policy(scheme=mine):
            out = _serve(matmul_engine, _ec(policy=Policy(
                scheme="naive", blocks=SMOKE_BLOCKS)), reqs)
        assert calls == []
        with tschemes.use_policy(scheme="naive"):
            want = _serve(matmul_engine, _ec(policy=Policy(
                scheme="naive", blocks=SMOKE_BLOCKS)), reqs)
        assert out[0].tokens == want[0].tokens
        assert out[0].telemetry == want[0].telemetry

        engine = InferenceEngine(cfg, _ec(policy=Policy(
            scheme=mine, blocks=SMOKE_BLOCKS)), model=matmul_engine["model"],
            params=matmul_engine["params"])
        tick_calls = []

        def tick(running, events, _orig=engine._decode_tick):
            before = len(calls)
            _orig(running, events)
            tick_calls.append((len(running), len(calls) - before))

        engine._decode_tick = tick
        with tschemes.use_policy(scheme="naive"):
            engine.run(reqs)
        # per running slot: 7 projections x n_layers, one K-block each at
        # the smoke widths (K <= 128), plus the tick's one telemetry
        # launch folding ceil(512 / 8192) = 1 step per logit row
        per_position = 7 * cfg.n_layers
        assert tick_calls and all(n == slots * per_position + 1
                                  for slots, n in tick_calls), tick_calls
    finally:
        tschemes.unregister("test_torch_matmul_counting")
