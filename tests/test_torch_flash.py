"""The port's flash slice vs the JAX reference, on the CPU.

The reference runs its Pallas flash kernels in interpret mode, as its own
tests do; the port's wrappers run their plain versions (the CUDA kernels
are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Inputs come from
numpy seeds and go through both packages. Parity tiers:

* tier 3 (tolerance against the reference). Finalized outputs within
  ``FLASH_TOL`` (rtol 1e-5, atol 2e-6); the raw grids (values and
  compensation terms) within ``GRID_RTOL`` = 1e-5 of their row's scale.
  Both sides compute in float32 with the same block structure, but XLA's
  in-block ``dot_general`` sums ``q . k`` and ``p . v`` in its own order
  and XLA's CPU ``exp`` is not torch's (measured: 4.8e-7 max abs on
  outputs of magnitude ~2; grids within 7.4e-7 of their row scale). Model logits
  (smoke config, float32, JAX weights through the bridge) and serving
  telemetry: rtol = atol = 1e-5, as in ``test_torch_serve.py``. Greedy
  tokens: EXACT.
* tier 2 (bitwise within the port): a chunk at an aligned offset equals
  the full grid's rows; GQA through ``bh // G`` equals broadcast k/v; the
  oracle ``ref.flash_attention_ref`` equals the engine; solo equals
  interleaved under flash.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.kernels import engine as jeng
from repro.kernels import flash_attention as jfa
from repro.kernels import schemes as jschemes
from repro.kernels.schemes import Policy as JaxPolicy
from repro.models import build_model as jax_build
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import engine as teng
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kahan_matmul as tkm
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
FLASH_TOL = dict(rtol=1e-5, atol=2e-6)
GRID_RTOL = 1e-5
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, bh, sq, skv, dh, groups=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, dh)).astype(np.float32)
    k = rng.standard_normal((bh // groups, skv, dh)).astype(np.float32)
    v = rng.standard_normal((bh // groups, skv, dh)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close_grids(got, want):
    """(l_s, l_c, acc_s, acc_c): each grid within ``GRID_RTOL`` of its
    row's scale (|l_s| for the l pair, max |acc_s| over the row for the acc
    pair): the raw acc sums cancel, so an elementwise rtol would be
    meaningless near zero."""
    for s_got, c_got, s_want, c_want in ((got[0], got[1], want[0], want[1]),
                                         (got[2], got[3], want[2], want[3])):
        s_want, c_want = np.asarray(s_want), np.asarray(c_want)
        scale = np.abs(s_want).max(axis=-1, keepdims=True)
        for g, w in ((s_got, s_want), (c_got, c_want)):
            assert np.all(np.abs(g.numpy() - w) <= GRID_RTOL * scale)


# ---------------------------------------------------------------------------
# Tier 3: the plain grids vs the Pallas grids (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grid_within_tolerance_of_reference(scheme, causal):
    """B7: raw grids and the finalized output, GQA G = 2, Sq and Skv off
    their blocks (the engine pads; padded keys are masked)."""
    q, k, v = _qkv(11, 4, 150, 300, 16, groups=2)
    kw = dict(block_q=64, block_k=128, causal=causal, q_groups=2)
    je = jeng.CompensatedReduction(scheme=scheme, interpret=True)
    jl, jo, _ = je.flash_attention_accumulators(*map(jnp.asarray, (q, k, v)),
                                                **kw)
    te = teng.CompensatedReduction(scheme=scheme)
    tl, to, sq = te.flash_attention_accumulators(*_t(q, k, v), **kw)
    assert te.last_path == "cpu" and sq == 150
    _close_grids((tl.s, tl.c, to.s, to.c), (jl.s, jl.c, jo.s, jo.c))
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), scheme=scheme,
                               interpret=True, **kw)
    got = tfa.flash_attention(*_t(q, k, v), scheme=scheme, **kw)
    assert got.shape == (4, 150, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_flash_chunk_grid_within_tolerance_of_reference(scheme):
    """B8: a 40-query chunk at offset 100 (not block-aligned) against a
    300-row cache, GQA G = 2."""
    q, k, v = _qkv(13, 4, 40, 300, 16, groups=2)
    kw = dict(block_q=256, block_k=128, q_groups=2)
    je = jeng.CompensatedReduction(scheme=scheme, interpret=True)
    jl, jo, _ = je.flash_chunk_attention_accumulators(
        *map(jnp.asarray, (q, k, v)), q_off=jnp.int32(100), **kw)
    te = teng.CompensatedReduction(scheme=scheme)
    tl, to, w = te.flash_chunk_attention_accumulators(*_t(q, k, v),
                                                      q_off=100, **kw)
    assert w == 40 and tl.s.shape == (4, 40, 1)
    _close_grids((tl.s, tl.c, to.s, to.c), (jl.s, jl.c, jo.s, jo.c))
    want = jfa.flash_chunk_attention(*map(jnp.asarray, (q, k, v)),
                                     q_off=jnp.int32(100), scheme=scheme,
                                     interpret=True, **kw)
    got = tfa.flash_chunk_attention(*_t(q, k, v), q_off=100, scheme=scheme,
                                    **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)


def test_flash_block_body_and_tree_match_reference():
    """The shared pieces: ``rowsum_tree`` bitwise (elementwise adds in the
    same tree) and one ``flash_block_update`` fold within FLASH_TOL."""
    rng = np.random.default_rng(3)
    p = rng.random((5, 200)).astype(np.float32)
    want = np.asarray(jfa.rowsum_tree(jnp.asarray(p)))
    got = tfa.rowsum_tree(torch.from_numpy(p)).numpy()
    assert np.array_equal(got, want)
    q, k, v = _qkv(5, 1, 8, 128, 16)
    sch = jschemes.get("kahan")
    m0 = jnp.full((8, 1), jfa.NEG_INF, jnp.float32)
    z1, zd = jnp.zeros((8, 1), jnp.float32), jnp.zeros((8, 16), jnp.float32)
    want = jfa.flash_block_update(
        sch, jnp.asarray(q[0]), jnp.asarray(k[0]), jnp.asarray(v[0]), m0, z1,
        z1, zd, zd, qb=0, kb=0, step=0, block_q=8, block_k=128, kv_len=100,
        causal=True, scale=16 ** -0.5)
    tq, tk, tv = _t(q, k, v)
    got = tfa.flash_block_update(
        tschemes.KAHAN, tq, tk, tv, torch.full((1, 8, 1), tfa.NEG_INF),
        torch.zeros(1, 8, 1), torch.zeros(1, 8, 1), torch.zeros(1, 8, 16),
        torch.zeros(1, 8, 16), q_pos=torch.arange(8)[:, None],
        k_pos=torch.arange(128)[None, :], kv_len=100, causal=True,
        scale=tfa.softmax_scale(16), step=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), **FLASH_TOL)


# ---------------------------------------------------------------------------
# The CUDA kernel's tile plan (host side; the card is not needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_k", [1, 8, 128, 256, 1024])
@pytest.mark.parametrize("dh", [1, 3, 16, 64, 128, 255, 256])
def test_flash_plan_fits_every_shape(dh, block_k):
    """Every dh and block_k the kernel accepts gets a plan: a tile height
    the kernel has, at most 32 acc cells a thread, and shared memory
    within the H100's 232448 bytes, for grids small and large."""
    for bh, sq in ((1, 1), (16, 64), (16, 2048), (64, 4096)):
        rows, smem = tfa.flash_plan(bh, sq, dh, block_k)
        assert rows in tfa.TILE_ROWS[4]
        assert rows * ((dh + 3) // 4 * 4) <= tfa.TILE_OUTPUTS[4]
        assert smem == tfa.flash_smem_bytes(rows, dh, block_k) <= 232448


def test_flash_plan_tiles_entry_and_chunk():
    """OLMo-1B's shapes: the 2048-token prefill (B7, 512 CTAs) takes the
    64-row tile; a 64-row serving chunk (B8) keeps 16 rows (64 CTAs); dh
    256 with block_k 1024 fits only 16 rows."""
    assert tfa.flash_plan(16, 2048, 128, 256) == (64, 168960)
    assert tfa.flash_plan(16, 64, 128, 256) == (16, 92928)
    assert tfa.flash_plan(16, 2048, 256, 1024) == (16, 215808)
    # two CTAs an SM decide the height: 1088 rows of 16 head-rows do
    assert tfa.flash_plan(16, 1088, 128, 256)[0] == 64
    assert tfa.flash_plan(16, 1024, 128, 256)[0] == 16
    assert tfa.flash_plan(16, 1024, 128, 256, sms=64)[0] == 64


def test_flash_plan_bytes_match_the_layout():
    """``flash_smem_bytes`` is the source note's layout, worked by hand:
    q tile ``rows * ld`` + scores ``rows * (round4(block_k) + 4)`` + 2
    ring stages of ``round4(min(64, block_k) * ld)`` + 4 statistics a
    row, in floats, with ld = dh + 4, or dh + 1 when dh % 4 != 0."""
    # 64 * 132 + 64 * 260 + 2 * 64 * 132 + 4 * 64 = 42240 floats
    assert tfa.flash_smem_bytes(64, 128, 256) == 168960
    # 16 * 132 + 16 * 260 + 2 * 64 * 132 + 4 * 16 = 23232 floats
    assert tfa.flash_smem_bytes(16, 128, 256) == 92928
    # 16 * 260 + 16 * 1028 + 2 * 64 * 260 + 4 * 16 = 53952 floats
    assert tfa.flash_smem_bytes(16, 256, 1024) == 215808
    # ld 19: 16 * 19 + 16 * 104 + 2 * 64 * 19 + 4 * 16 = 4464 floats
    assert tfa.flash_smem_bytes(16, 18, 100) == 17856
    # 64 * 19 + 64 * 104 + 2 * 64 * 19 + 4 * 64 = 10560 floats
    assert tfa.flash_smem_bytes(64, 18, 100) == 42240
    # ld 4, 10 keys a stage: 16 * 4 + 16 * 16 + 2 * 40 + 4 * 16 = 464
    assert tfa.flash_smem_bytes(16, 3, 10) == 1856
    # ld 2, one key, a stage rounded up to 4: 32 + 128 + 8 + 64 = 232
    assert tfa.flash_smem_bytes(16, 1, 1) == 928


@pytest.mark.parametrize("itemsize", [2, 8])
def test_flash_plan_in_bfloat16_and_float64(itemsize):
    """bfloat16 (2 bytes) takes float32's heights, 64 or 16 rows: its q
    tile, score block and statistics in float32's layout (its values are
    held in floats), its K/V ring in bfloat16 (ld = dh + 8). float64 (8
    bytes) takes 32 or 16 rows, its layout padded by 16 bytes (ld = dh +
    2, the score row round2(block_k) + 2), the 32-row tile with 32-key
    ring stages. The tall tile where the grid keeps two
    CTAs an SM (B7), 16 rows otherwise (a B8 chunk). bfloat16 fits every
    dh and block_k; float64 fits OLMo-1B's dh 128 up to block_k 512; every
    (dh, block_k) the kernel takes either fits or raises."""
    tall = 64 if itemsize == 2 else 32
    # B7: ceil(2048 / rows) * 16 CTAs >= 2 * 132; a B8 chunk never is
    assert tfa.flash_plan(16, 2048, 128, 256, itemsize=itemsize)[0] == tall
    assert tfa.flash_plan(16, 64, 128, 256, itemsize=itemsize)[0] == 16
    assert tfa.flash_plan(1, 1, 128, 256, itemsize=itemsize)[0] == 16
    if itemsize == 2:
        # 4 * (64 * 132 + 64 * 260 + 4 * 64) + 2 * 2 * 64 * 136 bytes
        assert tfa.flash_plan(16, 2048, 128, 256, itemsize=2) == (64, 136192)
        # 4 * (16 * 132 + 16 * 260 + 4 * 16) + 2 * 2 * 64 * 136
        assert tfa.flash_plan(16, 64, 128, 256, itemsize=2) == (16, 60160)
        # 4 * (16 * 260 + 16 * 1028 + 4 * 16) + 2 * 2 * 64 * 264
        assert tfa.flash_smem_bytes(16, 256, 1024, 2) == 150272
        # ld 19 floats, 19 bfloat16 in the ring (dh % 8 != 0):
        # 4 * (16 * 19 + 16 * 104 + 4 * 16) + 2 * 2 * 64 * 19
        assert tfa.flash_smem_bytes(16, 18, 100, 2) == 12992
    else:
        # 32 * 130 + 32 * 258 + 2 * 32 * 130 + 4 * 32 = 20864 doubles
        assert tfa.flash_plan(16, 2048, 128, 256, itemsize=8) == (32, 166912)
        # 16 * 130 + 16 * 258 + 2 * 64 * 130 + 4 * 16 = 22912 doubles
        assert tfa.flash_plan(16, 64, 128, 256, itemsize=8) == (16, 183296)
        # 32 * 130 + 32 * 514 + 2 * 32 * 130 + 4 * 32 = 29056 doubles: the
        # H100's limit exactly
        assert tfa.flash_plan(16, 2048, 128, 512, itemsize=8) == (32, 232448)
        assert tfa.flash_plan(16, 64, 128, 512, itemsize=8) == (16, 216064)
        with pytest.raises(ValueError, match="no tile fits"):
            tfa.flash_plan(16, 64, 128, 1024, itemsize=8)
        with pytest.raises(ValueError, match="no tile fits"):
            tfa.flash_plan(16, 64, 256, 128, itemsize=8)
    for dh in (1, 3, 16, 18, 64, 80, 128, 255, 256):
        for bk in (1, 8, 46, 47, 100, 128, 256, 512, 1024):
            for bh, sq in ((4, 64), (64, 4096)):
                try:
                    rows, smem = tfa.flash_plan(bh, sq, dh, bk,
                                                itemsize=itemsize)
                except ValueError as err:
                    assert "no tile fits" in str(err)
                    assert itemsize == 8 and not (dh <= 128 and bk <= 512)
                    continue
                assert rows in tfa.TILE_ROWS[itemsize]
                assert rows * ((dh + 3) // 4 * 4) <= (
                    tfa.TILE_OUTPUTS[itemsize])
                assert smem == tfa.flash_smem_bytes(rows, dh, bk, itemsize)
                assert smem <= tfa.SMEM_LIMIT
                assert (rows, smem) in tfa.fitting_tiles(dh, bk, itemsize)


def test_float64_tiles_reach_the_1024_key_softmax():
    """A block_k of 513-1024 keys runs the softmax's 1024-key form (p2 =
    1024): in float64 every tile's plan reaches it, the 32-row tile and
    the 16-row tile of four acc rows a thread (dh > 128) as well as the
    16-row tile of two. Those are the shapes the card test holds to the
    plain version at block_k 600, 513 and 1024."""
    # 32 * 66 + 32 * 602 + 2 * 32 * 66 + 4 * 32 = 25728 doubles
    assert tfa.flash_plan(16, 2048, 64, 600, itemsize=8) == (32, 205824)
    # 16 * 138 + 16 * 516 + 2 * 64 * 138 + 4 * 16 = 28192 doubles
    assert tfa.flash_plan(16, 64, 136, 513, itemsize=8) == (16, 225536)
    # ld 144 (dh odd): 16 * 144 + 16 * 516 + 2 * 64 * 144 + 4 * 16 = 29056
    # doubles, the limit exactly; dh 144 (ld 146) does not fit
    assert tfa.fitting_tiles(143, 513, 8) == [(16, 232448)]
    assert tfa.fitting_tiles(144, 513, 8) == []
    # 16 * 66 + 16 * 1026 + 2 * 64 * 66 + 4 * 16 = 25984 doubles
    assert tfa.flash_plan(4, 256, 64, 1024, itemsize=8) == (16, 207872)


# ---------------------------------------------------------------------------
# Tier 2: bitwise within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunk_rows_equal_full_grid_bitwise(scheme):
    """B8 at block-aligned offsets walks the rows B7 walks: same k-blocks,
    masks and fold order, so the raw grids are bitwise equal."""
    q, k, v = _qkv(31, 2, 256, 256, 16)
    tq, tk, tv = _t(q, k, v)
    sch = tschemes.get(scheme)
    kw = dict(block_q=64, block_k=128, scheme=sch, kv_len=256)
    full = tfa.flash_accumulators(tq, tk, tv, causal=True, **kw)
    for off in (0, 64, 128):
        chunk = tfa.flash_chunk_accumulators(tq[:, off:off + 64], tk, tv,
                                             off, **kw)
        for g, w in zip(chunk, full):
            assert torch.equal(g, w[:, off:off + 64]), (scheme, off)


@pytest.mark.parametrize("chunk", [False, True])
def test_gqa_index_equals_broadcast_bitwise(chunk):
    """q_groups = G reads k/v head-row bh // G: the same numbers as k/v
    repeated G times, to the bit; and the oracle agrees."""
    q, k, v = _qkv(23, 6, 100, 160, 16, groups=3)
    tq, tk, tv = _t(q, k, v)
    kb, vb = tk.repeat_interleave(3, 0), tv.repeat_interleave(3, 0)
    if chunk:
        run = lambda k_, v_, g: tfa.flash_chunk_attention(  # noqa: E731
            tq, k_, v_, q_off=60, scheme="kahan", q_groups=g)
        want = tref.flash_attention_ref(tq, tk, tv, "kahan", q_groups=3,
                                        q_off=60)
    else:
        run = lambda k_, v_, g: tfa.flash_attention(  # noqa: E731
            tq, k_, v_, scheme="kahan", causal=False, q_groups=g)
        want = tref.flash_attention_ref(tq, tk, tv, "kahan", causal=False,
                                        q_groups=3)
    grouped = run(tk, tv, 3)
    assert torch.equal(grouped, run(kb, vb, 1))
    assert torch.equal(grouped, want)


# ---------------------------------------------------------------------------
# The model: prefill and the parallel chunk body vs the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmo_flash():
    """The OLMo-1B smoke config with ``kahan_attention``, JAX weights and
    the same weights in the port."""
    jcfg = jax_smoke("olmo-1b").replace(kahan_attention=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    cfg = get_smoke("olmo-1b").replace(kahan_attention=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, cfg=cfg,
                model=build_model(cfg, CPU), params=params)


def _prompt(n, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


def test_prefill_logits_and_cache_within_tolerance(olmo_flash):
    """``TransformerLM.prefill`` (B7 per layer) vs the reference's: last
    position logits and every cache row; greedy token exact."""
    s = olmo_flash
    toks = _prompt(37, s["cfg"].vocab_size)[None]
    jcache, _ = s["jmodel"].init_cache(1, 48)
    jlog, jcache = s["jmodel"].prefill(
        s["jparams"], {"tokens": jnp.asarray(toks)}, jcache)
    cache = s["model"].init_cache(1, 48)
    before = teng.launch_counts()
    log, cache = s["model"].prefill(s["params"], torch.from_numpy(
        toks.astype(np.int64)), cache)
    assert teng.launch_counts() == before      # CPU tensors: no launches
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **MODEL_TOL)
    assert int(log.argmax()) == int(jnp.argmax(jlog))
    for got, want in zip(cache["blocks"], jcache["blocks"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
    # a 1-token prompt is a 1-row prefill (the reference raises there):
    # the same logits as the decode step at position 0
    one = torch.from_numpy(toks[:, :1].astype(np.int64))
    log1, _ = s["model"].prefill(s["params"], one, s["model"].init_cache(1, 4))
    dec = s["model"].decode_step(s["params"], s["model"].init_cache(1, 4),
                                 one[:, 0], 0)
    np.testing.assert_allclose(log1.numpy(), dec.numpy(), **MODEL_TOL)


def _drive(model, params, prompt, max_len, chunks, parallel, jax_side):
    """Replay a chunk schedule [(width, nvalid), ...] through one body."""
    cache = model.init_cache(1, max_len)
    if jax_side:
        cache = cache[0]                       # (cache, sharding specs)
    fn = model.prefill_chunk_parallel if parallel else model.prefill_chunk
    off, logits = 0, None
    for width, nvalid in chunks:
        padded = np.zeros((1, width), np.int32)
        padded[0, :nvalid] = prompt[off:off + nvalid]
        if jax_side:
            logits, cache = fn(params, {"tokens": jnp.asarray(padded)},
                               cache, jnp.int32(off), jnp.int32(nvalid))
        else:
            logits, cache = fn(params, torch.from_numpy(
                padded.astype(np.int64)), cache, off, nvalid)
        off += nvalid
    return logits, cache


@pytest.mark.parametrize("kahan_attention", [True, False])
def test_parallel_chunk_body_within_tolerance(olmo_flash, kahan_attention):
    """``prefill_chunk_parallel`` over chunks (8, 8), (8, 8), (8, 5) — a
    bucketed tail whose padding must not write the cache — vs the
    reference's, through B8 (``kahan_attention``) or the materialized
    core; logits and cache within tolerance, rows past the prompt
    pristine, greedy token exact."""
    s = olmo_flash
    chunks = [(8, 8), (8, 8), (8, 5)]
    prompt = _prompt(21, s["cfg"].vocab_size, seed=1)
    jmodel, model = s["jmodel"], s["model"]
    if not kahan_attention:
        jmodel = jax_build(s["jcfg"].replace(kahan_attention=False))
        model = build_model(s["cfg"].replace(kahan_attention=False), CPU)
    with jschemes.use_policy(JaxPolicy(scheme="kahan")):
        jlog, jcache = _drive(jmodel, s["jparams"], prompt, 32, chunks,
                              True, True)
    log, cache = _drive(model, s["params"], prompt, 32, chunks, True, False)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **MODEL_TOL)
    assert int(log.argmax()) == int(jnp.argmax(jlog))
    for got, want in zip(cache["blocks"], jcache["blocks"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        assert not got[:, :, 21:].any()


def test_parallel_chunk_body_matches_scan_and_launches_per_layer(olmo_flash):
    """Within the port: the parallel body and the per-position scan give
    the same greedy token and close logits; a width-1 chunk runs the
    decode mode (no flash), as in the reference."""
    s = olmo_flash
    prompt = _prompt(9, s["cfg"].vocab_size, seed=2)
    chunks = [(8, 8), (1, 1)]
    log_p, cache_p = _drive(s["model"], s["params"], prompt, 16, chunks,
                            True, False)
    log_s, cache_s = _drive(s["model"], s["params"], prompt, 16, chunks,
                            False, False)
    np.testing.assert_allclose(log_p.numpy(), log_s.numpy(), **MODEL_TOL)
    assert int(log_p.argmax()) == int(log_s.argmax())
    for a, b in zip(cache_p["blocks"], cache_s["blocks"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **MODEL_TOL)


# ---------------------------------------------------------------------------
# The serving engine under flash
# ---------------------------------------------------------------------------

def _tiny_cfgs(kahan_attention=True):
    """The reference's tiny GQA config (``tests/test_serve_engine.py``:
    4 heads over 2 kv heads) in both packages."""
    kw = dict(name="tiny", family="dense", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
              param_dtype="float32", compute_dtype="float32", loss_chunk=64,
              kahan_attention=kahan_attention)
    return JaxArchConfig(**kw), ArchConfig(**kw)


SPEC = [(5, 3), (8, 2), (3, 4)]
ARRIVALS = [0, 1, 2]


@pytest.fixture(scope="module")
def tiny_flash():
    jcfg, cfg = _tiny_cfgs()
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(4))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    rng = np.random.default_rng(len("kahan"))
    prompts = [rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32)
               for p, _ in SPEC]
    jreqs = [JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=n),
                        request_id=i)
             for i, (p, (_, n)) in enumerate(zip(prompts, SPEC))]
    jec = JaxEngineConfig(max_slots=2, max_len=16, track_stats=True,
                          prefill_chunk=4, prefill_mode="flash",
                          policy=JaxPolicy(scheme="kahan", unroll=2))
    jout = JaxEngine(jcfg, jec, model=jmodel, params=jparams).run(
        jreqs, ARRIVALS)
    return dict(cfg=cfg, model=build_model(cfg, CPU), params=params,
                prompts=prompts, jout=jout)


def _ec(**kw):
    base = dict(max_slots=2, max_len=16, track_stats=True, prefill_chunk=4,
                prefill_mode="flash", policy=Policy(scheme="kahan", unroll=2))
    base.update(kw)
    return EngineConfig(**base)


def _requests(prompts, temperature=0.0):
    return [Request(prompt=p, request_id=i, sampling=SamplingParams(
        temperature=temperature, max_new_tokens=n, seed=5 + i))
        for i, (p, (_, n)) in enumerate(zip(prompts, SPEC))]


def _serve(s, ec, requests, arrivals=None):
    engine = InferenceEngine(s["cfg"], ec, model=s["model"],
                             params=s["params"])
    return engine.run(requests, arrivals), engine


def test_flash_engine_matches_reference_engine(tiny_flash):
    """The port's flash engine vs the reference's flash engine on the
    staggered trace: tokens exact, telemetry within MODEL_TOL; every chunk
    ran the flash body."""
    out, engine = _serve(tiny_flash, _ec(), _requests(tiny_flash["prompts"]),
                         ARRIVALS)
    assert engine.prefill_body == "flash"
    for rid, (_, n) in enumerate(SPEC):
        want = tiny_flash["jout"][rid]
        assert out[rid].tokens == want.tokens, rid
        assert len(out[rid].tokens) == n
        np.testing.assert_allclose(out[rid].telemetry, want.telemetry,
                                   **MODEL_TOL)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_flash_solo_vs_interleaved_bitwise(tiny_flash, temperature):
    """Tier 2: under flash a request alone emits bitwise the same tokens
    and telemetry as interleaved (greedy and sampled)."""
    reqs = _requests(tiny_flash["prompts"], temperature)
    inter, _ = _serve(tiny_flash, _ec(), reqs, ARRIVALS)
    for req in reqs:
        solo, _ = _serve(tiny_flash, _ec(), [req])
        assert solo[req.request_id].tokens == inter[req.request_id].tokens
        assert (solo[req.request_id].telemetry
                == inter[req.request_id].telemetry)


@pytest.mark.parametrize("other", [dict(prefill_mode="scan"),
                                   dict(prefill_chunk=None),
                                   dict(prefill_chunk=2)],
                         ids=["scan", "one-shot", "chunk2"])
def test_flash_tokens_exact_across_bodies_and_widths(tiny_flash, other):
    """Flash vs scan, and chunked vs one-shot (or narrower chunks) under
    flash: the same tokens, telemetry within MODEL_TOL (different widths
    round the projections differently)."""
    reqs = _requests(tiny_flash["prompts"])
    base, _ = _serve(tiny_flash, _ec(), reqs, ARRIVALS)
    out, engine = _serve(tiny_flash, _ec(**other), reqs, ARRIVALS)
    assert engine.prefill_body == other.get("prefill_mode", "flash")
    for rid in range(len(SPEC)):
        assert out[rid].tokens == base[rid].tokens, rid
        np.testing.assert_allclose(out[rid].telemetry, base[rid].telemetry,
                                   **MODEL_TOL)


def test_prefill_body_resolution_and_errors(tiny_flash):
    """"flash" resolves to "scan" for a model without the parallel path;
    bad modes and GQA mismatches fail fast; a ``kahan_matmul`` model
    builds, and the check its kernel runs before a CUDA launch accepts
    every compute dtype of the reference (bfloat16 among them) and
    refuses any other (float16) and a scheme without a device
    function."""
    s = tiny_flash
    model = build_model(s["cfg"], CPU)
    model.parallel_prefill_ok = False
    engine = InferenceEngine(s["cfg"], _ec(), model=model, params=s["params"])
    assert engine.prefill_body == "scan"
    with pytest.raises(ValueError, match="prefill_mode"):
        EngineConfig(prefill_mode="parallel")
    with pytest.raises(ValueError, match="q_groups"):
        tfa.flash_attention(torch.zeros(6, 8, 16), torch.zeros(4, 8, 16),
                            torch.zeros(4, 8, 16), q_groups=3)
    with pytest.raises(ValueError, match="q_groups"):
        tfa.flash_chunk_attention(torch.zeros(6, 8, 16),
                                  torch.zeros(4, 8, 16),
                                  torch.zeros(4, 8, 16), q_off=0, q_groups=3)
    with pytest.raises(ValueError, match="multiples"):
        tfa.flash_accumulators(torch.zeros(2, 10, 16), torch.zeros(2, 128, 16),
                               torch.zeros(2, 128, 16), block_q=8,
                               block_k=128, scheme=tschemes.KAHAN,
                               causal=True, kv_len=128)
    assert build_model(s["cfg"].replace(kahan_matmul=True),
                       CPU).st.kahan_matmul
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        assert tkm.check_device_call(tschemes.KAHAN, dtype) is None
    with pytest.raises(ValueError, match="compute dtype"):
        tkm.check_device_call(tschemes.KAHAN, torch.float16)
    with pytest.raises(NotImplementedError, match="device function"):
        tkm.check_device_call(dataclasses.replace(tschemes.KAHAN,
                                                  device_id=None),
                              torch.bfloat16)


def test_launcher_serves_flash_on_cpu(capsys):
    """``--prefill-mode flash`` on the port's launcher; an unknown mode
    fails at the parse boundary."""
    from repro_torch.launch import serve

    serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                "--trace", "0:6:2,1:9:2", "--stats", "--prefill-chunk", "4",
                "--prefill-mode", "flash"])
    out = capsys.readouterr().out
    assert "r0+4/flash" in out and "request 1 (arrived t=1, prompt=9" in out
    with pytest.raises(ValueError, match="prefill-mode"):
        serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                    "--prefill-mode", "parallel"])
