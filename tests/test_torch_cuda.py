"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
CUDA device). Imports torch and the port only, so it runs on a machine
without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import schemes as tschemes

SCHEMES = ["naive", "kahan", "pairwise", "dot2"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """Tier 2 on the card: the CUDA kernels' grids equal their plain
    versions bit for bit, every built-in scheme, batched and single."""
    from repro_torch.kernels import engine, kahan_dot, kahan_sum

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for scheme in SCHEMES:
        sch = tschemes.get(scheme)
        for unroll in (1, 8):
            cells = 1024 * unroll
            x = torch.randn((2, 3, 4 * cells), generator=gen,
                            device=cuda_device).to(dtype)
            before = engine.launch_counts()
            got = kahan_dot.dot_accumulators_batched(x[0], x[1], scheme=sch,
                                                     unroll=unroll)
            want = kahan_dot.dot_plain(x[0], x[1], scheme=sch, unroll=unroll)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            got = kahan_sum.sum_accumulators(x[0, 0], scheme=sch,
                                             unroll=unroll)
            want = kahan_sum.sum_plain(x[0, :1], scheme=sch, unroll=unroll)
            assert all(torch.equal(g, w[0]) for g, w in zip(got, want))
            after = engine.launch_counts()
            assert after["dot_accumulators_batched"] == (
                before["dot_accumulators_batched"] + 1)
            assert after["sum_accumulators"] == before["sum_accumulators"] + 1


def _ring_n(batch, cells, dtype, device):
    """A row length spanning two full load rings and a partial stage of
    the sum kernel's plan for ``batch`` rows (the dot's ring is no
    deeper)."""
    from repro_torch.kernels import _build, kahan_dot

    itemsize = torch.empty((), dtype=dtype).element_size()
    _, depth, stages, _ = kahan_dot.reduce_plan(
        batch, cells, 1 << 30, itemsize, 1, _build.sm_count(device))
    return (2 * stages * depth + 3) * cells


def _off16(x):
    """The values of ``x`` in a view one element into a larger buffer
    (contiguous, not 16-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


#: (batch, unroll, row length or "ring", operands one element off 16 bytes)
REDUCE_CASES = {
    "ring-U1": (3, 1, "ring", False),
    "ring-U8": (3, 8, "ring", False),
    "batch1": (1, 8, "ring", False),
    "batch8": (8, 8, "ring", False),
    "serve": (4, 8, 57344, False),
    "misaligned-U8": (3, 8, "ring", True),
    "misaligned-U1": (3, 1, 5 * 1024, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_reduce_ring_matches_plain(cuda_device, dtype, case):
    """Tier 2 on the card, the load ring: for every built-in scheme the
    dot and sum grids equal their plain versions bit for bit over rows
    that span two full rings and a partial stage (U 1 and 8, batch 1, 3
    and 8), at the serving shape [4, 57344] (7 steps), and on operands one
    element off 16 bytes, which take the plain-load path; every batched
    row equals a single launch of it."""
    from repro_torch.kernels import kahan_dot, kahan_sum

    batch, unroll, n, misaligned = REDUCE_CASES[case]
    cells = 1024 * unroll
    deep = n == "ring"
    if deep:
        n = _ring_n(batch, cells, dtype, cuda_device)
    steps = n // cells
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for scheme in SCHEMES:
        sch = tschemes.get(scheme)
        kw = dict(scheme=sch, unroll=unroll)
        a, b = torch.randn((2, batch, n), generator=gen,
                           device=cuda_device).to(dtype)
        want_dot = kahan_dot.dot_plain(a, b, **kw)
        want_sum = kahan_sum.sum_plain(a, **kw)
        if misaligned:
            a, b = _off16(a), _off16(b)
        for fn, got, want in (
                (kahan_dot.dot_accumulators_batched,
                 kahan_dot.dot_accumulators_batched(a, b, **kw), want_dot),
                (kahan_sum.sum_accumulators_batched,
                 kahan_sum.sum_accumulators_batched(a, **kw), want_sum)):
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                scheme, fn.__name__)
            assert fn.copy == ("element" if misaligned else "cp.async")
            _, depth, stages, _ = fn.plan
            if deep:
                assert steps > 2 * stages * depth and steps % depth
            if case == "serve":
                assert stages == 1 and steps < depth
        for i in range(batch):
            one = kahan_dot.dot_accumulators(a[i], b[i], **kw)
            assert all(torch.equal(o, w[i]) for o, w in zip(one, want_dot))
            one = kahan_sum.sum_accumulators(a[i], **kw)
            assert all(torch.equal(o, w[i]) for o, w in zip(one, want_sum))
            assert kahan_sum.sum_accumulators.copy == fn.copy


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [2, 4, 16])
def test_cuda_reduce_sweep_unrolls_match_plain(cuda_device, unroll):
    """Tier 2 on the card, the unroll sweep of chip_smoke's phase 7 (U 1
    and 8 are above): for every built-in scheme the single-row float32 dot
    and sum grids at U 2, 4 and 16 equal their plain versions bit for bit,
    over 37 steps, and each launch ran the CTAs the machine model
    (``ecm.ecm_gpu``) counts."""
    import dataclasses

    from repro_torch.core import ecm
    from repro_torch.kernels import _build, kahan_dot, kahan_sum

    cells = 1024 * unroll
    machine = dataclasses.replace(ecm.H100, sms=_build.sm_count(cuda_device))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    a, b = torch.randn((2, 37 * cells), generator=gen, device=cuda_device)
    for scheme in SCHEMES:
        sch = tschemes.get(scheme)
        kw = dict(scheme=sch, unroll=unroll)
        for op, fn, got, want in (
                ("dot", kahan_dot.dot_accumulators,
                 kahan_dot.dot_accumulators(a, b, **kw),
                 kahan_dot.dot_plain(a[None], b[None], **kw)),
                ("sum", kahan_sum.sum_accumulators,
                 kahan_sum.sum_accumulators(a, **kw),
                 kahan_sum.sum_plain(a[None], **kw))):
            assert all(torch.equal(g, w[0]) for g, w in zip(got, want)), (
                scheme, op)
            model = ecm.ecm_gpu_for_scheme(machine, sch, a.numel(), unroll,
                                           op=op)
            assert model.ctas * fn.plan[0] == cells, (scheme, op)


@pytest.mark.cuda
def test_cuda_sqrt_is_correctly_rounded(cuda_device):
    """Tier 2 on the card: the optimizer's ``_sqrt`` takes ``torch.sqrt``
    on a CUDA tensor, which must equal the float64 root rounded once to
    float32 (what it computes on the CPU), over normal float32 values of
    every exponent."""
    from repro_torch.optim import adamw

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    m = torch.rand(1 << 22, generator=gen, device=cuda_device) + 1.0
    e = torch.randint(-120, 120, (1 << 22,), generator=gen,
                      device=cuda_device)
    x = (m * torch.exp2(e.float())).float()
    want = torch.sqrt(x.double()).float()
    assert torch.equal(adamw._sqrt(x), want)
    assert torch.equal(adamw._sqrt(x.cpu()), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kahan", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_apply_update_equals_cpu(cuda_device, dtype, kahan):
    """Tier 1 on the card: three ``apply_update`` steps with the
    engine-folded norm leave params, m, v, comp and the grad norm equal to
    the same steps on the CPU, bit for bit. On the CPU they equal the
    jitted reference's (tests/test_torch_optim.py); the exact fmas and the
    correctly rounded square root carry that to the card."""
    import numpy as np

    from repro_torch.core import tree as T
    from repro_torch.optim import AdamWConfig, apply_update, init

    rng = np.random.default_rng(8)
    shapes = {"a": (37, 19), "b": (5, 7, 3), "c": (11,), "d": (1, 6)}

    def tree(lo, hi, dt):
        return {k: torch.from_numpy((rng.standard_normal(s) * np.exp2(
            rng.integers(lo, hi, s))).astype(np.float32)).to(dt)
            for k, s in shapes.items()}

    cfg = AdamWConfig(kahan=kahan, kahan_norm=False)
    params = {"cpu": tree(-4, 1, dtype)}
    params["card"] = T.tree_map(lambda p: p.to(cuda_device, copy=True),
                                params["cpu"])
    state = {k: init(cfg, p) for k, p in params.items()}
    for i in range(3):
        g = tree(-6, 0, torch.float32)
        scale = torch.tensor(0.5 + 0.25 * i)
        out = {}
        for k, dev in (("cpu", "cpu"), ("card", cuda_device)):
            params[k], state[k], m = apply_update(
                cfg, params[k], T.tree_map(lambda x: x.to(dev), g),
                state[k], scale.to(dev))
            out[k] = m["grad_norm"].cpu()
        assert torch.equal(out["card"], out["cpu"]), i
        for name in ("m", "v") + (("comp",) if kahan else ()):
            for a, b in zip(T.leaves(getattr(state["card"], name)),
                            T.leaves(getattr(state["cpu"], name))):
                assert torch.equal(a.cpu(), b), (i, name)
        for a, b in zip(T.leaves(params["card"]), T.leaves(params["cpu"])):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), i


@pytest.mark.cuda
def test_cuda_reduce_refuses_a_wrong_plan(cuda_device):
    """The C entries recompute a plan's shared memory and check it: a byte
    count that disagrees, a CTA width, stage depth (4, 0, 128) or stage
    count (0) the kernel does not have, a width that does not divide the
    cells, an unknown copy path, or 16-byte copies from an operand off 16
    bytes is refused (error 1, cudaErrorInvalidValue); element copies take
    any operand."""
    from repro_torch.kernels import _build, kahan_dot

    cells, n = 8192, 4 * 8192
    x = torch.zeros(n + 1, device=cuda_device)
    out = [torch.empty(cells, device=cuda_device) for _ in range(2)]
    lib = _build.library("kahan_reduce")
    smem = kahan_dot.reduce_smem_bytes
    copy = kahan_dot.COPY
    good = kahan_dot.reduce_plan(1, cells, 4, 4, 1)

    def launch(ptr, plan, path):
        return lib.kahan_sum_launch(1, 0, ptr, out[0].data_ptr(),
                                    out[1].data_ptr(), 1, n, cells, *plan,
                                    path, _build.stream_ptr(cuda_device))

    for plan in ((*good[:3], good[3] + 16),
                 (48, 16, 1, smem(48, 16, 1, 4, 1)),
                 (64, 4, 1, smem(64, 4, 1, 4, 1)), (64, 0, 1, 16),
                 (64, 128, 1, smem(64, 128, 1, 4, 1)), (64, 16, 0, 0)):
        assert launch(x.data_ptr(), plan, copy["cp.async"]) == 1, plan
    assert launch(x.data_ptr(), good, len(copy)) == 1
    assert launch(x[1:].data_ptr(), good, copy["cp.async"]) == 1
    # a width that does not divide the cells: 64 chains of 1056
    err = lib.kahan_dot_launch(1, 0, x.data_ptr(), x.data_ptr(),
                               out[0].data_ptr(), out[1].data_ptr(), 1,
                               1056 * 4, 1056, 64, 16, 1,
                               smem(64, 16, 1, 4, 2), copy["cp.async"],
                               _build.stream_ptr(cuda_device))
    assert err == 1
    for path, ptr in (("cp.async", x.data_ptr()), ("element", x.data_ptr()),
                      ("element", x[1:].data_ptr())):
        assert launch(ptr, good, copy[path]) == 0, path
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_runtime_scheme_on_card_raises(cuda_device):
    """A scheme registered at runtime has no device function: on a CUDA
    tensor the wrappers raise, naming the scheme, and launch nothing; the
    same scheme still runs on CPU tensors."""
    from repro_torch.kernels import engine

    mine = tschemes.CompensationScheme(
        name="test_torch_cuda_plain",
        update=lambda s, c, x, step: (s + x, c),
        instruction_mix=tschemes.InstructionMix(adds=1, muls=1),
        error_bound=tschemes.NAIVE.error_bound)
    tschemes.register(mine)
    try:
        x = torch.arange(10000, dtype=torch.float32, device=cuda_device)
        before = engine.launch_counts()
        eng = engine.CompensatedReduction(scheme="test_torch_cuda_plain")
        with pytest.raises(NotImplementedError, match="test_torch_cuda_plain"):
            eng.asum(x)
        with pytest.raises(NotImplementedError, match="test_torch_cuda_plain"):
            eng.dot(x, x)
        assert engine.launch_counts() == before
        want = engine.CompensatedReduction(scheme="naive").asum(x.cpu())
        assert torch.equal(eng.asum(x.cpu()), want)
    finally:
        tschemes.unregister("test_torch_cuda_plain")


@pytest.mark.cuda
def test_smoke_engine_on_card_solo_vs_interleaved(cuda_device):
    """The serving engine on the card (smoke config): every decode tick
    launches the telemetry kernel, and a request alone emits bitwise the
    same tokens and telemetry as interleaved."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    cfg = get_smoke("olmo-1b")
    model = build_model(cfg, cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, (p,)),
                    sampling=SamplingParams(max_new_tokens=n), request_id=i)
            for i, (p, n) in enumerate([(9, 5), (14, 4), (3, 6)])]
    ec = EngineConfig(max_slots=2, max_len=24, track_stats=True,
                      prefill_chunk=4)
    before = engine.launch_counts()["sum_accumulators_batched"]
    served = InferenceEngine(cfg, ec, model=model, params=params).run(
        reqs, [0, 1, 3])
    assert engine.launch_counts()["sum_accumulators_batched"] > before
    for req in reqs:
        solo = InferenceEngine(cfg, ec, model=model, params=params).run(
            [req])[req.request_id]
        assert solo.tokens == served[req.request_id].tokens
        assert solo.telemetry == served[req.request_id].telemetry


def _ulps(a, b):
    """Max distance in float32 units in the last place."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


#: (BH, Sq, Skv, dh, block_q, block_k, offset of k/v in their storage):
#: Sq and Skv off their blocks and over several k-blocks; dh 18 (scalar
#: loads), 128 and 256; block_k 128, 256 and 1024; BH 48 and Sq 512 pick
#: the 64-row tile for B7 while a 64-row B8 chunk takes 16 rows; an
#: offset of 1 float leaves k and v off 16 bytes (plain loads in the ring)
FLASH_CASES = [
    (4, 150, 300, 16, 64, 128, 0),
    (4, 150, 300, 128, 64, 128, 0),
    (4, 150, 300, 18, 64, 128, 0),
    (48, 512, 600, 128, 64, 256, 0),
    (48, 512, 600, 128, 64, 256, 1),
    (4, 200, 1500, 256, 64, 1024, 0),
    (4, 100, 700, 18, 64, 256, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "bh{}-sq{}-skv{}-dh{}-bk{}-off{}".format(
                             c[0], c[1], c[2], c[3], c[5], c[6]))
def test_cuda_flash_kernels_match_plain(cuda_device, case):
    """Tier 2 on the card: the flash grids (B7 and B8) equal their plain
    version bit for bit, every built-in scheme, causal and not, GQA with
    G in {1, 2}; B8 rows at block-aligned offsets equal the B7 grid's
    rows, across tile heights where the plans differ."""
    from repro_torch.kernels import engine
    from repro_torch.kernels import flash_attention as fa

    bh, sq, skv, dh, bq, bk, offset = case
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    sq_pad, skv_pad = -(-sq // bq) * bq, -(-skv // bk) * bk

    def data(rows, n, pad, off=0):
        x = torch.randn((rows, n, dh), generator=gen, device=cuda_device)
        x = torch.cat([x, x.new_zeros((rows, pad - n, dh))], 1)
        # a contiguous view `off` floats into its storage
        buf = x.new_empty(x.numel() + off)
        buf[off:] = x.reshape(-1)
        return buf[off:].view(x.shape)

    for groups in (1, 2):
        q = data(bh, sq, sq_pad)
        k = data(bh // groups, skv, skv_pad, offset)
        v = data(bh // groups, skv, skv_pad, offset)
        assert (k.data_ptr() % 16 == 0) == (offset == 0)
        for scheme in SCHEMES:
            sch = tschemes.get(scheme)
            kw = dict(block_q=bq, block_k=bk, scheme=sch, kv_len=skv,
                      q_groups=groups)
            for causal in (True, False):
                before = engine.launch_counts()["flash_accumulators"]
                got = fa.flash_accumulators(q, k, v, causal=causal, **kw)
                assert (engine.launch_counts()["flash_accumulators"]
                        == before + 1)
                want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk,
                                      kv_len=skv, causal=causal,
                                      q_groups=groups)
                torch.cuda.synchronize()
                for name, g, w in zip(("l_s", "l_c", "a_s", "a_c"), got,
                                      want):
                    assert torch.equal(g, w), (
                        f"{scheme} causal={causal} G={groups} {name}: "
                        f"{_ulps(g, w)} ulp")
            # B8 at block-aligned offsets: the rows of the B7 grid
            full = fa.flash_accumulators(q, k, v, causal=True, **kw)
            full_rows = fa.flash_accumulators.plan[0]
            for off in range(0, min(sq_pad, 3 * bq), bq):
                chunk = fa.flash_chunk_accumulators(
                    q[:, off:off + bq].contiguous(), k, v, off, **kw)
                for g, w in zip(chunk, full):
                    assert torch.equal(g, w[:, off:off + bq]), (scheme, off)
            if bh == 48:
                assert (full_rows, fa.flash_chunk_accumulators.plan[0]) == (
                    64, 16)


#: (BH, dh, q_groups) the dense family serves: stablelm-3b's 32 heads of
#: dh 80 (tile rows 84 floats apart), qwen2.5-3b's 16 heads over 2 (G 8)
#: and internvl2-2b's 16 over 8 (G 2), both dh 128
DENSE_FAMILY_HEADS = [(32, 80, 1), (16, 128, 8), (16, 128, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,dh,groups", DENSE_FAMILY_HEADS)
def test_cuda_flash_dense_family_shapes_match_plain(cuda_device, bh, dh,
                                                     groups):
    """Tier 2 on the card at the dense family's head shapes: B8 on a
    64-token serving chunk at offsets 0, 64 and 128 of a 176-row cache
    (the engine pads it to 256), and B7 on 300 queries over 600 keys,
    equal to their plain version bit for bit, every built-in scheme."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for sq, skv, chunk_offsets in ((64, 176, (0, 64, 128)),
                                   (300, 600, ())):
        sq_pad, skv_pad = -(-sq // 64) * 64, -(-skv // 256) * 256

        def data(rows, n, pad):
            x = torch.randn((rows, n, dh), generator=gen, device=cuda_device)
            return torch.cat([x, x.new_zeros((rows, pad - n, dh))], 1)

        q = data(bh, sq, sq_pad)
        k = data(bh // groups, skv, skv_pad)
        v = data(bh // groups, skv, skv_pad)
        for scheme in SCHEMES:
            sch = tschemes.get(scheme)
            kw = dict(block_q=64, block_k=256, scheme=sch, kv_len=skv,
                      q_groups=groups)
            for off in chunk_offsets:
                got = fa.flash_chunk_accumulators(q, k, v, off, **kw)
                want = fa.flash_plain(q, k, v, scheme=sch, block_k=256,
                                      kv_len=skv, causal=True, q_off=off,
                                      q_groups=groups)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    scheme, off)
            if not chunk_offsets:
                got = fa.flash_accumulators(q, k, v, causal=True, **kw)
                want = fa.flash_plain(q, k, v, scheme=sch, block_k=256,
                                      kv_len=skv, causal=True,
                                      q_groups=groups)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (
                    scheme)


@pytest.mark.cuda
def test_cuda_paged_equals_dense(cuda_device):
    """Tier 2 on the card, qwen2.5-3b's smoke config (GQA, QKV bias)
    under flash prefill with ``kahan_attention``: the paged layout's
    tokens and telemetry equal the dense layout's bit for bit, pool and
    page tables on the card; a request admitted by reference from the
    prefix cache equals its private prefill."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    cfg = get_smoke("qwen2.5-3b").replace(kahan_attention=True)
    model = build_model(cfg, cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab_size, (9,))
    reqs = [Request(prompt=np.concatenate([base, rng.integers(
                        0, cfg.vocab_size, (t,))]),
                    sampling=SamplingParams(max_new_tokens=n), request_id=i)
            for i, (t, n) in enumerate([(5, 4), (3, 3), (7, 5)])]
    kw = dict(max_slots=2, max_len=32, track_stats=True, prefill_chunk=4,
              prefill_mode="flash")
    before = engine.launch_counts()["flash_chunk_accumulators"]
    dense = InferenceEngine(cfg, EngineConfig(**kw), model=model,
                            params=params).run(reqs, [0, 1, 2])
    assert engine.launch_counts()["flash_chunk_accumulators"] > before
    paged_kw = dict(kw, kv_layout="paged", page_size=4)
    eng = InferenceEngine(cfg, EngineConfig(**paged_kw), model=model,
                          params=params)
    pool = next(iter(eng.slots.cache.values()))[0]
    assert pool.device.type == "cuda"
    paged = eng.run(reqs, [0, 1, 2])
    for rid in dense:
        assert paged[rid].tokens == dense[rid].tokens
        assert paged[rid].telemetry == dense[rid].telemetry
    assert eng.pages.free_count == eng.num_pages
    shared = InferenceEngine(cfg, EngineConfig(prefix_cache=True,
                                               **paged_kw),
                             model=model, params=params)
    shared.run([reqs[0]])
    benef = shared.run([reqs[2]])[2]
    assert shared.prefix_hit_tokens > 0
    assert benef.tokens == dense[2].tokens
    assert benef.telemetry == dense[2].telemetry
    st = shared.page_stats()
    assert st["free_pages"] + st["prefix_pages"] == st["num_pages"]


@pytest.mark.cuda
def test_cuda_flash_refuses_a_wrong_plan(cuda_device):
    """The C entry recomputes the plan's shared memory: a byte count that
    disagrees, a tile height the kernel does not have, or 64 rows at dh
    256 (64 acc cells a thread), is refused (error 1,
    cudaErrorInvalidValue) and nothing launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    bh, sq, skv, dh, bk = 2, 64, 256, 256, 256
    q = torch.zeros((bh, sq, dh), device=cuda_device)
    k = torch.zeros((bh, skv, dh), device=cuda_device)
    outs = [torch.empty((bh, sq, 1), device=cuda_device) for _ in range(2)]
    outs += [torch.empty_like(q) for _ in range(2)]
    lib = _build.library("kahan_flash")
    rows, smem = fa.flash_plan(bh, sq, dh, bk)
    for plan in ((rows, smem + 16), (32, fa.flash_smem_bytes(32, dh, bk)),
                 (64, fa.flash_smem_bytes(64, dh, bk))):
        err = lib.kahan_flash_launch(
            1, 0, q.data_ptr(), k.data_ptr(), k.data_ptr(),
            *[o.data_ptr() for o in outs], bh, 1, sq, skv, dh, bk, skv, 0,
            1, fa.softmax_scale(dh), *plan, _build.stream_ptr(cuda_device))
        assert err == 1, plan


@pytest.mark.cuda
def test_cuda_flash_engine_equals_oracle(cuda_device):
    """The engine's flash entries on the card equal the plain oracle
    ``ref.flash_attention_ref`` (which replays the engine's policy), bit
    for bit, and launch their kernel once each."""
    from repro_torch.kernels import engine, ref
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((4, 70, 128), generator=gen, device=cuda_device)
    k = torch.randn((2, 200, 128), generator=gen, device=cuda_device)
    v = torch.randn((2, 200, 128), generator=gen, device=cuda_device)
    got = fa.flash_attention(q, k, v, scheme="kahan", q_groups=2)
    want = ref.flash_attention_ref(q, k, v, "kahan", q_groups=2)
    assert torch.equal(got, want)
    before = engine.launch_counts()["flash_chunk_accumulators"]
    got = fa.flash_chunk_attention(q[:, :64], k, v, q_off=100,
                                   scheme="dot2", q_groups=2)
    want = ref.flash_attention_ref(q[:, :64], k, v, "dot2", q_groups=2,
                                   q_off=100)
    assert torch.equal(got, want)
    assert engine.launch_counts()["flash_chunk_accumulators"] == before + 1


@pytest.mark.cuda
def test_cuda_flash_rejects_what_it_does_not_take(cuda_device):
    """float16, none of the reference's compute dtypes, has no flash
    instantiation (ValueError); a runtime scheme has no device function
    (NotImplementedError); neither launches. float64, refused before,
    launches once."""
    from repro_torch.kernels import engine
    from repro_torch.kernels import flash_attention as fa

    x = torch.zeros((2, 128, 16), device=cuda_device)
    kw = dict(block_q=128, block_k=128, kv_len=128, causal=True)
    before = engine.launch_counts()
    with pytest.raises(ValueError, match="compute dtype"):
        fa.flash_accumulators(x.half(), x.half(), x.half(),
                              scheme=tschemes.KAHAN, **kw)
    mine = tschemes.CompensationScheme(
        name="test_torch_cuda_flash", update=lambda s, c, x, step: (s + x, c),
        instruction_mix=tschemes.InstructionMix(adds=1, muls=1),
        error_bound=tschemes.NAIVE.error_bound)
    with pytest.raises(NotImplementedError, match="test_torch_cuda_flash"):
        fa.flash_accumulators(x, x, x, scheme=mine, **kw)
    assert engine.launch_counts() == before
    fa.flash_accumulators(x.double(), x.double(), x.double(),
                          scheme=tschemes.KAHAN, **kw)
    assert engine.launch_counts()["flash_accumulators"] == (
        before["flash_accumulators"] + 1)


def _matmul_operands(gen, dev, m, k, n, dtype):
    a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 9, 32, 37, 64, 100, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_matmul_kernel_matches_plain(cuda_device, dtype, m):
    """Tier 2 on the card: B5's grids equal the plain version bit for bit,
    every built-in scheme, operands in the compute dtype and (float32) in
    bf16: N and K padded by the engine (K 1100, N 200; at M 8 a K of 16
    blocks), and 1, 3, 4, 16 and 17 K-blocks of 128 at a ragged N 200
    (M > 8: every tile height, cluster splits that do and do not divide
    the K-blocks, more rounds than cluster ranks)."""
    from repro_torch.kernels import engine
    from repro_torch.kernels import kahan_matmul as km

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    operand_dtypes = ((dtype, torch.bfloat16) if dtype == torch.float32
                      else (dtype,))
    padded = [(m, 8192, 256)] if m == 8 else [(m, 1100, 200)]
    for scheme in SCHEMES:
        eng = engine.CompensatedReduction(scheme=scheme, compute_dtype=dtype)
        for odt in operand_dtypes:
            cases = [(k, n, eng._matmul_blocks(m, n, k, None, None, None))
                     for _, k, n in padded]
            cases += [(steps * 128, 200, (8, 200, 128))
                      for steps in (1, 3, 4, 16, 17)]
            for k, n, blocks in cases:
                a, b = _matmul_operands(gen, cuda_device, m, k, n, odt)
                ap, bp = eng._prep_matmul(a, b, blocks)
                assert ap.dtype == bp.dtype == odt
                before = engine.launch_counts()["matmul_accumulators"]
                got = km.matmul_accumulators(
                    ap, bp, scheme=eng.scheme, block_m=blocks[0],
                    block_n=blocks[1], block_k=blocks[2],
                    compute_dtype=dtype)
                assert (engine.launch_counts()["matmul_accumulators"]
                        == before + 1)
                want = km.matmul_plain(ap[None], bp[None], scheme=eng.scheme,
                                       block_k=blocks[2],
                                       compute_dtype=dtype)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w[0]), (scheme, m, k, n, odt)


@pytest.mark.cuda
def test_cuda_matmul_bf16_operands_equal_promoted_first(cuda_device):
    """bf16 operands widened where the kernel reads them give the same
    grids as the same operands promoted to float32 first."""
    from repro_torch.kernels import kahan_matmul as km

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a, b = _matmul_operands(gen, cuda_device, 64, 2048, 512, torch.bfloat16)
    kw = dict(scheme=tschemes.KAHAN, block_m=64, block_n=256, block_k=512)
    for x, y in ((a, b), (a.float(), b), (a, b.float())):
        got = km.matmul_accumulators(x, y, **kw)
        want = km.matmul_accumulators(a.float(), b.float(), **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [9, 64, 300])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_cuda_batched_matmul_equals_loop_and_rows(cuda_device, scheme, m):
    """Tier 2 on the card: B6 at batch 3 equals a loop of B5 launches, and
    rows 0, 8, 31 and M - 1 of an M-row call equal M = 1 calls of the same
    rows, bitwise (M = 1 runs the rows path, M > 8 the tiles), in float32
    (float32 and bf16 operands) and float64."""
    from repro_torch.kernels import engine, ops

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    for dtype, odt in ((torch.float32, torch.float32),
                       (torch.float32, torch.bfloat16),
                       (torch.float64, torch.float64)):
        a = torch.randn((3, m, 1024), generator=gen,
                        device=cuda_device).to(odt)
        b = torch.randn((3, 1024, 384), generator=gen,
                        device=cuda_device).to(odt)
        kw = dict(scheme=scheme, compute_dtype=dtype)
        before = engine.launch_counts()
        batched = ops.batched_matmul(a, b, **kw)
        loop = [ops.matmul(a[i], b[i], **kw) for i in range(3)]
        after = engine.launch_counts()
        assert after["matmul_accumulators_batched"] == (
            before["matmul_accumulators_batched"] + 1)
        assert after["matmul_accumulators"] == (
            before["matmul_accumulators"] + 3)
        for i in range(3):
            assert torch.equal(batched[i], loop[i]), (dtype, odt, i)
        for r in sorted({0, 8, 31, m - 1} & set(range(m))):
            assert torch.equal(ops.matmul(a[0, r:r + 1], b[0], **kw),
                               loop[0][r:r + 1]), (dtype, odt, r)


@pytest.mark.cuda
def test_cuda_matmul_backward_launches_the_kernel(cuda_device):
    """The autograd backward of ``ops.matmul`` launches B5 twice, and its
    gradients equal B5 on ``(g, bᵀ)`` and ``(aᵀ, g)`` bit for bit."""
    from repro_torch.kernels import engine, ops

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    a = torch.randn((20, 700), generator=gen, device=cuda_device)
    b = torch.randn((700, 300), generator=gen, device=cuda_device)
    g = torch.randn((20, 300), generator=gen, device=cuda_device)
    a.requires_grad_()
    b.requires_grad_()
    out = ops.matmul(a.bfloat16(), b, scheme="dot2")
    before = engine.launch_counts()["matmul_accumulators"]
    out.backward(g)
    assert engine.launch_counts()["matmul_accumulators"] == before + 2
    # the forward's blocks: (min(256, 24), min(256, 384), min(512, 768))
    kw = dict(scheme="dot2", block_m=24, block_n=256, block_k=512)
    da = ops.matmul(g, b.detach().T, **kw).bfloat16().float()
    db = ops.matmul(a.detach().bfloat16().T, g, **kw)
    assert torch.equal(a.grad, da) and torch.equal(b.grad, db)


@pytest.mark.cuda
def test_cuda_matmul_rejects_what_it_does_not_take(cuda_device):
    """float16, none of the reference's compute dtypes, has no matmul
    instantiation (ValueError); a runtime scheme has no device function
    (NotImplementedError); neither launches. A bfloat16 compute dtype,
    refused before, launches once."""
    from repro_torch.kernels import engine
    from repro_torch.kernels import kahan_matmul as km

    x = torch.zeros((8, 128), device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros((128, 128), device=cuda_device, dtype=torch.bfloat16)
    kw = dict(block_m=8, block_n=128, block_k=128)
    before = engine.launch_counts()
    with pytest.raises(ValueError, match="compute dtype"):
        km.matmul_accumulators(x.half(), w.half(), scheme=tschemes.KAHAN,
                               compute_dtype=torch.float16, **kw)
    mine = tschemes.CompensationScheme(
        name="test_torch_cuda_matmul", update=lambda s, c, x, step: (s + x, c),
        instruction_mix=tschemes.InstructionMix(adds=1, muls=1),
        error_bound=tschemes.NAIVE.error_bound)
    with pytest.raises(NotImplementedError, match="test_torch_cuda_matmul"):
        km.matmul_accumulators(x, w, scheme=mine, **kw)
    assert engine.launch_counts() == before
    km.matmul_accumulators(x, w, scheme=tschemes.KAHAN,
                           compute_dtype=torch.bfloat16, **kw)
    assert engine.launch_counts()["matmul_accumulators"] == (
        before["matmul_accumulators"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_cuda_matmul_rows_path_matches_plain(cuda_device, scheme):
    """The M <= 8 path on unpadded rows: M in {1, 3, 8} x 1, 4 and 16
    K-blocks, float32 (bf16 and float32 operands) and float64, N a
    multiple of the CTA's 16 columns and not, equal to ``matmul_plain``
    bit for bit; B6 at M 1 equals a loop of B5."""
    from repro_torch.kernels import kahan_matmul as km

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    sch = tschemes.get(scheme)
    for dtype, odts in ((torch.float32, (torch.float32, torch.bfloat16)),
                        (torch.float64, (torch.float64,))):
        for odt in odts:
            for m in (1, 3, 8):
                for steps in (1, 4, 16):
                    for n in (256, 200):
                        a, b = _matmul_operands(gen, cuda_device, m,
                                                steps * 128, n, odt)
                        kw = dict(scheme=sch, block_m=8, block_n=n,
                                  block_k=128, compute_dtype=dtype)
                        got = km.matmul_accumulators(a, b, **kw)
                        want = km.matmul_plain(a[None], b[None], scheme=sch,
                                               block_k=128,
                                               compute_dtype=dtype)
                        torch.cuda.synchronize()
                        for g, w in zip(got, want):
                            assert torch.equal(g, w[0]), (m, steps, n, odt)
        a = torch.randn((4, 1, 2048), generator=gen,
                        device=cuda_device).to(dtype)
        b = torch.randn((4, 2048, 384), generator=gen,
                        device=cuda_device).to(dtype)
        kw = dict(scheme=sch, block_m=8, block_n=128, block_k=512,
                  compute_dtype=dtype)
        batched = km.matmul_accumulators_batched(a, b, **kw)
        for i in range(4):
            one = km.matmul_accumulators(a[i], b[i], **kw)
            assert all(torch.equal(g[i], o) for g, o in zip(batched, one))


# ---------------------------------------------------------------------------
# Training: the column scan of the global norm, a train step on the card
# ---------------------------------------------------------------------------

#: (rows, trailing shape): tall, wide, one row, rows off the 16-row batch,
#: trailing sizes off the 128-thread CTA
COLUMN_CASES = [(300, (37, 5)), (2, (65,)), (1, (7,)), (41, (1,)),
                (17, (129,)), (16, (256,)), (1000, (3,))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,trail", COLUMN_CASES)
def test_cuda_column_scan_matches_loop(cuda_device, rows, trail, dtype):
    """Tier 2 on the card: the column-scan kernel's (s, c) vectors equal
    its plain loop's (``core.kahan.column_sq_plain``) bit for bit."""
    from repro_torch.core.kahan import column_sq_plain
    from repro_torch.kernels import kahan_columns

    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x = torch.randn((rows, *trail), generator=gen, device=cuda_device,
                    dtype=torch.float64)
    e = torch.randint(-8, 8, x.shape, generator=gen, device=cuda_device)
    x = (x * torch.exp2(e.double())).to(dtype)
    before = kahan_columns.column_sq_accumulators.launches
    got = kahan_columns.column_sq_accumulators(x)
    assert kahan_columns.column_sq_accumulators.launches == before + 1
    want = column_sq_plain(x.float())
    for g, w in zip(got, want):
        assert g.shape == trail and g.dtype == torch.float32
        assert torch.equal(g, w)


def _smoke_step(device, kahan_matmul, kahan_norm, steps=2):
    """``steps`` train steps (2 microbatches each) of the OLMo-1B smoke
    config on ``device`` from the same params (made on the CPU) and
    batches; returns (params, opt state, metrics)."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import batch_to_device

    cfg = get_smoke("olmo-1b").replace(loss_chunk=16,
                                      kahan_matmul=kahan_matmul)
    params = build_model(cfg, torch.device("cpu")).init(
        torch.Generator().manual_seed(0))
    params = T.tree_map(lambda p: p.to(device).requires_grad_(), params)
    tc = TrainConfig(steps=steps, microbatches=2, warmup=0,
                     opt=AdamWConfig(lr=1e-3, kahan_norm=kahan_norm))
    model = build_model(cfg, device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4))
    step = make_train_step(model, cfg, tc)
    opt = init(tc.opt, params)
    for i in range(steps):
        params, opt, m = step(params, opt,
                              batch_to_device(data.batch_at(i), device))
    return params, opt, m


@pytest.mark.cuda
@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_cuda_train_step_matches_cpu(cuda_device, kahan_matmul):
    """Tier 3: two smoke-config train steps on the card within rtol 1e-5
    (loss, grad norm) and 1e-5 absolute (params) of the same steps on the
    CPU: float32 matmuls sum in other orders there."""
    from repro_torch.core import tree as T

    out = [_smoke_step(d, kahan_matmul, True)
           for d in (cuda_device, torch.device("cpu"))]
    (pc, _, mc), (pp, _, mp) = out
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(float(mc[k]), float(mp[k]), rtol=1e-5,
                                   atol=0)
    for a, b in zip(T.leaves(pc), T.leaves(pp)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kahan_norm", [False, True])
def test_cuda_train_step_launch_counts(cuda_device, kahan_norm):
    """With ``kahan_matmul`` one step of 2 microbatches launches B5 4 * 7 *
    n_layers * 2 times (forward, recompute, dA, dB); the norm launches B3
    (``kahan_norm=False``) or the column scan once a parameter leaf."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts

    n_layers = get_smoke("olmo-1b").n_layers
    reset_launch_counts()
    _smoke_step(cuda_device, True, kahan_norm, steps=1)
    counts = launch_counts()
    leaves = 8          # embed table + q, k, v, o, gate, up, down
    assert counts["matmul_accumulators"] == 4 * 7 * n_layers * 2
    norm = "column_sq_accumulators" if kahan_norm else "sum_accumulators"
    other = "sum_accumulators" if kahan_norm else "column_sq_accumulators"
    assert counts[norm] == leaves and counts[other] == 0


# ---------------------------------------------------------------------------
# Subnormals (-ftz=true) and the sharded sum on two ranks
# ---------------------------------------------------------------------------

TINY = 2.0 ** -126


def _subnormal_reaching(gen, shape, lo, hi, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    e = torch.randint(lo, hi, shape, generator=gen, device=device)
    sub = torch.rand(shape, generator=gen, device=device) < 0.2
    e = torch.where(sub, torch.randint(-149, -127, shape, generator=gen,
                                       device=device), e)
    return (x * torch.exp2(e.double())).float()


@pytest.mark.cuda
def test_cuda_ftz_boundary_products(cuda_device):
    """The card's ``.ftz`` flushes as x86 does, and so as the reference
    and the plain versions: (1 - 2^-24) * tiny (exact below tiny at 24
    bits) gives zero, (1 - 2^-23) * tiny * (1 + 2^-23) gives tiny; a
    subnormal operand counts as zero. Through the naive and kahan dots'
    fma and dot2's split product, one product a cell."""
    from repro_torch.kernels import kahan_dot

    a = torch.zeros(1024, dtype=torch.float64)
    b = torch.zeros(1024, dtype=torch.float64)
    pairs = [(1 - 2.0 ** -24, TINY), (1 - 2.0 ** -23, TINY * (1 + 2.0 ** -23)),
             (1.0, 2.0 ** -149), (-(1 - 2.0 ** -24), TINY)]
    for i, (x, y) in enumerate(pairs):
        a[i], b[i] = x, y
    a, b = a.float().to(cuda_device), b.float().to(cuda_device)
    # naive's s is fma(a, b, +0): the negative product flushes to -0;
    # kahan's and dot2's s is +0 + (the flushed product): +0
    for scheme, last in (("naive", -0x80000000), ("kahan", 0), ("dot2", 0)):
        sch = tschemes.get(scheme)
        s, _ = kahan_dot.dot_accumulators(a, b, scheme=sch, unroll=1)
        got = s.reshape(-1)[:4].view(torch.int32).tolist()
        assert got == [0, 0x800000, 0, last], (scheme, got)
        plain = kahan_dot.dot_plain(a[None], b[None], scheme=sch, unroll=1)
        assert torch.equal(s, plain[0][0]), scheme


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_flush_like_plain(cuda_device, dtype):
    """Tier 2 on subnormal-reaching data: products and sums that
    underflow, subnormal operands; the dot, sum, matmul and column-scan
    kernels equal their flushing plain versions bit for bit."""
    from repro_torch.core.kahan import column_sq_plain
    from repro_torch.kernels import (engine, kahan_columns, kahan_dot,
                                     kahan_matmul, kahan_sum)

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for scheme in SCHEMES:
        sch = tschemes.get(scheme)
        for lo, hi in ((-75, -52), (-135, -110)):
            a = _subnormal_reaching(gen, (2, 3 * 8192), lo, hi,
                                    cuda_device).to(dtype)
            b = _subnormal_reaching(gen, (2, 3 * 8192), lo, hi,
                                    cuda_device).to(dtype)
            got = kahan_dot.dot_accumulators_batched(a, b, scheme=sch,
                                                     unroll=8)
            want = kahan_dot.dot_plain(a, b, scheme=sch, unroll=8)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            got = kahan_sum.sum_accumulators_batched(a, scheme=sch, unroll=8)
            want = kahan_sum.sum_plain(a, scheme=sch, unroll=8)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        eng = engine.CompensatedReduction(scheme=sch)
        a = _subnormal_reaching(gen, (37, 1100), -75, -52,
                                cuda_device).to(dtype)
        b = _subnormal_reaching(gen, (1100, 200), -75, -52,
                                cuda_device).to(dtype)
        blocks = eng._matmul_blocks(37, 200, 1100, None, None, None)
        ap, bp = eng._prep_matmul(a, b, blocks)
        got = kahan_matmul.matmul_accumulators(
            ap, bp, scheme=sch, block_m=blocks[0], block_n=blocks[1],
            block_k=blocks[2], compute_dtype=torch.float32)
        want = kahan_matmul.matmul_plain(ap[None], bp[None], scheme=sch,
                                         block_k=blocks[2],
                                         compute_dtype=torch.float32)
        assert all(torch.equal(g, w[0]) for g, w in zip(got, want))
    x = _subnormal_reaching(gen, (300, 37, 5), -75, -52,
                            cuda_device).to(dtype)
    got = kahan_columns.column_sq_accumulators(x)
    want = column_sq_plain(x.float())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


_RANK = """
import sys, torch, torch.distributed as dist
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import engine
from repro_torch.launch.mesh import make_local_mesh
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
mesh = make_local_mesh()
gen = torch.Generator(device="cuda").manual_seed(3)
x = torch.randn(2 * (3 * 8192 + 5), generator=gen, device="cuda")
engine.reset_launch_counts()
got = coll.sharded_asum(mesh, x)
torch.save({"sum": got.cpu(), "launches": engine.launch_counts()}, out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_sharded_asum_two_ranks(cuda_device, tmp_path):
    """Two gloo ranks on the card: ``sharded_asum`` launches B3 once a
    rank, both ranks hold the same bits, equal to the single-device tree
    over the two shards' grids computed here with the same kernel."""
    from repro_torch.kernels import engine

    root = Path(__file__).resolve().parents[1]
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.pt")], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in ranks:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2 * (3 * 8192 + 5), generator=gen, device=cuda_device)
    eng = engine.CompensatedReduction()
    accs = [eng.sum_accumulators(s) for s in x.view(2, -1)]
    want = engine.merge_accumulators(torch.stack([a.s for a in accs]),
                                     torch.stack([a.c for a in accs]))
    for r in res:
        assert r["launches"]["sum_accumulators"] == 1
        assert torch.equal(r["sum"], want.cpu())



@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "llama4-maverick-400b-a17b"])
def test_cuda_moe_is_repeatable_and_matches_cpu(cuda_device, name):
    """The MoE layer on the card (smoke config, float32, drops at
    capacity 1.25): two calls give the same bits (no atomics in the
    dispatch or the combine), the routing equals the CPU's and the output
    is within 1e-5 of it; the combine alone, on the same contributions,
    within 1e-6 of the CPU's fold."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.models import build_model, moe

    cfg = get_smoke(name)
    model = build_model(cfg, torch.device("cpu"))
    seg = next(s for s in model.segments if s.kind in ("moe", "super"))
    params = model.init(torch.Generator().manual_seed(0))
    p = params[seg.name]
    p = T.tree_map(lambda t: t[0], p["b"] if seg.kind == "super" else p)
    p = p["ffn"]
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pc = T.tree_map(lambda t: t.to(cuda_device), p)
    y1, m1 = moe.moe_apply(pc, cfg, x.to(cuda_device))
    y2, m2 = moe.moe_apply(pc, cfg, x.to(cuda_device))
    assert torch.equal(y1, y2) and torch.equal(m1["aux_loss"],
                                               m2["aux_loss"])
    y, m = moe.moe_apply(p, cfg, x)
    assert float(m1["dropped_frac"]) == float(m["dropped_frac"]) > 0
    torch.testing.assert_close(y1.cpu(), y, rtol=1e-5, atol=1e-5)
    r = moe.route(p, cfg, x, 16)
    rc = moe.route(pc, cfg, x.to(cuda_device), 16)
    assert torch.equal(rc.expert_idx.cpu(), r.expert_idx)
    assert torch.equal(rc.keep.cpu(), r.keep)
    contrib = torch.randn((*r.token.shape, cfg.d_model),
                          generator=torch.Generator().manual_seed(2))
    got = moe.combine(contrib.to(cuda_device), rc.order, cfg.moe.top_k)
    want = moe.combine(contrib, r.order, cfg.moe.top_k)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_hymba_smoke_engine_matches_cpu(cuda_device):
    """hymba-1.5b's smoke config served on the card (rings that wrap,
    SSM state, a global layer paged beside them): greedy tokens bitwise
    equal to the CPU's on the same weights, dense and paged; the
    telemetry within rtol 1e-5 of the CPU's (the card's matmuls sum in
    another order); paged == dense and solo == interleaved bitwise on the
    card."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    cfg = get_smoke("hymba-1.5b")
    cpu = torch.device("cpu")
    params = build_model(cfg, cpu).init(torch.Generator().manual_seed(0))
    on_card = T.tree_map(lambda t: t.to(cuda_device), params)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, (p,)),
                    sampling=SamplingParams(max_new_tokens=n), request_id=i)
            for i, (p, n) in enumerate([(12, 4), (21, 3), (9, 5)])]

    def serve(dev, p, layout, requests, arrivals):
        ec = EngineConfig(max_slots=2, max_len=32, track_stats=True,
                          prefill_chunk=4, kv_layout=layout, page_size=4)
        return InferenceEngine(cfg, ec, model=build_model(cfg, dev),
                               params=p).run(requests, arrivals)

    want = serve(cpu, params, "dense", reqs, [0, 1, 3])
    before = engine.launch_counts()["sum_accumulators_batched"]
    got = {layout: serve(cuda_device, on_card, layout, reqs, [0, 1, 3])
           for layout in ("dense", "paged")}
    assert engine.launch_counts()["sum_accumulators_batched"] > before
    solo = serve(cuda_device, on_card, "dense", reqs[1:2], [0])[1]
    for rid in want:
        assert got["dense"][rid].tokens == want[rid].tokens
        np.testing.assert_allclose(got["dense"][rid].telemetry,
                                   want[rid].telemetry, rtol=1e-5)
        assert got["paged"][rid].tokens == got["dense"][rid].tokens
        assert got["paged"][rid].telemetry == got["dense"][rid].telemetry
    assert solo.tokens == got["dense"][1].tokens
    assert solo.telemetry == got["dense"][1].telemetry


@pytest.mark.cuda
def test_cuda_xlstm_smoke_engine_matches_cpu(cuda_device):
    """xlstm-1.3b's smoke config served on the card (recurrent state only:
    paged asked for resolves dense; one slot, so the second request
    reuses the first one's evicted slot): greedy tokens bitwise equal to
    the CPU's on the same weights, the telemetry within rtol 1e-5; the
    reused slot serves bitwise what a fresh engine serves on the card."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    cfg = get_smoke("xlstm-1.3b")
    cpu = torch.device("cpu")
    params = build_model(cfg, cpu).init(torch.Generator().manual_seed(0))
    on_card = T.tree_map(lambda t: t.to(cuda_device), params)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, (p,)),
                    sampling=SamplingParams(max_new_tokens=n), request_id=i)
            for i, (p, n) in enumerate([(12, 4), (21, 3)])]

    def serve(dev, p, requests):
        ec = EngineConfig(max_slots=1, max_len=32, track_stats=True,
                          prefill_chunk=4, kv_layout="paged", page_size=4)
        eng = InferenceEngine(cfg, ec, model=build_model(cfg, dev), params=p)
        assert eng.kv_layout == "dense"
        return eng.run(requests)

    want = serve(cpu, params, reqs)
    before = engine.launch_counts()["sum_accumulators_batched"]
    got = serve(cuda_device, on_card, reqs)
    assert engine.launch_counts()["sum_accumulators_batched"] > before
    fresh = serve(cuda_device, on_card, reqs[1:])[1]
    for rid in want:
        assert got[rid].tokens == want[rid].tokens
        np.testing.assert_allclose(got[rid].telemetry, want[rid].telemetry,
                                   rtol=1e-5)
    assert fresh.tokens == got[1].tokens
    assert fresh.telemetry == got[1].telemetry


@pytest.mark.cuda
def test_cuda_whisper_smoke_engine_matches_cpu(cuda_device):
    """whisper-large-v3's smoke config served on the card under flash
    prefill (each request with its frames): greedy tokens bitwise equal
    to the CPU's on the same weights, the telemetry within rtol 1e-5;
    paged (only the self-attention K/V) == dense and solo == interleaved
    bitwise on the card."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.launch.serve import build_requests
    from repro_torch.models import build_model
    from repro_torch.serve import EngineConfig, InferenceEngine

    cfg = get_smoke("whisper-large-v3")
    cpu = torch.device("cpu")
    params = build_model(cfg, cpu).init(torch.Generator().manual_seed(0))
    on_card = T.tree_map(lambda t: t.to(cuda_device), params)
    reqs, arrivals = build_requests(
        cfg, [(0, 12, 4, 0.0), (1, 17, 3, 0.0), (3, 9, 5, 0.0)], seed=0)

    def serve(dev, p, layout, requests, arr):
        ec = EngineConfig(max_slots=2, max_len=24, track_stats=True,
                          prefill_chunk=4, prefill_mode="flash",
                          kv_layout=layout, page_size=4)
        return InferenceEngine(cfg, ec, model=build_model(cfg, dev),
                               params=p).run(requests, arr)

    want = serve(cpu, params, "dense", reqs, arrivals)
    got = {layout: serve(cuda_device, on_card, layout, reqs, arrivals)
           for layout in ("dense", "paged")}
    solo = serve(cuda_device, on_card, "dense", reqs[1:2], [0])[1]
    for rid in want:
        assert got["dense"][rid].tokens == want[rid].tokens
        np.testing.assert_allclose(got["dense"][rid].telemetry,
                                   want[rid].telemetry, rtol=1e-5)
        assert got["paged"][rid].tokens == got["dense"][rid].tokens
        assert got["paged"][rid].telemetry == got["dense"][rid].telemetry
    assert solo.tokens == got["dense"][1].tokens
    assert solo.telemetry == got["dense"][1].telemetry


#: (BH, Sq, Skv, dh, block_k, offset of k/v in elements): the flash cases
#: of the compute dtypes; dh 18 takes scalar loads, an offset of 1 element
#: plain loads in the ring; dh 256 at block_k 1024 fits in bfloat16 only
#: (float64's 16-row tile fits dh 128 up to block_k 512)
DTYPE_FLASH_CASES = [
    (4, 150, 300, 16, 128, 0),
    (4, 150, 300, 18, 128, 0),
    (48, 512, 600, 128, 256, 0),
    (16, 300, 600, 128, 256, 1),
    (4, 200, 1500, 256, 1024, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("case", DTYPE_FLASH_CASES,
                         ids=lambda c: "bh{}-dh{}-bk{}-off{}".format(
                             c[0], c[3], c[4], c[5]))
def test_cuda_flash_bf16_and_f64_match_plain(cuda_device, dtype, case):
    """Tier 2 on the card in bfloat16 and float64 compute: B7 (causal and
    not, G 1 and 2) and B8 (at block-aligned offsets, equal to B7's rows)
    equal their plain version bit for bit, every built-in scheme, in the
    16-row tile."""
    from repro_torch.kernels import flash_attention as fa

    bh, sq, skv, dh, bk, offset = case
    if dtype == torch.float64 and dh > 128:
        with pytest.raises(ValueError, match="no tile fits"):
            fa.flash_plan(bh, sq, dh, bk, itemsize=8)
        return
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    sq_pad, skv_pad = -(-sq // 64) * 64, -(-skv // bk) * bk

    def data(rows, n, pad, off=0):
        x = torch.randn((rows, n, dh), generator=gen, device=cuda_device)
        x = torch.cat([x, x.new_zeros((rows, pad - n, dh))], 1).to(dtype)
        buf = x.new_empty(x.numel() + off)
        buf[off:] = x.reshape(-1)
        return buf[off:].view(x.shape)

    for groups in (1, 2):
        q = data(bh, sq, sq_pad)
        k = data(bh // groups, skv, skv_pad, offset)
        v = data(bh // groups, skv, skv_pad, offset)
        for scheme in SCHEMES:
            sch = tschemes.get(scheme)
            kw = dict(block_q=64, block_k=bk, scheme=sch, kv_len=skv,
                      q_groups=groups)
            for causal in (True, False):
                got = fa.flash_accumulators(q, k, v, causal=causal, **kw)
                want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk,
                                      kv_len=skv, causal=causal,
                                      q_groups=groups)
                torch.cuda.synchronize()
                assert fa.flash_accumulators.plan[0] == 16
                for g, w in zip(got, want):
                    assert g.dtype == dtype and torch.equal(g, w), (
                        scheme, causal, groups)
            full = fa.flash_accumulators(q, k, v, causal=True, **kw)
            for off in range(0, min(sq_pad, 128), 64):
                chunk = fa.flash_chunk_accumulators(
                    q[:, off:off + 64].contiguous(), k, v, off, **kw)
                for g, w in zip(chunk, full):
                    assert torch.equal(g, w[:, off:off + 64]), (scheme, off)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 9, 37, 64, 300])
def test_cuda_matmul_bf16_matches_plain(cuda_device, m):
    """Tier 2 on the card in bfloat16 compute: B5 (the rows path at M <=
    8, the tiles above) at 1, 4 and 17 K-blocks of 128 and N 200, and B6
    at batch 3, equal to the plain version bit for bit, every built-in
    scheme; B6 equals a loop of B5."""
    from repro_torch.kernels import kahan_matmul as km

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    bf16 = torch.bfloat16
    for scheme in SCHEMES:
        sch = tschemes.get(scheme)
        kw = dict(scheme=sch, block_m=8, block_n=200, block_k=128,
                  compute_dtype=bf16)
        for steps in (1, 4, 17):
            a, b = _matmul_operands(gen, cuda_device, m, steps * 128, 200,
                                    bf16)
            got = km.matmul_accumulators(a, b, **kw)
            want = km.matmul_plain(a[None], b[None], scheme=sch, block_k=128,
                                   compute_dtype=bf16)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == bf16 and torch.equal(g, w[0]), (scheme,
                                                                  steps)
        a = torch.randn((3, m, 1024), generator=gen, device=cuda_device).to(
            bf16)
        b = torch.randn((3, 1024, 200), generator=gen,
                        device=cuda_device).to(bf16)
        got = km.matmul_accumulators_batched(a, b, **kw)
        want = km.matmul_plain(a, b, scheme=sch, block_k=128,
                               compute_dtype=bf16)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        for i in range(3):
            one = km.matmul_accumulators(a[i], b[i], **kw)
            assert all(torch.equal(g[i], o) for g, o in zip(got, one))


@pytest.mark.cuda
def test_cuda_vmap_lands_on_one_batched_launch(cuda_device):
    """``torch.func.vmap`` of ``ops.dot``, ``ops.asum`` and ``ops.matmul``
    on the card: ONE launch of B2, B4 or B6 and none other, equal to the
    batched entry point and to a loop of single calls bit for bit; a
    runtime scheme raises under vmap too and launches nothing."""
    from repro_torch.kernels import engine, ops

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    a = torch.randn((6, 50000), generator=gen, device=cuda_device)
    b = torch.randn((6, 50000), generator=gen, device=cuda_device)
    x = torch.randn((4, 64, 512), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((512, 384), generator=gen, device=cuda_device).bfloat16()
    for wrapper, vmapped, batched, loop in (
            ("dot_accumulators_batched",
             lambda: torch.func.vmap(lambda p, q: ops.dot(p, q))(a, b),
             lambda: ops.batched_dot(a, b),
             lambda: torch.stack([ops.dot(a[i], b[i]) for i in range(6)])),
            ("sum_accumulators_batched",
             lambda: torch.func.vmap(lambda p: ops.asum(p), in_dims=1)(a.T),
             lambda: ops.batched_asum(a),
             lambda: torch.stack([ops.asum(a[i]) for i in range(6)])),
            ("matmul_accumulators_batched",
             lambda: torch.func.vmap(lambda p: ops.matmul(p, w))(x),
             lambda: ops.batched_matmul(x, w.expand(4, 512, 384)),
             lambda: torch.stack([ops.matmul(x[i], w) for i in range(4)]))):
        before = engine.launch_counts()
        got = vmapped()
        after = engine.launch_counts()
        assert {n: after[n] - before[n] for n in after
                if after[n] != before[n]} == {wrapper: 1}
        assert torch.equal(got, batched()) and torch.equal(got, loop())
    mine = tschemes.CompensationScheme(
        name="test_torch_cuda_vmap", update=lambda s, c, x, step: (s + x, c),
        instruction_mix=tschemes.InstructionMix(adds=1, muls=1),
        error_bound=tschemes.NAIVE.error_bound)
    before = engine.launch_counts()
    with pytest.raises(NotImplementedError, match="test_torch_cuda_vmap"):
        torch.func.vmap(lambda p: ops.asum(p, scheme=mine))(a)
    assert engine.launch_counts() == before


@pytest.mark.cuda
def test_cuda_vmap_engine_matches_the_cpu(cuda_device):
    """A smoke ``slot_loop="vmap"`` engine on the card (flash prefill,
    ``kahan_matmul``: B5 once a projection and tick for all running
    slots) emits the greedy tokens of the same engine on the CPU."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import engine
    from repro_torch.models import build_model
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    cfg = get_smoke("olmo-1b").replace(kahan_attention=True,
                                       kahan_matmul=True)
    cpu = torch.device("cpu")
    params = build_model(cfg, cpu).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, (p,)),
                    sampling=SamplingParams(max_new_tokens=n), request_id=i)
            for i, (p, n) in enumerate([(9, 5), (14, 4), (3, 6)])]
    ec = EngineConfig(max_slots=2, max_len=24, track_stats=True,
                      prefill_chunk=4, prefill_mode="flash", slot_loop="vmap")
    out = {}
    for dev in (cpu, cuda_device):
        p = params if dev == cpu else _to_device(params, dev)
        before = engine.launch_counts()["matmul_accumulators"]
        out[dev.type] = InferenceEngine(cfg, ec, model=build_model(cfg, dev),
                                        params=p).run(reqs, [0, 1, 3])
    assert engine.launch_counts()["matmul_accumulators"] > before
    for req in reqs:
        assert (out["cuda"][req.request_id].tokens
                == out["cpu"][req.request_id].tokens)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    return tree.to(dev)


# ---------------------------------------------------------------------------
# The sharded norm and B7 on a rank's heads (the sharded steps)
# ---------------------------------------------------------------------------

#: the sharded norm's tree: leaves sharded on rows over "data", one
#: replicated (norm scales), one on columns
_NORM_SHAPES = {"emb": (1000, 64), "w": (4, 96, 48), "scale": (64,),
                "cols": (3, 130)}
_NORM_SPECS = {"emb": ("vocab", "embed"), "w": (None, "embed", "mlp"),
               "scale": (None,), "cols": (None, "embed")}

_NORM_RANK = """
import sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import engine
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import sharded_sq_norm
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shapes, specs = eval(sys.argv[4]), eval(sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
mesh = init_device_mesh("cuda", (2, 1), mesh_dim_names=("data", "model"))
gen = torch.Generator(device="cuda").manual_seed(28)
grads = {k: torch.randn(s, generator=gen, device="cuda")
         for k, s in sorted(shapes.items())}
dgrads = shd.distribute_tree(mesh, shd.TRAIN_RULES, specs, grads)
res = {}
for kahan_norm in (True, False):
    engine.reset_launch_counts()
    got = sharded_sq_norm(AdamWConfig(kahan_norm=kahan_norm), dgrads)
    res[kahan_norm] = {"sq": got.cpu(), "launches": engine.launch_counts(),
                       "local": {k: g.to_local().cpu()
                                 for k, g in dgrads.items()},
                       "placements": {k: str(g.placements)
                                      for k, g in dgrads.items()}}
torch.save(res, out)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_sharded_norm_two_ranks(cuda_device, tmp_path):
    """Two gloo ranks on the card, a tree of DTensor gradients on a (data
    2, model 1) mesh: the sharded squared norm is the same bits on both
    ranks, launches the column scan (``kahan_norm``) or B3 once a leaf a
    rank owns, and equals the fold of the per-rank partials computed here:
    under B3, each rank's grids from the CPU's plain version on the same
    shards, gathered and folded on the CPU, bit for bit; under the column
    scan, each rank's (s, c) pair from the kernel on the same shards
    folded by the same tree (the column vectors are the plain loop's,
    ``test_cuda_column_scan_matches_loop``)."""
    from repro_torch.core.kahan import kahan_sq_pair
    from repro_torch.kernels import engine
    from repro_torch.optim.adamw import _square_sums

    root = Path(__file__).resolve().parents[1]
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _NORM_RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.pt"), repr(_NORM_SHAPES),
         repr(_NORM_SPECS)], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in ranks:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    keys = sorted(_NORM_SHAPES)
    # rank 1 owns no copy of a replicated leaf ("scale")
    owned = [[res[r][True]["local"][k] for k in keys
              if r == 0 or "Shard" in res[r][True]["placements"][k]]
             for r in range(2)]
    eng = engine.CompensatedReduction()
    grid = 8 * eng.unroll * 128
    s_all, c_all, pairs = [], [], []
    for r in range(2):
        s = torch.zeros(grid * len(keys))
        c = torch.zeros_like(s)
        mine = [k for k in keys
                if r == 0 or "Shard" in res[r][True]["placements"][k]]
        ps, pc = _square_sums(eng, [res[r][True]["local"][k] for k in mine])
        for j, k in enumerate(mine):
            i = keys.index(k)
            s[i * grid:(i + 1) * grid] = ps[j * grid:(j + 1) * grid]
            c[i * grid:(i + 1) * grid] = pc[j * grid:(j + 1) * grid]
        s_all.append(s)
        c_all.append(c)
        pairs.append(kahan_sq_pair([x.to(cuda_device) for x in owned[r]]))
    want_b3 = engine.merge_accumulators(torch.stack(s_all),
                                        torch.stack(c_all))
    want_col = engine.merge_accumulators(
        torch.stack([p[0] for p in pairs]).reshape(2, 1),
        torch.stack([p[1] for p in pairs]).reshape(2, 1))
    for r in range(2):
        assert torch.equal(res[r][False]["sq"], res[0][False]["sq"])
        assert torch.equal(res[r][True]["sq"], res[0][True]["sq"])
        assert torch.equal(res[r][False]["sq"], want_b3)
        assert torch.equal(res[r][True]["sq"], want_col.cpu())
        assert res[r][False]["launches"]["sum_accumulators"] == len(owned[r])
        assert res[r][True]["launches"]["column_sq_accumulators"] == sum(
            x.dim() >= 2 and x.shape[0] > 1 for x in owned[r])


@pytest.mark.cuda
@pytest.mark.parametrize("heads,groups", [(16, 1), (8, 4)])
def test_cuda_flash_on_local_heads_equals_full_launch(cuda_device, heads,
                                                      groups):
    """B7 on one rank's heads (the sharded prefill's local launch): its
    grids equal those heads' rows of one launch over every head, bit for
    bit, and the plain version on the same heads; so do the finalized
    outputs of ``flash_attention``."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(15)
    b, s, dh, ranks = 2, 512, 128, 2
    q = torch.randn(b, heads, s, dh, generator=gen, device=cuda_device)
    kv = torch.randn(2, b, heads // groups, s, dh, generator=gen,
                     device=cuda_device)
    sch = tschemes.get("kahan")
    kw = dict(block_q=256, block_k=256, scheme=sch, kv_len=s,
              q_groups=groups)
    flat = (q.flatten(0, 1), kv[0].flatten(0, 1), kv[1].flatten(0, 1))
    full = fa.flash_accumulators(*flat, causal=True, **kw)
    out = fa.flash_attention(*flat, causal=True, q_groups=groups)
    per_q, per_kv = heads // ranks, heads // groups // ranks
    for r in range(ranks):
        ql = q[:, r * per_q:(r + 1) * per_q].flatten(0, 1).contiguous()
        kl, vl = (t[:, r * per_kv:(r + 1) * per_kv].flatten(0, 1)
                  .contiguous() for t in kv)
        local = fa.flash_accumulators(ql, kl, vl, causal=True, **kw)
        plain = fa.flash_plain(ql, kl, vl, scheme=sch, block_k=256,
                               kv_len=s, causal=True, q_groups=groups)
        for g, f, w in zip(local, full, plain):
            mine = f.view(b, ranks, per_q, *f.shape[1:])[:, r].flatten(0, 1)
            assert torch.equal(g, mine) and torch.equal(g, w)
        got = fa.flash_attention(ql, kl, vl, causal=True, q_groups=groups)
        assert torch.equal(got, out.view(b, ranks, per_q, s, dh)[:, r]
                           .flatten(0, 1))


@pytest.mark.cuda
def test_cuda_cost_audit_sass_strict(cuda_device):
    """The cost auditor's SASS level with the card's toolkit: the scheme
    probes of ``csrc/cost_probe.cu`` carry their declared mix, the
    float32 probes no conversion, every compensation add survives, the
    shipping kernels hold no tensor-core opcode in B1-B6 and no FFMA in
    the B3/B4 sum instantiations; with the CPU cost cells, no finding."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--cost", "--sass",
         "--strict"], capture_output=True, text=True, cwd=str(root),
        env=dict(os.environ, PYTHONPATH=str(root / "src")), timeout=900)
    assert proc.returncode == 0, proc.stdout[-6000:] + proc.stderr[-3000:]
    assert "0 violation(s)" in proc.stdout
