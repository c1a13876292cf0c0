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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_cuda_flash_refuses_another_dtypes_plan(cuda_device, dtype):
    """In bfloat16 and float64 the C entry takes exactly the heights of
    ``TILE_ROWS[itemsize]`` in their own layout: the chosen plan's bytes
    off by 16, the other dtype's tall height (32 rows in bfloat16, 64 in
    float64), bfloat16 laid out as float32 (its ring in float) and
    float64's 32 rows at dh 256 (32 acc cells a thread) are refused
    (error 1, cudaErrorInvalidValue) and nothing launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    itemsize = torch.empty((), dtype=dtype).element_size()
    code = _build.DTYPE_CODE[dtype]
    lib = _build.library("kahan_flash")

    def launch(dh, plan, bh=2, sq=64, skv=64, bk=64):
        q = torch.zeros((bh, sq, dh), device=cuda_device, dtype=dtype)
        outs = [torch.empty((bh, sq, 1), device=cuda_device, dtype=dtype)
                for _ in range(2)] + [torch.empty_like(q) for _ in range(2)]
        return lib.kahan_flash_launch(
            1, code, q.data_ptr(), q.data_ptr(), q.data_ptr(),
            *[o.data_ptr() for o in outs], bh, 1, sq, skv, dh, bk, skv, 0,
            1, fa.softmax_scale(dh), *plan, _build.stream_ptr(cuda_device))

    rows, smem = fa.flash_plan(2, 64, 16, 64, itemsize=itemsize)
    assert launch(16, (rows, smem)) == 0
    other = 32 if itemsize == 2 else 64
    bad = [(rows, smem + 16),
           (other, fa.flash_smem_bytes(other, 16, 64, itemsize))]
    if itemsize == 2:
        bad.append((rows, fa.flash_smem_bytes(rows, 16, 64, 4)))
    for plan in bad:
        assert launch(16, plan) == 1, plan
    if itemsize == 8:
        plan = (32, fa.flash_smem_bytes(32, 256, 1, 8))
        assert plan[1] <= fa.SMEM_LIMIT
        assert launch(256, plan, skv=1, bk=1) == 1, plan
    torch.cuda.synchronize()


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


#: every family's smoke config (phase 17 of chip_smoke.py trains each at
#: its published width)
FAMILY_SMOKES = ["olmo-1b", "qwen2.5-3b", "internvl2-2b",
                 "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b",
                 "hymba-1.5b", "xlstm-1.3b", "whisper-large-v3"]


def _smoke_data(cfg):
    from repro_torch.data import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
        vision_patches=cfg.vision.n_patches if cfg.vision else 0,
        d_model=cfg.d_model,
        n_frames=cfg.encoder.n_frames if cfg.encoder else 0))


def _smoke_step(device, kahan_matmul, kahan_norm, steps=2, name="olmo-1b",
                wide=False, **replace):
    """``steps`` train steps (2 microbatches each) of ``name``'s smoke
    config (with ``replace``) on ``device`` from the same params (made on
    the CPU) and batches; returns (params, opt state, metrics). ``wide``:
    params, compute, the microbatch accumulator and the kernels' Policy
    in float64, and the model's float32 casts widened
    (``torch_widen.WidenedModel``)."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.kernels import use_policy
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import batch_to_device
    from torch_widen import WidenedModel

    cfg = get_smoke(name).replace(kahan_matmul=kahan_matmul, **replace)
    if wide:
        cfg = cfg.replace(param_dtype="float64", compute_dtype="float64")
    if name == "olmo-1b":
        cfg = cfg.replace(loss_chunk=16)
    params = build_model(cfg, torch.device("cpu")).init(
        torch.Generator().manual_seed(0))
    params = T.tree_map(lambda p: p.to(device).requires_grad_(), params)
    tc = TrainConfig(steps=steps, microbatches=2, warmup=0,
                     accum_dtype="float64" if wide else "float32",
                     opt=AdamWConfig(lr=1e-3, kahan_norm=kahan_norm))
    model = build_model(cfg, device)
    data = _smoke_data(cfg)
    step = make_train_step(WidenedModel(model) if wide else model, cfg, tc)
    opt = init(tc.opt, params)
    with use_policy(compute_dtype=torch.float64 if wide else torch.float32):
        for i in range(steps):
            params, opt, m = step(params, opt,
                                  batch_to_device(data.batch_at(i), device))
    return params, opt, m


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILY_SMOKES)
@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_cuda_train_step_matches_cpu(cuda_device, kahan_matmul, name):
    """Tier 3: two smoke-config train steps of every family (float32
    compute) on the card within rtol 1e-5 (loss, grad norm) and 1e-5
    absolute (params) of the same steps on the CPU: float32 matmuls sum in
    other orders there. hymba-1.5b as its CPU parity against the
    reference holds it (float64 params, compute, accumulator and kernel
    Policy, the model's float32 casts widened): in float32 the two
    devices' roundings part one embedding component of a rare token, and
    Adam's first updates turn that into a 7.0e-5 step difference (one
    element of 131072; 2.2e-5 in float64 with the casts kept)."""
    from repro_torch.core import tree as T

    wide = name == "hymba-1.5b"
    out = [_smoke_step(d, kahan_matmul, True, name=name, wide=wide)
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


#: B5 launches a projection makes in one step of 2 microbatches: 4 a
#: microbatch (forward, recompute, dA, dB) in a layer under
#: ``torch.utils.checkpoint``, 3 in whisper's encoder (run once)
FAMILY_B5 = {
    "olmo-1b": 4 * 7 * 2 * 2,                   # 7 projections, 2 layers
    "qwen2.5-3b": 4 * 7 * 2 * 2,
    "internvl2-2b": 4 * 7 * 2 * 2,
    # MLA q, dkv, kr, o and 3 MLP (dense) or shared-expert projections a
    # layer, 3 layers
    "deepseek-v2-lite-16b": 4 * 7 * 3 * 2,
    # 2 superblocks of a dense and a MoE layer (shared expert): 7 each
    "llama4-maverick-400b-a17b": 4 * 14 * 2 * 2,
    "hymba-1.5b": 4 * 7 * 4 * 2,                # the SSM stays plain
    "xlstm-1.3b": 0,                            # einsums, as the reference
    # encoder: q, k, v, o, up, down; decoder: self q/k/v/o, cross q/o, MLP
    "whisper-large-v3": (3 * 6 * 2 + 4 * 8 * 2) * 2,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILY_SMOKES)
def test_cuda_family_train_step_launch_counts(cuda_device, name):
    """Every family's step under ``kahan_matmul`` (``kahan_norm=False``):
    B5 the count its projections give (``FAMILY_B5``), B3 once a parameter
    leaf, no other kernel."""
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts

    reset_launch_counts()
    params, _, _ = _smoke_step(cuda_device, True, False, steps=1, name=name)
    from repro_torch.core import tree as T

    counts = launch_counts()
    assert counts.pop("matmul_accumulators") == FAMILY_B5[name]
    assert counts.pop("sum_accumulators") == len(T.leaves(params))
    assert not any(counts.values()), counts


def _bits(x):
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()]) if x.is_floating_point() else x


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILY_SMOKES)
def test_cuda_train_step_repeats_bitwise(cuda_device, name):
    """Tier 2 on the card: one step of every family's smoke config
    (``kahan_matmul`` on) run twice from the same params, optimizer state
    and batch gives the same bits: loss, grad norm, every param and moment
    leaf (a MoE config's dispatch and pick backward included)."""
    from repro_torch.core import tree as T

    runs = [_smoke_step(cuda_device, True, True, steps=1, name=name)
            for _ in range(2)]
    (p1, o1, m1), (p2, o2, m2) = runs
    for k in ("loss", "grad_norm"):
        assert torch.equal(_bits(m1[k]), _bits(m2[k])), k
    for a, b in zip(T.leaves((p1, o1)), T.leaves((p2, o2))):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))


@pytest.mark.cuda
def test_cuda_moe_top6_step_repeats_bitwise(cuda_device):
    """deepseek-v2-lite's smoke config routed top-6, as its published
    config is: a token's six gradient rows are added in one fixed order,
    so one step run twice from the same state gives the same bits (an
    atomic sum of two terms from zero is the same either way; of six, it
    is not)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T

    moe = dataclasses.replace(get_smoke("deepseek-v2-lite-16b").moe,
                              top_k=6)
    runs = [_smoke_step(cuda_device, True, True, steps=1,
                        name="deepseek-v2-lite-16b", moe=moe)
            for _ in range(2)]
    (p1, o1, m1), (p2, o2, m2) = runs
    assert float(m1["dropped_frac"]) > 0
    for k in ("loss", "grad_norm"):
        assert torch.equal(_bits(m1[k]), _bits(m2[k])), k
    for a, b in zip(T.leaves((p1, o1)), T.leaves((p2, o2))):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAMILY_SMOKES)
def test_cuda_train_step_has_no_atomic_op(cuda_device, name):
    """Under ``torch.use_deterministic_algorithms(True, warn_only=True)``
    one step of every family's smoke config (``kahan_matmul`` on) reports
    no op without a deterministic CUDA implementation (the cuBLAS
    workspace note, about streams that share one, aside)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _smoke_step(cuda_device, True, True, steps=1, name=name)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    found = {str(w.message).splitlines()[0] for w in caught}
    atomic = [m for m in found if "deterministic" in m
              and "CuBLAS" not in m and "CUBLAS_WORKSPACE_CONFIG" not in m]
    assert not atomic, atomic


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_backward_matches_cpu_order(cuda_device, name, dtype):
    """The MoE dispatch's token gather and the expert-output pick, on the
    card, give bitwise the gradients autograd's own backward gives on the
    CPU, which scatter-adds in the sorted order: each token's ``top_k``
    rows from zero by ascending expert, each kept entry's row once (a
    dropped entry's pick gradient zero, as its gate makes it); at a smoke
    config's routing with drops, float32 and bfloat16."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.models import build_model, moe

    cfg = get_smoke(name)
    model = build_model(cfg, torch.device("cpu"))
    seg = next(s for s in model.segments if s.kind in ("moe", "super"))
    p = model.init(torch.Generator().manual_seed(0))[seg.name]
    p = T.tree_map(lambda t: t[0], p["b"] if seg.kind == "super" else p)
    gen = torch.Generator().manual_seed(1)
    xg = torch.randn((2, 16, cfg.d_model), generator=gen)
    r = moe.route(p["ffn"], cfg, xg, 16)
    assert not bool(r.keep.all())                  # some entries drop
    g, tk = r.token.shape
    e, cap, d = cfg.moe.n_experts, r.capacity, cfg.d_model
    rows = torch.where(r.keep, r.pos, cap)
    gi = torch.arange(g)[:, None].expand_as(rows)
    x = xg.to(dtype).requires_grad_()
    out = torch.randn((g, e, cap, d), generator=gen).to(dtype)
    out.requires_grad_()
    cot = torch.randn((g, tk, d), generator=gen).to(dtype)
    # a dropped entry's pick is weighted by its zero gate in moe_apply
    pick_cot = cot * r.keep[..., None].to(dtype)
    # the CPU's own autograd: scatter-adds in index order
    want_x = torch.autograd.grad(
        torch.gather(x, 1, r.token[..., None].expand(-1, -1, d)), x, cot)[0]
    want_o = torch.autograd.grad(
        out[gi, r.expert, rows.clamp_max(cap - 1)], out, pick_cot)[0]
    dev = cuda_device
    xc = x.detach().to(dev).requires_grad_()
    oc = out.detach().to(dev).requires_grad_()
    got_x = torch.autograd.grad(moe._TokenGather.apply(
        xc, r.token.to(dev), r.order.to(dev), cfg.moe.top_k), xc,
        cot.to(dev))[0]
    got_o = torch.autograd.grad(moe._ExpertPick.apply(
        oc, gi.to(dev), r.expert.to(dev), rows.to(dev)), oc,
        pick_cot.to(dev))[0]
    assert torch.equal(_bits(got_x.cpu()), _bits(want_x))
    assert torch.equal(_bits(got_o.cpu()), _bits(want_o))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 11008), (11008, 2048),
                                 (2048, 2816), (2816, 2048)])
def test_cuda_matmul_padded_backward_matches_plain(cuda_device, k, n):
    """B5's backward where the engine pads K or N (qwen2.5-3b's up and
    down 11008 -> 11264, deepseek-v2-lite's shared expert 2816 -> 3072):
    dA = g @ Wᵀ and dB = aᵀ @ g bitwise equal to the plain version on the
    operands ``_prep_matmul`` pads at the backward's blocks, unpadded."""
    from repro_torch.core import kahan as K
    from repro_torch.kernels import engine, kahan_matmul, ops

    m = 64
    eng = engine.CompensatedReduction(scheme="kahan")
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def plain(x, y, blocks):
        xp, yp = eng._prep_matmul(x, y, blocks)
        s, c = kahan_matmul.matmul_plain(xp[None], yp[None],
                                         scheme=eng.scheme,
                                         block_k=blocks[2],
                                         compute_dtype=torch.float32)
        return K.add(s[0], c[0])[:, :y.shape[1]]

    a = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((k, n), generator=gen, device=cuda_device).bfloat16()
    g = torch.randn((m, n), generator=gen, device=cuda_device)
    a.requires_grad_(), w.requires_grad_()
    before = engine.launch_counts()["matmul_accumulators"]
    ops.matmul(a, w, scheme="kahan").backward(g)
    assert engine.launch_counts()["matmul_accumulators"] == before + 3
    fwd = eng._matmul_blocks(m, n, k, None, None, None)
    da = plain(g, w.detach().T.contiguous(),
               eng._matmul_blocks(m, k, n, *fwd)).to(a.dtype)
    db = plain(a.detach().T.contiguous(), g,
               eng._matmul_blocks(k, n, m, *fwd)).to(w.dtype)
    assert a.grad.shape == (m, k) and w.grad.shape == (k, n)
    assert torch.equal(_bits(a.grad), _bits(da))
    assert torch.equal(_bits(w.grad), _bits(db))


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


#: (BH, Sq, Skv, dh, block_k, offset of k/v in elements, q_groups): the
#: flash cases of the compute dtypes; dh 18 takes scalar loads, an offset
#: of 1 element plain loads in the ring; dh 256 at block_k 1024 fits in
#: bfloat16 only (float64 fits dh 128 up to block_k 512). BH 48 at Sq 512
#: and 520, BH 40 (hymba's dh 64 at G 5) and BH 32 (dh 80) at Sq 520 make
#: ``flash_plan`` choose the tall tile (64 rows in bfloat16, 32 in
#: float64) for B7; the others, and B8's 64-row chunks, 16 rows
DTYPE_FLASH_CASES = [
    (4, 150, 300, 16, 128, 0, (1, 2)),
    (4, 150, 300, 18, 128, 0, (1, 2)),
    (48, 512, 600, 128, 256, 0, (1, 2)),
    (16, 300, 600, 128, 256, 1, (1, 2)),
    (4, 200, 1500, 256, 1024, 0, (1, 2)),
    (40, 520, 600, 64, 256, 0, (1, 5)),
    (32, 520, 600, 80, 256, 0, (1, 2)),
    (48, 520, 700, 128, 256, 1, (2,)),
    # block_k 513-1024: the softmax's 1024-key form, in float64 in the
    # 32-row tile, the 16-row tile of two acc rows a thread and of four
    (16, 200, 1200, 64, 600, 0, (1, 2)),
    (4, 200, 1500, 64, 1024, 0, (1, 2)),
    (4, 200, 1026, 136, 513, 0, (1,)),
]


def _flash_data(gen, dtype, dev, rows, n, pad, dh, off=0):
    """``[rows, pad, dh]`` of ``dtype``: ``n`` normal rows then zeros, in a
    contiguous view ``off`` elements into its storage."""
    x = torch.randn((rows, n, dh), generator=gen, device=dev)
    x = torch.cat([x, x.new_zeros((rows, pad - n, dh))], 1).to(dtype)
    buf = x.new_empty(x.numel() + off)
    buf[off:] = x.reshape(-1)
    return buf[off:].view(x.shape)


def _flash_tiles(fa, dtype, bh, sq, dh, bk):
    """Every (rows, bytes) the kernel has for these shapes in ``dtype``,
    the plan ``flash_plan`` picks first."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    chosen = fa.flash_plan(bh, sq, dh, bk, itemsize=itemsize)
    return [chosen] + [plan for plan in fa.fitting_tiles(dh, bk, itemsize)
                       if plan != chosen]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("case", DTYPE_FLASH_CASES,
                         ids=lambda c: "bh{}-dh{}-bk{}-off{}-g{}".format(
                             c[0], c[3], c[4], c[5], c[6][-1]))
def test_cuda_flash_bf16_and_f64_match_plain(cuda_device, dtype, case):
    """Tier 2 on the card in bfloat16 and float64 compute: B7 (causal and
    not, at each case's G) and B8 (at block-aligned offsets, equal to B7's
    rows) equal their plain version bit for bit, every built-in scheme, in
    the tile ``flash_plan`` picks; the other height, where it fits,
    forced through the launch, gives the same rows."""
    from repro_torch.kernels import flash_attention as fa

    bh, sq, skv, dh, bk, offset, groups_of = case
    itemsize = torch.empty((), dtype=dtype).element_size()
    if dtype == torch.float64 and not fa.fitting_tiles(dh, bk, itemsize):
        with pytest.raises(ValueError, match="no tile fits"):
            fa.flash_plan(bh, sq, dh, bk, itemsize=8)
        return
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    sq_pad, skv_pad = -(-sq // 64) * 64, -(-skv // bk) * bk
    tiles = _flash_tiles(fa, dtype, bh, sq_pad, dh, bk)
    tall = fa.TILE_ROWS[itemsize][0]
    assert (tiles[0][0] == tall) == (-(-sq_pad // tall) * bh >= 2 * 132), (
        tiles[0])
    for groups in groups_of:
        q = _flash_data(gen, dtype, cuda_device, bh, sq, sq_pad, dh)
        k = _flash_data(gen, dtype, cuda_device, bh // groups, skv, skv_pad,
                        dh, offset)
        v = _flash_data(gen, dtype, cuda_device, bh // groups, skv, skv_pad,
                        dh, offset)
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
                assert fa.flash_accumulators.plan == tiles[0]
                for g, w in zip(got, want):
                    assert g.dtype == dtype and torch.equal(g, w), (
                        scheme, causal, groups)
                for plan in tiles[1:]:
                    other = fa._launch(
                        q, k, v, causal=causal, q_off=0,
                        counter=fa.flash_accumulators, plan=plan, **kw)
                    for g, w in zip(other, got):
                        assert torch.equal(g, w), (scheme, causal, plan)
            full = fa.flash_accumulators(q, k, v, causal=True, **kw)
            for off in range(0, min(sq_pad, 128), 64):
                chunk = fa.flash_chunk_accumulators(
                    q[:, off:off + 64].contiguous(), k, v, off, **kw)
                assert fa.flash_chunk_accumulators.plan[0] == 16
                for g, w in zip(chunk, full):
                    assert torch.equal(g, w[:, off:off + 64]), (scheme, off)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_cuda_flash_bf16_subnormal_reaching_matches_plain(cuda_device,
                                                          scheme):
    """Tier 2 on subnormal-reaching data in bfloat16 compute, in the
    64-row tile and the 16-row one: scores spread over about 100, so that
    exp's arguments pass -87.34 (where its result leaves float's normal
    range), and v down to 2^-40 with a fifth of it subnormal, so that
    products p * v fall below 2^-126. B7 (causal and not) equals its
    flushing plain version bit for bit."""
    from repro_torch.kernels import flash_attention as fa

    dev, bh, sq, skv, dh, bk = cuda_device, 48, 512, 512, 64, 256
    gen = torch.Generator(device=dev).manual_seed(11)
    # q row i is a_i everywhere and k row j is c_j / dh: s_ij is about
    # a_i c_j / 8, spread over about 100 to 150 a row
    a = torch.rand((bh, sq, 1), generator=gen, device=dev) + 0.5
    c = torch.rand((bh, skv, 1), generator=gen, device=dev) * -800 + 40
    q = a.expand(bh, sq, dh).to(torch.bfloat16).contiguous()
    k = (c / dh).expand(bh, skv, dh).to(torch.bfloat16).contiguous()
    e = torch.randint(-40, -9, (bh, skv, dh), generator=gen, device=dev)
    sub = torch.rand((bh, skv, dh), generator=gen, device=dev) < 0.2
    e = torch.where(sub, torch.randint(-133, -126, (bh, skv, dh),
                                       generator=gen, device=dev), e)
    sign = torch.randint(0, 2, (bh, skv, dh), generator=gen, device=dev)
    v = ((sign * 2 - 1) * torch.exp2(e.float())).to(torch.bfloat16)
    assert (v.float().abs() < 2.0 ** -126).any()
    sch = tschemes.get(scheme)
    kw = dict(block_q=64, block_k=bk, scheme=sch, kv_len=skv, q_groups=1)
    for causal in (True, False):
        want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk, kv_len=skv,
                              causal=causal)
        for plan in _flash_tiles(fa, torch.bfloat16, bh, sq, dh, bk):
            got = fa._launch(q, k, v, causal=causal, q_off=0,
                             counter=fa.flash_accumulators, plan=plan, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (causal, plan)


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


def _matmul_plan_launches(km, a, b, kw):
    """B5 (or B6, for a 3-D ``a``) under the kernel's own plan, then under
    every other plan ``fitting_plans`` lists, each one counted launch."""
    batched = a.dim() == 3
    a3, b3 = (a, b) if batched else (a[None], b[None])
    counter = (km.matmul_accumulators_batched if batched
               else km.matmul_accumulators)
    plans = km.fitting_plans(a3.shape[0], a3.shape[1], a3.shape[2],
                             kw["block_k"], kw["compute_dtype"])
    for plan in (None, *plans):
        before = counter.launches
        got = km._launch(a3, b3, counter=counter, plan=plan, **kw)
        assert counter.launches == before + 1
        yield plan, got


@pytest.mark.cuda
@pytest.mark.parametrize("m", [9, 37, 64, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_cuda_matmul_every_plan_matches_plain(cuda_device, dtype, m):
    """Tier 2 on the card in bfloat16 and float64 compute: B5 at M > 8
    under its own plan and under every other tile height and cluster
    split the C entry takes (``fitting_plans``: 32, 64 and 128 rows in
    bfloat16, 32 and 64 in float64, splits 1 to min(K-blocks, 8)), at 1,
    4 and 17 K-blocks of 128 and a ragged N 200, equals the plain version
    bit for bit, every built-in scheme."""
    from repro_torch.kernels import kahan_matmul as km

    gen = torch.Generator(device=cuda_device).manual_seed(12)
    assert km.TILE_ROWS[dtype] == ((32, 64) if dtype == torch.float64
                                   else (32, 64, 128))
    for scheme in SCHEMES:
        sch = tschemes.get(scheme)
        kw = dict(scheme=sch, block_m=8, block_n=200, block_k=128,
                  compute_dtype=dtype)
        for steps in (1, 4, 17):
            a, b = _matmul_operands(gen, cuda_device, m, steps * 128, 200,
                                    dtype)
            want = km.matmul_plain(a[None], b[None], scheme=sch, block_k=128,
                                   compute_dtype=dtype)
            n_plans = 0
            for plan, got in _matmul_plan_launches(km, a, b, kw):
                torch.cuda.synchronize()
                n_plans += 1
                for g, w in zip(got, want):
                    assert g.dtype == dtype and torch.equal(g, w), (
                        scheme, steps, plan)
            assert n_plans == 1 + len(km.TILE_ROWS[dtype]) * min(steps, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_cuda_matmul_batched_equals_loop_in_bf16_and_f64(cuda_device, dtype,
                                                         scheme):
    """Tier 2 on the card in bfloat16 and float64 compute: B6 at batch 3
    equals its plain version and a loop of B5 launches bit for bit, at M
    1 (the rows path), 9 and 64 (the tiles, every plan forced on B6)."""
    from repro_torch.kernels import kahan_matmul as km

    gen = torch.Generator(device=cuda_device).manual_seed(13)
    sch = tschemes.get(scheme)
    kw = dict(scheme=sch, block_m=8, block_n=200, block_k=256,
              compute_dtype=dtype)
    for m in (1, 9, 64):
        a = torch.randn((3, m, 1024), generator=gen,
                        device=cuda_device).to(dtype)
        b = torch.randn((3, 1024, 200), generator=gen,
                        device=cuda_device).to(dtype)
        loop = [km.matmul_accumulators(a[i], b[i], **kw) for i in range(3)]
        want = km.matmul_plain(a, b, scheme=sch, block_k=256,
                               compute_dtype=dtype)
        for plan, got in _matmul_plan_launches(km, a, b, kw):
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (m,
                                                                      plan)
            for i in range(3):
                assert all(torch.equal(g[i], o)
                           for g, o in zip(got, loop[i])), (m, plan, i)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", SCHEMES)
def test_cuda_matmul_bf16_subnormal_reaching_matches_plain(cuda_device,
                                                           scheme):
    """Tier 2 on subnormal-reaching data in bfloat16 compute: operands
    down to 2^-70 with a fifth of them subnormal, so that products fall
    below 2^-126 (flushed) and partial sums near it; and operands up to
    2^57, products up to 2^116, near bfloat16's largest finite value
    (no sum reaches it). B5 on the rows path (M 1, 3, 8) and at M 37 under
    every plan equals its flushing plain version bit for bit."""
    from repro_torch.kernels import kahan_matmul as km

    dev, bf16 = cuda_device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(14)

    def data(shape, lo, hi):
        e = torch.randint(lo, hi, shape, generator=gen, device=dev)
        sub = torch.rand(shape, generator=gen, device=dev) < 0.2
        if lo < 0:
            e = torch.where(sub, torch.randint(-133, -126, shape,
                                               generator=gen, device=dev), e)
        sign = torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
        frac = 1 + torch.rand(shape, generator=gen, device=dev)
        return (sign * frac * torch.exp2(e.float())).to(bf16)

    sch = tschemes.get(scheme)
    kw = dict(scheme=sch, block_m=8, block_n=200, block_k=128,
              compute_dtype=bf16)
    for lo, hi in ((-70, -50), (40, 58)):
        for m in (1, 3, 8, 37):
            a, b = data((m, 4 * 128), lo, hi), data((4 * 128, 200), lo, hi)
            if lo < 0:
                assert (a.float().abs() < 2.0 ** -126).any()
            want = km.matmul_plain(a[None], b[None], scheme=sch, block_k=128,
                                   compute_dtype=bf16)
            assert all(bool(torch.isfinite(w).all()) for w in want)
            for plan, got in _matmul_plan_launches(km, a, b, kw):
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (lo, m, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cuda_matmul_refuses_a_wrong_plan(cuda_device, dtype):
    """The C entry takes exactly the plans of ``fitting_plans`` for the
    compute dtype: a height it does not have (48 rows; 128 in float64), a
    split of 0 or past min(K-blocks, 8), a plan at M <= 8, or a height
    without a split, is refused (error 1, cudaErrorInvalidValue) and
    nothing launches; ``_launch`` refuses the same before it launches.
    ``grid_plan`` reports a plan of the list: at the 64-token gate/up
    shape 64 rows, split 2 in float32 and bfloat16, 1 in float64 (one
    CTA an SM)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import kahan_matmul as km

    code = _build.DTYPE_CODE[dtype]
    lib = _build.library("kahan_matmul")

    def launch(m, plan, k=512):
        a = torch.zeros((m, k), device=cuda_device, dtype=dtype)
        b = torch.zeros((k, 64), device=cuda_device, dtype=dtype)
        s, c = torch.empty((m, 64), device=cuda_device, dtype=dtype), \
            torch.empty((m, 64), device=cuda_device, dtype=dtype)
        return lib.kahan_matmul_launch(
            1, code, code, code, a.data_ptr(), b.data_ptr(), s.data_ptr(),
            c.data_ptr(), 1, m, 64, k, 128, *plan,
            _build.stream_ptr(cuda_device))

    fitting = km.fitting_plans(1, 16, 512, 128, dtype)
    assert len(fitting) == len(km.TILE_ROWS[dtype]) * 4
    for plan in fitting + ((0, 0),):
        assert launch(16, plan) == 0, plan
    bad = [(48, 1), (64, 0), (64, 5), (32, 9), (0, 1)]
    if dtype == torch.float64:
        bad.append((128, 1))
    for plan in bad:
        assert launch(16, plan) == 1, plan
    assert launch(8, (32, 1)) == 1
    torch.cuda.synchronize()
    x = torch.zeros((16, 512), device=cuda_device, dtype=dtype)
    w = torch.zeros((512, 64), device=cuda_device, dtype=dtype)
    before = km.matmul_accumulators.launches
    for plan in bad:
        with pytest.raises(ValueError, match="plan"):
            km._launch(x[None], w[None], scheme=tschemes.KAHAN, block_m=8,
                       block_n=64, block_k=128, compute_dtype=dtype,
                       counter=km.matmul_accumulators, plan=plan)
    assert km.matmul_accumulators.launches == before
    rows, cols, split = km.grid_plan(1, 64, 8192, 2048, 512, dtype)
    assert (rows, cols) == (64, 64)
    assert split == (1 if dtype == torch.float64 else 2)
    assert (rows, split) in km.fitting_plans(1, 64, 2048, 512, dtype)


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
