"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
CUDA device). Imports torch and the port only, so it runs on a machine
without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

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


@pytest.mark.cuda
def test_runtime_scheme_on_card_raises(cuda_device):
    """A scheme registered at runtime has no device function: on a CUDA
    tensor the wrappers raise, naming the scheme, and launch nothing; the
    same scheme still runs on CPU tensors."""
    from repro_torch.kernels import engine

    mine = tschemes.CompensationScheme(
        name="test_torch_cuda_plain",
        update=lambda s, c, x, step: (s + x, c),
        instruction_mix=tschemes.InstructionMix(adds=1, muls=1))
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
