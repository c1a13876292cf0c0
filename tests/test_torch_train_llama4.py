"""The port's whole train step against the reference's on
llama4-maverick-400b-a17b's smoke config (dense and MoE layers
interleaved in superblocks, top-1 routing with drops, a shared expert):
two steps at microbatches 2, ``kahan_matmul`` off and on, at ROADMAP's
training tolerances (tier 3; ``tests/torch_train_parity.py``). Its
published size does not train on one card (PERF.md); this smoke step is
its training's CPU check.

In float64 with the model's float32 casts widened on both sides, as the
MoE family's gradients are held. In float64 with the casts kept, an
embedding component of -1.6e-7 (two microbatches' terms nearly
cancelling) parts by 1.8% between the sides, and Adam's eps-damped
ratio turns that into a 5.6e-5 step difference; widened, every leaf
within 7.5e-9."""

import pytest
from torch_train_parity import train_step_parity


@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_train_step_within_tolerance(kahan_matmul, monkeypatch):
    from repro.models import common, layers, moe, transformer

    train_step_parity("llama4-maverick-400b-a17b", kahan_matmul, monkeypatch,
                      x64=True, widen=(common, layers, moe, transformer))
