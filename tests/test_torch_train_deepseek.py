"""The port's whole train step against the reference's on
deepseek-v2-lite-16b's smoke config (MLA, a dense first layer, routed
experts top-2 with capacity drops, a shared expert): two steps at
microbatches 2, ``kahan_matmul`` off and on, at ROADMAP's training
tolerances (tier 3; ``tests/torch_train_parity.py``), the same entries
dropped on both sides.

In float64 with the model's float32 casts widened on both sides, as the
MoE family's gradients are held (``tests/test_torch_configs.py``): in
float32 the two sides' roundings alone part them by up to 2.9e-6 of a
leaf's largest magnitude, and Adam's first moving update turns the
rounding of a small component into a step of up to ``lr``."""

import pytest
from torch_train_parity import train_step_parity


@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_train_step_within_tolerance(kahan_matmul, monkeypatch):
    from repro.models import common, layers, moe, transformer

    train_step_parity("deepseek-v2-lite-16b", kahan_matmul, monkeypatch,
                      x64=True, widen=(common, layers, moe, transformer))
