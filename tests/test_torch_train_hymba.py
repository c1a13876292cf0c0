"""The port's whole train step against the reference's on hymba-1.5b's
smoke config (attention beside the SSM, global and window layers): two
steps at microbatches 2, ``kahan_matmul`` off and on, at ROADMAP's
training tolerances (tier 3; ``tests/torch_train_parity.py``).

In float64 with the model's float32 casts widened on both sides, as
``tests/test_torch_hybrid.py`` holds hymba's gradients: the casts'
rounding, not the model, parts the two sides (2.0e-6 to 4.2e-6 of a
leaf's largest magnitude in float32)."""

import pytest
from torch_train_parity import train_step_parity


@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_train_step_within_tolerance(kahan_matmul, monkeypatch):
    from repro.models import common, hybrid, layers, ssm

    train_step_parity("hymba-1.5b", kahan_matmul, monkeypatch, x64=True,
                      widen=(common, hybrid, layers, ssm))
