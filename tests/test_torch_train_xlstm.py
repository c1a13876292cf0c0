"""The port's whole train step against the reference's on xlstm-1.3b's
smoke config (mLSTM and sLSTM blocks): two steps at microbatches 2,
``kahan_matmul`` off and on (its projections are einsums on both sides,
so the option changes no product), at ROADMAP's training tolerances
(tier 3; ``tests/torch_train_parity.py``).

In float64 with the model's float32 casts widened on both sides and the
parameters in float64 without the bridge, as ``tests/test_torch_xlstm.py``
holds xLSTM's gradients (its gates and states round to float32 on both
sides otherwise)."""

import pytest
from torch_train_parity import train_step_parity


@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_train_step_within_tolerance(kahan_matmul, monkeypatch):
    from repro.models import common, layers, xlstm, xlstm_lm

    train_step_parity("xlstm-1.3b", kahan_matmul, monkeypatch, x64=True,
                      widen=(common, layers, xlstm, xlstm_lm), bridge=False)
