"""The port's whole train step against the reference's on
internvl2-2b's smoke config (patch embeddings spliced over the first
positions, the loss masked over them): two steps at microbatches 2,
``kahan_matmul`` off and on, at ROADMAP's training tolerances (tier 3;
``tests/torch_train_parity.py``), in float32."""

import pytest
from torch_train_parity import train_step_parity


@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_train_step_within_tolerance(kahan_matmul):
    train_step_parity("internvl2-2b", kahan_matmul)
