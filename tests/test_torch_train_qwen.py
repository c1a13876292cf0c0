"""The port's whole train step against the reference's on qwen2.5-3b's
smoke config (GQA, q/k/v biases, tied embeddings): two steps at
microbatches 2, ``kahan_matmul`` off and on, at ROADMAP's training
tolerances (tier 3; ``tests/torch_train_parity.py``).

In float64 with the model's float32 casts widened on both sides. The k
bias's gradient is zero in exact arithmetic (a bias on every key of a
query shifts all its scores alike, and the softmax ignores the shift), so
each side's is rounding alone, and Adam's first moving update turns
that into a step of up to ``lr`` times the ratio of two noises: in
float32 the k bias parts by 5.1e-6, in float64 with the casts kept by
3.4e-6, against the 2e-6 tolerance; widened, every leaf within 1.3e-7."""

import pytest
from torch_train_parity import train_step_parity


@pytest.mark.parametrize("kahan_matmul", [False, True])
def test_train_step_within_tolerance(kahan_matmul, monkeypatch):
    from repro.models import common, layers, transformer

    train_step_parity("qwen2.5-3b", kahan_matmul, monkeypatch, x64=True,
                      widen=(common, layers, transformer))
