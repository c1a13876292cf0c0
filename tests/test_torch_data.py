"""The port's data pipeline (``repro_torch.data``) vs the JAX package's
(parity tier 1: bitwise): the same batches and host shards at every step,
and the same resume state."""

import numpy as np
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro_torch.data import DataConfig, SyntheticLM

CFG = dict(vocab_size=101, seq_len=16, global_batch=4)


def _same_batch(a, b) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("step", [0, 1, 7, 1000])
def test_batches_bitwise(step):
    ref = JaxSyntheticLM(JaxDataConfig(**CFG))
    port = SyntheticLM(DataConfig(**CFG))
    assert _same_batch(ref.batch_at(step), port.batch_at(step))


def test_batches_bitwise_at_olmo_vocab():
    """The port's sampler searches precomputed CDFs where the reference
    recomputes them per token; the same tokens at OLMo-1B's vocabulary."""
    cfg = dict(vocab_size=50304, seq_len=16, global_batch=8)
    ref = JaxSyntheticLM(JaxDataConfig(**cfg))
    port = SyntheticLM(DataConfig(**cfg))
    assert _same_batch(ref.batch_at(2), port.batch_at(2))


@pytest.mark.parametrize("host_count", [2, 4])
def test_host_shards_bitwise(host_count):
    ref = JaxSyntheticLM(JaxDataConfig(**CFG))
    port = SyntheticLM(DataConfig(**CFG))
    for h in range(host_count):
        assert _same_batch(
            ref.batch_at(3, host_index=h, host_count=host_count),
            port.batch_at(3, host_index=h, host_count=host_count))


def test_iterator_and_resume():
    port = SyntheticLM(DataConfig(**CFG))
    first = [next(port) for _ in range(3)]
    state = port.state_dict()
    assert state == {"step": 3}
    again = SyntheticLM(DataConfig(**CFG))
    again.load_state_dict({"step": 1})
    assert _same_batch(next(again), first[1])
    b = first[0]
    assert np.array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["loss_mask"].dtype == np.float32 and b["loss_mask"].all()
