"""Slot-addressed KV cache for the continuous-batching engine (counterpart
of ``repro/serve/slots.py``, dense layout).

One cache from the model's own ``init_cache`` with a fixed request axis
of ``max_slots`` rows — axis 1 of every leaf, behind the stacked layer
axis. ``gather_row`` hands out a slot's batch-1 row as VIEWS of the big
cache, so the model's in-place K/V writes land in the slot directly;
``scatter_row`` installs a row from elsewhere. ``reset`` returns a slot
to the pristine zero state on eviction.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Tensor = torch.Tensor
Cache = Dict[str, Tuple[Tensor, ...]]

#: the request axis of every cache leaf ([L, B, S, KV, dh])
BATCH_AXIS = 1


def gather_row(cache: Cache, slot: int) -> Cache:
    """Slot ``slot`` as a batch-1 row cache of views (writes go through)."""
    return {k: tuple(t.narrow(BATCH_AXIS, slot, 1) for t in leaves)
            for k, leaves in cache.items()}


def scatter_row(cache: Cache, row: Cache, slot: int) -> None:
    """Copy a batch-1 row cache into slot ``slot``."""
    for k, leaves in cache.items():
        for big, r in zip(leaves, row[k]):
            big.narrow(BATCH_AXIS, slot, 1).copy_(r)


class SlotKVCache:
    """Fixed-batch slot cache over the model's cache."""

    def __init__(self, model, max_slots: int, max_len: int):
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = model.init_cache(max_slots, max_len)

    def reset(self, slot: int) -> None:
        """Return ``slot`` to the model's pristine (zero) init state — freed
        slots never leak a previous request's K/V."""
        for leaves in gather_row(self.cache, slot).values():
            for t in leaves:
                t.zero_()
