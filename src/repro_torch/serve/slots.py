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

from typing import Any, Dict

import torch

from repro_torch.models.common import cache_leaves, map_cache_leaves

Tensor = torch.Tensor
Cache = Dict[str, Any]

#: the request axis of every cache leaf ([L, B, S, ...]: the port stacks a
#: layer axis in front of every leaf, also for an unstacked segment)
BATCH_AXIS = 1


def gather_row(cache: Cache, slot: int) -> Cache:
    """Slot ``slot`` as a batch-1 row cache of views (writes go through)."""
    return map_cache_leaves(lambda t: t.narrow(BATCH_AXIS, slot, 1), cache)


def scatter_row(cache: Cache, row: Cache, slot: int) -> None:
    """Copy a batch-1 row cache into slot ``slot``."""
    map_cache_leaves(lambda big, r: big.narrow(BATCH_AXIS, slot, 1).copy_(r),
                     cache, row)


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
        for t in cache_leaves(gather_row(self.cache, slot)):
            t.zero_()
