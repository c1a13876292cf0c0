"""Slot-addressed KV cache for the continuous-batching engine (counterpart
of ``repro/serve/slots.py``, dense layout).

One cache from the model's own ``init_cache`` with a fixed request axis
of ``max_slots`` rows — axis 1 of every leaf, behind the stacked layer
axis. ``gather_row`` hands out a slot's batch-1 row as VIEWS of the big
cache, so the model's in-place K/V writes land in the slot directly
(``gather_rows`` several slots' rows, for the vmapped decode tick);
``scatter_row`` installs a row from elsewhere. ``reset`` returns a slot
to the model's initial state on eviction: the row of a fresh
``init_cache(1, max_len)``, as the reference scatters it — zeros for
K/V, but -1e30 for an xLSTM's stabiliser ``m``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

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


def gather_rows(cache: Cache, slots: Sequence[int]):
    """Slots ``slots`` (ascending) as one batch-``len(slots)`` cache, and
    the function that writes it back. Contiguous slots are views (writes
    go through; the write-back does nothing); other slots are copies that
    the write-back scatters into those slots' rows, and no other row."""
    lo, n = slots[0], len(slots)
    if list(slots) == list(range(lo, lo + n)):
        return (map_cache_leaves(lambda t: t.narrow(BATCH_AXIS, lo, n), cache),
                lambda: None)
    leaves = cache_leaves(cache)
    idx = torch.tensor(list(slots), device=leaves[0].device)
    rows = map_cache_leaves(lambda t: t.index_select(BATCH_AXIS, idx), cache)

    def scatter_rows():
        map_cache_leaves(lambda big, r: big.index_copy_(BATCH_AXIS, idx, r),
                         cache, rows)

    return rows, scatter_rows


def scatter_row(cache: Cache, row: Cache, slot: int) -> None:
    """Copy a batch-1 row cache into slot ``slot``."""
    map_cache_leaves(lambda big, r: big.narrow(BATCH_AXIS, slot, 1).copy_(r),
                     cache, row)


def pristine_row(row: Cache) -> Any:
    """A fresh batch-1 row (``init_cache(1, max_len)``) reduced to what a
    reset must copy: each leaf that is not all zeros, None for the rest
    (a zeroed leaf is reset by ``zero_``, with the same bits)."""
    return map_cache_leaves(lambda t: t if bool(t.any()) else None, row)


def reset_leaf(view: Tensor, pristine) -> None:
    """Return one slot leaf (a view) to its initial bits."""
    if pristine is None:
        view.zero_()
    else:
        view.copy_(pristine)


class SlotKVCache:
    """Fixed-batch slot cache over the model's cache."""

    def __init__(self, model, max_slots: int, max_len: int):
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = model.init_cache(max_slots, max_len)
        self._pristine = pristine_row(model.init_cache(1, max_len))

    def reset(self, slot: int) -> None:
        """Return ``slot`` to the model's initial row — freed slots never
        leak a previous request's state, and the next request starts
        where a fresh engine would."""
        map_cache_leaves(reset_leaf, gather_row(self.cache, slot),
                         self._pristine)
