"""Paged KV cache: a fixed-size page pool and per-request page tables
(counterpart of ``repro/serve/paging.py``).

The dense ``SlotKVCache`` holds ``max_slots x max_len`` positions per KV
leaf whether or not anyone lives there; the compensated kernels are bound
by data traffic (the paper's ECM result), so the serving footprint should
scale with LIVE tokens instead. Under ``EngineConfig.kv_layout="paged"``
every PAGEABLE cache leaf (position-addressed KV history, found by
``models.common.cache_page_axes``) lives in a pool of ``num_pages`` pages
of ``page_size`` positions, and a request's logical row is assembled
through its page table on the way into the same batch-1 decode and chunk
bodies the dense engine runs. Leaves that are not pageable (the
``pageable=False`` split: ring buffers, recurrent state) keep their dense
``max_slots`` rows inside the same cache.

THE DENSE ORACLE. ``SlotKVCache`` stays the default and the bitwise
oracle: a request's tokens AND telemetry are identical under either
layout, and identical whether its pages are contiguous or scattered.

* Gather and scatter are EXACT data movement on device tensors
  (``index_select`` / ``index_copy_`` over the page axis with a table
  that lives on the cache's device).
* The gathered row is bitwise the dense row, in the dense row's layout:
  pages are zero-reset when freed (and the pool starts zero), and every
  position past the live page count is an exact zero, so unwritten
  positions carry the bits a dense slot row would.
* Between gather and scatter run the SAME batch-1 decode step and chunk
  bodies as in the dense layout.

THE NULL PAGE. Page 0 is reserved and never allocated. Tables hold it
past a request's reserved pages; the gather never reads it (those
positions are zeros) and no scatter writes it. Allocatable pages are
1..num_pages.

THE ALLOCATOR is plain deterministic Python (``PageAllocator``:
lowest-numbered page first, sorted free list). The engine reserves EVERY
page a request can touch (``ceil((prompt_len + max_new_tokens - 1) /
page_size)`` less shared prefix pages) at admission, so decode never
allocates and never runs out of pages mid-request; admission blocks
(FIFO head of line) when the pool is short, and impossible requests
fail fast at ``submit``.

Eager PyTorch needs none of the reference's traced-operand machinery
(one compiled program for any placement, barrier pins, masked scatter
lanes redirected to the NULL page): a decode step writes back exactly
the page holding its position and a prefill chunk exactly its own pages.
"""

from __future__ import annotations

import bisect
from typing import Any, List, Sequence

import torch

from repro_torch.models.common import (
    cache_batch_axes,
    cache_leaves,
    cache_page_axes,
    map_cache_leaves,
)
from repro_torch.serve.slots import pristine_row, reset_leaf

Tensor = torch.Tensor

#: the reserved never-allocated page: no scatter writes it and the gather
#: never reads it.
NULL_PAGE = 0


def pages_for(n_positions: int, page_size: int) -> int:
    """Pages covering positions [0, n_positions): ceil division."""
    return -(-n_positions // page_size)


# ---------------------------------------------------------------------------
# Per-leaf page ops
# ---------------------------------------------------------------------------
#
# A leaf of the dense layout has a request axis ``b`` and a sequence axis
# ``s`` (b < s: every cache of the port stacks [layers, batch, seq, ...]).
# Its pool drops the request axis and splits the sequence axis into
# (page, position in page): [L, B, S, KV, dh] -> [L, num_pages + 1,
# page_size, KV, dh]. The page axis of the pool is therefore ``s - 1``.

def _page_axis(b: int, s: int) -> int:
    if not b < s:
        raise ValueError(f"a pageable leaf needs its request axis ({b}) "
                         f"before its sequence axis ({s})")
    return s - 1


def gather_pages(pool: Tensor, table: Tensor, n_live: int, b: int, s: int,
                 max_len: int) -> Tensor:
    """A request's batch-1 leaf row assembled through its page table.

    ``pool``: [..., num_pages + 1, page_size, ...]; ``table``: [max_pages]
    int64 on the pool's device; ``n_live``: the request's reserved page
    count. Positions at or past ``n_live * page_size`` are EXACT zeros
    (table entries past the live count are never read): with zero-reset
    on free, the row is bitwise the dense slot row. Returns a new
    contiguous tensor in the dense row layout (request axis ``b`` of
    size 1, ``max_len`` positions along ``s``)."""
    pa = _page_axis(b, s)
    ps = pool.shape[pa + 1]
    shape = list(pool.shape)
    shape[pa:pa + 2] = [max_len]
    row = pool.new_zeros(shape)
    if n_live:
        pages = pool.index_select(pa, table[:n_live])
        row.narrow(pa, 0, n_live * ps).copy_(pages.flatten(pa, pa + 1))
    return row.unsqueeze(b)


def scatter_pages(pool: Tensor, leaf_row: Tensor, table: Tensor,
                  first_page: int, end_page: int, b: int, s: int) -> None:
    """Write a row's pages ``[first_page, end_page)`` back through its
    table, in place. Pages outside that range are not written: shared
    prefix pages below a prefill chunk's first page stay strictly
    copy-on-write."""
    pa = _page_axis(b, s)
    ps = pool.shape[pa + 1]
    n = end_page - first_page
    if n <= 0:
        return
    seg = leaf_row.squeeze(b).narrow(pa, first_page * ps, n * ps)
    pool.index_copy_(pa, table[first_page:end_page],
                     seg.unflatten(pa, (n, ps)).to(pool.dtype))


def scatter_one_page(pool: Tensor, leaf_row: Tensor, table: Tensor,
                     page_index: int, b: int, s: int) -> None:
    """Write back ONLY the page holding a decode position: a decode step
    writes one position, so the tick moves O(page_size) bytes a leaf,
    not O(max_len)."""
    scatter_pages(pool, leaf_row, table, page_index, page_index + 1, b, s)


# ---------------------------------------------------------------------------
# Row-level (whole cache) ops
# ---------------------------------------------------------------------------

def paged_gather_row(cache: Any, batch_axes: Any, page_axes: Any, slot: int,
                     table: Tensor, n_live: int, max_len: int) -> Any:
    """Batch-1 row of a mixed dense/paged cache: dense leaves as views of
    their slot (writes go through), pool leaves assembled through the
    page table (a copy, written back by the scatters below)."""
    def one(leaf, b, s):
        if s < 0:
            return leaf.narrow(b, slot, 1)
        return gather_pages(leaf, table, n_live, b, s, max_len)

    return map_cache_leaves(one, cache, batch_axes, page_axes)


def paged_scatter_row(cache: Any, row: Any, batch_axes: Any, page_axes: Any,
                      table: Tensor, first_page: int, end_page: int) -> None:
    """Install a prefill chunk's row: pool leaves through the table, pages
    ``[first_page, end_page)`` only (dense leaves were written through
    their views)."""
    def one(leaf, r, b, s):
        if s >= 0:
            scatter_pages(leaf, r, table, first_page, end_page, b, s)

    map_cache_leaves(one, cache, row, batch_axes, page_axes)


def paged_scatter_decode(cache: Any, row: Any, batch_axes: Any,
                         page_axes: Any, table: Tensor, pos: int) -> None:
    """Decode write-back: pool leaves write the ONE page holding ``pos``
    (dense leaves were written through their views)."""
    def one(leaf, r, b, s):
        if s >= 0:
            ps = leaf.shape[_page_axis(b, s) + 1]
            scatter_one_page(leaf, r, table, pos // ps, b, s)

    map_cache_leaves(one, cache, row, batch_axes, page_axes)


# ---------------------------------------------------------------------------
# Deterministic free-list allocator (plain Python)
# ---------------------------------------------------------------------------

class PageAllocator:
    """Lowest-numbered-page-first free list over pages 1..num_pages.

    Deterministic (sorted free list, like the scheduler's lowest-free-
    slot policy), so a replayed trace allocates identically, and as the
    reference's does. Page 0 (``NULL_PAGE``) never enters the free list.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages + 1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take the ``n`` lowest free pages; raises on exhaustion (the
        engine checks ``free_count`` first: running out here is a
        bookkeeping bug, not backpressure)."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)} "
                f"free of {self.num_pages}")
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == NULL_PAGE or p > self.num_pages:
                raise ValueError(f"cannot free page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            bisect.insort(self._free, p)


# ---------------------------------------------------------------------------
# The pool-backed cache
# ---------------------------------------------------------------------------

class PagedKVCache:
    """Mixed dense/paged slot cache over the model's cache.

    Pageable leaves live as pools ``[..., num_pages + 1, page_size, ...]``
    (page 0 = NULL) on the model's device; every other leaf keeps its
    dense ``max_slots`` rows exactly as ``SlotKVCache`` holds them."""

    def __init__(self, model, max_slots: int, max_len: int,
                 page_size: int, num_pages: int):
        if max_len % page_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of "
                f"page_size={page_size}")
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_size = page_size
        self.num_pages = num_pages
        #: pages per logical row: the page table's width
        self.max_pages = max_len // page_size
        self.specs = model.cache_specs()
        self.batch_axes = cache_batch_axes(self.specs)
        row = model.init_cache(1, max_len)
        self.page_axes = cache_page_axes(row, self.specs, max_len)

        # the zero-fill gather needs pristine == all zeros for every
        # pageable leaf
        def pristine(leaf, s):
            if s >= 0 and bool(leaf.any()):
                raise ValueError(
                    "pageable cache leaf has a non-zero pristine state: the "
                    "paged layout's zero-fill gather cannot represent it "
                    "(keep the leaf dense via the kv_ring spec flag)")

        map_cache_leaves(pristine, row, self.page_axes)
        #: the initial bits of the dense leaves, for ``reset``
        self._pristine = pristine_row(row)
        axes = cache_leaves(self.page_axes)
        if all(s < 0 for s in axes):
            raise ValueError(
                "kv_layout='paged': the model's cache has no pageable leaf "
                "(every leaf is a ring buffer or recurrent state)")
        dense = any(s < 0 for s in axes)
        full = model.init_cache(max_slots, max_len) if dense else row

        def build(lf, lr, b, s):
            if s < 0:
                return lf
            shape = list(lr.squeeze(b).shape)
            pa = _page_axis(b, s)
            shape[pa:pa + 1] = [num_pages + 1, page_size]
            return lr.new_zeros(shape)

        self.cache = map_cache_leaves(build, full, row, self.batch_axes,
                                 self.page_axes)

    @staticmethod
    def page_axes_of(model, max_len: int) -> List[int]:
        """Every cache leaf's pageable axis (-1: stays dense), in
        ``cache_leaves`` order, from a batch-1 row of the model's cache:
        the engine serves a model with none pageable (all-window hybrids,
        recurrent families) on the dense layout, as the reference's
        ``PagedKVCache.pageable`` decides."""
        return cache_leaves(cache_page_axes(model.init_cache(1, max_len),
                                            model.cache_specs(), max_len))

    def table_tensor(self, table) -> Tensor:
        """A page table (host ints) as the int64 index tensor the gather
        and scatters take, on the pool's device."""
        leaf = cache_leaves(self.cache)[0]
        return torch.as_tensor(table, dtype=torch.long).to(leaf.device)

    # ------------------------------------------------------------- row ops
    def gather(self, slot: int, table: Tensor, n_live: int) -> Any:
        """A request's dense-equivalent batch-1 row (see
        ``paged_gather_row``)."""
        return paged_gather_row(self.cache, self.batch_axes, self.page_axes,
                                slot, table, n_live, self.max_len)

    def scatter(self, row: Any, table: Tensor, first_page: int,
                end_page: int) -> None:
        paged_scatter_row(self.cache, row, self.batch_axes, self.page_axes,
                          table, first_page, end_page)

    def scatter_decode(self, row: Any, table: Tensor, pos: int) -> None:
        paged_scatter_decode(self.cache, row, self.batch_axes,
                             self.page_axes, table, pos)

    def read(self, slot: int, table, n_live: int) -> Any:
        """A request's row (introspection / tests)."""
        return self.gather(slot, self.table_tensor(table), n_live)

    # ------------------------------------------------------------- mutators
    def reset(self, slot: int) -> None:
        """Return a freed slot's DENSE leaves to the model's initial row
        (``slots.reset_leaf``: zeros, or an xLSTM-style non-zero start);
        pool leaves are reset page by page (``reset_pages``)."""
        def one(leaf, b, s, pristine):
            if s < 0:
                reset_leaf(leaf.narrow(b, slot, 1), pristine)

        map_cache_leaves(one, self.cache, self.batch_axes, self.page_axes,
                         self._pristine)

    def reset_pages(self, pages: Sequence[int]) -> None:
        """Zero freed pages before they re-enter the free list: the
        pristine bits the zero-fill gather relies on."""
        idx = self.table_tensor(list(pages))

        def one(leaf, b, s):
            if s >= 0:
                leaf.index_fill_(_page_axis(b, s), idx, 0)

        map_cache_leaves(one, self.cache, self.batch_axes, self.page_axes)

    def copy_page(self, src: int, dst: int) -> None:
        """Device-side page copy (copy-on-write at the first divergent
        prefix page): the copied bits are the donor's."""
        si, di = self.table_tensor([src]), self.table_tensor([dst])

        def one(leaf, b, s):
            if s >= 0:
                pa = _page_axis(b, s)
                leaf.index_copy_(pa, di, leaf.index_select(pa, si))

        map_cache_leaves(one, self.cache, self.batch_axes, self.page_axes)

    # ----------------------------------------------------------- accounting
    @property
    def page_bytes(self) -> int:
        """Bytes of ONE page across every pool leaf: the unit of the
        engine's live-memory accounting."""
        def one(leaf, s, b):
            if s < 0:
                return 0
            return (leaf.numel() // leaf.shape[_page_axis(b, s)]
                    * leaf.element_size())

        return sum(cache_leaves(map_cache_leaves(
            one, self.cache, self.page_axes, self.batch_axes)))
