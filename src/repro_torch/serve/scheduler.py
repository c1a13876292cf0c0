"""Request objects + the slot-based continuous-batching scheduler.

A line-for-line copy of ``repro/serve/scheduler.py`` (the ALLOCATING
state belongs to the paged KV layout, ``repro_torch.serve.paging``).

The scheduling layer is deliberately plain Python (no array code): it decides
WHICH request occupies WHICH decode slot WHEN, and nothing it decides may
change a request's numerics — the bitwise solo-vs-batched contract in
``repro_torch.serve.engine`` depends on every per-request quantity (prompt,
sampling key, emit indices, cache row) being independent of the
scheduler's choices. Keeping the scheduler free of array code makes that
separation auditable.

Admission policy: FIFO over arrival order, lowest free slot first — both
deterministic, so a replayed trace schedules identically.

Lifecycle: ``QUEUED -> [ALLOCATING ->] PREFILLING -> RUNNING ->
FINISHED``. A request occupies its slot from admission (PREFILLING) on,
but only joins the decode batch once its whole prompt has been
prefilled — chunked prefill spreads that work over multiple engine
steps under the engine's chunk budget, so one long prompt can no longer
stall every occupied decode slot for its full prefill. Under the paged
KV layout the queue head passes through ALLOCATING first (prefix match
+ page reservation, see the state-constant docstring); page exhaustion
sends it back to QUEUED without consuming a slot.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional

#: request lifecycle states. ALLOCATING is the paged-KV admission
#: window (``EngineConfig.kv_layout="paged"``): the queue head holds it
#: while the engine matches its prompt against the prefix cache and
#: reserves EVERY page the request can touch from the deterministic
#: free list — on page exhaustion the request returns to QUEUED at the
#: queue head (strict FIFO: later requests cannot jump a starved head)
#: and admission stalls until finishing requests release pages.
#: Allocation happens here, on the host, at admission — never inside a
#: trace, and decode can never run out of pages mid-request.
QUEUED, ALLOCATING, PREFILLING, RUNNING, FINISHED = (
    "queued", "allocating", "prefilling", "running", "finished")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature     0 = greedy argmax; > 0 samples categorically from
                    ``logits / temperature``
    max_new_tokens  tokens to emit (the first comes from prefill logits)
    seed            per-request RNG stream selector: the engine seeds
                    every draw from (engine sample_seed, seed,
                    emit_index).
                    None -> the request_id, so distinct requests get
                    distinct streams by default and a replayed request
                    (same id) gets the same stream.
    """

    temperature: float = 0.0
    max_new_tokens: int = 16
    seed: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.

    prompt      token ids, shape [S] (list / numpy array / tensor)
    sampling    per-request SamplingParams
    request_id  stable int identity; None -> assigned by the engine
                (submission order). Also the default sampling stream.
    extras      extra prefill inputs for multimodal archs, UNBATCHED
                (a VLM's ``vision_embeds`` [n_patches, d_model]; the
                engine rejects any other).
    """

    prompt: Any
    sampling: SamplingParams = SamplingParams()
    request_id: Optional[int] = None
    extras: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class RequestHandle:
    """Mutable per-request state, returned by ``engine.submit``.

    tokens     emitted token ids (grows once per engine step while running)
    telemetry  compensated squared logit norm per emitted token (fp32
               bits preserved; populated when the engine tracks stats)
    """

    request_id: int
    request: Request
    status: str = QUEUED
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    telemetry: List[float] = dataclasses.field(default_factory=list)
    # engine-internal decode bookkeeping (valid while RUNNING)
    pos: int = 0          # next cache write position (= prompt_len + emitted - 1)
    emitted: int = 0
    # engine-internal prefill bookkeeping (valid while PREFILLING):
    # prompt positions [0, prefill_pos) are already in the slot cache
    prefill_pos: int = 0
    prompt_len: int = 0

    @property
    def done(self) -> bool:
        return self.status == FINISHED

    @property
    def remaining(self) -> int:
        return self.request.sampling.max_new_tokens - self.emitted

    @property
    def seed(self) -> int:
        s = self.request.sampling.seed
        return self.request_id if s is None else s


class SlotScheduler:
    """Continuous-batching slot allocator: a fixed decode batch of
    ``max_slots`` rows; finished requests free their slot and queued
    requests are prefilled into free slots mid-flight.
    """

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self._free: List[int] = list(range(max_slots))   # sorted ascending
        self._queue: Deque[RequestHandle] = collections.deque()
        self._running: Dict[int, RequestHandle] = {}     # slot -> handle

    # ------------------------------------------------------------- admission
    def submit(self, handle: RequestHandle) -> None:
        handle.status = QUEUED
        self._queue.append(handle)

    def can_admit(self) -> bool:
        return bool(self._free) and bool(self._queue)

    def peek(self) -> Optional[RequestHandle]:
        """The queue head (next to admit), without popping — the paged
        engine's page-reservation hook: pages are reserved for the head
        BEFORE it consumes a slot, so a page-starved request blocks in
        the queue (strict FIFO), never in a slot."""
        return self._queue[0] if self._queue else None

    def admit_next(self) -> RequestHandle:
        """Pop the oldest queued request into the lowest free slot.

        The request enters PREFILLING: it owns the slot (and its pristine
        cache row) but joins the decode batch only once the engine marks
        it RUNNING after the last prefill chunk. (Under the paged layout
        the head arrives here in ALLOCATING, its pages already
        reserved.)"""
        slot = self._free.pop(0)
        handle = self._queue.popleft()
        handle.status = PREFILLING
        handle.slot = slot
        self._running[slot] = handle
        return handle

    def mark_running(self, handle: RequestHandle) -> None:
        """Prefill complete: the request joins the decode batch."""
        if handle.status != PREFILLING or self._running.get(handle.slot) is not handle:
            raise RuntimeError(
                f"mark_running: request {handle.request_id} is not "
                f"prefilling in an owned slot (status={handle.status!r})")
        handle.status = RUNNING

    # -------------------------------------------------------------- release
    def release(self, handle: RequestHandle) -> int:
        """Mark finished and free its slot (returned, for cache reset)."""
        slot = handle.slot
        if slot is None or self._running.get(slot) is not handle:
            # a real exception, not an assert: the slot-ownership
            # invariant guards cache reuse and must hold under python -O
            raise RuntimeError(
                f"release: request {handle.request_id} does not own slot "
                f"{slot!r} (double release, or a handle the scheduler "
                "never admitted)")
        del self._running[slot]
        bisect.insort(self._free, slot)
        handle.status = FINISHED
        handle.slot = None
        return slot

    # ------------------------------------------------------------- queries
    @property
    def running(self) -> Dict[int, RequestHandle]:
        """slot -> handle for every slot in the decode batch (admission
        order) — PREFILLING slots are excluded until their prompt is
        fully in the cache."""
        return {s: h for s, h in self._running.items()
                if h.status == RUNNING}

    @property
    def prefilling(self) -> Dict[int, RequestHandle]:
        """slot -> handle for every mid-prefill slot (admission order —
        the engine spends its chunk budget oldest-first)."""
        return {s: h for s, h in self._running.items()
                if h.status == PREFILLING}

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        return bool(self._running) or bool(self._queue)

    @property
    def occupancy(self) -> int:
        return len(self._running)
