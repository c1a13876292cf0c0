"""Request-level continuous-batching inference engine, in PyTorch
(counterpart of ``repro/serve/engine.py``: dense and paged KV layouts,
the prefix cache, scan and flash prefill).

    engine = InferenceEngine(cfg, EngineConfig(max_slots=8, max_len=512))
    handle = engine.submit(Request(prompt=[3, 1, 4], sampling=SamplingParams(
        temperature=0.7, max_new_tokens=32)))
    while not handle.done:
        engine.step()                 # one engine tick
    print(handle.tokens, handle.telemetry)

Scheduling as in the reference: a fixed decode batch of ``max_slots``
slot caches. Each ``step()`` admits queued requests into free slots, runs
up to ``prefill_budget`` prompt chunks of ``prefill_chunk`` tokens (oldest
request first; the tail chunk is scheduled as a power-of-two bucket) and
then ONE decode tick over the slots whose requests are RUNNING.

THE NUMERICS CONTRACT within the port: a request's tokens and telemetry
are bitwise identical whether it runs alone or interleaved with other
traffic, and whether its prompt is prefilled in chunks or one-shot.

* Prefill (``prefill_mode="scan"``, the default and the oracle) runs
  every prompt position through the model's own batch-1 decode step
  (``models.common.prefill_chunk_scan``), so chunking cannot change a
  position's arithmetic. ``prefill_mode="flash"`` runs each chunk in ONE
  forward pass (``prefill_chunk_parallel``), its attention through the
  chunk flash kernel when the config has ``kahan_attention``. A chunk's
  width and offset are a pure function of the request's own prompt, so
  solo-vs-interleaved stays bitwise; chunked-vs-one-shot gives the same
  tokens, with the telemetry within a tolerance (different widths round
  the projections differently). ``engine.prefill_body`` reports the
  resolved body: configs without the parallel path run "scan".
* The decode tick runs the slots ONE AT A TIME through the same batch-1
  decode step — the analogue of the reference's ``lax.scan`` over slots.
  A batched matmul would let the library pick its kernel by batch size,
  and a request's bits would then depend on its neighbours.
  ``EngineConfig.slot_loop="vmap"`` opts out of that guarantee for
  throughput, as the reference's does: the tick is ONE ``decode_step``
  over the running slots' rows, each at its own position (a LongTensor
  of positions, PyTorch's form of the reference's ``jax.vmap`` of its
  one-slot body). Only the running rows are computed and written: free
  and PREFILLING rows keep their bits (the reference keeps them through
  an exact select, ``repro/serve/engine.py:563-577``). Its tokens and
  telemetry then depend on which requests share a tick; ``"scan"`` stays
  the default and the bitwise oracle.
* Sampling draws from a generator seeded by (``sample_seed``, the
  request's seed, the emit index) only.
* The telemetry (``track_stats``) is ONE ``batched_asum`` launch over the
  whole slot batch per tick — rows are independent, bitwise equal to a
  per-request loop — plus one per finished prefill.

ONE ``Policy`` (``EngineConfig.policy``) selects the compensation scheme,
unroll and accumulate dtype of everything the engine computes: the
telemetry, and the flash kernels' accumulators (prefill chunks run under
``use_policy``).

REQUEST EXTRAS (a VLM's ``vision_embeds``, unbatched ``[n_patches, D]``;
an encoder-decoder's ``frames``, ``[n_frames, D]``) move to the engine's
device ONCE, at the request's first chunk, and are dropped when its
prefill completes (``repro/serve/engine.py:751-755, 800-815, 926``). A
VLM's are handed to every chunk of its prompt. A model with a
``prefill_begin`` (the encoder-decoder) takes them there instead, once,
in the request's first chunk: it encodes the frames and fills the cross
K/V of the request's slot, which every later chunk and decode step reads
(``repro/serve/engine.py:584-600, 911``).

PAGED KV LAYOUT (``EngineConfig.kv_layout="paged"``, ``serve.paging``):
pageable cache leaves live in a pool of ``num_pages`` pages of
``page_size`` positions, addressed per request through a page table on
the cache's device, so live KV memory scales with live tokens. Each
decode position and prefill chunk gathers the request's row through its
table, runs the same batch-1 body as the dense layout and writes back
only the pages it touched. The dense layout stays the default and the
bitwise oracle: tokens and telemetry are the same bits under either
layout and under any page placement. Pages are reserved whole-request at
admission (the ALLOCATING state; exhaustion blocks admission, strict
FIFO), and ``EngineConfig.prefix_cache`` adds a refcounted radix tree
(``serve.prefix``) over finished prompts, so a request whose prompt
prefix is resident admits by reference and resumes prefill at the shared
page boundary. Pageable leaves page; the others (a hybrid's ring buffers
and SSM state) keep their dense slot rows beside them, and a model with
no pageable leaf at all is served on the dense layout, as the reference
resolves it (``engine.kv_layout`` reports the layout served).
``engine.page_stats()`` reports the pool's accounting. The page
bookkeeping is the reference's, decision for decision. The prefix cache
is refused (``ValueError``) for a model with state that does not page
(unless it has a ``prefill_begin``, whose requests never share):
a prefix hit resumes past positions whose ring rows and SSM state the
request never computed, and the reference, which shares such prefixes,
then serves other tokens than without the cache
(``scripts/hymba_prefix_reference.py``). A request with extras, and any
request of a model with a ``prefill_begin``, never shares: their cached
positions depend on more than the tokens
(``repro/serve/engine.py:954-966``).

EVICTION resets a slot to the model's initial row (``serve.slots``): an
xLSTM's stabiliser state starts at -1e30, and a slot zeroed instead would
serve a reused slot's next request other tokens.

The vmapped slot loop serves the dense layout only: with
``kv_layout="paged"`` it raises, as the reference's does (its paged tick
threads the page pool through the slot scan). The reference's
compile-count guard has no analogue here: eager PyTorch compiles nothing
per chunk width or page placement.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels import schemes as _schemes
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.models.layers import activation_sq_norm
from repro_torch.serve.paging import PageAllocator, PagedKVCache, pages_for
from repro_torch.serve.prefix import PrefixNode, RadixPrefixTree
from repro_torch.serve.scheduler import (
    ALLOCATING,
    QUEUED,
    Request,
    RequestHandle,
    SlotScheduler,
)
from repro_torch.serve.slots import (
    SlotKVCache,
    gather_row,
    gather_rows,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level serving configuration.

    The fields are the reference's, so a caller written against the
    reference's API runs unchanged.

    max_slots      decode batch width: concurrent requests per tick
    max_len        per-slot cache capacity (prompt + generated tokens)
    track_stats    record the compensated squared logit norm per token
    policy         ONE Policy for the engine's compensated reductions;
                   None captures the ambient ``use_policy`` default
    sample_seed    engine-level sampling seed
    slot_loop      "scan" (slots run one at a time through the batch-1
                   decode step: the default and the bitwise oracle) or
                   "vmap" (one decode step over the running slots, each
                   at its own position; bits may depend on the
                   neighbours). "vmap" takes the dense layout only
    prefill_chunk  prompt-chunk width; None = one-shot (whole prompt)
    prefill_budget max prefill chunks per ``step()``; None = unbounded
    max_finished   retain at most this many FINISHED handles in
                   ``engine.handles`` (oldest-finished evicted first);
                   None = retain all (callers can still drain with
                   ``pop_finished()``)
    prefill_mode   "scan" (per-position, the oracle) or "flash" (one
                   forward pass per chunk)
    kv_layout      "dense" (the default and the bitwise oracle: rows of
                   max_slots x max_len) or "paged" (a page pool with
                   per-request page tables, ``serve.paging``)
    page_size      positions a page (a power of two; max_len must be a
                   multiple). Paged layout only
    num_pages      pool capacity in pages; None = dense parity (max_slots
                   * max_len / page_size). Admission blocks (FIFO) when
                   the pool runs short; a request that could never fit
                   fails at ``submit``
    prefix_cache   keep finished requests' full prompt pages in a
                   refcounted radix tree (``serve.prefix``) so that a
                   request with a resident prompt prefix admits by
                   reference. Paged layout only; the engine refuses it
                   for a model with state that does not page
    """

    max_slots: int = 4
    max_len: int = 512
    track_stats: bool = False
    policy: Optional[Policy] = None
    sample_seed: int = 0
    slot_loop: str = "scan"
    prefill_chunk: Optional[int] = 64
    prefill_budget: Optional[int] = None
    max_finished: Optional[int] = None
    prefill_mode: str = "scan"
    kv_layout: str = "dense"
    page_size: int = 16
    num_pages: Optional[int] = None
    prefix_cache: bool = False

    def __post_init__(self):
        if self.slot_loop not in ("scan", "vmap"):
            raise ValueError(f"slot_loop must be 'scan' or 'vmap', got "
                             f"{self.slot_loop!r}")
        if self.prefill_mode not in ("scan", "flash"):
            raise ValueError(f"prefill_mode must be 'scan' or 'flash', "
                             f"got {self.prefill_mode!r}")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {self.kv_layout!r}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.kv_layout == "paged":
            ps = self.page_size
            if ps < 1 or (ps & (ps - 1)):
                raise ValueError(
                    f"page_size must be a power of two >= 1, got {ps}")
            if self.max_len % ps:
                raise ValueError(
                    f"max_len={self.max_len} must be a multiple of "
                    f"page_size={ps}")
            if self.num_pages is not None and self.num_pages < 1:
                raise ValueError(
                    f"num_pages must be >= 1 (or None for dense parity), "
                    f"got {self.num_pages}")
            if self.slot_loop == "vmap":
                raise ValueError(
                    "kv_layout='paged' requires slot_loop='scan' (the "
                    "reference's paged decode tick threads the page pool "
                    "through the slot scan)")
        if self.prefix_cache and self.kv_layout != "paged":
            raise ValueError(
                "prefix_cache=True requires kv_layout='paged' (prefix "
                "sharing is page-granular)")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None for one-shot "
                f"prefill), got {self.prefill_chunk}")
        if self.prefill_budget is not None and self.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1 (or None for unbounded), "
                f"got {self.prefill_budget}")
        if self.max_finished is not None and self.max_finished < 0:
            raise ValueError(
                f"max_finished must be >= 0 (or None to retain all), "
                f"got {self.max_finished}")


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One emitted token, as surfaced by ``step()`` / ``stream()``."""

    request_id: int
    token: int
    norm: Optional[float]    # compensated |logits|^2 (None if not tracked)
    done: bool


def _bucket(n: int, chunk: int) -> int:
    """Smallest power of two >= n, capped at the chunk width."""
    b = 1
    while b < n:
        b *= 2
    return min(b, chunk)


def _next_chunk(prompt_len: int, offset: int, chunk: Optional[int],
                ) -> Tuple[int, int]:
    """(width, nvalid) of the next prefill chunk at ``offset`` — a pure
    function of the prompt length and the chunk width."""
    remaining = prompt_len - offset
    if chunk is None:
        return prompt_len, prompt_len
    if remaining > chunk:
        return chunk, chunk
    return _bucket(remaining, chunk), remaining


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sampling_seed(sample_seed: int, seed: int, emit_index: int) -> int:
    """The generator seed of one draw: a hash of (engine seed, request
    seed, emit index) only, so a request's stream cannot depend on its
    neighbours (the reference folds the same triple into a jax key)."""
    h = _splitmix64(sample_seed & _MASK64)
    h = _splitmix64(h ^ (seed & _MASK64))
    h = _splitmix64(h ^ (emit_index & _MASK64))
    return h >> 1


@dataclasses.dataclass
class _PageLease:
    """One admitted request's page reservation (paged layout only).

    table      [max_pages] page table, host ints: shared prefix pages
               first, then the request's own pages, NULL (0) past
               ``n_pages``
    table_dev  the same table as an index tensor on the cache's device
    n_pages    reserved pages in all (every page the request can touch,
               fixed at admission, so decode never allocates)
    shared     the acquired prefix-tree path (refs held until finish)
    own        engine-owned pages (freed, or adopted by the prefix tree,
               at finish)
    resume     prefill resume offset: positions [0, resume) came in by
               reference (and at most one copy-on-write page) and are
               never re-prefilled
    """

    table: np.ndarray
    table_dev: torch.Tensor
    n_pages: int
    shared: List[PrefixNode]
    own: List[int]
    resume: int


class InferenceEngine:
    """Continuous-batching serving engine over the port's model zoo.

    ``model`` / ``params`` may be passed in to share one set of weights
    across engines (solo replays against the weights the loaded engine
    serves). ``device=None`` means the card; pass ``device="cpu"`` to run
    on the CPU.
    """

    def __init__(self, cfg: ArchConfig, ec: EngineConfig = EngineConfig(),
                 seed: int = 0, model=None, params=None,
                 device: DeviceSpec = None):
        self.cfg = cfg
        self.ec = ec
        self.policy = (ec.policy if ec.policy is not None
                       else _schemes.current_policy())
        if model is None:
            model = build_model(cfg, resolve_device(device))
        self.model = model
        self.device = model.device
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model.init(gen)
        self.params = params
        self.pages: Optional[PageAllocator] = None
        self.prefix: Optional[RadixPrefixTree] = None
        self.num_pages = 0
        # the layout served: "paged" needs at least one pageable leaf; a
        # model without one runs dense (``kv_layout`` reports it)
        axes = (PagedKVCache.page_axes_of(model, ec.max_len)
                if ec.kv_layout == "paged" else [])
        #: the model's one-time prefill setup (the encoder-decoder's), run
        #: in a request's first chunk; None for the other families
        self._begin = getattr(model, "prefill_begin", None)
        # a ``prefill_begin`` family shares no prefix at all (``_sharable``),
        # so its dense cross K/V cannot be skipped by a prefix hit
        if (ec.prefix_cache and self._begin is None
                and any(s < 0 for s in axes)):
            raise ValueError(
                f"prefix_cache=True: {cfg.name}'s cache holds state that "
                f"does not page (ring buffers, recurrent state); a shared "
                f"prefix would resume without it")
        if any(s >= 0 for s in axes):
            self.num_pages = (
                ec.num_pages if ec.num_pages is not None
                else ec.max_slots * ec.max_len // ec.page_size)
            self.slots = PagedKVCache(model, ec.max_slots, ec.max_len,
                                      ec.page_size, self.num_pages)
            self.pages = PageAllocator(self.num_pages)
            if ec.prefix_cache:
                self.prefix = RadixPrefixTree(ec.page_size)
        else:
            self.slots = SlotKVCache(model, ec.max_slots, ec.max_len)
        self.scheduler = SlotScheduler(ec.max_slots)
        # request_id -> its page lease; the counters ``page_stats`` reads
        self._leases: Dict[int, _PageLease] = {}
        self.prefix_hit_tokens = 0
        self.page_stalls = 0
        # request_id -> its extras on the device, from its first chunk to
        # the end of its prefill
        self._extras_dev: Dict[int, Dict[str, torch.Tensor]] = {}
        self._next_id = 0
        parallel = ec.prefill_mode == "flash" and model.parallel_prefill_ok
        self._prefill_body = "flash" if parallel else "scan"
        self._chunk_fn = (model.prefill_chunk_parallel if parallel
                          else model.prefill_chunk)
        # (request_id, width, body) of every prefill chunk the most recent
        # step() ran
        self.last_chunks: List[Tuple[int, int, str]] = []
        self.t = 0
        self.handles: Dict[int, RequestHandle] = {}
        # request ids of the retained finished handles, oldest first
        self._finished: Deque[int] = collections.deque()

    @property
    def prefill_body(self) -> str:
        """The RESOLVED chunk body: "flash" only when ``prefill_mode ==
        "flash"`` and the model's ``parallel_prefill_ok``; otherwise
        "scan"."""
        return self._prefill_body

    # ------------------------------------------------------------ submission
    def submit(self, request: Request) -> RequestHandle:
        """Queue a request; returns its live handle immediately."""
        rid = request.request_id
        if rid is None:
            rid = self._next_id
        if rid in self.handles:
            raise ValueError(f"request_id {rid} already submitted")
        self._next_id = max(self._next_id, rid) + 1
        if request.sampling.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._check_extras(rid, request.extras)
        prompt = np.asarray(request.prompt)
        if prompt.ndim != 1 or prompt.shape[0] == 0:
            raise ValueError(
                f"request {rid}: prompt must be a non-empty 1-D token "
                f"sequence, got shape {tuple(prompt.shape)}")
        prompt_len = int(prompt.shape[0])
        if prompt_len + request.sampling.max_new_tokens - 1 > self.ec.max_len:
            raise ValueError(
                f"request {rid}: prompt_len={prompt_len} + "
                f"max_new_tokens={request.sampling.max_new_tokens} exceeds "
                f"the engine's max_len={self.ec.max_len}")
        if self.pages is not None:
            need = pages_for(
                prompt_len + request.sampling.max_new_tokens - 1,
                self.ec.page_size)
            if need > self.num_pages:
                # could never be admitted even with the whole pool free:
                # waiting at the head of the FIFO would starve the queue
                raise ValueError(
                    f"request {rid}: needs {need} pages but the pool has "
                    f"only {self.num_pages}: raise num_pages or shrink the "
                    f"request")
        handle = RequestHandle(request_id=rid, request=request,
                               prompt_len=prompt_len)
        self.handles[rid] = handle
        self.scheduler.submit(handle)
        return handle

    def _check_extras(self, rid: int, extras) -> None:
        """A request's extras must be the ones the model takes, at their
        shapes: a VLM's ``vision_embeds`` [n_patches, d_model], an
        encoder-decoder's ``frames`` [n_frames, d_model] (which it must
        bring). Anything else raises at ``submit``."""
        cfg = self.cfg
        want = {}
        if cfg.vision is not None:
            want["vision_embeds"] = (cfg.vision.n_patches, cfg.d_model)
        if cfg.encoder is not None:
            want["frames"] = (cfg.encoder.n_frames, cfg.d_model)
        extras = extras or {}
        unknown = sorted(set(extras) - set(want))
        if unknown:
            raise ValueError(
                f"request {rid}: extras {unknown} not taken by {cfg.name} "
                f"(it takes {sorted(want) or 'none'})")
        if self._begin is not None and "frames" not in extras:
            raise ValueError(f"request {rid}: {cfg.name} needs 'frames' "
                             f"{want['frames']} among its extras")
        for name, value in extras.items():
            shape = tuple(np.shape(value))
            if shape != want[name]:
                raise ValueError(f"request {rid}: {name} of shape {shape}, "
                                 f"want {want[name]}")

    def _extras(self, rid: int, request: Request) -> Dict[str, torch.Tensor]:
        """The request's extras as batch-1 tensors on the engine's device,
        moved once and reused by every chunk of its prompt."""
        if not request.extras:
            return {}
        if rid not in self._extras_dev:
            self._extras_dev[rid] = {
                k: torch.as_tensor(np.asarray(v)).to(self.device)[None]
                for k, v in request.extras.items()}
        return self._extras_dev[rid]

    # -------------------------------------------------------------- numerics
    def _norms(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, V_pad] -> [B] compensated squared logit norms, ONE batched
        sum launch. Valid-vocab slice only: the padded region carries the
        -1e30 bias, whose square overflows float32."""
        return activation_sq_norm(logits[:, :self.cfg.vocab_size],
                                  scheme=self.policy)

    def _sample(self, logits_row: torch.Tensor, seed: int, emit_index: int,
                temperature: float) -> int:
        """Greedy argmax at temperature <= 0; above, Gumbel-max sampling
        from ``logits / temperature`` with noise drawn from the request's
        own (seed, emit index) stream."""
        if temperature <= 0:
            return int(torch.argmax(logits_row))
        gen = torch.Generator().manual_seed(
            sampling_seed(self.ec.sample_seed, seed, emit_index))
        u = torch.rand(logits_row.shape, generator=gen, dtype=torch.float64)
        gumbel = (-torch.log(-torch.log(u))).to(torch.float32)
        scores = logits_row.float() / temperature + gumbel.to(self.device)
        return int(torch.argmax(scores))

    # ------------------------------------------------------------------ step
    def step(self) -> List[TokenEvent]:
        """One engine tick: admissions, up to ``prefill_budget`` prefill
        chunks (oldest request first; a request whose last chunk lands
        emits its first token and joins the decode batch), then one decode
        tick over the running slots. Returns the tokens emitted."""
        events: List[TokenEvent] = []
        self.last_chunks = []
        sch = self.scheduler
        budget = self.ec.prefill_budget
        spent = 0
        while True:
            while sch.can_admit():
                if self.pages is not None and not self._reserve_pages(
                        sch.peek()):
                    # page exhaustion: the head waits IN THE QUEUE (strict
                    # FIFO) until finishing requests release pages
                    self.page_stalls += 1
                    break
                sch.admit_next()
            if budget is not None and spent >= budget:
                break
            prefilling = sch.prefilling
            if not prefilling:
                break
            slot, h = next(iter(prefilling.items()))
            self._run_chunk(slot, h, events)
            spent += 1
        running = sch.running
        if running:
            self._decode_tick(running, events)
        self.t += 1
        return events

    def _run_chunk(self, slot: int, h: RequestHandle,
                   events: List[TokenEvent]) -> None:
        """Advance one PREFILLING request by one chunk; on the final chunk
        record emit 0 (and its telemetry) and move it into the decode
        batch."""
        offset = h.prefill_pos
        width, nvalid = _next_chunk(h.prompt_len, offset,
                                    self.ec.prefill_chunk)
        self.last_chunks.append((h.request_id, width, self.prefill_body))
        toks = np.zeros((1, width), np.int64)
        toks[0, :nvalid] = np.asarray(h.request.prompt)[offset:offset + nvalid]
        extras = self._extras(h.request_id, h.request)
        resume = 0
        if self.pages is not None:
            lease = self._leases[h.request_id]
            row = self.slots.gather(slot, lease.table_dev, lease.n_pages)
            resume = lease.resume
        else:
            row = gather_row(self.slots.cache, slot)
        with _schemes.use_policy(self.policy):
            if self._begin is not None:
                # the setup takes the extras, in the first chunk only
                if offset == resume:
                    self._begin(self.params, row, **extras)
                extras = {}
            logits, _ = self._chunk_fn(
                self.params, torch.from_numpy(toks).to(self.device), row,
                offset, nvalid, **extras)
        if self.pages is not None:
            # write back ONLY the chunk's pages: everything below
            # ``offset`` (shared prefix pages among them) stays untouched
            ps = self.ec.page_size
            self.slots.scatter(row, lease.table_dev, offset // ps,
                               (offset + nvalid - 1) // ps + 1)
        h.prefill_pos = offset + nvalid
        if h.prefill_pos == h.prompt_len:
            self._extras_dev.pop(h.request_id, None)
            self.scheduler.mark_running(h)
            h.pos = h.prompt_len
            sp = h.request.sampling
            tok = self._sample(logits[0], h.seed, 0, sp.temperature)
            norm = self._norms(logits)[0] if self.ec.track_stats else None
            self._record(h, tok, norm, events)

    def _decode_tick(self, running: Dict[int, RequestHandle],
                     events: List[TokenEvent]) -> None:
        """One decode position for every running slot under the engine's
        Policy (as a prefill chunk runs): one slot at a time through the
        batch-1 decode step, or with ``slot_loop="vmap"`` one step over
        them all; then ONE telemetry launch over the whole [max_slots,
        vocab] logit batch (rows of idle slots are zero)."""
        logits = torch.zeros((self.ec.max_slots, self.cfg.padded_vocab),
                             dtype=torch.float32, device=self.device)
        if self.ec.slot_loop == "vmap":
            self._vmapped_step(running, logits)
        else:
            self._scanned_step(running, logits)
        toks = {slot: self._sample(logits[slot], h.seed, h.emitted,
                                   h.request.sampling.temperature)
                for slot, h in running.items()}
        norms = self._norms(logits).cpu() if self.ec.track_stats else None
        for slot, h in running.items():
            h.pos += 1
            self._record(h, toks[slot],
                         None if norms is None else norms[slot], events)

    def _scanned_step(self, running: Dict[int, RequestHandle],
                      logits: torch.Tensor) -> None:
        """The ``slot_loop="scan"`` tick: each running slot's row through
        the batch-1 decode step in turn, its logits into ``logits``' row."""
        for slot, h in running.items():
            tok_in = torch.tensor([h.tokens[-1]], device=self.device)
            if self.pages is not None:
                lease = self._leases[h.request_id]
                row = self.slots.gather(slot, lease.table_dev, lease.n_pages)
            else:
                row = gather_row(self.slots.cache, slot)
            with _schemes.use_policy(self.policy):
                row_logits = self.model.decode_step(self.params, row, tok_in,
                                                    h.pos)
            if self.pages is not None:
                # the one page holding the position just written
                self.slots.scatter_decode(row, lease.table_dev, h.pos)
            logits[slot] = row_logits[0]

    def _vmapped_step(self, running: Dict[int, RequestHandle],
                      logits: torch.Tensor) -> None:
        """The ``slot_loop="vmap"`` tick: ONE ``decode_step`` over the
        running slots' rows, token ``tokens[-1]`` of each at its own
        position ``pos`` (a LongTensor), written into ``logits``' rows.
        Only those rows are gathered (views where the slots are
        contiguous, else copies scattered back), so the rows of free and
        PREFILLING slots keep their bits."""
        slots = sorted(running)
        handles = [running[s] for s in slots]
        toks = torch.tensor([h.tokens[-1] for h in handles],
                            device=self.device)
        pos = torch.tensor([h.pos for h in handles], device=self.device)
        rows, scatter = gather_rows(self.slots.cache, slots)
        with _schemes.use_policy(self.policy):
            out = self.model.decode_step(self.params, rows, toks, pos)
        scatter()
        logits[slots] = out

    def _record(self, h: RequestHandle, token: int, norm,
                events: List[TokenEvent]) -> None:
        h.tokens.append(token)
        h.emitted += 1
        nval = None
        if self.ec.track_stats:
            # float() of a float32 is exact: the telemetry keeps its bits
            nval = float(np.float32(float(norm)))
            h.telemetry.append(nval)
        done = h.remaining == 0
        if done:
            slot = self.scheduler.release(h)
            self.slots.reset(slot)      # eviction hook: no stale state
            if self.pages is not None:
                self._release_pages(h)
            self._finished.append(h.request_id)
            if self.ec.max_finished is not None:
                while len(self._finished) > self.ec.max_finished:
                    self.handles.pop(self._finished.popleft(), None)
        events.append(TokenEvent(h.request_id, token, nval, done))

    # ------------------------------------------------------ page admission
    def _sharable(self, h: RequestHandle) -> bool:
        """May this request share prompt pages through the prefix tree?
        Only when its cache bits are a function of its tokens alone: no
        extras (patch embeddings or frames feed the cached positions), no
        ``prefill_begin`` family (its setup conditions every position),
        and under the flash body only with a chunk width (the alignable
        resume offset) (``repro/serve/engine.py::_sharable``)."""
        return (self.prefix is not None and not h.request.extras
                and self._begin is None
                and (self.prefill_body == "scan"
                     or self.ec.prefill_chunk is not None))

    def _reserve_pages(self, h: RequestHandle) -> bool:
        """Reserve EVERY page the queue head can touch (the ALLOCATING
        window); False = the pool is exhausted even after evicting cached
        prefix pages, and the head goes back to QUEUED. All allocation
        happens here, on the host, and never mid-decode.

        With the prefix cache, the prompt is matched against the radix
        tree first: matched full pages are taken BY REFERENCE (refcounted,
        never written: the prefill writes back only pages from the resume
        offset on), and under the scan body one partially matching page
        may be copied (copy-on-write). The resume offset is capped so at
        least one prompt position is prefilled again (the final chunk's
        logits emit token 0) and, under the flash body, aligned to the
        page size and the chunk width, so that a resumed request runs
        exactly the chunks its private prefill would from that offset.
        The reference's decisions, step for step."""
        ec = self.ec
        ps = ec.page_size
        h.status = ALLOCATING
        total = pages_for(
            h.prompt_len + h.request.sampling.max_new_tokens - 1, ps)
        prompt = [int(t) for t in np.asarray(h.request.prompt)]
        sharable = self._sharable(h)
        path: List[PrefixNode] = []
        resume = 0
        if sharable:
            path = self.prefix.match(prompt)
            r = min(len(path) * ps, h.prompt_len - 1)
            if self.prefill_body == "flash":
                c = ec.prefill_chunk
                r = min(r, c * ((h.prompt_len - 1) // c))
                align = max(ps, c)
                r = (r // align) * align
            else:
                r = (r // ps) * ps
            path = path[:r // ps]
            resume = r
        shared = len(path)
        need = total - shared
        if self.prefix is not None:
            self.prefix.acquire(path)
            if self.pages.free_count < need:
                # reclaim refs-0 cached prefix pages, oldest first (the
                # path just acquired is pinned by its refs)
                freed = self.prefix.evict(need - self.pages.free_count)
                if freed:
                    self.slots.reset_pages(freed)   # pristine before reuse
                    self.pages.free(freed)
        if self.pages.free_count < need:
            if self.prefix is not None:
                self.prefix.release(path)
            h.status = QUEUED
            return False
        own = self.pages.alloc(need)
        if sharable and self.prefill_body == "scan":
            # copy-on-write at the first divergent page (scan body only:
            # a flash resume stays chunk-aligned): copy the child sharing
            # the longest token prefix of the next page into the request's
            # first own page and resume AFTER the overlap
            donor, t = self.prefix.partial_child(path, prompt)
            t = min(t, h.prompt_len - 1 - resume)
            if donor is not None and t > 0:
                self.slots.copy_page(donor.page, own[0])
                resume += t
        table = np.zeros((self.slots.max_pages,), np.int32)
        for j, node in enumerate(path):
            table[j] = node.page
        table[shared:shared + need] = own
        self._leases[h.request_id] = _PageLease(
            table=table, table_dev=self.slots.table_tensor(table),
            n_pages=total, shared=path, own=own, resume=resume)
        h.prefill_pos = resume
        self.prefix_hit_tokens += resume
        return True

    def _release_pages(self, h: RequestHandle) -> None:
        """Finish hook (after the slot is released): drop the request's
        prefix references, offer its full prompt pages to the prefix tree
        (the first insert of a page run wins: any two requests' bits for
        the same full-page run are the same), and zero-reset and free
        whatever the tree did not adopt. After a drained trace, free pages
        plus tree-owned pages == num_pages."""
        lease = self._leases.pop(h.request_id)
        own = list(lease.own)
        if self.prefix is not None:
            self.prefix.release(lease.shared)
            if self._sharable(h):
                ps = self.ec.page_size
                if self.prefill_body == "flash":
                    # only positions computed by FULL chunk-width chunks
                    # may be shared under flash (tail buckets round by
                    # their width)
                    c = self.ec.prefill_chunk
                    n_ins = (c * ((h.prompt_len - 1) // c)) // ps
                else:
                    n_ins = h.prompt_len // ps
                if n_ins:
                    prompt = [int(t) for t in np.asarray(h.request.prompt)]
                    adopted, _ = self.prefix.insert(
                        prompt, n_ins, lease.table[:n_ins])
                    if adopted:
                        taken = set(adopted)
                        own = [p for p in own if p not in taken]
        if own:
            self.slots.reset_pages(own)   # pristine before the free list
            self.pages.free(own)

    @property
    def kv_layout(self) -> str:
        """The RESOLVED cache layout: "paged" only when
        ``EngineConfig.kv_layout == "paged"`` and the model's cache has a
        pageable leaf; otherwise "dense"."""
        return "paged" if self.pages is not None else "dense"

    def page_stats(self) -> Dict[str, int]:
        """Pool and prefix accounting (paged layout only), with the
        reference's keys. ``pages_in_use`` counts every page not free
        (reserved by requests, or owned by the tree); ``kv_bytes_in_use``
        is that count times the bytes of one page across every pool leaf:
        the live footprint that scales with live tokens where the dense
        layout holds ``max_slots * max_len`` rows."""
        if self.pages is None:
            raise RuntimeError(
                "page_stats: the dense layout has no page pool "
                "(kv_layout='dense')")
        in_use = self.num_pages - self.pages.free_count
        return {
            "num_pages": self.num_pages,
            "free_pages": self.pages.free_count,
            "pages_in_use": in_use,
            "prefix_pages": (self.prefix.total_pages
                             if self.prefix is not None else 0),
            "prefix_cached_pages": (self.prefix.cached_pages
                                    if self.prefix is not None else 0),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "page_stalls": self.page_stalls,
            "kv_bytes_in_use": in_use * self.slots.page_bytes,
        }

    # ------------------------------------------------------- handle hygiene
    def pop_finished(self) -> Dict[int, RequestHandle]:
        """Drain the retained finished handles (request_id -> handle) and
        drop them from ``engine.handles``: what keeps a long-lived
        engine's handle table bounded (see also
        ``EngineConfig.max_finished``)."""
        out = {}
        while self._finished:
            rid = self._finished.popleft()
            h = self.handles.pop(rid, None)
            if h is not None:
                out[rid] = h
        return out

    # ------------------------------------------------------------ driving
    def stream(self, requests: Sequence[Request] = (),
               arrivals: Optional[Sequence[int]] = None,
               _sink: Optional[Dict[int, RequestHandle]] = None,
               ) -> Iterator[Tuple[int, List[TokenEvent]]]:
        """Drive a trace to completion, yielding ``(step, events)`` per
        tick; ``arrivals[i]`` is the engine step at which ``requests[i]``
        arrives (default: all at step 0)."""
        arr = [0] * len(requests) if arrivals is None else list(arrivals)
        if len(arr) != len(requests):
            raise ValueError("arrivals must match requests")
        pending = sorted(range(len(requests)), key=lambda i: (arr[i], i))
        while pending or self.scheduler.busy:
            while pending and arr[pending[0]] <= self.t:
                h = self.submit(requests[pending.pop(0)])
                if _sink is not None:
                    _sink[h.request_id] = h
            yield self.t, self.step()

    def run(self, requests: Sequence[Request] = (),
            arrivals: Optional[Sequence[int]] = None,
            ) -> Dict[int, RequestHandle]:
        """Submit ``requests`` (staggered by ``arrivals``) and step until
        drained; returns ``request_id -> handle`` for the trace this call
        drove (handles are captured at submission, so they survive
        ``max_finished`` eviction)."""
        driven = {rid: h for rid, h in self.handles.items() if not h.done}
        for _ in self.stream(requests, arrivals, _sink=driven):
            pass
        return driven
