"""Request-level continuous-batching inference engine, in PyTorch
(counterpart of ``repro/serve/engine.py``: dense KV layout, scan and
flash prefill).

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
* Sampling draws from a generator seeded by (``sample_seed``, the
  request's seed, the emit index) only.
* The telemetry (``track_stats``) is ONE ``batched_asum`` launch over the
  whole slot batch per tick — rows are independent, bitwise equal to a
  per-request loop — plus one per finished prefill.

ONE ``Policy`` (``EngineConfig.policy``) selects the compensation scheme,
unroll and accumulate dtype of everything the engine computes: the
telemetry, and the flash kernels' accumulators (prefill chunks run under
``use_policy``).

The reference's paged KV layout, prefix cache and vmapped slot loop are
ported in later slices; asking for them raises.
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
from repro_torch.serve.scheduler import Request, RequestHandle, SlotScheduler
from repro_torch.serve.slots import SlotKVCache, gather_row

_LATER = "ported in a later slice — see ROADMAP"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level serving configuration.

    The fields are the reference's, so a caller written against the
    reference's API runs unchanged. ``slot_loop``, ``kv_layout`` and
    ``prefix_cache`` accept only the value the port carries: the
    reference's other options raise, naming the later slice, instead of
    being ignored.

    max_slots      decode batch width: concurrent requests per tick
    max_len        per-slot cache capacity (prompt + generated tokens)
    track_stats    record the compensated squared logit norm per token
    policy         ONE Policy for the engine's compensated reductions;
                   None captures the ambient ``use_policy`` default
    sample_seed    engine-level sampling seed
    slot_loop      "scan" only: slots run one at a time
    prefill_chunk  prompt-chunk width; None = one-shot (whole prompt)
    prefill_budget max prefill chunks per ``step()``; None = unbounded
    max_finished   retain at most this many FINISHED handles in
                   ``engine.handles`` (oldest-finished evicted first);
                   None = retain all (callers can still drain with
                   ``pop_finished()``)
    prefill_mode   "scan" (per-position, the oracle) or "flash" (one
                   forward pass per chunk)
    kv_layout      "dense" only
    prefix_cache   False only
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
    prefix_cache: bool = False

    def __post_init__(self):
        if self.slot_loop != "scan":
            raise ValueError(f"slot_loop={self.slot_loop!r}: only 'scan' "
                             f"here; 'vmap' is {_LATER}")
        if self.prefill_mode not in ("scan", "flash"):
            raise ValueError(f"prefill_mode must be 'scan' or 'flash', "
                             f"got {self.prefill_mode!r}")
        if self.kv_layout != "dense":
            raise ValueError(f"kv_layout={self.kv_layout!r}: only 'dense' "
                             f"here; 'paged' is {_LATER}")
        if self.prefix_cache:
            raise ValueError(f"prefix_cache is {_LATER}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
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
        self.slots = SlotKVCache(model, ec.max_slots, ec.max_len)
        self.scheduler = SlotScheduler(ec.max_slots)
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
        if request.extras:
            raise ValueError(f"request {rid}: prefill extras (multimodal "
                             f"inputs) are {_LATER}")
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
        handle = RequestHandle(request_id=rid, request=request,
                               prompt_len=prompt_len)
        self.handles[rid] = handle
        self.scheduler.submit(handle)
        return handle

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
        with _schemes.use_policy(self.policy):
            logits, _ = self._chunk_fn(
                self.params, torch.from_numpy(toks).to(self.device),
                gather_row(self.slots.cache, slot), offset, nvalid)
        h.prefill_pos = offset + nvalid
        if h.prefill_pos == h.prompt_len:
            self.scheduler.mark_running(h)
            h.pos = h.prompt_len
            sp = h.request.sampling
            tok = self._sample(logits[0], h.seed, 0, sp.temperature)
            norm = self._norms(logits)[0] if self.ec.track_stats else None
            self._record(h, tok, norm, events)

    def _decode_tick(self, running: Dict[int, RequestHandle],
                     events: List[TokenEvent]) -> None:
        """One decode position for every running slot, one slot at a time
        through the batch-1 decode step under the engine's Policy (as a
        prefill chunk runs); then ONE telemetry launch over the whole
        [max_slots, vocab] logit batch (rows of idle slots are zero)."""
        logits = torch.zeros((self.ec.max_slots, self.cfg.padded_vocab),
                             dtype=torch.float32, device=self.device)
        toks: Dict[int, int] = {}
        for slot, h in running.items():
            tok_in = torch.tensor([h.tokens[-1]], device=self.device)
            with _schemes.use_policy(self.policy):
                row_logits = self.model.decode_step(
                    self.params, gather_row(self.slots.cache, slot), tok_in,
                    h.pos)
            logits[slot] = row_logits[0]
            toks[slot] = self._sample(row_logits[0], h.seed, h.emitted,
                                      h.request.sampling.temperature)
        norms = self._norms(logits).cpu() if self.ec.track_stats else None
        for slot, h in running.items():
            h.pos += 1
            self._record(h, toks[slot],
                         None if norms is None else norms[slot], events)

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
            self._finished.append(h.request_id)
            if self.ec.max_finished is not None:
                while len(self._finished) > self.ec.max_finished:
                    self.handles.pop(self._finished.popleft(), None)
        events.append(TokenEvent(h.request_id, token, nval, done))

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
