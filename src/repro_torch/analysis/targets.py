"""Registry of auditable trace targets (counterpart of
``repro/analysis/targets.py``, with the reference's target ids).

A *target* bundles what one entry point needs to be audited: a build
callable producing a :class:`TraceArtifact` (the op log of one eager call
of the real entry point on CPU tensors, optionally an oracle's log, the
standalone shared-body log, the prefill key family), a tag set that
scopes which trace rules run on it, and per-target exemptions (rule id ->
mandatory reason, audited in the report like a source pragma).

The built-ins cover the port's numerics surface at tiny shapes: the
``ops.*`` engine entries, flash B7/B8 with their oracle and shared block
body, the serving engine's decode tick and every prefill bucket program
(dense, flash and paged), the sharded collectives in the dry run's fake
world (``launch/dryrun.py::fake_world``) and the optimizer's
``engine_sq_norm``. Builds are memoized and lazy: importing this module
registers targets and runs nothing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Tuple,
)

import numpy as np
import torch

from repro_torch.analysis import trace as _trace


@dataclasses.dataclass
class TraceArtifact:
    """What one build produced — each field feeds specific trace rules.

    log             the target's op log (most rules)
    oracle_log      the plain oracle's op log (trace-barrier-pinned)
    body_log        the standalone shared-body op log (trace-barrier-
                    pinned containment reference)
    compute_dtype   resolved accumulate dtype (trace-accum-dtype)
    slot_positions  the running slots' positions in slot order
                    (trace-decode-is-scan)
    program_keys    prefill (width, runs_begin) family
                    (trace-program-count)
    program_bound   the O(#buckets) cap on that family
    work            kernel entries' abstract records (fake-tensor runs)
    """

    log: Optional[List[_trace.Op]] = None
    oracle_log: Optional[List[_trace.Op]] = None
    body_log: Optional[List[_trace.Op]] = None
    compute_dtype: Any = None
    slot_positions: Optional[Tuple[int, ...]] = None
    program_keys: Optional[frozenset] = None
    program_bound: Optional[int] = None
    work: Optional[Dict[str, Dict[str, float]]] = None


@dataclasses.dataclass(frozen=True)
class Target:
    """One auditable entry point.

    id       stable identifier (the finding anchor: ``<id>:0:0``)
    build    () -> TraceArtifact (memoized below)
    tags     trace rules run on any tag overlap ("kernel", "sharded",
             "serve", "decode", "prefill", "shared-block",
             "program-count"; the cost level's "cost", "sass")
    doc      one-line description (--trace --list-rules)
    exempt   rule id -> reason; suppresses that rule's findings on this
             target, surfaced in the report exactly like a source pragma
    """

    id: str
    build: Callable[[], Any]
    tags: Tuple[str, ...]
    doc: str
    exempt: Mapping[str, str] = dataclasses.field(default_factory=dict)


_REGISTRY: Dict[str, Target] = {}


def register(target: Target, *, override: bool = False) -> Target:
    """Add a target (same registry contract as ``rules.register``)."""
    if not isinstance(target, Target):
        raise TypeError(f"expected Target, got {type(target)!r}")
    if target.id in _REGISTRY and not override:
        raise ValueError(
            f"trace target {target.id!r} already registered "
            f"(pass override=True to replace)")
    _REGISTRY[target.id] = target
    return target


def unregister(target_id: str) -> None:
    """Remove a target (tests / plugin teardown)."""
    _REGISTRY.pop(target_id, None)


def names() -> Tuple[str, ...]:
    """Registered target ids, registration order."""
    return tuple(_REGISTRY)


def registered() -> Dict[str, Target]:
    """Snapshot of the registry."""
    return dict(_REGISTRY)


def get(target_id: str) -> Target:
    """Fail-fast lookup with the registered menu."""
    try:
        return _REGISTRY[target_id]
    except KeyError:
        raise ValueError(
            f"unknown trace target {target_id!r}; registered targets: "
            f"{sorted(_REGISTRY)}") from None


def select(target_ids: Optional[Iterable[str]]) -> List[Target]:
    """All targets, or a validated subset."""
    if target_ids is None:
        return list(_REGISTRY.values())
    return [get(t) for t in target_ids]


# ---------------------------------------------------------------------------
# Shared tiny fixtures (memoized)
# ---------------------------------------------------------------------------

#: the audit runs every target eagerly on CPU tensors
AUDIT_DEVICE = "cpu"

#: audit shapes (the reference's): big enough to exercise blocking, small
#: enough that the whole audit stays within seconds
_N = 64
_MM = 8
_FLASH = (2, 8, 8)          # (batch*heads, seq, head_dim)
_FLASH_BLOCK = 8

#: tiny serving config: max_slots deliberately != n_layers
_SLOTS = 3
_MAX_LEN = 16
_CHUNK = 4
_PAGE = 4


def data(*shape: int, seed: int = 0, dtype=torch.float32) -> torch.Tensor:
    """Seeded normal values of ``shape`` on the audit device."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


@functools.lru_cache(maxsize=None)
def tiny_arch():
    """The audit's model config (the reference's tiny dense config)."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                      param_dtype="float32", compute_dtype="float32",
                      loss_chunk=64)


@functools.lru_cache(maxsize=None)
def tiny_flash_arch():
    """Flash-capable twin of :func:`tiny_arch`: ``kahan_attention=True``
    routes the parallel chunk body through the chunk flash kernel."""
    return dataclasses.replace(tiny_arch(), name="tiny-flash",
                               kahan_attention=True)


def _engine(arch, **ec):
    from repro_torch.serve import EngineConfig, InferenceEngine

    return InferenceEngine(arch, EngineConfig(
        max_slots=_SLOTS, max_len=_MAX_LEN, prefill_chunk=_CHUNK, **ec),
        device=AUDIT_DEVICE)


#: one engine a role: the tick engine fills its slots, the prefill
#: engines admit one probe a width
_tiny_tick = functools.lru_cache(maxsize=None)(lambda: _engine(tiny_arch()))
_tiny_prefill = functools.lru_cache(maxsize=None)(
    lambda: _engine(tiny_arch()))
_tiny_flash = functools.lru_cache(maxsize=None)(
    lambda: _engine(tiny_flash_arch(), prefill_mode="flash"))
_tiny_paged_tick = functools.lru_cache(maxsize=None)(
    lambda: _engine(tiny_arch(), kv_layout="paged", page_size=_PAGE))
_tiny_paged_prefill = functools.lru_cache(maxsize=None)(
    lambda: _engine(tiny_arch(), kv_layout="paged", page_size=_PAGE))


@functools.lru_cache(maxsize=None)
def _engine_compute_dtype():
    from repro_torch.kernels.engine import CompensatedReduction

    return CompensatedReduction().compute_dtype


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _ops_build(name: str, *shapes) -> Callable[[], TraceArtifact]:
    @functools.lru_cache(maxsize=None)
    def build() -> TraceArtifact:
        from repro_torch.kernels import ops

        args = [data(*s, seed=i) for i, s in enumerate(shapes)]
        log, _ = _trace.op_log(getattr(ops, name), *args)
        return TraceArtifact(log=log, compute_dtype=_engine_compute_dtype())

    return build


def flash_body_log(*, dh: int, block_q: int, block_k: int, kv_len: int,
                   causal: bool = True) -> List[_trace.Op]:
    """The op log of ONE ``flash_block_update`` (kahan) at a block
    geometry, run standalone: the shared body the B7/B8 plain versions
    and the oracle must contain (the reference's ``flash_block_probe``)."""
    from repro_torch.kernels import schemes
    from repro_torch.kernels.flash_attention import (
        NEG_INF,
        flash_block_update,
        softmax_scale,
    )

    q = data(1, block_q, dh, seed=1)
    k = data(1, block_k, dh, seed=2)
    v = data(1, block_k, dh, seed=3)
    m = torch.full((1, block_q, 1), NEG_INF)
    l_s = torch.zeros((1, block_q, 1))
    a_s = torch.zeros((1, block_q, dh))
    log, _ = _trace.op_log(
        flash_block_update, schemes.get("kahan"), q, k, v, m, l_s,
        torch.zeros_like(l_s), a_s, torch.zeros_like(a_s),
        q_pos=torch.arange(block_q)[:, None],
        k_pos=torch.arange(block_k)[None, :], kv_len=kv_len, causal=causal,
        scale=softmax_scale(dh), step=0)
    return log


@functools.lru_cache(maxsize=None)
def _flash_build() -> TraceArtifact:
    from repro_torch.kernels import ref as _ref
    from repro_torch.kernels.engine import CompensatedReduction

    eng = CompensatedReduction(scheme="kahan")
    q = data(*_FLASH)
    log, _ = _trace.op_log(eng.flash_attention, q, q, q,
                           block_q=_FLASH_BLOCK, block_k=_FLASH_BLOCK)
    oracle, _ = _trace.op_log(_ref.flash_attention_ref, q, q, q,
                              scheme="kahan", block_q=_FLASH_BLOCK,
                              block_k=_FLASH_BLOCK)
    body = flash_body_log(dh=_FLASH[2], block_q=_FLASH_BLOCK,
                          block_k=_FLASH_BLOCK, kv_len=_FLASH[1])
    return TraceArtifact(log=log, oracle_log=oracle, body_log=body,
                         compute_dtype=eng.compute_dtype)


@functools.lru_cache(maxsize=None)
def _flash_chunk_build() -> TraceArtifact:
    from repro_torch.kernels.engine import CompensatedReduction

    eng = CompensatedReduction(scheme="kahan")
    q, kv = data(*_FLASH), data(*_FLASH, seed=1)
    log, _ = _trace.op_log(eng.flash_chunk_attention, q, kv, kv, q_off=3,
                           block_q=_FLASH_BLOCK, block_k=_FLASH_BLOCK)
    body = flash_body_log(dh=_FLASH[2], block_q=_FLASH_BLOCK,
                          block_k=_FLASH_BLOCK, kv_len=_FLASH[1])
    return TraceArtifact(log=log, body_log=body,
                         compute_dtype=eng.compute_dtype)


@functools.lru_cache(maxsize=None)
def _sq_norm_build() -> TraceArtifact:
    from repro_torch.optim.adamw import engine_sq_norm

    grads = {"w": data(_MM, _MM), "b": data(_MM, seed=1)}
    log, _ = _trace.op_log(engine_sq_norm, grads)
    return TraceArtifact(log=log, compute_dtype=_engine_compute_dtype())


def _sharded_build(name: str, *shapes) -> Callable[[], TraceArtifact]:
    """A collective run once in the dry run's fake world (a fake process
    group of the production mesh's 256 ranks, rank 0, on fake tensors):
    ``shapes`` are per-rank, scaled by the world on the sharded axis."""
    @functools.lru_cache(maxsize=None)
    def build() -> TraceArtifact:
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.distributed import collectives
        from repro_torch.kernels import abstract
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_local_mesh

        fn = getattr(collectives, name)
        work: dict = {}
        with fake_world(False) as world:
            mesh = make_local_mesh(device=AUDIT_DEVICE)
            with FakeTensorMode():
                args = [torch.empty(*[d * world if i == axis else d
                                      for i, d in enumerate(s)])
                        for s, axis in shapes]
                with abstract.recording(work):
                    log, _ = _trace.op_log(fn, mesh, *args)
        return TraceArtifact(log=log, work=work)

    return build


def _marked_log(engine, fn: Callable, args) -> List[_trace.Op]:
    """The op log of ``fn(*args)`` with each of the engine model's
    ``decode_step`` calls marked (``call.decode_step``: batch, positions)."""
    def facts(params, cache, tokens, pos):
        p = pos.tolist() if isinstance(pos, torch.Tensor) else [pos]
        return (("batch", int(tokens.shape[0])), ("pos", tuple(p)))

    with _trace.marking(engine.model, "decode_step", "decode_step",
                        facts):
        log, _ = _trace.op_log(fn, *args)
    return log


def _tick_build(engine_fn) -> Callable[[], TraceArtifact]:
    @functools.lru_cache(maxsize=None)
    def build() -> TraceArtifact:
        engine = engine_fn()
        fn, args = engine.trace_tick()
        positions = tuple(h.pos for _, h in sorted(args[0].items()))
        return TraceArtifact(log=_marked_log(engine, fn, args),
                             slot_positions=positions)

    return build


def prefill_widths() -> Tuple[int, ...]:
    """The audit engine's chunk-width family (power-of-two tail buckets
    up to the chunk, plus the chunk itself)."""
    from repro_torch.serve.engine import prefill_program_family

    fam = prefill_program_family(_MAX_LEN, _CHUNK, needs_begin=False)
    return tuple(sorted({w for w, _ in fam}))


@functools.lru_cache(maxsize=None)
def _prefill_logs(engine_fn, widths: Tuple[int, ...]) -> Dict[int, Any]:
    """width -> op log of that bucket program (one engine a family)."""
    engine = engine_fn()
    out = {}
    for width in sorted(widths, reverse=True):
        fn, args = engine.trace_prefill(width, first=False)
        out[width] = _trace.op_log(fn, *args)[0]
    return out


@functools.lru_cache(maxsize=None)
def _prefill_body() -> List[_trace.Op]:
    """The per-position step of ``models.common.prefill_chunk_scan``, run
    standalone: one position (a width-1 chunk) of the dense model through
    its own ``prefill_chunk`` on a fresh cache row — the containment
    reference every bucket program must reproduce once per position."""
    engine = _tiny_prefill()
    model = engine.model
    row = model.init_cache(1, _MAX_LEN)
    toks = torch.ones((1, 1), dtype=torch.int64)
    return _trace.op_log(model.prefill_chunk, engine.params, toks, row,
                         0, 1)[0]


def _prefill_build(width: int) -> Callable[[], TraceArtifact]:
    def build() -> TraceArtifact:
        return TraceArtifact(
            log=_prefill_logs(_tiny_prefill, prefill_widths())[width],
            body_log=_prefill_body())

    return build


@functools.lru_cache(maxsize=None)
def _prefill_flash_body(dh: int, block_k: int) -> List[_trace.Op]:
    return flash_body_log(dh=dh, block_q=8, block_k=block_k,
                          kv_len=_MAX_LEN)


def _prefill_flash_build(width: int) -> Callable[[], TraceArtifact]:
    def build() -> TraceArtifact:
        engine = _tiny_flash()
        if engine.prefill_body != "flash":
            raise RuntimeError("the audit's flash engine resolved to the "
                               "scan body")
        log = _prefill_logs(_tiny_flash, prefill_widths())[width]
        body = None
        if width > 1:
            # the chunk flash kernel's block at the engine's resolved
            # geometry: block_q the 8-padded width, block_k clamped to
            # the 128-padded cache
            body = _prefill_flash_body(tiny_flash_arch().head_dim,
                                       min(256, -(-_MAX_LEN // 128) * 128))
        return TraceArtifact(log=log, body_log=body)

    return build


@functools.lru_cache(maxsize=None)
def _paged_prefill_build() -> TraceArtifact:
    return TraceArtifact(
        log=_prefill_logs(_tiny_paged_prefill, (_CHUNK,))[_CHUNK],
        body_log=_prefill_body())


def _family_build() -> TraceArtifact:
    from repro_torch.serve.engine import (
        prefill_program_bound,
        prefill_program_family,
    )

    return TraceArtifact(
        program_keys=prefill_program_family(_MAX_LEN, _CHUNK,
                                            needs_begin=False),
        program_bound=prefill_program_bound(_CHUNK, needs_begin=False))


def _engine_family_build(engine_fn) -> Callable[[], TraceArtifact]:
    """The keys the engine itself fed its prefill over a trace of every
    prompt length 1..max_len - 1 (one new token each), against the bound:
    the family sweep and what the engine really ran must both fit."""
    @functools.lru_cache(maxsize=None)
    def build() -> TraceArtifact:
        from repro_torch.serve import Request, SamplingParams
        from repro_torch.serve.engine import prefill_program_bound

        engine = engine_fn()
        engine.run([Request(prompt=list(range(1, n + 1)),
                            sampling=SamplingParams(max_new_tokens=1))
                    for n in range(1, _MAX_LEN)])
        fam = _family_build()
        return TraceArtifact(
            program_keys=fam.program_keys | frozenset(
                engine.prefill_programs),
            program_bound=prefill_program_bound(_CHUNK, needs_begin=False))

    return build


# ---------------------------------------------------------------------------
# Built-in targets (the reference's ids)
# ---------------------------------------------------------------------------

for _t in (
    Target(id="ops.dot", build=_ops_build("dot", (_N,), (_N,)),
           tags=("kernel",),
           doc="compensated dot product (engine entry, B1's plain version)"),
    Target(id="ops.asum", build=_ops_build("asum", (_N,)),
           tags=("kernel",),
           doc="compensated sum (engine entry, B3's plain version)"),
    Target(id="ops.batched_dot",
           build=_ops_build("batched_dot", (4, _N), (4, _N)),
           tags=("kernel",),
           doc="batched compensated dots (B2's plain version)"),
    Target(id="ops.batched_asum",
           build=_ops_build("batched_asum", (4, _N)),
           tags=("kernel",),
           doc="batched compensated sums (B4's plain version)"),
    Target(id="ops.matmul",
           build=_ops_build("matmul", (_MM, _MM), (_MM, _MM)),
           tags=("kernel",),
           doc="compensated matmul across K-blocks (B5's plain version)"),
    Target(id="ops.batched_matmul",
           build=_ops_build("batched_matmul", (2, _MM, _MM),
                            (2, _MM, _MM)),
           tags=("kernel",),
           doc="batched compensated matmuls (B6's plain version)"),
    Target(id="kernels.flash_attention", build=_flash_build,
           tags=("kernel", "shared-block"),
           doc="flash B7's plain version vs the oracle, sharing "
               "flash_block_update"),
    Target(id="kernels.flash_chunk_attention", build=_flash_chunk_build,
           tags=("kernel", "shared-block"),
           doc="chunked-prefill flash B8's plain version (queries at an "
               "offset) embedding the same flash_block_update"),
    Target(id="optim.engine_sq_norm", build=_sq_norm_build,
           tags=("kernel", "sharded"),
           doc="optimizer global-norm fold through the engine's merge "
               "tree"),
    Target(id="collectives.sharded_asum",
           build=_sharded_build("sharded_asum", ((_N,), 0)),
           tags=("sharded",),
           doc="cross-rank compensated sum (all-gather + two-sum tree)"),
    Target(id="collectives.sharded_dot",
           build=_sharded_build("sharded_dot", ((_N,), 0), ((_N,), 0)),
           tags=("sharded",),
           doc="cross-rank compensated dot (all-gather + two-sum tree)"),
    Target(id="collectives.sharded_matmul",
           build=_sharded_build("sharded_matmul", ((_MM, _MM), 1),
                                ((_MM, _MM), 0)),
           tags=("sharded",),
           doc="K-sharded compensated matmul (all-gather + grid merge)"),
    Target(id="collectives.deterministic_mean",
           build=_sharded_build("deterministic_mean", ((1,), 0)),
           tags=("sharded",),
           doc="bitwise-deterministic scalar mean over a mesh axis"),
    Target(id="serve.decode_tick", build=_tick_build(_tiny_tick),
           tags=("serve", "decode"),
           doc="the engine's decode tick over the running slots"),
    Target(id="serve.prefill_buckets",
           build=_engine_family_build(lambda: _engine(tiny_arch())),
           tags=("program-count",),
           doc="the prefill (width, runs_begin) family, and the keys the "
               "engine fed its prefill, vs the O(#buckets) bound"),
    Target(id="serve.prefill_flash_buckets",
           build=_engine_family_build(
               lambda: _engine(tiny_flash_arch(), prefill_mode="flash")),
           tags=("program-count",),
           doc="flash-mode prefill keys — the parallel body keeps the "
               "same O(#buckets) bound"),
    Target(id="serve.paged_decode_tick",
           build=_tick_build(_tiny_paged_tick),
           tags=("serve", "decode"),
           doc="paged decode tick: page-table gather/scatter around the "
               "same batch-1 decode step"),
    Target(id="serve.paged_prefill.w4", build=_paged_prefill_build,
           tags=("serve", "prefill", "shared-block"),
           doc="paged prefill program — must embed the dense engine's "
               "per-position step verbatim"),
    Target(id="serve.paged_prefill_buckets",
           build=_engine_family_build(
               lambda: _engine(tiny_arch(), kv_layout="paged",
                               page_size=_PAGE)),
           tags=("program-count",),
           doc="paged prefill keys — page tables keep placement out of "
               "the key, same O(#buckets) bound"),
):
    register(_t)

for _w in prefill_widths():
    register(Target(
        id=f"serve.prefill.w{_w}", build=_prefill_build(_w),
        tags=("serve", "prefill", "shared-block"),
        doc=f"prefill bucket program at chunk width {_w} (must embed the "
            f"per-position step verbatim)"))
    register(Target(
        id=f"serve.prefill_flash.w{_w}", build=_prefill_flash_build(_w),
        tags=(("serve", "prefill", "shared-block") if _w > 1
              else ("serve", "prefill")),
        doc=(f"flash-mode prefill program at chunk width {_w} (must embed "
             f"the flash block body verbatim)" if _w > 1 else
             "flash-mode width-1 bucket (runs the decode mode — no flash "
             "grid)")))
