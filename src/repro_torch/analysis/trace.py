"""Trace-level contract rules: audit recorded op logs, not source text.

Counterpart of ``repro/analysis/trace.py``. The reference traces each
registered entry point with ``jax.make_jaxpr`` and audits the jaxpr. The
port has no traced program: an eager call runs op by op, and the kernels
launch through ctypes, which ``torch.export`` and ``fx`` cannot see
through. Its counterpart of the jaxpr is the **op log** of one eager call
of the entry point on CPU tensors at tiny shapes (``record``):

- every aten op (and collective) the call dispatches, through a
  ``TorchDispatchMode`` as ``perf/roofline.py``'s ``DeviceCounter`` is;
- every call of one of ``core/kahan.py``'s rounding op functions
  (``add``, ``sub``, ``mul``, ``div``, the fused ``_fma`` / ``_exact_fma``,
  ``flush``, ``promote``) as ONE entry ``kahan.<fn>``, whatever aten ops
  emulate its rounding on the CPU: each is one instruction on the card,
  as the reference's jaxpr shows ``add`` / ``mul`` before XLA lowers them;
- every kernel entry (``kernel.<wrapper>``): on CPU tensors the plain
  version's ops follow it in the log; on fake tensors (the sharded targets
  in the dry run's fake world) the wrapper records its own work
  (``kernels.abstract.record``) and runs nothing.

A target may also mark calls of its own (``call.<name>``, e.g. the model's
``decode_step``) and regions (``region``: the cost level's scheme folds).
A *trace rule* runs over a target's ``TraceArtifact`` and yields the AST
layer's ``Violation`` objects, anchored ``target:0:0``.

=============================  ==========================================
trace-no-raw-psum              no float all-reduce / reduce-scatter (eager
                               c10d or functional) in a sharded target's
                               log — catches what the AST rule cannot see
trace-barrier-pinned           the registered shared block body (flash's
                               ``flash_block_update``, the prefill's
                               per-position step) appears as one
                               contiguous op sequence in the kernel's and
                               the oracle's logs (eager torch has no
                               barriers: the containment is what ports)
trace-decode-is-scan           under ``slot_loop="scan"`` a tick runs
                               ``decode_step`` once per running slot, at
                               batch 1, in slot order (fires on "vmap")
trace-accum-dtype              every float op output in a kernel target's
                               log carries the resolved compute dtype
trace-no-host-callback         no device-to-host copy or
                               ``aten._local_scalar_dense`` (``.item()``,
                               ``int()`` of a tensor) in a serving log
trace-program-count            the prefill (width, runs_begin) keys stay
                               within the O(#buckets) bound
=============================  ==========================================

The reference's seventh trace rule, ``trace-barrier-survives-fusion``,
checks compiled truth (optimized HLO); its counterpart is the SASS nvcc
makes, so it lives at the cost level under ``--sass``
(``analysis/costmodel.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Tuple,
)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.core import LintReport, Pragma, Violation

TraceChecker = Callable[[Any, Any], Iterator[Violation]]


@dataclasses.dataclass(frozen=True)
class TraceRule:
    """One run-time clause of the engine contract.

    id        exemption-addressable identifier (``Target.exempt`` key)
    tags      a rule runs on every target sharing at least one tag
    checker   generator over (target, artifact) yielding Violations
    fix_hint  one-line remediation appended to findings
    doc       one-line statement of the clause (--trace --list-rules)
    """

    id: str
    tags: Tuple[str, ...]
    checker: TraceChecker
    fix_hint: str
    doc: str

    def applies_to(self, target) -> bool:
        return bool(set(self.tags) & set(target.tags))


_REGISTRY: Dict[str, TraceRule] = {}


def register(rule: TraceRule, *, override: bool = False) -> TraceRule:
    """Add a trace rule (same registry contract as ``rules.register``)."""
    if not isinstance(rule, TraceRule):
        raise TypeError(f"expected TraceRule, got {type(rule)!r}")
    if rule.id in _REGISTRY and not override:
        raise ValueError(
            f"trace rule {rule.id!r} already registered "
            f"(pass override=True to replace)")
    _REGISTRY[rule.id] = rule
    return rule


def unregister(rule_id: str) -> None:
    """Remove a trace rule (tests / plugin teardown)."""
    _REGISTRY.pop(rule_id, None)


def names() -> Tuple[str, ...]:
    """Registered trace-rule ids, registration order."""
    return tuple(_REGISTRY)


def registered() -> Dict[str, TraceRule]:
    """Snapshot of the registry."""
    return dict(_REGISTRY)


def get(rule_id: str) -> TraceRule:
    """Fail-fast lookup with the registered menu."""
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        raise ValueError(
            f"unknown trace rule {rule_id!r}; registered trace rules: "
            f"{sorted(_REGISTRY)}") from None


def select(rule_ids: Optional[Iterable[str]]) -> List[TraceRule]:
    """All trace rules, or a validated subset."""
    if rule_ids is None:
        return list(_REGISTRY.values())
    return [get(r) for r in rule_ids]


# ---------------------------------------------------------------------------
# The op log
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Op:
    """One entry of an op log.

    name       "aten.<op>.<overload>", "c10d.<op>", "kahan.<fn>",
               "kernel.<wrapper>" or "call.<name>"
    dtypes     dtypes of the entry's floating tensor outputs
    numel      elements of its first tensor output (0: none)
    in_dtypes  dtypes of its floating tensor inputs
    devices    devices of its tensor outputs
    region     the innermost ``region`` it ran in ("" outside any)
    step       the region's step (a scheme fold's step index), or None
    meta       facts a ``call.*`` entry or a region marker carries
    """

    name: str
    dtypes: Tuple[str, ...] = ()
    numel: int = 0
    in_dtypes: Tuple[str, ...] = ()
    devices: Tuple[str, ...] = ()
    region: str = ""
    step: Optional[int] = None
    meta: Tuple = ()


#: ``core.kahan``'s rounding op functions: one entry each, whatever
#: emulates them on the CPU
KAHAN_OPS = ("add", "sub", "mul", "div", "_fma", "_exact_fma", "flush",
             "promote")

#: kernel modules whose ``_launch`` is every wrapper's one entry
_KERNEL_MODULES = ("kahan_dot", "kahan_sum", "kahan_matmul",
                   "flash_attention", "kahan_columns")


class _State(threading.local):
    log: Optional[List[Op]] = None
    depth: int = 0
    region: str = ""
    step: Optional[int] = None


_STATE = _State()


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _float_dtypes(tensors) -> Tuple[str, ...]:
    return tuple(str(t.dtype).removeprefix("torch.") for t in tensors
                 if t.is_floating_point())


def _append(name: str, out=None, args=(), meta: Tuple = ()) -> None:
    outs = _tensors(out)
    _STATE.log.append(Op(
        name=name, dtypes=_float_dtypes(outs),
        numel=outs[0].numel() if outs else 0,
        in_dtypes=_float_dtypes(_tensors(args)),
        devices=tuple(t.device.type for t in outs),
        region=_STATE.region, step=_STATE.step, meta=meta))


def note(name: str, out=None, meta: Tuple = ()) -> None:
    """Append a ``name`` entry to the op log being recorded (no-op
    outside ``record``)."""
    if _STATE.log is not None and _STATE.depth == 0:
        _append(name, out, meta=meta)


@contextlib.contextmanager
def region(label: str, step: Optional[int] = None) -> Iterator[None]:
    """Tag every entry recorded inside with ``label`` (and ``step``)."""
    saved = (_STATE.region, _STATE.step)
    _STATE.region, _STATE.step = label, step
    try:
        yield
    finally:
        _STATE.region, _STATE.step = saved


@contextlib.contextmanager
def quiet() -> Iterator[None]:
    """Record nothing inside (an instrument's own reads)."""
    _STATE.depth += 1
    try:
        yield
    finally:
        _STATE.depth -= 1


class _Dispatch(TorchDispatchMode):
    """Logs every op dispatched outside a ``kahan.*`` entry."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _STATE.log is not None and _STATE.depth == 0:
            name = f"{func.namespace}.{func.__name__}"
            _append(name, out, (args, kwargs), meta=_meta(name, func, args))
        return out


def _meta(name: str, func, args) -> Tuple:
    """A copy's source device (("src", "cuda")); a reducing collective's
    reduce op (``_reduce_meta``)."""
    if name.startswith(_COPIES):
        inputs = _tensors(args)
        return (("src", inputs[-1].device.type),) if inputs else ()
    return _reduce_meta(func, args)


def _reduce_meta(func, args) -> Tuple:
    """The reduce op of an all-reduce / reduce-scatter: ("op", "sum")."""
    name = func.__name__.split(".")[0]
    if name not in _REDUCING:
        return ()
    if func.namespace == "_c10d_functional" and len(args) > 1:
        # the functional collectives name the op: "sum", "max", ...
        return (("op", str(args[1]).lower()),)
    if func.namespace == "c10d" and len(args) > 2 \
            and hasattr(args[2], "op"):
        # c10d's ReduceOp script object: ``op()`` is its RedOpType code
        code = args[2].op()
        return (("op", _RED_OP_TYPES[code] if 0 <= code < len(
            _RED_OP_TYPES) else str(code)),)
    return (("op", "sum"),)


#: ``torch.distributed.ReduceOp.RedOpType`` by code
_RED_OP_TYPES = ("sum", "avg", "product", "min", "max", "band", "bor",
                 "bxor", "premul_sum")


def _op_wrapper(fn, label: str):
    def op(*args, **kwargs):
        outer = _STATE.log is not None and _STATE.depth == 0
        _STATE.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            _STATE.depth -= 1
        if outer:
            _append(label, out, args)
        return out
    op.__wrapped__ = fn
    return op


def _launch_wrapper(fn):
    def launch(*args, **kwargs):
        counter = kwargs.get("counter") or next(
            (a for a in args if callable(a) and hasattr(a, "launches")),
            None)
        out = fn(*args, **kwargs)
        note(f"kernel.{getattr(counter, '__name__', fn.__module__)}", out,
             meta=tuple(sorted((k, v) for k, v in kwargs.items()
                               if isinstance(v, (int, bool, str)))))
        return out
    launch.__wrapped__ = fn
    return launch


@contextlib.contextmanager
def record(log: Optional[List[Op]] = None) -> Iterator[List[Op]]:
    """Record the op log of the code run inside into ``log`` (a new list
    unless given): ``core.kahan``'s op functions and every kernel
    module's ``_launch`` are wrapped for the duration, and a dispatch
    mode logs the aten ops outside them."""
    import importlib
    import sys

    from repro_torch.core import kahan as K

    if _STATE.log is not None:
        raise RuntimeError("op logs do not nest")
    log = [] if log is None else log
    # the op functions under every name a port module bound them to
    # (``from repro_torch.core.kahan import add``)
    ops = {id(getattr(K, n)): _op_wrapper(getattr(K, n), f"kahan.{n}")
           for n in KAHAN_OPS}
    patches = [(mod, attr, ops[id(val)])
               for name, mod in list(sys.modules.items())
               if name.startswith("repro_torch.") and mod is not None
               for attr, val in list(vars(mod).items()) if id(val) in ops]
    for mod_name in _KERNEL_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        if hasattr(mod, "_launch"):
            patches.append((mod, "_launch", _launch_wrapper(mod._launch)))
    saved = [(owner, n, getattr(owner, n)) for owner, n, _ in patches]
    for owner, n, fn in patches:
        setattr(owner, n, fn)
    _STATE.log = log
    try:
        with _Dispatch():
            yield log
    finally:
        _STATE.log = None
        for owner, n, fn in saved:
            setattr(owner, n, fn)


def op_log(fn: Callable, *args, **kwargs) -> Tuple[List[Op], Any]:
    """(op log, result) of one call ``fn(*args, **kwargs)``."""
    with record() as log:
        out = fn(*args, **kwargs)
    return log, out


@contextlib.contextmanager
def marking(owner, attr: str, label: str,
            meta: Callable[..., Tuple] = lambda *a, **k: ()):
    """Log each call of ``owner.<attr>`` as a ``call.<label>`` entry
    (before its ops), with ``meta(*args, **kwargs)`` read quietly."""
    fn = getattr(owner, attr)

    def marked(*args, **kwargs):
        with quiet():
            facts = meta(*args, **kwargs)
        note(f"call.{label}", meta=facts)
        return fn(*args, **kwargs)

    own = attr in vars(owner)
    setattr(owner, attr, marked)
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, fn)
        else:
            delattr(owner, attr)


def op_names(log: List[Op]) -> List[str]:
    """The name sequence of a log — what the containment checks compare
    (the reference's ``primitive_seq``)."""
    return [op.name for op in log]


def contains_subsequence(hay: List[str], needle: List[str]) -> bool:
    """True when ``needle`` appears as a CONTIGUOUS run inside ``hay``."""
    n = len(needle)
    if n == 0:
        return True
    return any(hay[i:i + n] == needle for i in range(len(hay) - n + 1))


def _v(target, rule: str, message: str) -> Violation:
    return Violation(rule=rule, path=target.id, line=0, col=0,
                     message=message)


# ---------------------------------------------------------------------------
# Built-in trace rules
# ---------------------------------------------------------------------------

#: collectives that sum floats in the backend's order (eager c10d and
#: functional spellings)
_REDUCING = frozenset(("allreduce_", "allreduce_coalesced_", "all_reduce",
                       "all_reduce_", "all_reduce_coalesced",
                       "all_reduce_coalesced_", "reduce_scatter_",
                       "_reduce_scatter_base_", "reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced", "reduce_"))
_ORDER_FREE = frozenset(("max", "min", "band", "bor", "bxor"))
_HOST_READS = frozenset(("aten._local_scalar_dense.default",
                         "aten.item.default"))
_COPIES = ("aten._to_copy.", "aten.copy_.", "aten.to.")


def _check_no_raw_psum(target, art) -> Iterator[Violation]:
    for op in art.log or ():
        ns, _, rest = op.name.partition(".")
        if ns in ("c10d", "_c10d_functional") \
                and rest.split(".")[0] in _REDUCING \
                and (op.in_dtypes or op.dtypes) \
                and dict(op.meta).get("op", "sum") not in _ORDER_FREE:
            yield _v(target, "trace-no-raw-psum",
                     f"float {op.name} in the recorded log — the backend "
                     f"picks its reduction order")


def _check_barrier_pinned(target, art) -> Iterator[Violation]:
    if art.body_log is None:
        return
    body = op_names(art.body_log)
    if not body:
        yield _v(target, "trace-barrier-pinned",
                 "the registered shared block body records ZERO ops")
        return
    for label, log in (("kernel", art.log), ("oracle", art.oracle_log)):
        if log is None:
            continue
        if not contains_subsequence(op_names(log), body):
            yield _v(target, "trace-barrier-pinned",
                     f"{label} log does not contain the shared block "
                     f"body's {len(body)}-op sequence contiguously — the "
                     f"body ran differently in context")


def _check_decode_is_scan(target, art) -> Iterator[Violation]:
    if art.slot_positions is None:
        return
    calls = [dict(op.meta) for op in art.log or ()
             if op.name == "call.decode_step"]
    want = [{"batch": 1, "pos": (p,)} for p in art.slot_positions]
    if calls != want:
        got = [(c.get("batch"), c.get("pos")) for c in calls]
        yield _v(target, "trace-decode-is-scan",
                 f"the tick ran decode_step as {got} (batch, positions); "
                 f"the scan runs it once per running slot at batch 1 in "
                 f"slot order {list(art.slot_positions)} — a batched "
                 f"(vmapped) tick's rounding depends on the batch")


def _check_accum_dtype(target, art) -> Iterator[Violation]:
    if art.log is None or art.compute_dtype is None:
        return
    want = str(art.compute_dtype).removeprefix("torch.")
    offending: Dict[Tuple[str, str], int] = {}
    for op in art.log:
        for dt in op.dtypes:
            if dt != want:
                offending[(op.name, dt)] = offending.get((op.name, dt), 0) + 1
    for (name, dt), count in sorted(offending.items()):
        yield _v(target, "trace-accum-dtype",
                 f"{count} {name} output(s) carry float dtype {dt}; the "
                 f"resolved Policy.compute_dtype is {want}")


def _check_no_host_callback(target, art) -> Iterator[Violation]:
    for op in art.log or ():
        if op.name in _HOST_READS:
            yield _v(target, "trace-no-host-callback",
                     f"{op.name} in a serving log — the host waits for the "
                     f"card on every execution")
        elif op.name.startswith(_COPIES) and "cpu" in op.devices \
                and dict(op.meta).get("src") not in (None, "cpu"):
            yield _v(target, "trace-no-host-callback",
                     f"{op.name} copies to the host in a serving log")


def _check_program_count(target, art) -> Iterator[Violation]:
    if art.program_keys is None or art.program_bound is None:
        return
    n = len(set(art.program_keys))
    if n > art.program_bound:
        yield _v(target, "trace-program-count",
                 f"prefill key family has {n} (width, runs_begin) keys, "
                 f"exceeding the O(#buckets) bound of {art.program_bound} "
                 f"— per-prompt-length programs are back")


for _rule in (
    TraceRule(
        id="trace-no-raw-psum",
        tags=("sharded",),
        checker=_check_no_raw_psum,
        fix_hint="all-gather the (s, c) grids and fold through "
                 "engine.merge_accumulator_grids (distributed.collectives)",
        doc="no float all-reduce / reduce-scatter anywhere in sharded "
            "entry-point logs — catches dynamically constructed "
            "reductions the AST rule cannot see",
    ),
    TraceRule(
        id="trace-barrier-pinned",
        tags=("shared-block",),
        checker=_check_barrier_pinned,
        fix_hint="route the computation through the registered shared "
                 "body (flash_block_update / the model's per-position "
                 "step in prefill_chunk_scan)",
        doc="the shared block body runs as the identical contiguous op "
            "sequence in kernel and oracle logs",
    ),
    TraceRule(
        id="trace-decode-is-scan",
        tags=("decode",),
        checker=_check_decode_is_scan,
        fix_hint="keep EngineConfig.slot_loop='scan' (vmap forfeits the "
                 "bitwise slot-placement guarantee)",
        doc="the decode tick runs decode_step once per running slot, at "
            "batch 1, in slot order",
    ),
    TraceRule(
        id="trace-accum-dtype",
        tags=("kernel",),
        checker=_check_accum_dtype,
        fix_hint="thread the engine's compute_dtype through (Policy."
                 "compute_dtype is the accumulate-dtype authority)",
        doc="every float op output in kernel logs uses the resolved "
            "Policy.compute_dtype",
    ),
    TraceRule(
        id="trace-no-host-callback",
        tags=("serve",),
        checker=_check_no_host_callback,
        fix_hint="keep tick and chunk bodies on the card; read values at "
                 "the engine's host emit point (InferenceEngine._emit)",
        doc="no device-to-host copy or _local_scalar_dense in serving "
            "logs",
    ),
    TraceRule(
        id="trace-program-count",
        tags=("program-count",),
        checker=_check_program_count,
        fix_hint="set a finite EngineConfig.prefill_chunk so tail chunks "
                 "bucket to powers of two",
        doc="the prefill key family stays within the O(#buckets) bound "
            "(serve.engine.prefill_program_bound)",
    ),
):
    register(_rule)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def audit(target_ids: Optional[Iterable[str]] = None,
          rule_ids: Optional[Iterable[str]] = None) -> LintReport:
    """Run trace rules over registered targets -> a ``LintReport``.

    Findings anchor ``target:0:0``, per-target exemptions surface as
    ``Pragma`` entries (``used`` marks whether they suppressed a live
    finding), and a target whose build raises becomes a
    ``trace-build-error`` violation rather than aborting the audit.
    """
    from repro_torch.analysis import targets as _targets

    report = LintReport()
    rules = select(rule_ids)
    for target in _targets.select(target_ids):
        applicable = [r for r in rules if r.applies_to(target)]
        if not applicable:
            continue
        report.files += 1
        try:
            art = target.build()
        except Exception as e:  # noqa: BLE001 — any build failure is a finding
            report.violations.append(Violation(
                rule="trace-build-error", path=target.id, line=0, col=0,
                message=f"target build failed: {type(e).__name__}: {e}",
                fix_hint="fix the registered build in analysis/targets.py "
                         "(a target that cannot run cannot be audited)"))
            continue
        for rule in applicable:
            found = [dataclasses.replace(v, fix_hint=v.fix_hint
                                         or rule.fix_hint)
                     for v in rule.checker(target, art)]
            if rule.id in target.exempt:
                report.exemptions.append(Pragma(
                    rule=rule.id, reason=target.exempt[rule.id],
                    path=target.id, line=0, comment_line=0,
                    used=bool(found)))
                continue
            report.violations.extend(found)
    report.violations.sort(key=lambda v: (v.path, v.rule))
    return report
