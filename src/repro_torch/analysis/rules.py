"""The contract-rule registry and the built-in rules, for torch source.

Counterpart of ``repro/analysis/rules.py``: the same registry, the same
eight rule ids and the same clause for each, with checkers that resolve
torch names. A rule is a frozen dataclass bundling what one contract
clause needs (id, scope globs, checker, fix-hint, doc line);
``register()`` adds more at runtime, and every consumer (the CLI, the
self-lint test, pragma validation) resolves rules through the registry.

==========================  =================================================
no-raw-psum                 cross-rank float reductions fold (s, c) grids
                            through the deterministic two-sum tree, never
                            dist.all_reduce / reduce_scatter (eager or
                            functional collectives)
no-legacy-mode-kwarg        the mode= kwarg stays removed
no-uncompensated-reduction  torch.sum/mean/cumsum/prod/matmul/mm/bmm/einsum/
                            tensordot/inner/dot/vdot/vecdot/trace/
                            linalg.norm, F.linear, the ``@`` operator and
                            the method spellings (``x.sum()``) in hot-path
                            packages route through ops.* or carry an
                            annotated exemption
no-literal-interpret        device="cpu" / torch.device("cpu") literals pin
                            the device at a call site; an entry point runs
                            on the card unless its caller asks for the CPU
                            (``repro_torch.device.resolve_device`` is the
                            one authority)
no-hardcoded-accum-dtype    kernel wrappers, plain versions and oracles
                            accumulate in the resolved Policy.compute_dtype,
                            not a hardcoded torch dtype
no-host-sync-in-trace       .item()/torch.cuda.synchronize() anywhere in
                            scope, and .tolist()/.cpu()/.numpy()/float()/
                            int()/np.asarray() inside decode/prefill bodies,
                            wait for the card
no-raw-prngkey              generators are seeded at boundary modules only
                            (train/launch/config): no torch.manual_seed and
                            no torch.Generator made elsewhere
no-deprecated-surface       internal code must not call the deprecated
                            lock-step train.serve.Server shim
==========================  =================================================
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.analysis.core import FileContext, Violation

Checker = Callable[[FileContext], Iterator[Violation]]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One machine-checked clause of the engine contract.

    id        pragma-addressable identifier (``allow-<id>(reason)``)
    scope     fnmatch globs over package-relative paths the rule runs on
    checker   generator over an annotated AST yielding Violations
    fix_hint  one-line remediation appended to findings
    doc       one-line statement of the contract clause (--list-rules)
    exclude   globs carved OUT of scope (e.g. the device-resolution
              authority module for no-literal-interpret)
    """

    id: str
    scope: Tuple[str, ...]
    checker: Checker
    fix_hint: str
    doc: str
    exclude: Tuple[str, ...] = ()

    def applies_to(self, relpath: str) -> bool:
        if any(fnmatch.fnmatch(relpath, g) for g in self.exclude):
            return False
        return any(fnmatch.fnmatch(relpath, g) for g in self.scope)


_REGISTRY: Dict[str, Rule] = {}


def register(rule: Rule, *, override: bool = False) -> Rule:
    """Add a rule (returns it). Duplicate ids fail fast unless
    override=True."""
    if not isinstance(rule, Rule):
        raise TypeError(f"expected Rule, got {type(rule)!r}")
    if rule.id in _REGISTRY and not override:
        raise ValueError(
            f"rule {rule.id!r} already registered "
            f"(pass override=True to replace)")
    _REGISTRY[rule.id] = rule
    return rule


def unregister(rule_id: str) -> None:
    """Remove a rule (tests / plugin teardown)."""
    _REGISTRY.pop(rule_id, None)


def names() -> Tuple[str, ...]:
    """Registered rule ids, registration order."""
    return tuple(_REGISTRY)


def registered() -> Dict[str, Rule]:
    """Snapshot of the registry (copy — safe to iterate while registering)."""
    return dict(_REGISTRY)


def get(rule_id: str) -> Rule:
    """Fail-fast lookup with the registered menu."""
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        raise ValueError(
            f"unknown contract rule {rule_id!r}; registered rules: "
            f"{sorted(_REGISTRY)}") from None


def select(rule_ids: Optional[Iterable[str]]) -> List[Rule]:
    """All rules, or a validated subset (unknown ids fail fast)."""
    if rule_ids is None:
        return list(_REGISTRY.values())
    return [get(r) for r in rule_ids]


# ---------------------------------------------------------------------------
# Built-in rules
# ---------------------------------------------------------------------------

#: packages whose reductions are serving/training hot paths — the scope
#: of the core no-uncompensated-reduction clause.
HOT_SCOPE = ("kernels/*", "serve/*", "models/*", "optim/*", "distributed/*")

#: the torch reduction entry points the contract covers: matmul-shaped
#: contractions, full/axis sums, the sum-derived mean/cumsum, the
#: diagonal sum trace and the sequential-rounding product prod.
TORCH_REDUCTIONS = ("sum", "mean", "cumsum", "prod", "matmul", "mm", "bmm",
                    "einsum", "tensordot", "inner", "dot", "vdot", "vecdot",
                    "trace")

_TORCH_REDUCTION_NAMES = frozenset(
    f"torch.{r}" for r in TORCH_REDUCTIONS) | frozenset(
    ("torch.linalg.norm", "torch.linalg.vecdot", "torch.norm",
     "torch.nn.functional.linear"))

#: the same reductions as Tensor methods (``x.sum()``, ``a.matmul(b)``)
_METHOD_REDUCTIONS = frozenset(
    ("sum", "mean", "cumsum", "prod", "matmul", "mm", "bmm", "inner", "dot",
     "vdot", "trace", "norm"))

#: roots of names that are host-side math, never a device reduction
#: (``np.prod(x.shape)``, ``math.prod``, builtins)
_HOST_ROOTS = ("numpy", "math", "builtins", "statistics", "itertools",
               "functools", "operator")

_PSUM_NAMES = frozenset(
    f"torch.distributed.{n}" for n in (
        "all_reduce", "all_reduce_coalesced", "reduce_scatter",
        "reduce_scatter_tensor", "reduce")) | frozenset(
    f"torch.distributed._functional_collectives.{n}" for n in (
        "all_reduce", "all_reduce_coalesced", "all_reduce_inplace",
        "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced"))
#: reduce ops that are exact whatever the order (a MAX all-reduce is the
#: reference's pmax, which its rule does not name either)
_ORDER_FREE_OPS = frozenset(
    f"torch.distributed.ReduceOp.{op}" for op in ("MAX", "MIN", "BAND",
                                                  "BOR", "BXOR"))
_SEED_NAMES = frozenset(("torch.manual_seed", "torch.Generator",
                         "torch.random.manual_seed", "torch.cuda.manual_seed",
                         "torch.cuda.manual_seed_all"))


#: receivers that name the compensated engine itself: ``eng.matmul(a,
#: b)`` or ``_engine(...).dot(a, b)`` is the engine's method, not a
#: tensor's
_ENGINE_RECEIVERS = frozenset(("eng", "engine", "_engine",
                               "CompensatedReduction"))


def _is_module_receiver(ctx: FileContext, node: ast.AST) -> bool:
    """True when ``node`` (a method call's receiver) is an imported name
    or an attribute chain rooted in one (a module or a module's function,
    not a tensor), or the compensated engine (``_ENGINE_RECEIVERS``)."""
    if isinstance(node, ast.Call):
        node = node.func
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and (node.id in ctx.aliases
                                           or node.id in _ENGINE_RECEIVERS)


def _is_host_call(ctx: FileContext, node: ast.AST) -> bool:
    """True for a call into host-side math (``np.asarray(a, np.float64)``)."""
    return isinstance(node, ast.Call) and (
        ctx.resolve(node.func) or "").startswith(_HOST_ROOTS)


def _check_uncompensated_reduction(ctx: FileContext) -> Iterator[Violation]:
    for node in ctx.walk():
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if _is_host_call(ctx, node.left) or _is_host_call(ctx, node.right):
                continue
            yield ctx.violation(
                node, "no-uncompensated-reduction",
                "raw @ contraction off the compensated engine")
            continue
        if not isinstance(node, ast.Call):
            continue
        name = ctx.resolve(node.func)
        if name in _TORCH_REDUCTION_NAMES:
            short = name.removeprefix("torch.").replace(
                "nn.functional.", "F.")
            yield ctx.violation(
                node, "no-uncompensated-reduction",
                f"raw torch.{short} reduction off the compensated engine"
                if not short.startswith("F.") else
                f"raw {short} contraction off the compensated engine")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _METHOD_REDUCTIONS \
                and not _is_module_receiver(ctx, node.func.value) \
                and not (name or "").startswith(_HOST_ROOTS):
            yield ctx.violation(
                node, "no-uncompensated-reduction",
                f"raw .{node.func.attr}() reduction off the compensated "
                f"engine")


def _reduce_op(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg in ("op", "reduceOp"):
            return kw.value
    return call.args[1] if len(call.args) > 1 else None


def _check_raw_psum(ctx: FileContext) -> Iterator[Violation]:
    for call in ctx.calls():
        name = ctx.resolve(call.func)
        op = _reduce_op(call)
        if name in _PSUM_NAMES and not (
                op is not None and ctx.resolve(op) in _ORDER_FREE_OPS):
            yield ctx.violation(
                call, "no-raw-psum",
                f"{name.rsplit('.', 1)[1]} is an order-unspecified "
                f"cross-rank float reduction")


def _check_legacy_mode(ctx: FileContext) -> Iterator[Violation]:
    for call in ctx.calls():
        for kw in call.keywords:
            if kw.arg == "mode":
                yield ctx.violation(
                    call, "no-legacy-mode-kwarg",
                    "mode= kwarg (the legacy compensation-scheme alias "
                    "stays removed)")
    for fn in ctx.functions():
        args = fn.args
        all_args = (*args.posonlyargs, *args.args, *args.kwonlyargs)
        for a in all_args:
            if a.arg == "mode":
                yield ctx.violation(
                    fn, "no-legacy-mode-kwarg",
                    f"function {fn.name!r} declares a 'mode' parameter")


def _is_cpu_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.split(":")[0] == "cpu"


def _check_literal_device(ctx: FileContext) -> Iterator[Violation]:
    for call in ctx.calls():
        for kw in call.keywords:
            if kw.arg == "device" and _is_cpu_literal(kw.value):
                yield ctx.violation(
                    call, "no-literal-interpret",
                    "device='cpu' literal pins the device at the call site")
        if ctx.resolve(call.func) == "torch.device" and call.args \
                and _is_cpu_literal(call.args[0]):
            yield ctx.violation(
                call, "no-literal-interpret",
                "torch.device('cpu') literal pins the device at the call "
                "site")


_HARDCODED_DTYPES = frozenset(
    ("torch.float32", "torch.float64", "torch.bfloat16", "torch.float",
     "torch.double"))


def _check_hardcoded_accum_dtype(ctx: FileContext) -> Iterator[Violation]:
    for node in ctx.walk():
        if isinstance(node, ast.Attribute):
            name = ctx.resolve(node)
            if name in _HARDCODED_DTYPES and ctx.in_function_body(node) \
                    and not ctx.in_default_arg(node):
                yield ctx.violation(
                    node, "no-hardcoded-accum-dtype",
                    f"hardcoded {name} accumulate dtype in a kernel body")


_TRACE_BODY_MARKERS = ("decode", "prefill")
#: host pulls: the reference's np.asarray, flagged inside decode/prefill
#: bodies (``.item()`` is flagged anywhere in scope, as there)
_PULL_METHODS = ("tolist", "cpu", "numpy")


def _in_trace_body(ctx: FileContext, node: ast.AST) -> bool:
    return any(m in fn for fn in ctx.enclosing_functions(node)
               for m in _TRACE_BODY_MARKERS)


def _check_host_sync(ctx: FileContext) -> Iterator[Violation]:
    for call in ctx.calls():
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "item" \
                and not call.args:
            yield ctx.violation(
                call, "no-host-sync-in-trace",
                ".item() waits for the card and copies to the host")
        elif isinstance(func, ast.Attribute) \
                and func.attr in _PULL_METHODS and not call.args \
                and not _is_module_receiver(ctx, func.value) \
                and _in_trace_body(ctx, call):
            yield ctx.violation(
                call, "no-host-sync-in-trace",
                f".{func.attr}() inside a decode/prefill body pulls the "
                f"value to the host")
        elif ctx.resolve(func) == "torch.cuda.synchronize":
            yield ctx.violation(
                call, "no-host-sync-in-trace",
                "torch.cuda.synchronize() waits for the card")
        elif isinstance(func, ast.Name) and func.id in ("float", "int"):
            if call.args and not isinstance(call.args[0], ast.Constant):
                if _in_trace_body(ctx, call):
                    yield ctx.violation(
                        call, "no-host-sync-in-trace",
                        f"{func.id}() on a non-literal inside a "
                        f"decode/prefill body waits for the card when it "
                        f"is a tensor")
        elif ctx.resolve(func) == "numpy.asarray" \
                and _in_trace_body(ctx, call):
            yield ctx.violation(
                call, "no-host-sync-in-trace",
                "np.asarray() inside a decode/prefill body pulls the "
                "value to the host")


def _check_raw_prngkey(ctx: FileContext) -> Iterator[Violation]:
    for call in ctx.calls():
        name = ctx.resolve(call.func)
        if name in _SEED_NAMES:
            yield ctx.violation(
                call, "no-raw-prngkey",
                f"{name} outside a boundary module — streams must derive "
                f"from a seed or generator they were handed")


def _check_deprecated_surface(ctx: FileContext) -> Iterator[Violation]:
    for node in ctx.walk():
        if isinstance(node, ast.ImportFrom) and node.module in (
                "repro_torch.train.serve", "repro_torch.train"):
            for a in node.names:
                if a.name == "Server":
                    yield ctx.violation(
                        node, "no-deprecated-surface",
                        "imports the deprecated lock-step "
                        "train.serve.Server shim")
        elif isinstance(node, ast.Attribute):
            if ctx.resolve(node) in ("repro_torch.train.serve.Server",
                                     "repro_torch.train.Server"):
                yield ctx.violation(
                    node, "no-deprecated-surface",
                    "references the deprecated lock-step "
                    "train.serve.Server shim")


for _rule in (
    Rule(
        id="no-raw-psum",
        scope=HOT_SCOPE + ("train/*", "core/*"),
        checker=_check_raw_psum,
        fix_hint="all-gather the (s, c) grids and fold through "
                 "engine.merge_accumulator_grids (see "
                 "distributed.collectives)",
        doc="cross-rank reductions use the deterministic two-sum merge "
            "tree, never an order-unspecified all_reduce/reduce_scatter",
    ),
    Rule(
        id="no-legacy-mode-kwarg",
        scope=("*",),
        checker=_check_legacy_mode,
        fix_hint="write scheme=/Policy (repro_torch.kernels.schemes)",
        doc="the legacy compensation mode= kwarg stays removed",
    ),
    Rule(
        id="no-uncompensated-reduction",
        scope=HOT_SCOPE,
        checker=_check_uncompensated_reduction,
        fix_hint="route through ops.dot/asum/matmul (or annotate: "
                 "# contract: allow-no-uncompensated-reduction(reason))",
        doc="hot-path reductions run on the engine's (s, c) accumulators "
            "or carry an annotated exemption",
    ),
    Rule(
        id="no-literal-interpret",
        scope=("*",),
        exclude=("device.py",),
        checker=_check_literal_device,
        fix_hint="take a device argument (None: the card, resolved by "
                 "repro_torch.device.resolve_device) or follow an input "
                 "tensor's device",
        doc="the device resolves through device.resolve_device only — no "
            "'cpu' literals at call sites",
    ),
    Rule(
        id="no-hardcoded-accum-dtype",
        scope=("kernels/kahan_dot.py", "kernels/kahan_sum.py",
               "kernels/kahan_matmul.py", "kernels/flash_attention.py",
               "kernels/ref.py", "kernels/engine.py"),
        checker=_check_hardcoded_accum_dtype,
        fix_hint="use the compute_dtype argument the engine threads in "
                 "(Policy.compute_dtype is the accumulate-dtype authority)",
        doc="kernel wrappers, plain versions and oracles accumulate in the "
            "resolved Policy.compute_dtype (parameter defaults are fine)",
    ),
    Rule(
        id="no-host-sync-in-trace",
        scope=("models/*", "serve/*"),
        checker=_check_host_sync,
        fix_hint="keep the value on the card; read it only at the "
                 "engine's host-side emit points",
        doc="no .item()/synchronize() in scope, and decode/prefill bodies "
            "never .tolist()/.cpu()/float()/int()/np.asarray() a tensor — "
            "each one waits for the card",
    ),
    Rule(
        id="no-raw-prngkey",
        scope=("models/*", "kernels/*", "optim/*", "distributed/*",
               "serve/*", "core/*", "data/*", "perf/*", "ft/*",
               "checkpoint/*"),
        checker=_check_raw_prngkey,
        fix_hint="take a generator or seed handed down by the boundary "
                 "(train/launch/engine config seed)",
        doc="generators are made and seeded at boundary modules only; "
            "per-request streams derive from per-request state",
    ),
    Rule(
        id="no-deprecated-surface",
        scope=("*",),
        exclude=("train/*",),
        checker=_check_deprecated_surface,
        fix_hint="use repro_torch.serve.InferenceEngine (submit/step/run)",
        doc="internal code does not call the deprecated lock-step "
            "train.serve.Server shim",
    ),
):
    register(_rule)
