"""Cost-level contract rules: verify kernel cost against the ECM model
(counterpart of ``repro/analysis/costmodel.py``).

The paper's method is low-level instruction analysis feeding the ECM
model: count the flops, loads and stores one loop iteration executes, and
the model predicts when compensation hides behind the memory stream.
``core/ecm.py`` builds its H100 kernel descriptions from each scheme's
*declared* ``instruction_mix``; this level checks the declaration against
what the port executes, at two depths:

* **On the CPU** (always). :func:`register_cost_targets` registers one
  cost target per kernel kind x registered scheme into the shared
  :mod:`repro_torch.analysis.targets` registry — ``cost.dot.<scheme>``,
  ``cost.asum.<scheme>``, ``cost.matmul.<scheme>``,
  ``cost.flash.<scheme>`` — plus the ``cost.dot.kahan.bf16`` cell. Each
  build counts, through the trace level's op log, the calls into
  ``core/kahan.py``'s op functions that the scheme's fold makes, weighted
  by elements: ``add`` / ``sub`` one add, ``mul`` one mul, a fused
  ``_fma`` / ``_exact_fma`` one add AND one mul (the reference's jaxpr
  shows an fma as the mul and the add XLA later contracts), and a raw
  torch add or mul in the fold one each. The dot and sum paths probe the
  scheme's ``mul_update`` / ``update`` at every step of two fold periods
  (a conditional fold, pairwise's every 32 steps, is in the static mix as
  it is in the device code: the most ops any step takes count); matmul
  and flash run their plain versions over 32 K-blocks and count the fold
  sites only (``scheme.update``), reporting the in-block product chain
  without gating it, as the reference treats its one ``dot_general``. The
  traffic is the bytes the kernel entries record on fake tensors
  (``kernels.abstract.record``'s ``moved``: inputs read once, outputs
  written once) at two sizes.
* **In SASS** (``--cost --sass``, :func:`register_sass`): the probe source
  ``csrc/cost_probe.cu`` (one ``__global__`` a scheme x dtype x path that
  applies ``update<S>`` / ``mul_update<S>`` of ``csrc/schemes.cuh`` to one
  loaded element) is built with the kernels' own flags and disassembled;
  its FADD/FMUL/FFMA (DADD/DMUL/DFMA) counts must equal the declared mix.
  The shipping libraries under ``build/kernels/`` are counted too.

=============================  ==========================================
cost-instruction-mix           the counted per-element add/mul mix equals
                               the scheme's declared ``InstructionMix``
                               (``traced_dot`` on the dot path,
                               ``traced_sum`` on the sum path and the
                               matmul/flash fold sites), no matrix op in
                               a fold; on SASS: each probe's counts, no
                               tensor-core opcode in B1-B6 and no FFMA in
                               the B3/B4 sum instantiations
cost-memory-traffic            recorded bytes/element equal streams x
                               ``ecm.elem_bytes_for_dtype``; the
                               accumulator store is n-independent
cost-compensation-ratio        at the counted mix the scheme's dot stays
                               bound by the bytes on the H100
                               (``ecm.ecm_gpu`` at the Policy's unroll):
                               its time equals naive's
cost-ecm-tables-derived        ``ecm.gpu_kernel_for_scheme`` is
                               reproducible from the counted mix
cost-no-hidden-copies          (--sass) no F2F / PRMT data movement in
                               the float32 probes
trace-barrier-survives-fusion  (--sass) every compensation add survives
                               nvcc: each scheme's probe keeps its adds
                               beyond naive's
=============================  ==========================================

The reference exempts dot2 from ``cost-compensation-ratio`` and
``cost-ecm-tables-derived`` (``costmodel.py:451``): at 25 raw flops an
element it is compute-bound on v5e, and the TPU tables keep the canonical
17. Neither reason holds on the H100, so the port registers no such
exemption (a stale one fails the self-audit): the model's dot2 row is
bound by the bytes at U = 8 (issue 0.207 ms against 0.351 ms of bytes
over 2^27 elements), and ``gpu_kernel_for_scheme`` is built from the
traced counts.
"""

from __future__ import annotations

import dataclasses
import functools
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

from repro_torch.analysis import trace as _trace
from repro_torch.analysis.core import LintReport, Pragma, Violation

CostChecker = Callable[[Any, Any], Iterator[Violation]]

#: audit sizes of the 1-D traffic: _N1 is exactly one kernel block at the
#: default policy (8 rows x unroll 8 x 128 lanes), _N2 two — measuring at
#: both shows loads scale linearly while the accumulator store stays
#: constant (the reference's sizes)
_N1 = 8 * 128 * 8
_N2 = 2 * _N1
#: elements a dot/sum probe folds, and the steps it is probed at (two
#: periods of the longest conditional fold, pairwise's 32)
_PROBE_ELEMS = 8
PROBE_STEPS = 64
#: matmul cell: [16, 256] x [256, 16] on (8, 8, 8) blocks -> 32 K-blocks
_MM_N = 16
_MM_BLOCK = 8
_K_STEPS = 32
#: flash cell: 8 query rows, dh 8, 32 k-blocks of 8 keys; a k-block
#: folds l (8 elements) and acc (8 x 8)
_FLASH_DIM = 8
_FLASH_FOLD_ELEMS = _FLASH_DIM * (1 + _FLASH_DIM)
#: the compensation-ratio operating point: the paper's sweep length at
#: the Policy's default unroll
RATIO_N = 1 << 27
RATIO_UNROLL = 8
_RATIO_TOL = 1e-9


# ---------------------------------------------------------------------------
# Artifact + rule registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CostArtifact:
    """Counted cost of one kernel kind and scheme at audit shapes.

    kind                "dot" | "asum" | "matmul" | "flash"
    scheme              registered scheme name
    compute_dtype       resolved accumulate dtype
    adds / muls         fold adds / muls per fold element (dot/asum: per
                        element; matmul: per output cell per K-block;
                        flash: per l/acc element per k-block)
    matrix_calls        matrix-product aten ops inside the folds
    chain_adds/muls     the in-block product chain per fold element per
                        step (matmul / flash; reported, not gated)
    load_bytes_per_elem n -> recorded input bytes per element
    store_bytes         n -> recorded accumulator-output bytes
    fold_elems          accumulator elements a flash k-block folds
    """

    kind: str
    scheme: str
    compute_dtype: Any = None
    adds: float = 0.0
    muls: float = 0.0
    matrix_calls: int = 0
    chain_adds: float = 0.0
    chain_muls: float = 0.0
    load_bytes_per_elem: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    store_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    fold_elems: int = 0


@dataclasses.dataclass(frozen=True)
class CostRule:
    """One cost clause of the performance contract.

    id        exemption-addressable identifier (``Target.exempt`` key)
    tags      a rule runs on every cost target sharing at least one tag
              ("cost-dot" / "cost-asum" / "cost-matmul" / "cost-flash" /
              "sass-probe" / "sass-census")
    checker   generator over (target, artifact) yielding Violations
    fix_hint  one-line remediation appended to findings
    doc       one-line statement of the clause (--cost --list-rules)
    """

    id: str
    tags: Tuple[str, ...]
    checker: CostChecker
    fix_hint: str
    doc: str

    def applies_to(self, target) -> bool:
        return bool(set(self.tags) & set(target.tags))


_REGISTRY: Dict[str, CostRule] = {}


def register(rule: CostRule, *, override: bool = False) -> CostRule:
    """Add a cost rule (same registry contract as ``rules.register``)."""
    if not isinstance(rule, CostRule):
        raise TypeError(f"expected CostRule, got {type(rule)!r}")
    if rule.id in _REGISTRY and not override:
        raise ValueError(
            f"cost rule {rule.id!r} already registered "
            f"(pass override=True to replace)")
    _REGISTRY[rule.id] = rule
    return rule


def unregister(rule_id: str) -> None:
    """Remove a cost rule (tests / plugin teardown)."""
    _REGISTRY.pop(rule_id, None)


def names() -> Tuple[str, ...]:
    """Registered cost-rule ids, registration order."""
    return tuple(_REGISTRY)


def registered() -> Dict[str, CostRule]:
    """Snapshot of the registry."""
    return dict(_REGISTRY)


def get(rule_id: str) -> CostRule:
    """Fail-fast lookup with the registered menu."""
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        raise ValueError(
            f"unknown cost rule {rule_id!r}; registered cost rules: "
            f"{sorted(_REGISTRY)}") from None


def select(rule_ids: Optional[Iterable[str]]) -> List[CostRule]:
    """All cost rules, or a validated subset."""
    if rule_ids is None:
        return list(_REGISTRY.values())
    return [get(r) for r in rule_ids]


# ---------------------------------------------------------------------------
# Counting: what the folds execute
# ---------------------------------------------------------------------------

#: op-log entries -> (adds, muls) each element
_KAHAN_COST = {"kahan.add": (1, 0), "kahan.sub": (1, 0),
               "kahan.mul": (0, 1), "kahan._fma": (1, 1),
               "kahan._exact_fma": (1, 1)}
_ATEN_ADDS = ("aten.add.", "aten.add_.", "aten.sub.", "aten.sub_.",
              "aten.rsub.")
_ATEN_MULS = ("aten.mul.", "aten.mul_.")
_ATEN_MATRIX = ("aten.mm.", "aten.bmm.", "aten.addmm.", "aten.matmul.",
                "aten.dot.", "aten.baddbmm.", "aten.vdot.")


def op_cost(op: _trace.Op) -> Tuple[int, int]:
    """(adds, muls) one element of an op-log entry costs (floats only)."""
    if not op.dtypes:
        return 0, 0
    if op.name in _KAHAN_COST:
        return _KAHAN_COST[op.name]
    if op.name.startswith(_ATEN_ADDS):
        return 1, 0
    if op.name.startswith(_ATEN_MULS):
        return 0, 1
    return 0, 0


def weighted_op_counts(log: List[_trace.Op], region: Optional[str] = None,
                       ) -> Tuple[float, float, int]:
    """(adds, muls, matrix_calls) of a log's entries (those in ``region``
    when given), each weighted by its output elements — the vector op
    count the card executes; matrix products count apart, as the
    reference counts ``dot_general``."""
    adds = muls = 0.0
    matrix = 0
    for op in log:
        if region is not None and op.region != region:
            continue
        if op.name.startswith(_ATEN_MATRIX):
            matrix += 1
            continue
        a, m = op_cost(op)
        adds += a * op.numel
        muls += m * op.numel
    return adds, muls, matrix


def per_step_counts(log: List[_trace.Op],
                    ) -> Dict[int, Tuple[float, float, int]]:
    """step -> (fold adds, fold muls, fold elements) of a log recorded
    with a ``counting`` scheme; the elements are those the step's fold
    calls returned (``fold`` markers)."""
    out: Dict[int, List[float]] = {}
    for op in log:
        if op.region != "fold" or op.step is None:
            continue
        row = out.setdefault(op.step, [0.0, 0.0, 0])
        if op.name == "call.fold":
            row[2] += op.numel
            continue
        a, m = op_cost(op)
        row[0] += a * op.numel
        row[1] += m * op.numel
    return {g: tuple(r) for g, r in out.items()}


def counting(scheme):
    """A copy of ``scheme`` whose ``update`` / ``mul_update`` run in the
    op log's "fold" region at their step, each call marked with the
    elements it folds."""
    def wrap(fn, step_arg: int):
        def fold(*args):
            with _trace.region("fold", args[step_arg]):
                s, c = fn(*args)
                _trace.note("call.fold", s)
            return s, c
        return fold

    return dataclasses.replace(scheme, update=wrap(scheme.update, 3),
                               mul_update=wrap(scheme.mul_update, 4))


def _max_per_elem(steps: Dict[int, Tuple[float, float, int]],
                  ) -> Tuple[float, float]:
    """The most adds and muls an element any step's fold costs."""
    adds = max((a / n for a, _, n in steps.values() if n), default=0.0)
    muls = max((m / n for _, m, n in steps.values() if n), default=0.0)
    return adds, muls


def _resolve_dtype(compute_dtype):
    from repro_torch.kernels import schemes as _schemes

    return _schemes.resolve_compute_dtype(compute_dtype)


def _probe_values(n: int, dtype, seed: int) -> torch.Tensor:
    from repro_torch.analysis.targets import data

    return data(n, seed=seed, dtype=torch.float64).to(dtype)


def probe_mix(scheme_name: str, path: str, compute_dtype=None,
              ) -> Tuple[float, float, int]:
    """(adds, muls, matrix calls) an element of the scheme's ``path``
    ("dot": ``mul_update``, "sum": ``update``) costs, probed on
    ``_PROBE_ELEMS`` elements at steps 0..PROBE_STEPS-1."""
    from repro_torch.kernels import schemes as _schemes

    dt = _resolve_dtype(compute_dtype)
    sch = counting(_schemes.get(scheme_name))
    s, c, a, b = (_probe_values(_PROBE_ELEMS, dt, seed)
                  for seed in range(4))
    with _trace.record() as log:
        for g in range(PROBE_STEPS):
            if path == "dot":
                sch.mul_update(s, c, a, b, g)
            else:
                sch.update(s, c, a, g)
    adds, muls = _max_per_elem(per_step_counts(log))
    return adds, muls, weighted_op_counts(log, "fold")[2]


def _fold_artifact(kind: str, scheme_name: str, dt, log, cells: int,
                   ) -> CostArtifact:
    """Fold mix per fold element from a plain run's log; the product
    chain outside the folds per fold element per step."""
    steps = per_step_counts(log)
    adds, muls = _max_per_elem(steps)
    chain_adds, chain_muls, _ = weighted_op_counts(
        [op for op in log if op.region != "fold"])
    n_steps = max(len(steps), 1)
    return CostArtifact(
        kind=kind, scheme=scheme_name, compute_dtype=dt, adds=adds,
        muls=muls, matrix_calls=weighted_op_counts(log, "fold")[2],
        chain_adds=chain_adds / (n_steps * cells),
        chain_muls=chain_muls / (n_steps * cells),
        fold_elems=cells)


def recorded_traffic(kind: str, n: int, compute_dtype,
                     ) -> Tuple[float, int]:
    """(input bytes, output bytes) the kernel entry of ``ops.<kind>``
    records for ``n`` elements on fake tensors: the engine pads and
    promotes, the wrapper records ``moved`` (inputs read once, outputs
    written once) and runs nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import abstract
    from repro_torch.kernels.engine import CompensatedReduction

    eng = CompensatedReduction(compute_dtype=compute_dtype)
    work: dict = {}
    with FakeTensorMode():
        xs = [torch.empty(n, dtype=compute_dtype)
              for _ in range(2 if kind == "dot" else 1)]
        with abstract.recording(work):
            acc = (eng.dot_accumulators(*xs) if kind == "dot"
                   else eng.sum_accumulators(*xs))
    moved = sum(w["bytes"] for w in work.values())
    stores = abstract.nbytes(acc.s, acc.c)
    return moved - stores, stores


def _reduction_cost_build(kind: str, scheme_name: str,
                          compute_dtype=None) -> Callable[[], CostArtifact]:
    """The 1-D reductions: the probed mix of the scheme's dot / sum path,
    and the traffic recorded at _N1 and _N2."""
    def build() -> CostArtifact:
        dt = _resolve_dtype(compute_dtype)
        adds, muls, matrix = probe_mix(
            scheme_name, "dot" if kind == "dot" else "sum", dt)
        art = CostArtifact(kind=kind, scheme=scheme_name, compute_dtype=dt,
                           adds=adds, muls=muls, matrix_calls=matrix)
        for n in (_N1, _N2):
            loads, stores = recorded_traffic(kind, n, dt)
            art.load_bytes_per_elem[n] = loads / n
            art.store_bytes[n] = stores
        return art

    return build


def _matmul_cost_build(scheme_name: str) -> Callable[[], CostArtifact]:
    """``ops.matmul`` on CPU tensors over ``_K_STEPS`` K-blocks: the fold
    (``scheme.update`` of each block's product) per output cell per
    K-block."""
    def build() -> CostArtifact:
        from repro_torch.kernels import ops
        from repro_torch.kernels import schemes as _schemes

        dt = _resolve_dtype(None)
        k = _MM_BLOCK * _K_STEPS
        a = _probe_values(_MM_N * k, dt, 0).reshape(_MM_N, k)
        b = _probe_values(k * _MM_N, dt, 1).reshape(k, _MM_N)
        with _trace.record() as log:
            ops.matmul(a, b, scheme=counting(_schemes.get(scheme_name)),
                       block_m=_MM_BLOCK, block_n=_MM_BLOCK,
                       block_k=_MM_BLOCK)
        return _fold_artifact("matmul", scheme_name, dt, log,
                              _MM_N * _MM_N)

    return build


def _flash_cost_build(scheme_name: str) -> Callable[[], CostArtifact]:
    """The flash plain version over ``_K_STEPS`` k-blocks: the two fold
    sites (l and acc) per folded element per k-block."""
    def build() -> CostArtifact:
        from repro_torch.kernels import schemes as _schemes
        from repro_torch.kernels.engine import CompensatedReduction

        dt = _resolve_dtype(None)
        eng = CompensatedReduction(
            scheme=counting(_schemes.get(scheme_name)))
        skv = _FLASH_DIM * _K_STEPS
        q = _probe_values(_FLASH_DIM * _FLASH_DIM, dt, 0).reshape(
            1, _FLASH_DIM, _FLASH_DIM)
        kv = _probe_values(skv * _FLASH_DIM, dt, 1).reshape(
            1, skv, _FLASH_DIM)
        with _trace.record() as log:
            eng.flash_attention(q, kv, kv, block_q=_FLASH_DIM,
                                block_k=_FLASH_DIM, causal=False)
        return _fold_artifact("flash", scheme_name, dt, log,
                              _FLASH_FOLD_ELEMS)

    return build


_KINDS = ("dot", "asum", "matmul", "flash")


def register_cost_targets() -> Tuple[str, ...]:
    """(Re-)register one cost target per kernel kind x registered scheme
    into the shared ``analysis.targets`` registry, plus the bf16 cell.
    Idempotent and registry-driven: schemes registered at runtime are
    covered by the next audit, and the cells of unregistered schemes are
    pruned. Returns the registered target ids."""
    from repro_torch.analysis import targets as _targets
    from repro_torch.kernels import schemes as _schemes

    ids = []

    def _add(target):
        _targets.register(target, override=True)
        ids.append(target.id)

    for name in _schemes.names():
        _add(_targets.Target(
            id=f"cost.dot.{name}",
            build=_reduction_cost_build("dot", name),
            tags=("cost", "cost-dot"),
            doc=f"counted cost of the {name} dot path (B1/B2) vs the ECM "
                f"model (mix, traffic, ratio, tables)"))
        _add(_targets.Target(
            id=f"cost.asum.{name}",
            build=_reduction_cost_build("asum", name),
            tags=("cost", "cost-asum"),
            doc=f"counted cost of the {name} sum path (B3/B4: sum-path mix "
                f"+ single-stream traffic)"))
        _add(_targets.Target(
            id=f"cost.matmul.{name}",
            build=_matmul_cost_build(name),
            tags=("cost", "cost-matmul"),
            doc=f"counted cost of the {name} matmul fold (B5/B6: sum path "
                f"per cell per K-block, no matrix op in the fold)"))
        _add(_targets.Target(
            id=f"cost.flash.{name}",
            build=_flash_cost_build(name),
            tags=("cost", "cost-flash"),
            doc=f"counted cost of the {name} flash folds (B7/B8: sum path "
                f"at the l and acc sites)"))
    _add(_targets.Target(
        id="cost.dot.kahan.bf16",
        build=_reduction_cost_build("dot", "kahan",
                                    compute_dtype="bfloat16"),
        tags=("cost", "cost-dot"),
        doc="the kahan dot at bfloat16 accumulate — the halved element "
            "width must reach the traffic model"))
    prefixes = tuple(f"cost.{k}." for k in _KINDS)
    for tid, target in _targets.registered().items():
        if "cost" in target.tags and tid.startswith(prefixes) \
                and tid not in ids:
            _targets.unregister(tid)
    if _SASS_ON:
        ids += _register_sass_targets()
    return tuple(ids)


# ---------------------------------------------------------------------------
# Built-in cost rules
# ---------------------------------------------------------------------------

def _v(target, rule: str, message: str) -> Violation:
    return Violation(rule=rule, path=target.id, line=0, col=0,
                     message=message)


def _expectation(art):
    from repro_torch.core import ecm

    return ecm.expected_cost(
        art.scheme, compute_dtype=art.compute_dtype,
        streams=2 if art.kind == "dot" else 1)


def _check_instruction_mix(target, art) -> Iterator[Violation]:
    if isinstance(art, SassArtifact):
        yield from _check_sass_mix(target, art)
        return
    exp = _expectation(art)
    if art.kind in ("dot", "asum"):
        want = ((exp.dot_adds, exp.dot_muls) if art.kind == "dot"
                else (exp.sum_adds, 0))
        if (art.adds, art.muls) != (float(want[0]), float(want[1])):
            yield _v(target, "cost-instruction-mix",
                     f"counted {art.kind} path executes {art.adds:g} adds + "
                     f"{art.muls:g} muls per element; the declared "
                     f"instruction_mix says {want[0]} + {want[1]}")
    else:
        if (art.adds, art.muls) != (float(exp.sum_adds), 0.0):
            yield _v(target, "cost-instruction-mix",
                     f"{art.kind} fold executes {art.adds:g} adds + "
                     f"{art.muls:g} muls per fold element per block; the "
                     f"scheme's sum path declares {exp.sum_adds} + 0 (the "
                     f"products belong to the block's chain)")
    if art.matrix_calls:
        yield _v(target, "cost-instruction-mix",
                 f"{art.matrix_calls} matrix-product op(s) inside the "
                 f"{art.kind} folds — the fixed-order fold must not route "
                 f"through a library product")


def _check_memory_traffic(target, art) -> Iterator[Violation]:
    exp = _expectation(art)
    for n, got in sorted(art.load_bytes_per_elem.items()):
        if got != float(exp.load_bytes_per_elem):
            yield _v(target, "cost-memory-traffic",
                     f"kernel entry records {got:g} input bytes/element at "
                     f"n={n}; {exp.streams} stream(s) x {exp.elem_bytes} B "
                     f"({str(art.compute_dtype).removeprefix('torch.')}) "
                     f"predicts {exp.load_bytes_per_elem}")
    stores = sorted(art.store_bytes.items())
    if len(stores) >= 2 and len({b for _, b in stores}) != 1:
        yield _v(target, "cost-memory-traffic",
                 f"accumulator store bytes vary with n ({dict(stores)}) — "
                 f"the emitted (s, c) grids must be n-independent")


def _check_compensation_ratio(target, art) -> Iterator[Violation]:
    from repro_torch.core import ecm
    from repro_torch.kernels import schemes as _schemes

    exp = _expectation(art)
    flops = int(round(art.adds + art.muls))
    sch = _schemes.get(art.scheme)
    kernel = ecm.GPUKernel(
        name=f"{art.scheme}-measured", streams=exp.streams,
        elem_bytes=exp.elem_bytes, flops=flops,
        dep_ops=ecm.CHAIN_OPS.get(sch.device_id, flops))
    res = ecm.ecm_gpu(ecm.H100, kernel, RATIO_N, RATIO_UNROLL)
    naive = ecm.ecm_gpu(ecm.H100, dataclasses.replace(
        kernel, name="naive-measured", flops=2, dep_ops=1), RATIO_N,
        RATIO_UNROLL)
    ratio = res.pred_ms / naive.pred_ms
    if res.bound != "hbm" or ratio > 1.0 + _RATIO_TOL:
        yield _v(target, "cost-compensation-ratio",
                 f"at the counted mix ({art.adds:g} adds + {art.muls:g} "
                 f"muls/elem) the {art.scheme} dot is {res.bound}-bound on "
                 f"the {ecm.H100.name} with T_ECM {ratio:.2f}x naive — "
                 f"compensation is no longer hidden behind the bytes")


def _check_ecm_tables_derived(target, art) -> Iterator[Violation]:
    from repro_torch.core import ecm

    table = ecm.gpu_kernel_for_scheme(art.scheme, op="dot",
                                      compute_dtype=art.compute_dtype)
    measured = int(round(art.adds + art.muls))
    if table.flops != measured:
        yield _v(target, "cost-ecm-tables-derived",
                 f"ecm.gpu_kernel_for_scheme({art.scheme!r}) models "
                 f"{table.flops} flops/elem but the counted body executes "
                 f"{measured} — the ECM table has drifted from the kernel")
    want_bytes = ecm.elem_bytes_for_dtype(art.compute_dtype)
    if table.elem_bytes != want_bytes:
        yield _v(target, "cost-ecm-tables-derived",
                 f"ecm.gpu_kernel_for_scheme({art.scheme!r}) models "
                 f"{table.elem_bytes} B/elem but the resolved compute dtype "
                 f"is {want_bytes} B")


for _rule in (
    CostRule(
        id="cost-instruction-mix",
        tags=("cost-dot", "cost-asum", "cost-matmul", "cost-flash",
              "sass-probe", "sass-census"),
        checker=_check_instruction_mix,
        fix_hint="fix the scheme's update or its declared InstructionMix "
                 "(traced_* overrides declare a raw count that differs "
                 "from the canonical accounting)",
        doc="the counted per-element mix of every fold (and, with --sass, "
            "of every probe's SASS) matches the declared instruction_mix",
    ),
    CostRule(
        id="cost-memory-traffic",
        tags=("cost-dot", "cost-asum"),
        checker=_check_memory_traffic,
        fix_hint="the kernel must read each input once at the resolved "
                 "compute_dtype and emit fixed-size (s, c) grids",
        doc="recorded bytes/element match the elem_bytes_for_dtype-derived "
            "expectation; the accumulator store is n-independent",
    ),
    CostRule(
        id="cost-compensation-ratio",
        tags=("cost-dot",),
        checker=_check_compensation_ratio,
        fix_hint="keep the scheme's per-element flops under the H100's "
                 "hide-point at the Policy's unroll, or exempt with the "
                 "documented accuracy-vs-cost trade",
        doc="at the counted mix the scheme's dot stays bound by the bytes "
            "on the H100 — compensation costs ~nothing vs naive",
    ),
    CostRule(
        id="cost-ecm-tables-derived",
        tags=("cost-dot",),
        checker=_check_ecm_tables_derived,
        fix_hint="ecm.gpu_kernel_for_scheme must be reproducible from the "
                 "counted mix",
        doc="every H100 kernel description is reproducible from a counted "
            "instruction mix",
    ),
):
    register(_rule)


# ---------------------------------------------------------------------------
# The SASS level (--sass)
# ---------------------------------------------------------------------------

_SASS_ON = False

#: the probe source and its functions: probe_<path>_<scheme>_<dtype>
PROBE_SOURCE = "cost_probe"
PROBE_DTYPES = ("f32", "f64", "bf16")
_PROBE_TORCH = {"f32": "float32", "f64": "float64", "bf16": "bfloat16"}
#: the shipping libraries the census reads
SHIPPING = ("kahan_reduce", "kahan_matmul", "kahan_flash")


@dataclasses.dataclass
class SassArtifact:
    """Opcode counts read from SASS.

    kind      "probe" (one scheme x dtype x path) or "census"
    scheme    the probe's scheme ("" for the census)
    dtype     "f32" | "f64" | "bf16"
    path      "dot" | "sum"
    adds/muls the probe's float adds / muls (an FMA counts one each)
    opcodes   opcode -> count (probe: its function; census: unused)
    baseline  the naive probe's adds at the same dtype and path
    functions census: kernel function name -> opcode counts
    """

    kind: str
    scheme: str = ""
    dtype: str = ""
    path: str = ""
    adds: int = 0
    muls: int = 0
    opcodes: Dict[str, int] = dataclasses.field(default_factory=dict)
    baseline: Optional[int] = None
    functions: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)


@functools.lru_cache(maxsize=None)
def _probe_sass() -> Dict[str, Dict[str, int]]:
    """function -> opcode counts of the built probe library."""
    from repro_torch.kernels import _build
    from repro_torch.perf import sass_analysis

    return sass_analysis.opcode_counts(sass_analysis.disassemble(
        _build.build(PROBE_SOURCE)))


def _probe_build(scheme: str, dtype: str, path: str,
                 ) -> Callable[[], SassArtifact]:
    def build() -> SassArtifact:
        from repro_torch.perf import sass_analysis

        funcs = _probe_sass()
        fn = f"probe_{path}_{scheme}_{dtype}"
        if fn not in funcs:
            raise RuntimeError(f"{fn} not in the probe library's SASS "
                               f"(functions: {sorted(funcs)})")
        adds, muls = sass_analysis.float_mix(funcs[fn])
        base = sass_analysis.float_mix(
            funcs[f"probe_{path}_naive_{dtype}"])[0]
        return SassArtifact(kind="probe", scheme=scheme, dtype=dtype,
                            path=path, adds=adds, muls=muls,
                            opcodes=funcs[fn], baseline=base)

    return build


@functools.lru_cache(maxsize=None)
def _census_build() -> SassArtifact:
    """Opcode counts of every kernel function in the shipping libraries,
    built from the checkout's sources as the wrappers build them."""
    from repro_torch.kernels import _build
    from repro_torch.perf import sass_analysis

    functions: Dict[str, Dict[str, int]] = {}
    for name in SHIPPING:
        functions.update(sass_analysis.opcode_counts(
            sass_analysis.disassemble(_build.build(name))))
    return SassArtifact(kind="census", functions=functions)


def _register_sass_targets() -> List[str]:
    from repro_torch.analysis import targets as _targets
    from repro_torch.kernels import schemes as _schemes

    ids = []
    for sch in _schemes.registered().values():
        if sch.device_id is None:
            continue
        for dtype in PROBE_DTYPES:
            for path in ("dot", "sum"):
                tags = ("cost", "sass", "sass-probe")
                if dtype == "f32":
                    tags += ("sass-f32",)
                tid = f"sass.probe.{path}.{sch.name}.{dtype}"
                _targets.register(_targets.Target(
                    id=tid, build=_probe_build(sch.name, dtype, path),
                    tags=tags,
                    doc=f"SASS of the {sch.name} {path} update in {dtype} "
                        f"(csrc/cost_probe.cu) vs its declared mix"),
                    override=True)
                ids.append(tid)
    _targets.register(_targets.Target(
        id="sass.census", build=_census_build,
        tags=("cost", "sass", "sass-census"),
        doc="opcode census of the shipping kernels (B1-B8): no tensor "
            "core in B1-B6, no FFMA in the B3/B4 sum instantiations"),
        override=True)
    ids.append("sass.census")
    return ids


def declared_probe_mix(art: SassArtifact) -> Tuple[int, int]:
    """(adds, muls) the probe's scheme declares for its path."""
    from repro_torch.core import ecm

    exp = ecm.expected_cost(art.scheme)
    return ((exp.dot_adds, exp.dot_muls) if art.path == "dot"
            else (exp.sum_adds, 0))


def _check_sass_mix(target, art: SassArtifact) -> Iterator[Violation]:
    from repro_torch.perf import sass_analysis

    if art.kind == "probe":
        want = declared_probe_mix(art)
        if (art.adds, art.muls) != want:
            yield _v(target, "cost-instruction-mix",
                     f"SASS of the {art.scheme} {art.path} probe ({art.dtype}) "
                     f"executes {art.adds} adds + {art.muls} muls "
                     f"({sass_analysis.float_ops(art.opcodes)}); the declared "
                     f"instruction_mix says {want[0]} + {want[1]}")
        return
    for fn, ops in sorted(art.functions.items()):
        kernel = sass_analysis.kernel_of(fn)
        if kernel in sass_analysis.FIXED_ORDER_KERNELS:
            tc = {op: n for op, n in ops.items()
                  if op in sass_analysis.TENSOR_CORE_OPS}
            if tc:
                yield _v(target, "cost-instruction-mix",
                         f"{fn}: tensor-core opcode(s) {tc} in a "
                         f"fixed-order chain kernel ({kernel})")
        if kernel in sass_analysis.SUM_KERNELS:
            fused = {op: n for op, n in ops.items()
                     if op in sass_analysis.FUSED_OPS}
            if fused:
                yield _v(target, "cost-instruction-mix",
                         f"{fn}: fused multiply-add(s) {fused} in a sum "
                         f"instantiation — every asum path is unfused")


def _check_no_hidden_copies(target, art) -> Iterator[Violation]:
    from repro_torch.perf import sass_analysis

    moves = {op: n for op, n in art.opcodes.items()
             if op in sass_analysis.CONVERSION_OPS}
    if moves:
        yield _v(target, "cost-no-hidden-copies",
                 f"SASS of the {art.scheme} {art.path} probe ({art.dtype}) "
                 f"holds {moves} — data movement the byte model does not "
                 f"account for")


def _check_barrier_survives(target, art) -> Iterator[Violation]:
    want = declared_probe_mix(art)[0]
    from repro_torch.core import ecm

    base = ecm.expected_cost("naive")
    base_want = base.dot_adds if art.path == "dot" else base.sum_adds
    if art.baseline is not None and \
            art.adds - art.baseline < want - base_want:
        yield _v(target, "trace-barrier-survives-fusion",
                 f"the {art.scheme} {art.path} probe ({art.dtype}) keeps "
                 f"{art.adds - art.baseline} adds beyond naive's; its "
                 f"compensation declares {want - base_want} — nvcc folded "
                 f"compensation arithmetic away")


def register_sass() -> None:
    """Register the SASS level (``--cost --sass``): the probe and census
    targets, ``cost-no-hidden-copies`` on the float32 probes and
    ``trace-barrier-survives-fusion`` on every probe. Without it they are
    not registered."""
    global _SASS_ON
    _SASS_ON = True
    register(CostRule(
        id="cost-no-hidden-copies",
        tags=("sass-f32",),
        checker=_check_no_hidden_copies,
        fix_hint="keep scheme updates in the accumulate dtype (no "
                 "conversions, no byte permutes)",
        doc="no F2F / PRMT data movement in the SASS of the float32 "
            "scheme probes",
    ), override=True)
    register(CostRule(
        id="trace-barrier-survives-fusion",
        tags=("sass-probe",),
        checker=_check_barrier_survives,
        fix_hint="build with the kernels' NVCC_FLAGS (-fmad=false, no "
                 "fast math) so nvcc may not fold compensation arithmetic",
        doc="every compensation add survives nvcc: each probe keeps its "
            "declared adds beyond naive's",
    ), override=True)


def unregister_sass() -> None:
    """Undo ``register_sass`` (tests / plugin teardown)."""
    from repro_torch.analysis import targets as _targets

    global _SASS_ON
    _SASS_ON = False
    for rid in ("cost-no-hidden-copies", "trace-barrier-survives-fusion"):
        unregister(rid)
    for tid in _targets.names():
        if tid.startswith("sass."):
            _targets.unregister(tid)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def audit(target_ids: Optional[Iterable[str]] = None,
          rule_ids: Optional[Iterable[str]] = None) -> LintReport:
    """Run cost rules over the cost targets -> a ``LintReport``.

    Findings anchor ``target:0:0``, ``Target.exempt`` entries surface as
    ``Pragma`` rows, and a target whose build fails (a SASS target
    without ``nvcc`` or a disassembler among them) becomes a
    ``cost-build-error`` violation — never a silent skip.
    """
    from repro_torch.analysis import targets as _targets

    register_cost_targets()
    report = LintReport()
    rules = select(rule_ids)
    if target_ids is None:
        selected = [t for t in _targets.select(None) if "cost" in t.tags]
    else:
        selected = _targets.select(target_ids)
    for target in selected:
        applicable = [r for r in rules if r.applies_to(target)]
        if not applicable:
            continue
        report.files += 1
        try:
            art = target.build()
        except Exception as e:  # noqa: BLE001 — any build failure is a finding
            report.violations.append(Violation(
                rule="cost-build-error", path=target.id, line=0, col=0,
                message=f"cost target build failed: "
                        f"{type(e).__name__}: {e}",
                fix_hint="fix the cost-target build (a kernel that cannot "
                         "be counted cannot be cost-audited)"))
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
