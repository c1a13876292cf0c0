"""Execution-Cache-Memory (ECM) performance model: the paper's x86 model
and an H100 half.

Counterpart of ``repro/core/ecm.py``. Four parts:

1. ``ecm_x86``: the paper's model, with the machine descriptions of the
   four Xeons of its Table 1 and the naive / Kahan dot kernels. It
   reproduces the paper's Table 2 and the predictions of its §3, field for
   field as the reference does.

2. ``ecm_gpu``: the H100 in place of the reference's TPU half. The unit
   of work is one chain of the port's reduction kernels
   (``csrc/kahan_reduce.cu``): the reference layout fixes 1024 * U
   independent chains, one thread each, and the host plan
   (``kahan_dot.reduce_plan``) spreads them over the SMs (32 CTAs at U =
   1, 64 at U = 2, 128 from U = 4 on for one row of 2^27). A shared-memory
   ring overlaps the loads with the chains, so the predicted time is the
   largest of four terms, in ms:

       t_hbm    bytes once / b_S                     (load-only bandwidth)
       t_chain  steps * dependent ops * add latency / clock
       t_issue  elements of the busiest SM * flops / (its lanes * clock)
       t_sm     bytes of the busiest SM / its load rate

   The paper saturates HBM with cores; the GPU does it with chains. ``u_s``
   is the least U (of ``UNROLLS``) at which ``t_hbm`` is the largest term,
   the H100's counterpart of the paper's saturation point ``n_s``.

3. ``RooflineTerms``: three-term roofline of a whole-model step on the
   H100 (bf16 tensor-core peak, HBM, NVLink).

4. The registry bridge: kernel descriptions derive from the port's
   compensation-scheme registry (``repro_torch.kernels.schemes``), which
   owns each scheme's instruction mix; this module adds the machine axis.
   The named constants (``KAHAN_AVX_SP``, ``KAHAN_SUM_H100``, ...) are
   built lazily (PEP 562), and the registry is imported only inside the
   functions that need it, so importing this module needs neither torch
   tensors nor a card.

Names of the reference with no counterpart here: the TPU half
(``TPUMachine``, ``TPU_V4``, ``TPU_V5E``, ``TPU_V5P``, ``TPU_MACHINES``,
``TPUKernelBlock``, ``tpu_dot_block``, ``TPUECMResult``, ``ecm_tpu``,
``tpu_block_for_scheme``, ``registry_tpu_blocks``,
``ecm_tpu_for_scheme``, and the constants ``KAHAN_DOT_TPU``,
``NAIVE_DOT_TPU``, ``DOT2_TPU`` and ``KAHAN_DOT_SEQ_TPU``): the port runs
on no TPU. ``GPUMachine`` / ``H100``, ``GPUKernel``, ``GPUECMResult``,
``ecm_gpu``, ``gpu_kernel_for_scheme``, ``registry_gpu_kernels``,
``ecm_gpu_for_scheme`` and ``KAHAN_DOT_H100``, ``NAIVE_DOT_H100``,
``DOT2_H100``, ``KAHAN_SUM_H100``, ``NAIVE_SUM_H100`` take their place.
``KAHAN_DOT_SEQ_TPU`` (an element-at-a-time variant) has none: every
chain of the port's kernels is already sequential.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union


# ===========================================================================
# Part 1: the paper's x86 model (validation target)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class X86Machine:
    """One row of paper Table 1 (per-socket)."""

    name: str
    clock_ghz: float
    cores: int
    simd_bytes: int                 # AVX register width
    avx_loads_per_cy: float         # AVX loads retired per cycle
    scalar_loads_per_cy: float
    add_per_cy: float               # ADD/SUB pipe throughput (SIMD or scalar insn)
    mul_per_cy: float
    l1l2_bytes_per_cy: float        # L2->L1 bus width
    l2l3_bytes_per_cy: float
    load_bw_gbs: float              # measured load-only memory bandwidth
    mem_penalty_cy_per_cl: float    # empirical latency penalty (paper §2/§3)
    l2l3_single_core_cy_per_cl: Optional[float] = None  # HSW uncore slowdown

    def t_l3mem_cy_per_cl(self) -> float:
        """Cycles to move one 64 B cache line from memory (no penalty)."""
        return 64.0 * self.clock_ghz / self.load_bw_gbs


# Paper Table 1 (load-only BW row), cache line = 64 B.
SNB = X86Machine("SNB", 2.7, 8, 32, 1.0, 2.0, 1.0, 1.0, 32.0, 32.0, 43.6, 5.1)
IVB = X86Machine("IVB", 2.2, 10, 32, 1.0, 2.0, 1.0, 1.0, 32.0, 32.0, 46.1, 2.9)
HSW = X86Machine("HSW", 2.3, 14, 32, 2.0, 2.0, 1.0, 2.0, 64.0, 32.0, 60.6, 11.1,
                 l2l3_single_core_cy_per_cl=2.77)
BDW = X86Machine("BDW", 1.8, 8, 32, 2.0, 2.0, 1.0, 2.0, 64.0, 32.0, 33.0, 1.0)

PAPER_MACHINES: Dict[str, X86Machine] = {m.name: m for m in (SNB, IVB, HSW, BDW)}


@dataclasses.dataclass(frozen=True)
class DotKernel:
    """Instruction mix of one *scalar iteration* of a dot-product loop."""

    name: str
    adds: int            # ADD/SUB ops per scalar iteration
    muls: int
    loads: int           # input streams (a[i], b[i])
    flops: int           # useful flops per iteration (for GUP accounting: 2)
    elem_bytes: int      # bytes per element (4 SP / 8 DP)
    simd: str            # 'scalar' | 'sse' | 'avx'


@dataclasses.dataclass(frozen=True)
class ECMResult:
    """ECM model output for one (machine, kernel) pair.

    ``model_cy`` is the shorthand {T_OL || T_nOL | L1L2 | L2L3 | L3Mem} and
    ``pred_cy`` the per-level prediction {L1 | L2 | L3 | Mem}; both in cycles
    per unit of work. ``perf_gups`` is per-level GUP/s, ``n_s`` the predicted
    saturation core count, ``p_bw_gups`` the bandwidth roofline.
    """

    machine: str
    kernel: str
    unit_iters: int
    t_ol: float
    t_nol: float
    t_l1l2: float
    t_l2l3: float
    t_l3mem: float
    penalty: float
    pred_cy: Tuple[float, float, float, float]
    perf_gups: Tuple[float, float, float, float]
    n_s: int
    p_bw_gups: float

    def shorthand(self) -> str:
        return (f"{{{self.t_ol:g} || {self.t_nol:g} | {self.t_l1l2:g} | "
                f"{self.t_l2l3:g} | {self.t_l3mem:g}+{self.penalty:g}}} cy")

    def pred_shorthand(self) -> str:
        p = self.pred_cy
        return f"{{{p[0]:g} | {p[1]:g} | {p[2]:g} | {p[3]:g}}} cy"


def ecm_x86(machine: X86Machine, kernel: DotKernel) -> ECMResult:
    """Evaluate the paper's ECM model for a dot-family kernel."""
    # Unit of work: one cache line per stream = 64/elem_bytes scalar iters.
    unit_iters = 64 // kernel.elem_bytes
    if kernel.simd == "avx":
        width = machine.simd_bytes // kernel.elem_bytes
    elif kernel.simd == "sse":
        width = 16 // kernel.elem_bytes
    else:
        width = 1
    vec_iters = unit_iters / width

    # Core: ADD pipe vs MUL pipe (separate ports) — bottleneck is the max.
    t_add = vec_iters * kernel.adds / machine.add_per_cy
    t_mul = vec_iters * kernel.muls / machine.mul_per_cy
    t_ol = max(t_add, t_mul)

    # Loads are the non-overlapping part (paper model assumption (i)).
    loads = vec_iters * kernel.loads
    loads_per_cy = machine.scalar_loads_per_cy if kernel.simd == "scalar" \
        else machine.avx_loads_per_cy
    if kernel.simd == "sse":
        # SSE loads dual-issue on all four machines (2×16 B ports).
        loads_per_cy = 2.0
    t_nol = loads / loads_per_cy

    # Transfers: one CL per stream per unit of work.
    cls_per_unit = kernel.loads  # 2 streams -> 2 CLs
    t_l1l2 = cls_per_unit * 64.0 / machine.l1l2_bytes_per_cy
    if machine.l2l3_single_core_cy_per_cl is not None:
        t_l2l3 = cls_per_unit * machine.l2l3_single_core_cy_per_cl
    else:
        t_l2l3 = cls_per_unit * 64.0 / machine.l2l3_bytes_per_cy
    t_l3mem = cls_per_unit * machine.t_l3mem_cy_per_cl()
    # The paper quotes the latency penalty per 2-CL unit of work directly
    # (e.g. "+2.9" on IVB); keep their convention: once per unit of work.
    penalty = machine.mem_penalty_cy_per_cl

    def pred(upto: int) -> float:
        t_data = sum([t_l1l2, t_l2l3, t_l3mem + penalty][:upto])
        return max(t_nol + t_data, t_ol)

    pred_cy = (pred(0), pred(1), pred(2), pred(3))
    perf = tuple(unit_iters * machine.clock_ghz / p for p in pred_cy)

    # Saturation (divide by the *no-penalty* memory transfer time, paper §3).
    n_s = math.ceil(pred_cy[3] / t_l3mem)
    # Bandwidth roofline: one update per (2 * elem_bytes) transferred.
    p_bw = machine.load_bw_gbs / (kernel.loads * kernel.elem_bytes)

    return ECMResult(
        machine=machine.name, kernel=kernel.name, unit_iters=unit_iters,
        t_ol=t_ol, t_nol=t_nol, t_l1l2=t_l1l2, t_l2l3=t_l2l3,
        t_l3mem=round(t_l3mem, 2), penalty=penalty,
        pred_cy=tuple(round(p, 2) for p in pred_cy),
        perf_gups=tuple(round(p, 2) for p in perf),
        n_s=n_s, p_bw_gups=round(p_bw, 2),
    )


def multicore_scaling(machine: X86Machine, kernel: DotKernel, n: int) -> float:
    """P(n) = min(n * P_ECM_mem, I * b_S) in GUP/s (paper §2)."""
    r = ecm_x86(machine, kernel)
    return min(n * r.perf_gups[3], r.p_bw_gups)


# ===========================================================================
# Part 2: the H100 and the port's streaming reductions
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class GPUMachine:
    """One NVIDIA GPU, as the model of the port's reductions sees it."""

    name: str
    sms: int                   # streaming multiprocessors
    fp32_lanes_per_sm: int     # float32 lanes: 4 sub-partitions x 32
    clock_mhz: float           # SM clock under load
    hbm_gbs: float             # peak HBM bandwidth (the bytes bound)
    load_gbs: float            # load-only bandwidth b_S (the model's t_hbm)
    fp32_tflops: float         # float32 peak outside the tensor cores
    bf16_tflops: float         # dense bf16 tensor-core peak
    nvlink_gbs: float          # NVLink bandwidth a GPU, both directions
    add_latency_cy: float      # dependent float32 add / fma latency
    #: GB/s that one SM's load ring moves at most (fitted on a naive
    #: row); None where no row shows such a limit
    sm_load_gbs: Optional[float] = None

    @property
    def cycles_per_ms(self) -> float:
        return self.clock_mhz * 1e3


#: NVIDIA H100 SXM5 80GB. Published (NVIDIA's H100 data sheet and
#: architecture white paper): 132 SMs, 128 float32 lanes an SM, 3.35 TB/s
#: HBM3, 67 TFLOP/s float32, 989 TFLOP/s dense bf16, 50 MB L2, 228 KB of
#: shared memory an SM, 80 GB, NVLink 900 GB/s; the dependent arithmetic
#: latency of 4 cycles is the CUDA C++ Programming Guide's ("most
#: arithmetic instructions", compute capability 7.x and later; the card
#: shows about 5.9 in these kernels, PERF.md §6, and the model keeps the
#: published figure so that no predicted row tunes it). Measured on the
#: card by ``chip_smoke.py`` phase 7 (PERF.md:212-216, NVIDIA H100 80GB
#: HBM3 at 700 W): the SM clock under load (``clock_under_load``), the
#: load-only bandwidth b_S (graph-timed ``torch.sum`` over 2^28 float32)
#: and one SM's load rate (fitted on the naive dot at U = 1, 32 SMs).
H100 = GPUMachine(
    name="H100 SXM5 80GB",
    sms=132,                   # published
    fp32_lanes_per_sm=128,     # published
    clock_mhz=1980.0,          # measured
    hbm_gbs=3350.0,            # published
    load_gbs=3062.6,           # measured
    fp32_tflops=67.0,          # published
    bf16_tflops=989.0,         # published
    # L2 50 MB, 228 KB of shared memory an SM, 80 GB HBM3: published, and
    # no term of the model reads them
    nvlink_gbs=900.0,          # published
    add_latency_cy=4.0,        # published
    sm_load_gbs=26.49,         # measured (fitted)
)

#: the unroll factors of the paper's sweep; ``u_s`` is the least of them
#: at which the bytes bound the kernel
UNROLLS = (1, 2, 4, 8, 16)

#: dependent float32 operations a step of the loop-carried chain of each
#: device function in ``csrc/schemes.cuh``, keyed by ``device_id``
#: (``schemes.NAIVE_ID`` .. ``DOT2_ID``); the same for ``update`` (sum)
#: and ``mul_update`` (dot):
#: - naive: s = fma(a, b, s) or s + x: 1.
#: - kahan: y = fma(a, b, c) (x + c) -> t = s + y -> t - s -> c = y - (t -
#:   s): 4.
#: - pairwise: s = fma(a, b, s): 1 (the fold c + s, s = 0 once in 32 steps
#:   breaks the chain; it is not on it).
#: - dot2: t = s + p and c + (ep + es), 1 each; TwoProd and the rest of
#:   TwoSum hang off the chain, so they cost issue slots, not latency.
CHAIN_OPS = {0: 1, 1: 4, 2: 1, 3: 1}


@dataclasses.dataclass(frozen=True)
class GPUKernel:
    """One of the port's streaming reductions (B1 / B3), per element."""

    name: str
    streams: int         # input streams (dot: 2, sum: 1)
    elem_bytes: int
    flops: int           # executed flops an element (the traced mix)
    dep_ops: int         # dependent operations a step of one chain


@dataclasses.dataclass(frozen=True)
class GPUECMResult:
    """The model's terms for one launch of ``n`` elements a row, ``batch``
    rows, at unroll ``unroll`` (times in ms). ``bound`` names the largest
    term ("hbm", "chain", "issue" or "sm"); ``bytes_bound_ms`` is the
    bytes over the peak HBM rate (the kernels' ``bound_ms``); ``u_s`` the
    least U of ``UNROLLS`` at which the bytes bound the kernel (None: none
    does)."""

    machine: str
    kernel: str
    n: int
    unroll: int
    batch: int
    chains: int          # chains a CTA (the plan's)
    ctas: int
    sms_used: int
    sm_chains: int       # chains on the busiest SM
    steps: int           # steps a chain
    t_hbm_ms: float
    t_chain_ms: float
    t_issue_ms: float
    t_sm_ms: float
    pred_ms: float
    bound: str
    bytes_bound_ms: float
    perf_gups: float
    p_bw_gups: float
    u_s: Optional[int]

    def shorthand(self) -> str:
        return (f"{{{self.t_hbm_ms:.4f} (hbm) | {self.t_chain_ms:.4f} "
                f"(chain) | {self.t_issue_ms:.4f} (issue) | "
                f"{self.t_sm_ms:.4f} (sm)}} ms")


def _gpu_terms(machine: GPUMachine, kernel: GPUKernel, n: int, unroll: int,
               batch: int) -> dict:
    from repro_torch.kernels.kahan_dot import reduce_plan

    cells = 1024 * unroll
    steps = -(-n // cells)
    chains = reduce_plan(batch, cells, steps, kernel.elem_bytes,
                         kernel.streams, machine.sms)[0]
    ctas = batch * cells // chains
    sm_chains = -(-ctas // machine.sms) * chains   # on the busiest SM
    per_ms = machine.cycles_per_ms
    total_bytes = batch * (steps * kernel.streams + 2) * cells \
        * kernel.elem_bytes
    sm_bytes = sm_chains * steps * kernel.streams * kernel.elem_bytes
    lanes = min(machine.fp32_lanes_per_sm, sm_chains)
    terms = {
        "hbm": total_bytes / (machine.load_gbs * 1e6),
        "chain": steps * kernel.dep_ops * machine.add_latency_cy / per_ms,
        "issue": sm_chains * steps * kernel.flops / (lanes * per_ms),
        "sm": (sm_bytes / (machine.sm_load_gbs * 1e6)
               if machine.sm_load_gbs else 0.0),
    }
    return dict(chains=chains, ctas=ctas, sms_used=min(ctas, machine.sms),
                sm_chains=sm_chains, steps=steps, terms=terms,
                total_bytes=total_bytes, bound=max(terms, key=terms.get))


def ecm_gpu(machine: GPUMachine, kernel: GPUKernel, n: int, unroll: int,
            batch: int = 1) -> GPUECMResult:
    """The model's prediction for one launch of ``kernel`` over ``batch``
    rows of ``n`` elements (padded to a multiple of 1024 * ``unroll``) at
    unroll ``unroll``: the largest of t_hbm, t_chain, t_issue and t_sm, the
    CTAs and SMs of the plan the wrapper launches, and ``u_s``."""
    r = _gpu_terms(machine, kernel, n, unroll, batch)
    t = r["terms"]
    pred = max(t.values())
    u_s = next((u for u in UNROLLS
                if _gpu_terms(machine, kernel, n, u, batch)["bound"] == "hbm"),
               None)
    return GPUECMResult(
        machine=machine.name, kernel=kernel.name, n=n, unroll=unroll,
        batch=batch, chains=r["chains"], ctas=r["ctas"],
        sms_used=r["sms_used"], sm_chains=r["sm_chains"], steps=r["steps"],
        t_hbm_ms=t["hbm"],
        t_chain_ms=t["chain"], t_issue_ms=t["issue"], t_sm_ms=t["sm"],
        pred_ms=pred, bound=r["bound"],
        bytes_bound_ms=r["total_bytes"] / (machine.hbm_gbs * 1e6),
        perf_gups=batch * n / (pred * 1e6),
        p_bw_gups=machine.load_gbs / (kernel.streams * kernel.elem_bytes),
        u_s=u_s)


#: how far a measured time must exceed the prediction without an SM limit
#: before ``fit_sm_load_gbs`` reads such a limit into it
SM_LIMIT_MARGIN = 0.05


def fit_sm_load_gbs(machine: GPUMachine, kernel: GPUKernel, n: int,
                    unroll: int, measured_ms: float) -> Optional[float]:
    """One SM's load rate (GB/s) implied by a measured time that the other
    terms leave unexplained: the busiest SM's bytes over that time, where
    it exceeds the prediction without an SM limit by more than
    ``SM_LIMIT_MARGIN``; None where it does not (no such limit shows). Fit
    it on a naive row only: the other schemes' rows are what the model
    predicts."""
    r = ecm_gpu(dataclasses.replace(machine, sm_load_gbs=None), kernel, n,
                unroll)
    if measured_ms <= (1.0 + SM_LIMIT_MARGIN) * r.pred_ms:
        return None
    return (r.sm_chains * r.steps * kernel.streams * kernel.elem_bytes
            / (measured_ms * 1e6))


def chain_scaling(machine: GPUMachine, kernel: GPUKernel, n: int,
                  unroll: int) -> float:
    """The model's rate in GUP/s at unroll ``unroll``: n over the largest
    of its terms (``ecm_gpu(...).perf_gups``), the counterpart of
    ``multicore_scaling``. 1024 * U chains take the place of the cores:
    ``t_chain`` falls as U grows and ``t_hbm`` does not, so the rate rises
    with U until the bytes bound it."""
    return ecm_gpu(machine, kernel, n, unroll).perf_gups


# ===========================================================================
# Part 3: roofline terms for whole-model steps
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline for one (arch x shape x chips) step."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    machine: GPUMachine = H100

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.machine.bf16_tflops * 1e12)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.machine.hbm_gbs * 1e9)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (
            self.chips * self.machine.nvlink_gbs * 1e9)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic fully-overlapped step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, model_flops: float) -> float:
        """Fraction of peak: useful-FLOPs-time / predicted step time."""
        ideal = model_flops / (self.chips * self.machine.bf16_tflops * 1e12)
        return ideal / self.step_time_s if self.step_time_s > 0 else 0.0


# ===========================================================================
# Part 4: compensation-scheme registry bridge
# ===========================================================================

def _scheme(spec) -> "object":
    from repro_torch.kernels import schemes as _schemes

    if isinstance(spec, str):
        return _schemes.get(spec)  # fail-fast: lists the registered menu
    return spec


#: bytes per element for each supported accumulate dtype, by name
_ELEM_BYTES = {"bfloat16": 2, "float32": 4, "float64": 8}


def elem_bytes_for_dtype(compute_dtype) -> int:
    """Element width of a supported accumulate dtype: a name, a numpy
    dtype or scalar type, or a torch dtype. A torch dtype has neither
    ``.name`` nor ``__name__``, and ``str(torch.float32)`` is
    ``"torch.float32"``: its prefix is dropped."""
    name = (getattr(compute_dtype, "name", None)
            or getattr(compute_dtype, "__name__", None)
            or str(compute_dtype)).removeprefix("torch.")
    try:
        return _ELEM_BYTES[name]
    except KeyError:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_ELEM_BYTES)}; "
            f"got {compute_dtype!r}") from None


def dot_kernel_for_scheme(scheme: Union[str, object], *, simd: str = "avx",
                          elem_bytes: int = 4, compute_dtype=None,
                          name: Optional[str] = None) -> DotKernel:
    """x86 kernel description for a registered scheme: the registry owns
    the adds/muls per scalar iteration, the caller picks the SIMD variant
    and element width."""
    sch = _scheme(scheme)
    mix = sch.instruction_mix
    if compute_dtype is not None:
        elem_bytes = elem_bytes_for_dtype(compute_dtype)
    return DotKernel(name or sch.name, adds=mix.adds, muls=mix.muls,
                     loads=2, flops=2, elem_bytes=elem_bytes, simd=simd)


def gpu_kernel_for_scheme(scheme: Union[str, object], *, op: str = "dot",
                          elem_bytes: int = 4, compute_dtype=None,
                          name: Optional[str] = None) -> GPUKernel:
    """H100 kernel description of a registered scheme's dot (``op="dot"``,
    B1/B2: the product path's traced flops) or sum (``op="sum"``, B3/B4:
    the sum path's). The chain is the device function's (``CHAIN_OPS``);
    a scheme registered at runtime, which has none, falls back to its
    flops a step: every op dependent, the reference TPU model's
    sequential assumption."""
    sch = _scheme(scheme)
    mix = sch.instruction_mix
    if compute_dtype is not None:
        elem_bytes = elem_bytes_for_dtype(compute_dtype)
    if op == "dot":
        streams, flops = 2, sum(mix.traced_dot)
    elif op == "sum":
        streams, flops = 1, sum(mix.traced_sum)
    else:
        raise ValueError(f"op must be 'dot' or 'sum'; got {op!r}")
    dep = CHAIN_OPS.get(sch.device_id, flops)
    return GPUKernel(name or f"{sch.name}-{op}", streams=streams,
                     elem_bytes=elem_bytes, flops=flops, dep_ops=dep)


def registry_dot_kernels(*, simd: str = "avx", elem_bytes: int = 4,
                         compute_dtype=None) -> Dict[str, DotKernel]:
    """One x86 kernel description per *currently registered* scheme."""
    from repro_torch.kernels import schemes as _schemes

    return {n: dot_kernel_for_scheme(s, simd=simd, elem_bytes=elem_bytes,
                                     compute_dtype=compute_dtype)
            for n, s in _schemes.registered().items()}


def registry_gpu_kernels(*, op: str = "dot", elem_bytes: int = 4,
                         compute_dtype=None) -> Dict[str, GPUKernel]:
    """One H100 kernel description per *currently registered* scheme."""
    from repro_torch.kernels import schemes as _schemes

    return {n: gpu_kernel_for_scheme(s, op=op, elem_bytes=elem_bytes,
                                     compute_dtype=compute_dtype)
            for n, s in _schemes.registered().items()}


def ecm_gpu_for_scheme(machine: GPUMachine, scheme: Union[str, object],
                       n: int, unroll: int = 8, *, op: str = "dot",
                       batch: int = 1, **kernel_kwargs) -> GPUECMResult:
    """The H100 prediction straight from a scheme name (schemes
    registered at runtime included)."""
    return ecm_gpu(machine, gpu_kernel_for_scheme(scheme, op=op,
                                                  **kernel_kwargs),
                   n, unroll, batch)


@dataclasses.dataclass(frozen=True)
class CostExpectation:
    """What the model EXPECTS a scheme's kernel body to cost, per element:
    the add/mul counts of the product path (``mul_update``; the dot
    kernel) and the sum path (``update``; the sum kernel and the matmul /
    flash fold sites) at their raw traced accounting
    (``InstructionMix.traced_dot`` / ``traced_sum``), plus the streamed
    bytes per element at the accumulate dtype. ``table_flops`` is the
    canonical per-element flop total the model's tables use; a deliberate
    canonical-vs-traced split (dot2's fma accounting) shows as a
    difference here."""

    scheme: str
    dot_adds: int        # mul_update path, adds per element
    dot_muls: int        # mul_update path, muls per element
    sum_adds: int        # update path, adds per element (muls are 0)
    elem_bytes: int      # bytes per element at the accumulate dtype
    streams: int         # input streams (dot: 2, asum: 1)
    table_flops: int     # canonical flops/elem the model's tables use

    @property
    def load_bytes_per_elem(self) -> int:
        return self.streams * self.elem_bytes

    @property
    def traced_flops(self) -> int:
        """Raw per-element flops the dot body executes."""
        return self.dot_adds + self.dot_muls


def expected_cost(scheme: Union[str, object], *, compute_dtype=None,
                  elem_bytes: int = 4, streams: int = 2) -> CostExpectation:
    """The model-side cost expectation for one registered scheme: counts
    from its ``instruction_mix``, bytes from ``elem_bytes_for_dtype``."""
    sch = _scheme(scheme)
    if compute_dtype is not None:
        elem_bytes = elem_bytes_for_dtype(compute_dtype)
    dot_adds, dot_muls = sch.instruction_mix.traced_dot
    sum_adds, _ = sch.instruction_mix.traced_sum
    return CostExpectation(
        scheme=sch.name, dot_adds=dot_adds, dot_muls=dot_muls,
        sum_adds=sum_adds, elem_bytes=elem_bytes, streams=streams,
        table_flops=sch.instruction_mix.flops)


def predicted_us_per_call(scheme: Union[str, object], n: int, *,
                          machine: GPUMachine = H100, unroll: int = 8,
                          op: str = "dot") -> float:
    """The model's time (µs) of one length-``n`` float32 dot or sum at
    unroll ``unroll`` on ``machine``: the model column beside a measured
    kernel time."""
    return ecm_gpu_for_scheme(machine, scheme, n, unroll,
                              op=op).pred_ms * 1e3


def model_relative_error(predicted_us: float, measured_us: float) -> float:
    """|measured - predicted| / measured, the model-honesty scalar."""
    if measured_us <= 0.0:
        return float("inf")
    return abs(measured_us - predicted_us) / measured_us


# Named kernel constants, derived lazily (PEP 562 module __getattr__) from
# the registry, so importing this module does not import the kernels
# package. Resolved values are cached in module globals.
_REGISTRY_CONSTANTS = {
    # paper Table 1/2 x86 variants
    "NAIVE_SP": lambda: dot_kernel_for_scheme("naive", simd="avx",
                                              name="naive"),
    "KAHAN_SCALAR_SP": lambda: dot_kernel_for_scheme(
        "kahan", simd="scalar", name="kahan-scalar"),
    "KAHAN_SSE_SP": lambda: dot_kernel_for_scheme("kahan", simd="sse",
                                                  name="kahan-sse"),
    "KAHAN_AVX_SP": lambda: dot_kernel_for_scheme("kahan", simd="avx",
                                                  name="kahan-avx"),
    "KAHAN_SCALAR_DP": lambda: dot_kernel_for_scheme(
        "kahan", simd="scalar", elem_bytes=8, name="kahan-scalar-dp"),
    "KAHAN_AVX_DP": lambda: dot_kernel_for_scheme(
        "kahan", simd="avx", elem_bytes=8, name="kahan-avx-dp"),
    # the H100's B1 (dot) and B3 (sum) at float32
    "NAIVE_DOT_H100": lambda: gpu_kernel_for_scheme("naive",
                                                    name="naive-dot"),
    "KAHAN_DOT_H100": lambda: gpu_kernel_for_scheme("kahan",
                                                    name="kahan-dot"),
    "DOT2_H100": lambda: gpu_kernel_for_scheme("dot2", name="dot2"),
    "NAIVE_SUM_H100": lambda: gpu_kernel_for_scheme("naive", op="sum",
                                                    name="naive-sum"),
    "KAHAN_SUM_H100": lambda: gpu_kernel_for_scheme("kahan", op="sum",
                                                    name="kahan-sum"),
}


def __getattr__(name: str):
    try:
        make = _REGISTRY_CONSTANTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    value = make()
    globals()[name] = value  # cache: derive once per process
    return value
