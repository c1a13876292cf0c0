"""Opcode counts of the kernels' SASS (counterpart of
``repro/perf/hlo_analysis.py``).

The reference parses XLA's optimized HLO for two things: trip-count
corrected FLOPs, bytes and collective bytes of a compiled step, and a flat
opcode inventory (``HloModule.opcode_counts``, ``hlo_analysis.py:162``)
that its auditor's compiled-truth rules read. The first role already has
its counterpart in ``perf/roofline.py::DeviceCounter`` (the dry run counts
what each rank's ops and kernel entries do); it is not repeated here.
What this module ports is the second: the opcode inventory of what the
compiler made, which for the port is the SASS nvcc builds for ``sm_90a``.

``disassemble`` runs ``cuobjdump -sass`` over a built library;
``opcode_counts`` parses its text (or ``nvdisasm``'s) into per-function
opcode counts, predicates and modifiers dropped (``@!P0 FADD.FTZ R3, R2,
R5`` counts as one ``FADD``). ``cuobjdump`` ships with the CUDA toolkit,
and Triton carries a copy under ``triton/backends/nvidia/bin/``; without
it, ``disassemble`` raises.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Tuple

#: float adds / muls / fused ops of the probes and kernels (FP32, FP64 and
#: the packed half/bfloat16 forms)
ADD_OPS = frozenset(("FADD", "DADD", "HADD2", "FADD32I"))
MUL_OPS = frozenset(("FMUL", "DMUL", "HMUL2", "FMUL32I"))
FUSED_OPS = frozenset(("FFMA", "DFMA", "HFMA2", "FFMA32I"))
#: conversions and byte permutes: data movement no byte model counts
CONVERSION_OPS = frozenset(("F2F", "F2FP", "PRMT", "I2F", "F2I"))
#: tensor-core instructions (warp-level and Hopper warpgroup forms)
TENSOR_CORE_OPS = frozenset(("HMMA", "HGMMA", "IMMA", "IGMMA", "QGMMA",
                             "DMMA", "BMMA", "BGMMA"))

#: kernels whose fixed-order chains forbid tensor cores (B1-B6) and the
#: sum instantiations (B3/B4), by their source name
FIXED_ORDER_KERNELS = frozenset(("kahan_dot_grid", "kahan_sum_grid",
                                 "kahan_matmul_rows", "kahan_matmul_grid"))
SUM_KERNELS = frozenset(("kahan_sum_grid",))

#: a packed half FMA whose multiplicands are both the zero register
#: (``HFMA2.MMA R3, -RZ, RZ, 0, 1.5`` materializes a constant, ``HFMA2
#: R1, -RZ, RZ, -R0`` negates a bf16 value): nvcc's move idiom, counted
#: apart as ``MOV_IDIOM``, not as arithmetic
MOV_IDIOM = "HFMA2.MOV"

_FUNC_RE = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN_RE = re.compile(
    r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
    r"(?:\.[A-Z0-9_.]+)?\b([^;]*)")


def _is_zero_reg(operand: str) -> bool:
    return operand.strip().lstrip("-|").startswith("RZ")


def _opcode(m: "re.Match") -> str:
    op, operands = m.group(1), m.group(2).split(",")
    if op == "HFMA2" and len(operands) >= 3 and _is_zero_reg(operands[1]) \
            and _is_zero_reg(operands[2]):
        return MOV_IDIOM
    return op


def opcode_counts(sass: str) -> Dict[str, Dict[str, int]]:
    """function -> {opcode: count} of ``cuobjdump -sass`` (or
    ``nvdisasm``) text: every instruction line counted once under its base
    opcode (predicate and ``.`` modifiers dropped; nvcc's zero-multiplicand
    HFMA2 move idiom under ``MOV_IDIOM``)."""
    out: Dict[str, Counter] = {}
    current: Optional[str] = None
    for line in sass.splitlines():
        m = _FUNC_RE.match(line)
        if m or line.startswith(".text."):
            # nvdisasm heads a function with ".text.<function>:"
            current = m.group(1) if m else \
                line[len(".text."):].split(":")[0].strip()
            out.setdefault(current, Counter())
            continue
        m = _INSN_RE.match(line)
        if m and current is not None:
            out[current][_opcode(m)] += 1
    return {fn: dict(c) for fn, c in out.items()}


def float_mix(ops: Dict[str, int]) -> Tuple[int, int]:
    """(adds, muls) of one function's opcodes, a fused multiply-add
    counting one of each (the reference's jaxpr accounting)."""
    fused = sum(n for op, n in ops.items() if op in FUSED_OPS)
    adds = sum(n for op, n in ops.items() if op in ADD_OPS) + fused
    muls = sum(n for op, n in ops.items() if op in MUL_OPS) + fused
    return adds, muls


def float_ops(ops: Dict[str, int]) -> Dict[str, int]:
    """The float arithmetic opcodes of one function (for findings)."""
    return {op: n for op, n in sorted(ops.items())
            if op in ADD_OPS | MUL_OPS | FUSED_OPS}


def kernel_of(function: str) -> str:
    """The source name of a (mangled) kernel function: the longest known
    kernel name it contains, else the function name itself."""
    known = sorted(FIXED_ORDER_KERNELS | {"kahan_flash_grid",
                                          "kahan_sq_columns"},
                   key=len, reverse=True)
    return next((k for k in known if k in function), function)


def tool(name: str) -> str:
    """Path of a CUDA binary utility (``cuobjdump``): on
    PATH, under ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``, or Triton's
    copy; raises if none is found."""
    found = shutil.which(name)
    if found:
        return found
    dirs = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin",
            Path("/usr/local/cuda/bin")]
    try:
        import importlib.util

        spec = importlib.util.find_spec("triton")
        if spec is not None and spec.origin:
            dirs.append(Path(spec.origin).parent / "backends" / "nvidia"
                        / "bin")
    except (ImportError, ValueError):
        pass
    for d in dirs:
        path = d / name
        if os.access(path, os.X_OK):
            return str(path)
    raise RuntimeError(
        f"{name} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin or "
        f"triton/backends/nvidia/bin): the SASS level needs the CUDA "
        f"toolkit's disassembler")


def disassemble(library: Path) -> str:
    """SASS text of every kernel in a built shared library or cubin
    (``cuobjdump -sass``); raises where the tool is missing or fails."""
    proc = subprocess.run([tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or "Function" not in proc.stdout:
        raise RuntimeError(
            f"cuobjdump -sass {library}: exit {proc.returncode}: "
            f"{proc.stderr.strip()[:400]}")
    return proc.stdout
