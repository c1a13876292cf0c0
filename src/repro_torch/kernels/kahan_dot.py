"""Compensated dot product: the wrapper of the Hopper kernel
``kahan_dot_grid`` (``csrc/kahan_reduce.cu``) and its plain version.

Counterpart of ``repro/kernels/kahan_dot.py``. The reference runs
``_dot_kernel`` on a Pallas grid ``(steps,)`` (``dot_accumulators``) or
``(batch, steps)`` (``dot_accumulators_batched``) with one ``(8U, 128)``
block per step; cell ``(r, l)`` folds element ``g*8U*128 + r*128 + l`` by
``scheme.mul_update`` at step ``g``. Here one CUDA launch serves both
calls (``blockIdx.y`` is the batch row); the layout and the rounding
sequence are the reference's, so the ``(s, c)`` grids are bitwise equal.
How the launch is cut into CTAs and how deep its shared-memory load ring
runs is planned here, on the host (``reduce_plan``), and changes no bit.

Which path runs depends only on where the tensors lie: on the CPU the
plain version (``dot_plain``), on a CUDA tensor the kernel. A scheme
registered at runtime has no device function and raises on a CUDA
tensor; a kernel that fails to build or launch raises. Nothing falls
back to the plain version on the card.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.kahan import flush
from repro_torch.kernels import _build, abstract
from repro_torch.kernels.schemes import CompensationScheme

Tensor = torch.Tensor
LANES = 128
SUBLANES = 8

#: the kernel's CTA widths (chains, one consumer thread each), widest
#: first; the steps a ring stage may hold, deepest first; the shared
#: memory a plan gives the rings of one SM's resident CTAs, and a stage at
#: most; a CTA's shared memory limit
CTA_CHAINS = (128, 64, 32)
STAGE_DEPTHS = (64, 32, 16, 8)
RING_BYTES = 64 * 1024
STAGE_BYTES = 16 * 1024
SMEM_LIMIT = 232448

Plan = Tuple[int, int, int, int]


def reduce_smem_bytes(chains: int, depth: int, stages: int, itemsize: int,
                      operands: int) -> int:
    """Dynamic shared memory of one CTA of ``kahan_dot_grid`` (``operands``
    2) or ``kahan_sum_grid`` (1), in bytes: ``stages`` stages of ``depth``
    steps of ``chains`` lanes of each operand, then a full and an empty
    mbarrier (8 bytes each) a stage."""
    return stages * (operands * depth * chains * itemsize + 16)


@functools.lru_cache(maxsize=None)
def reduce_plan(batch: int, cells: int, steps: int, itemsize: int,
                operands: int, sms: int = 132) -> Plan:
    """``(chains, depth, stages, smem_bytes)`` of a launch on ``batch``
    rows of ``steps`` steps of ``cells`` accumulator cells, ``operands``
    streams (2 for the dot, 1 for the sum) of ``itemsize``-byte elements:

    - chains a CTA: the widest of ``CTA_CHAINS`` that divides ``cells``
      and puts the fewest chains on the busiest of ``sms`` SMs (all CTAs
      resident): 64 at U = 8 for one row (128 CTAs), 32 at U = 1, 128 for
      the batched shapes;
    - the ring: ``RING_BYTES`` shared by the CTAs an SM holds, in stages
      of at most ``STAGE_BYTES`` and half the CTA's ring, as deep as that
      allows (16 KB: 32 steps of the dot at 64 float32 chains, 64 of the
      sum) but no deeper than the steps round up to; at least 2 stages,
      and no more than the steps fill.

    The bits do not depend on the plan. Cached: the wrappers ask at every
    launch."""
    if batch < 1 or steps < 1 or operands not in (1, 2):
        raise ValueError(f"reduce plan: batch={batch}, steps={steps}, "
                         f"operands={operands}")
    widths = [c for c in CTA_CHAINS if cells % c == 0]
    if not widths:
        raise ValueError(f"reduce plan: cells={cells} is not a multiple of "
                         f"{CTA_CHAINS[-1]}")

    def ctas_per_sm(chains: int) -> int:
        return -(-(batch * cells // chains) // sms)

    chains = min(widths, key=lambda c: (ctas_per_sm(c) * c, -c))
    step_bytes = operands * chains * itemsize
    ring = RING_BYTES // ctas_per_sm(chains)
    stage = min(STAGE_BYTES, ring // 2)
    shallowest = STAGE_DEPTHS[-1]
    depth = next((d for d in STAGE_DEPTHS if d * step_bytes <= stage),
                 shallowest)
    depth = min(depth, max(shallowest, 1 << (steps - 1).bit_length()))
    stages = min(max(2, ring // (depth * step_bytes)), -(-steps // depth))
    return (chains, depth, stages,
            reduce_smem_bytes(chains, depth, stages, itemsize, operands))


#: how the kernel's producer warps fill the ring (the C entries' codes):
#: one element a copy (operands off 16 bytes), or 16-byte cp.async
COPY = {"element": 0, "cp.async": 1}


def copy_path(*tensors: Tensor) -> str:
    """The ring's copy path for these operands: 16-byte copies when every
    one starts on 16 bytes, else one element a copy."""
    return ("cp.async" if all(t.data_ptr() % 16 == 0 for t in tensors)
            else "element")


def dot_plain(a: Tensor, b: Tensor, *, scheme: CompensationScheme,
              unroll: int = 8) -> Tuple[Tensor, Tensor]:
    """The plain PyTorch version: ``[B, n]`` inputs in the compute dtype,
    padded to a multiple of ``8U * 128`` -> ``[B, 8U, 128]`` (s, c) grids.
    A loop over steps; each step updates the whole grid elementwise, so a
    batch row rounds exactly as it would alone."""
    rows = SUBLANES * unroll
    batch, n = a.shape
    a3 = flush(a).reshape(batch, -1, rows, LANES)
    b3 = flush(b).reshape(batch, -1, rows, LANES)
    s = torch.zeros((batch, rows, LANES), dtype=a.dtype, device=a.device)
    c = torch.zeros_like(s)
    for g in range(a3.shape[1]):
        s, c = scheme.mul_update(s, c, a3[:, g], b3[:, g], g)
    return s, c


def _launch(a: Tensor, b: Tensor, scheme: CompensationScheme, unroll: int,
            counter, plan: Optional[Plan] = None,
            copy: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """One wrapper call: the plain version on CPU tensors, else one counted
    launch of the kernel under ``plan`` (``reduce_plan``'s unless given)
    on the copy path ``copy`` (``copy_path``'s unless given)."""
    rows = SUBLANES * unroll
    cells = rows * LANES
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"dot kernel: want equal [B, n] operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"dot kernel: operand dtypes differ: {a.dtype} vs "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"dot kernel: operands on {a.device} and {b.device}")
    batch, n = a.shape
    if n == 0 or n % cells:
        raise ValueError(f"dot kernel: n={n} must be a positive multiple of "
                         f"8*unroll*128={cells} (the caller pads)")
    if type(a) is not Tensor and abstract.screen(counter.__name__, a, b):
        s, c = (a.new_empty((batch, rows, LANES)) for _ in range(2))
        abstract.record(counter.__name__, 2 * batch * n,
                        abstract.nbytes(a, b, s, c))
        return s, c
    if a.device.type == "cpu":
        return dot_plain(a, b, scheme=scheme, unroll=unroll)
    if a.device.type != "cuda":
        raise ValueError(f"dot kernel: unsupported device {a.device}")
    if scheme.device_id is None:
        raise NotImplementedError(
            f"scheme {scheme.name!r} has no CUDA device function (only the "
            f"built-in schemes do); it runs on CPU tensors only")
    if a.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"no CUDA instantiation for {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("dot kernel: operands must be contiguous")
    if not 1 <= batch <= 65535:
        raise ValueError(f"dot kernel: batch={batch} outside [1, 65535]")
    s = torch.empty((batch, rows, LANES), dtype=a.dtype, device=a.device)
    c = torch.empty_like(s)
    if plan is None:
        plan = reduce_plan(batch, cells, n // cells, a.element_size(), 2,
                           sms=_build.sm_count(a.device))
    if copy is None:
        copy = copy_path(a, b)
    lib = _build.library("kahan_reduce")
    counter.launches += 1
    counter.plan, counter.copy = plan, copy
    err = lib.kahan_dot_launch(
        scheme.device_id, _build.DTYPE_CODE[a.dtype], a.data_ptr(),
        b.data_ptr(), s.data_ptr(), c.data_ptr(), batch, n, cells, *plan,
        COPY[copy], _build.stream_ptr(a.device))
    _build.check(err, "kahan_dot_grid")
    return s, c


def dot_accumulators(a: Tensor, b: Tensor, *, scheme: CompensationScheme,
                     unroll: int = 8) -> Tuple[Tensor, Tensor]:
    """1-D compensated dot: ``[n]`` operands (padded by the caller to a
    multiple of ``8U * 128``, in the compute dtype) -> ``[8U, 128]``
    (s, c) grids. Replaces ``repro/kernels/kahan_dot.py:89``."""
    s, c = _launch(a[None], b[None], scheme, unroll, dot_accumulators)
    return s[0], c[0]


def dot_accumulators_batched(a: Tensor, b: Tensor, *,
                             scheme: CompensationScheme, unroll: int = 8,
                             ) -> Tuple[Tensor, Tensor]:
    """Batched compensated dot: ``[B, n]`` -> ``[B, 8U, 128]`` (s, c)
    grids; each row rounds exactly as a single call would. Replaces
    ``repro/kernels/kahan_dot.py:139``."""
    return _launch(a, b, scheme, unroll, dot_accumulators_batched)


#: kernel launches made by each wrapper (chip_smoke.py reads and resets
#: them to show which path ran), and the plan and copy path of each one's
#: last launch
dot_accumulators.launches = 0
dot_accumulators_batched.launches = 0
dot_accumulators.plan = dot_accumulators_batched.plan = None
dot_accumulators.copy = dot_accumulators_batched.copy = None
