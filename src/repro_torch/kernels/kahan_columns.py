"""The column scan of the compensated global norm: the wrapper of the
Hopper kernel ``kahan_sq_columns`` (``csrc/kahan_reduce.cu``) and its
plain version.

``repro/core/kahan.py::tree_kahan_sq_norm`` scans each leaf of two or more
axes down its leading axis with ``lax.scan``: one Kahan chain per
trailing element, ``y = fma(row, row, c)`` (XLA contracts the square into
the step's first add on the CPU). It is no Pallas kernel, but a Python
loop over the rows of the ``[51200, 2048]`` embedding gradient is 51200
iterations of elementwise launches, so the port gives it a kernel: one
thread a trailing element, rows in ascending order, the same ops in the
same order, so its ``(s, c)`` vectors equal the plain loop's
(``core.kahan.column_sq_plain``) bit for bit.

A CPU tensor runs the plain loop; a CUDA tensor launches the kernel or
raises. Float32 and bfloat16 leaves go as they are (bfloat16 is widened
where it is read, as the reference casts every leaf to float32 first);
a leaf of any other floating dtype is cast to float32 first, as there.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.kahan import column_sq_plain
from repro_torch.kernels import _build, abstract

Tensor = torch.Tensor

#: leaf dtypes the kernel reads as they are
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def column_sq_accumulators(x: Tensor) -> Tuple[Tensor, Tensor]:
    """``x`` [R, ...] (R >= 1) -> float32 ``(s, c)`` of shape
    ``x.shape[1:]``: the compensated sums of squares of each trailing
    element over the rows, in ascending order."""
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"column scan: want a non-empty leaf of two or "
                         f"more axes, got {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        x = x.float()
    if type(x) is not Tensor and abstract.screen("column_sq_accumulators", x):
        s, c = (x.new_empty(x.shape[1:], dtype=torch.float32)
                for _ in range(2))
        abstract.record("column_sq_accumulators", 2 * x.numel(),
                        abstract.nbytes(x, s, c))
        return s, c
    if x.device.type == "cpu":
        return column_sq_plain(x.float())
    if x.device.type != "cuda":
        raise ValueError(f"column scan: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("column scan: the leaf must be contiguous")
    rows = x.shape[0]
    cols = x.numel() // rows
    s = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    c = torch.empty_like(s)
    lib = _build.library("kahan_reduce")
    column_sq_accumulators.launches += 1
    err = lib.kahan_sq_columns_launch(
        _build.DTYPE_CODE[x.dtype], x.data_ptr(), s.data_ptr(), c.data_ptr(),
        rows, cols, _build.stream_ptr(x.device))
    _build.check(err, "kahan_sq_columns")
    return s, c


#: kernel launches made by the wrapper
column_sq_accumulators.launches = 0
