"""Compensated dot product: the wrapper of the Hopper kernel
``kahan_dot_grid`` (``csrc/kahan_reduce.cu``) and its plain version.

Counterpart of ``repro/kernels/kahan_dot.py``. The reference runs
``_dot_kernel`` on a Pallas grid ``(steps,)`` (``dot_accumulators``) or
``(batch, steps)`` (``dot_accumulators_batched``) with one ``(8U, 128)``
block per step; cell ``(r, l)`` folds element ``g*8U*128 + r*128 + l`` by
``scheme.mul_update`` at step ``g``. Here one CUDA launch serves both
calls (``blockIdx.y`` is the batch row); the layout and the rounding
sequence are the reference's, so the ``(s, c)`` grids are bitwise equal.

Which path runs depends only on where the tensors lie: on the CPU the
plain version (``dot_plain``), on a CUDA tensor the kernel. A scheme
registered at runtime has no device function and raises on a CUDA
tensor; a kernel that fails to build or launch raises. Nothing falls
back to the plain version on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.schemes import CompensationScheme

Tensor = torch.Tensor
LANES = 128
SUBLANES = 8

def dot_plain(a: Tensor, b: Tensor, *, scheme: CompensationScheme,
              unroll: int = 8) -> Tuple[Tensor, Tensor]:
    """The plain PyTorch version: ``[B, n]`` inputs in the compute dtype,
    padded to a multiple of ``8U * 128`` -> ``[B, 8U, 128]`` (s, c) grids.
    A loop over steps; each step updates the whole grid elementwise, so a
    batch row rounds exactly as it would alone."""
    rows = SUBLANES * unroll
    batch, n = a.shape
    a3 = a.reshape(batch, -1, rows, LANES)
    b3 = b.reshape(batch, -1, rows, LANES)
    s = torch.zeros((batch, rows, LANES), dtype=a.dtype, device=a.device)
    c = torch.zeros_like(s)
    for g in range(a3.shape[1]):
        s, c = scheme.mul_update(s, c, a3[:, g], b3[:, g], g)
    return s, c


def _launch(a: Tensor, b: Tensor, scheme: CompensationScheme, unroll: int,
            counter) -> Tuple[Tensor, Tensor]:
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
    lib = _build.library("kahan_reduce")
    counter.launches += 1
    err = lib.kahan_dot_launch(
        scheme.device_id, _build.DTYPE_CODE[a.dtype], a.data_ptr(),
        b.data_ptr(), s.data_ptr(), c.data_ptr(), batch, n, cells,
        _build.stream_ptr(a.device))
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
#: them to show which path ran)
dot_accumulators.launches = 0
dot_accumulators_batched.launches = 0
