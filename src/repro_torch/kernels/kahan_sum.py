"""Compensated sum: the wrapper of the Hopper kernel ``kahan_sum_grid``
(``csrc/kahan_reduce.cu``) and its plain version.

Counterpart of ``repro/kernels/kahan_sum.py``: the same accumulator
layout as ``kahan_dot`` with one input stream, folded by
``scheme.update`` (no fused multiply-add anywhere). This is the kernel the
serving engine's per-request telemetry launches on every decode tick.
See ``kahan_dot`` for the paths, the layout and the plan
(``reduce_plan`` with one operand).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.kahan import flush
from repro_torch.kernels import _build, abstract
from repro_torch.kernels.kahan_dot import (
    LANES,
    SUBLANES,
    COPY,
    Plan,
    copy_path,
    reduce_plan,
)
from repro_torch.kernels.schemes import CompensationScheme

Tensor = torch.Tensor

def sum_plain(x: Tensor, *, scheme: CompensationScheme,
              unroll: int = 8) -> Tuple[Tensor, Tensor]:
    """The plain PyTorch version: ``[B, n]`` (compute dtype, padded to a
    multiple of ``8U * 128``) -> ``[B, 8U, 128]`` (s, c) grids."""
    rows = SUBLANES * unroll
    batch, n = x.shape
    x3 = flush(x).reshape(batch, -1, rows, LANES)
    s = torch.zeros((batch, rows, LANES), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(s)
    for g in range(x3.shape[1]):
        s, c = scheme.update(s, c, x3[:, g], g)
    return s, c


def _launch(x: Tensor, scheme: CompensationScheme, unroll: int, counter,
            plan: Optional[Plan] = None, copy: Optional[str] = None,
            ) -> Tuple[Tensor, Tensor]:
    """One wrapper call, as ``kahan_dot._launch`` with one operand."""
    rows = SUBLANES * unroll
    cells = rows * LANES
    if x.dim() != 2:
        raise ValueError(f"sum kernel: want a [B, n] operand, got "
                         f"{tuple(x.shape)}")
    batch, n = x.shape
    if n == 0 or n % cells:
        raise ValueError(f"sum kernel: n={n} must be a positive multiple of "
                         f"8*unroll*128={cells} (the caller pads)")
    if type(x) is not Tensor and abstract.screen(counter.__name__, x):
        s, c = (x.new_empty((batch, rows, LANES)) for _ in range(2))
        abstract.record(counter.__name__, batch * n, abstract.nbytes(x, s, c))
        return s, c
    if x.device.type == "cpu":
        return sum_plain(x, scheme=scheme, unroll=unroll)
    if x.device.type != "cuda":
        raise ValueError(f"sum kernel: unsupported device {x.device}")
    if scheme.device_id is None:
        raise NotImplementedError(
            f"scheme {scheme.name!r} has no CUDA device function (only the "
            f"built-in schemes do); it runs on CPU tensors only")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"no CUDA instantiation for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("sum kernel: operand must be contiguous")
    if not 1 <= batch <= 65535:
        raise ValueError(f"sum kernel: batch={batch} outside [1, 65535]")
    s = torch.empty((batch, rows, LANES), dtype=x.dtype, device=x.device)
    c = torch.empty_like(s)
    if plan is None:
        plan = reduce_plan(batch, cells, n // cells, x.element_size(), 1,
                           sms=_build.sm_count(x.device))
    if copy is None:
        copy = copy_path(x)
    lib = _build.library("kahan_reduce")
    counter.launches += 1
    counter.plan, counter.copy = plan, copy
    err = lib.kahan_sum_launch(
        scheme.device_id, _build.DTYPE_CODE[x.dtype], x.data_ptr(),
        s.data_ptr(), c.data_ptr(), batch, n, cells, *plan, COPY[copy],
        _build.stream_ptr(x.device))
    _build.check(err, "kahan_sum_grid")
    return s, c


def sum_accumulators(x: Tensor, *, scheme: CompensationScheme,
                     unroll: int = 8) -> Tuple[Tensor, Tensor]:
    """1-D compensated sum: ``[n]`` (padded, compute dtype) -> ``[8U, 128]``
    (s, c) grids. Replaces ``repro/kernels/kahan_sum.py:63``."""
    s, c = _launch(x[None], scheme, unroll, sum_accumulators)
    return s[0], c[0]


def sum_accumulators_batched(x: Tensor, *, scheme: CompensationScheme,
                             unroll: int = 8) -> Tuple[Tensor, Tensor]:
    """Batched compensated sum: ``[B, n]`` -> ``[B, 8U, 128]`` (s, c)
    grids. Replaces ``repro/kernels/kahan_sum.py:105``; the serving
    telemetry launches it at ``[max_slots, 57344]`` on every decode
    tick."""
    return _launch(x, scheme, unroll, sum_accumulators_batched)


#: kernel launches made by each wrapper, and the plan and copy path of
#: each one's last launch
sum_accumulators.launches = 0
sum_accumulators_batched.launches = 0
sum_accumulators.plan = sum_accumulators_batched.plan = None
sum_accumulators.copy = sum_accumulators_batched.copy = None
