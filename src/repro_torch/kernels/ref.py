"""Plain oracles of the compensated reductions (counterpart of
``repro/kernels/ref.py:52-116``).

Each oracle views the data as ``[steps, rows, lanes]``, folds it into a
``(rows, lanes)`` accumulator grid with the scheme's own callables and
merges with the engine's two-sum tree. With ``rows = 8 * unroll`` it is
bitwise equal to the corresponding ``ops`` entry point. Unlike the
engine, the oracles pad to ``rows * lanes`` only, so an empty input folds
no step at all (the total is still 0).
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import schemes as _schemes
from repro_torch.kernels.engine import merge_accumulators
from repro_torch.kernels.schemes import CompensationScheme

Tensor = torch.Tensor
SchemeSpec = Union[str, CompensationScheme, None]


def _pad_to(x: Tensor, multiple: int) -> Tensor:
    pad = (-x.shape[-1]) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
    return x


def _fold(xs, rows: int, lanes: int, sch: CompensationScheme, dot: bool):
    lead = xs[0].shape[:-1]
    views = [x.reshape(*lead, -1, rows, lanes) for x in xs]
    s = xs[0].new_zeros((*lead, rows, lanes))
    c = torch.zeros_like(s)
    for g in range(views[0].shape[-3]):
        if dot:
            s, c = sch.mul_update(s, c, views[0][..., g, :, :],
                                  views[1][..., g, :, :], g)
        else:
            s, c = sch.update(s, c, views[0][..., g, :, :], g)
    return s, c


def dot_ref(a: Tensor, b: Tensor, scheme: SchemeSpec = None, rows: int = 8,
            lanes: int = 128, *, compute_dtype=None) -> Tensor:
    """Oracle for the dot kernels."""
    sch = _schemes.resolve_scheme(scheme)
    cdt = _schemes.resolve_compute_dtype(compute_dtype)
    a = _pad_to(a.reshape(-1).to(cdt), rows * lanes)
    b = _pad_to(b.reshape(-1).to(cdt), rows * lanes)
    return merge_accumulators(*_fold((a, b), rows, lanes, sch, True))


def sum_ref(x: Tensor, scheme: SchemeSpec = None, rows: int = 8,
            lanes: int = 128, *, compute_dtype=None) -> Tensor:
    """Oracle for the sum kernels."""
    sch = _schemes.resolve_scheme(scheme)
    cdt = _schemes.resolve_compute_dtype(compute_dtype)
    x = _pad_to(x.reshape(-1).to(cdt), rows * lanes)
    return merge_accumulators(*_fold((x,), rows, lanes, sch, False))


def batched_dot_ref(a: Tensor, b: Tensor, scheme: SchemeSpec = None,
                    rows: int = 8, lanes: int = 128, *,
                    compute_dtype=None) -> Tensor:
    """Oracle for the batched dot grid: the single oracle per row."""
    return torch.stack([dot_ref(x, y, scheme, rows, lanes,
                                compute_dtype=compute_dtype)
                        for x, y in zip(a, b)])


def batched_sum_ref(x: Tensor, scheme: SchemeSpec = None, rows: int = 8,
                    lanes: int = 128, *, compute_dtype=None) -> Tensor:
    """Oracle for the batched sum grid: the single oracle per row."""
    return torch.stack([sum_ref(r, scheme, rows, lanes,
                                compute_dtype=compute_dtype) for r in x])
