"""Plain oracles of the compensated reductions (counterpart of
``repro/kernels/ref.py:52-160, 258``).

Each oracle views the data as ``[steps, rows, lanes]``, folds it into a
``(rows, lanes)`` accumulator grid with the scheme's own callables and
merges with the engine's two-sum tree. With ``rows = 8 * unroll`` it is
bitwise equal to the corresponding ``ops`` entry point. Unlike the
engine, the oracles pad to ``rows * lanes`` only, so an empty input folds
no step at all (the total is still 0). The matmul oracle folds K-blocks
of ``bk`` columns, each block product in the kernel's ascending order.
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


def matmul_ref(a: Tensor, b: Tensor, bk: int = 512,
               scheme: SchemeSpec = None, *, compute_dtype=None) -> Tensor:
    """Oracle of the matmul kernel: block products over K-blocks of ``bk``
    columns (zero-padded), folded with ``scheme.update`` at the block
    index, finalized ``s + c``. a ``[M, K]``, b ``[K, N]`` in any float
    dtype; accumulates in the compute dtype. Equal to ``ops.matmul`` bit
    for bit at the same ``bk``."""
    from repro_torch.kernels.kahan_matmul import block_product

    sch = _schemes.resolve_scheme(scheme)
    cdt = _schemes.resolve_compute_dtype(compute_dtype)
    a = _pad_to(a.to(cdt), bk)
    b = _pad_to(b.to(cdt).T, bk).T
    s = a.new_zeros((a.shape[0], b.shape[1]))
    c = torch.zeros_like(s)
    for g in range(a.shape[1] // bk):
        lo, hi = g * bk, (g + 1) * bk
        s, c = sch.update(s, c, block_product(a[:, lo:hi], b[lo:hi]), g)
    return s + c


def batched_matmul_ref(a: Tensor, b: Tensor, bk: int = 512,
                       scheme: SchemeSpec = None, *,
                       compute_dtype=None) -> Tensor:
    """Oracle of the batched matmul grid: the single oracle per batch
    index."""
    return torch.stack([matmul_ref(x, y, bk, scheme,
                                   compute_dtype=compute_dtype)
                        for x, y in zip(a, b)])


def matmul_exact_f64(a, b):
    """High-precision reference (numpy float64) for accuracy
    comparisons."""
    import numpy as np

    return np.asarray(a, np.float64) @ np.asarray(b, np.float64)


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor,
                        scheme: SchemeSpec = None, *, block_q: int = 256,
                        block_k: int = 256, causal: bool = True,
                        q_groups: int = 1, q_off: int = 0,
                        compute_dtype=None) -> Tensor:
    """Oracle of the flash engine (``repro/kernels/ref.py:161-257``): it
    replays the engine's policy (block clamps, promotion, zero-padding,
    ``s + c`` finalize and ``o / max(l, 1e-30)``) and runs the shared
    block body ``flash_block_update`` per query block and k-block, with
    k/v repeated ``q_groups`` times (pure data movement). Query rows are
    independent, so it is bitwise equal to the engine's
    ``flash_attention`` (``q_off = 0``) and, with ``causal=True``, to
    ``flash_chunk_attention`` (rows at ``q_off + i``). q ``[BH, Sq, dh]``; k/v ``[BH //
    q_groups, Skv, dh]``; returns ``[BH, Sq, dh]`` in the compute dtype."""
    from repro_torch.kernels.flash_attention import (
        NEG_INF, flash_block_update, softmax_scale)

    sch = _schemes.resolve_scheme(scheme)
    cdt = _schemes.resolve_compute_dtype(compute_dtype)
    bh, sq, dh = q.shape
    if k.shape[0] * q_groups != bh:
        raise ValueError(f"q has {bh} head-rows, k/v {k.shape[0]} with "
                         f"q_groups={q_groups}")
    k = k.repeat_interleave(q_groups, dim=0).to(cdt)
    v = v.repeat_interleave(q_groups, dim=0).to(cdt)
    skv = k.shape[1]
    block_q = min(block_q, -(-sq // 8) * 8)
    block_k = min(block_k, -(-skv // 128) * 128)
    n_qb, n_kb = -(-sq // block_q), -(-skv // block_k)
    q = torch.cat([q.to(cdt), q.new_zeros((bh, n_qb * block_q - sq, dh),
                                          dtype=cdt)], dim=1)
    pad = q.new_zeros((bh, n_kb * block_k - skv, dh))
    k, v = torch.cat([k, pad], dim=1), torch.cat([v, pad], dim=1)
    rows = []
    for qb in range(n_qb):
        qblk = q[:, qb * block_q:(qb + 1) * block_q]
        q_pos = (q_off + qb * block_q
                 + torch.arange(block_q, device=q.device))[:, None]
        m = torch.full((bh, block_q, 1), NEG_INF, dtype=cdt, device=q.device)
        l_s = torch.zeros((bh, block_q, 1), dtype=cdt, device=q.device)
        l_c = torch.zeros_like(l_s)
        a_s = torch.zeros_like(qblk)
        a_c = torch.zeros_like(qblk)
        for kb in range(n_kb):
            lo, hi = kb * block_k, (kb + 1) * block_k
            m, l_s, l_c, a_s, a_c = flash_block_update(
                sch, qblk, k[:, lo:hi], v[:, lo:hi], m, l_s, l_c, a_s, a_c,
                q_pos=q_pos,
                k_pos=torch.arange(lo, hi, device=q.device)[None, :],
                kv_len=skv, causal=causal,
                scale=softmax_scale(dh), step=kb)
        rows.append((a_s + a_c) / torch.clamp_min(l_s + l_c, 1e-30))
    return torch.cat(rows, dim=1)[:, :sq]
