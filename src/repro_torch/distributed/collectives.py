"""Cross-rank compensated reductions (counterpart of
``repro/distributed/collectives.py``).

The engine's sharded path: each rank runs the compensated kernel on its
own shard (B3, B1 or B5 on the card, the plain version on the CPU), the
per-rank ``(s, c)`` accumulator grids are all-gathered in rank order, and
ONE deterministic two-sum tree (``engine.merge_accumulators`` /
``merge_accumulator_grids``) folds them on every rank. No float
``all_reduce`` anywhere: its reduction order is the backend's, and the
result here is bitwise reproducible for a fixed axis size.

Input convention (``shard_map``'s ``P(axis)``): every rank passes the
whole tensor, replicated, and reduces its contiguous block in rank order
along the sharded dimension; a length that does not divide by the axis
size raises. ``mesh`` is a ``DeviceMesh`` (``launch.mesh.make_local_mesh``)
and ``axis`` one of its dimension names.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kahan as K
from repro_torch.kernels.engine import (
    CompensatedReduction,
    SchemeSpec,
    merge_accumulator_grids,
    merge_accumulators,
)

Tensor = torch.Tensor


def axis_size(mesh, axis: str = "data") -> int:
    """Ranks along ``axis`` of a ``DeviceMesh`` (1 for no mesh or an axis
    it does not name)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _axis(mesh, axis: str):
    """(process group, its size, this rank's index in it)."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _shard(x: Tensor, dim: int, n: int, r: int, what: str) -> Tensor:
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what}: dimension {dim} of {tuple(x.shape)} does "
                         f"not divide by the axis size {n}")
    return x.narrow(dim, r * (size // n), size // n).contiguous()


def merge_sharded_accumulators(s_gathered: Tensor, c_gathered: Tensor,
                               ) -> Tensor:
    """Collapse all-gathered per-rank grids ``[n, rows, lanes]`` (rank
    order) to one scalar: the single-device two-sum tree on the stacked
    grids, so the sharded result equals ``merge_accumulators`` on the same
    data on one device."""
    return merge_accumulators(s_gathered, c_gathered)


def _sharded_reduce(mesh, axis: str, what: str, accumulate, *xs) -> Tensor:
    group, n, r = _axis(mesh, axis)
    acc = accumulate(*(_shard(x, 0, n, r, what) for x in xs))
    return merge_sharded_accumulators(K.gather_ranks(acc.s, group),
                                      K.gather_ranks(acc.c, group))


def sharded_asum(mesh, x: Tensor, *, axis: str = "data",
                 scheme: SchemeSpec = None, unroll: Optional[int] = None,
                 compute_dtype=None) -> Tensor:
    """Compensated sum of ``x`` sharded over ``axis`` (dimension 0): the
    engine's sum kernel on this rank's block, the grids gathered, the
    tree folded. A compute-dtype scalar, the same bits on every rank.
    ``scheme`` / ``unroll`` / ``compute_dtype`` as the engine's (None:
    the ambient policy)."""
    eng = CompensatedReduction(scheme=scheme, unroll=unroll,
                               compute_dtype=compute_dtype)
    return _sharded_reduce(mesh, axis, "sharded_asum", eng.sum_accumulators,
                           x)


def sharded_dot(mesh, a: Tensor, b: Tensor, *, axis: str = "data",
                scheme: SchemeSpec = None, unroll: Optional[int] = None,
                compute_dtype=None) -> Tensor:
    """Compensated dot of two identically sharded tensors (see
    ``sharded_asum``)."""
    eng = CompensatedReduction(scheme=scheme, unroll=unroll,
                               compute_dtype=compute_dtype)
    return _sharded_reduce(mesh, axis, "sharded_dot", eng.dot_accumulators,
                           a, b)


def sharded_matmul(mesh, a: Tensor, b: Tensor, *, axis: str = "data",
                   scheme: SchemeSpec = None,
                   block_m: Optional[int] = None,
                   block_n: Optional[int] = None,
                   block_k: Optional[int] = None,
                   compute_dtype=None) -> Tensor:
    """``a @ b`` with K sharded over ``axis``: ``a`` [M, K] on its second
    dimension, ``b`` [K, N] on its first. Each rank runs the engine's
    matmul kernel on its K-slice (blocks clamped to the slice), the
    ``[M_pad, N_pad]`` (s, c) grids are gathered and folded rank-major,
    elementwise, by the two-sum tree. Returns the [M, N] product in the
    compute dtype on every rank."""
    eng = CompensatedReduction(scheme=scheme, compute_dtype=compute_dtype)
    group, n, r = _axis(mesh, axis)
    m, cols = a.shape[0], b.shape[1]
    acc = eng.matmul_accumulators(
        _shard(a, 1, n, r, "sharded_matmul"),
        _shard(b, 0, n, r, "sharded_matmul"),
        block_m=block_m, block_n=block_n, block_k=block_k)
    out = merge_accumulator_grids(K.gather_ranks(acc.s, group),
                                  K.gather_ranks(acc.c, group))
    return out[:m, :cols]


def deterministic_mean(mesh, values: Tensor, axis: str = "data") -> Tensor:
    """Bitwise-deterministic mean of per-rank scalars: ``values`` holds
    one float32 value a rank along ``axis`` (rank ``r`` takes ``values[r]``);
    the ``(value, 0)`` pairs are gathered and folded in rank order by
    ``compensated_psum_scalar``, then divided by the axis size."""
    group, n, r = _axis(mesh, axis)
    v = _shard(values.reshape(-1), 0, n, r, "deterministic_mean")[0]
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    s, c = K.kahan_step(zero, zero, v.float())
    rs, rc = K.compensated_psum_scalar(s, c, group)
    return K.div(K.add(rs, rc), K.scalar_like(n, rs))


def expected_grad_spec(param_spec):
    """Gradients share their parameter's sharding (ZeRO: the
    reduce-scatter is implied by emitting grads in the param's spec)."""
    return param_spec
