"""Public entry points of the compensated reductions — a thin veneer over
``CompensatedReduction`` (counterpart of ``repro/kernels/ops.py``).

Every function takes ``scheme`` (a registered name, a
``CompensationScheme`` or a ``Policy``; None -> the ambient
``schemes.use_policy`` default) and ``compute_dtype``; the reductions
take ``unroll``, the matmuls ``block_m`` / ``block_n`` / ``block_k``
(None -> the policy's ``blocks``). The inputs' device decides where the
work runs: CUDA tensors launch the Hopper kernels, CPU tensors run their
plain versions.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.engine import CompensatedReduction, SchemeSpec

Tensor = torch.Tensor


def _engine(scheme: SchemeSpec, unroll: Optional[int],
            compute_dtype) -> CompensatedReduction:
    return CompensatedReduction(scheme=scheme, unroll=unroll,
                                compute_dtype=compute_dtype)


def dot(a: Tensor, b: Tensor, *, scheme: SchemeSpec = None,
        unroll: Optional[int] = None, compute_dtype=None) -> Tensor:
    """Compensated dot product of two tensors (raveled); compute-dtype
    scalar."""
    return _engine(scheme, unroll, compute_dtype).dot(a, b)


def asum(x: Tensor, *, scheme: SchemeSpec = None,
         unroll: Optional[int] = None, compute_dtype=None) -> Tensor:
    """Compensated sum of a tensor (raveled); compute-dtype scalar."""
    return _engine(scheme, unroll, compute_dtype).asum(x)


def batched_dot(a: Tensor, b: Tensor, *, scheme: SchemeSpec = None,
                unroll: Optional[int] = None, compute_dtype=None) -> Tensor:
    """[batch, n] x [batch, n] -> [batch] compensated dots in one launch —
    bitwise equal to a loop of ``dot`` calls."""
    return _engine(scheme, unroll, compute_dtype).batched_dot(a, b)


def batched_asum(x: Tensor, *, scheme: SchemeSpec = None,
                 unroll: Optional[int] = None, compute_dtype=None) -> Tensor:
    """[batch, n] -> [batch] compensated sums in one launch — bitwise
    equal to a loop of ``asum`` calls."""
    return _engine(scheme, unroll, compute_dtype).batched_asum(x)


def matmul(a: Tensor, b: Tensor, *, block_m: Optional[int] = None,
           block_n: Optional[int] = None, block_k: Optional[int] = None,
           scheme: SchemeSpec = None, compute_dtype=None) -> Tensor:
    """C = A @ B with compensated accumulation across K-blocks
    (compute-dtype result). Pads N and K to block multiples and slices N
    back; M goes in as it is (the kernel masks the rows past it, and a
    row's bits do not depend on M). Differentiable, its backward through
    the same compensated kernel."""
    return _engine(scheme, None, compute_dtype).matmul(
        a, b, block_m=block_m, block_n=block_n, block_k=block_k)


def batched_matmul(a: Tensor, b: Tensor, *, block_m: Optional[int] = None,
                   block_n: Optional[int] = None,
                   block_k: Optional[int] = None, scheme: SchemeSpec = None,
                   compute_dtype=None) -> Tensor:
    """[batch, M, K] x [batch, K, N] -> [batch, M, N] compensated matmuls
    in one launch — bitwise equal to a loop of ``matmul`` calls."""
    return _engine(scheme, None, compute_dtype).batched_matmul(
        a, b, block_m=block_m, block_n=block_n, block_k=block_k)


# Convenience: the plain-torch oracles with the same semantics, under the
# reference's names (``repro/kernels/ops.py:125-129``).
dot_ref = functools.partial(_ref.dot_ref)
sum_ref = functools.partial(_ref.sum_ref)
matmul_ref = functools.partial(_ref.matmul_ref)
