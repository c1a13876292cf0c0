"""Matmul with compensated accumulation across K-blocks: the wrappers of
the Hopper kernel ``kahan_matmul_grid`` (``csrc/kahan_matmul.cu``) and
their plain version.

Counterpart of ``repro/kernels/kahan_matmul.py``. The reference runs
``_matmul_kernel`` on a Pallas grid ``(M/bm, N/bn, K/bk)`` with K
innermost: each K-block's tile product is folded into per-cell ``(s, c)``
accumulators by ``scheme.update(s, c, prod, k)``, ``k`` the K-block index,
and the kernel emits the raw grids (``finalize = s + c`` is the engine's).
Here one CUDA launch serves the single and the batched call
(``blockIdx.z`` is the batch index).

The block product is the port's own order: ONE ascending chain over the
block's ``block_k`` columns of rounded products and rounded adds
(``block_product``). The kernel and the plain version both use it, so
they agree bit for bit; XLA's in-block ``dot_general`` order cannot be
reproduced, so against the reference the port holds a tolerance. Only
``block_k`` decides the bits: each output cell is independent of the
others, so a row is the same whatever ``M`` is and whatever the other
rows hold, and ``block_m`` / ``block_n`` are only the padding unit: the
kernel masks rows past ``M``, so ``M`` need not be a multiple of
``block_m`` (the finalized products pass it unpadded; at ``M <= 8`` no
thread works on a row past it).

Operands may be stored in a narrower dtype than the compute dtype
(``OPERAND_DTYPES``: bfloat16 or float32 for a float32 compute dtype) and
are widened where they are read; widening is exact, so the grids equal
those of operands promoted first, and bf16 weights are never copied.

Every compute dtype of the reference runs on the card: float32, float64
and bfloat16. In bfloat16 each product, add and fold op is computed in
float32 and rounded to bfloat16 once, as torch computes a bfloat16 op, so
the kernel agrees with the plain version bit for bit (the kernel holds
the values as floats and rounds each with one conversion).

At M > 8 the kernel picks a tile height (``TILE_ROWS``) and a cluster
split from the shapes (``grid_plan`` asks the library which); a test may
force any other plan that ``fitting_plans`` lists through ``_launch``'s
``plan=``, and the bits do not depend on it.

Which path runs depends only on where the tensors lie: on the CPU the
plain version, on a CUDA tensor the kernel (a scheme without a device
function raises ``NotImplementedError``). Nothing falls back to the plain
version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.kahan import add, flush, mul, promote
from repro_torch.kernels import _build, abstract
from repro_torch.kernels.schemes import CompensationScheme

Tensor = torch.Tensor

#: operand dtypes each compute dtype takes as they are (widened on load);
#: any other operand is converted to the compute dtype by the engine
OPERAND_DTYPES = {
    torch.float32: (torch.float32, torch.bfloat16),
    torch.float64: (torch.float64,),
    torch.bfloat16: (torch.bfloat16,),
}


#: tile heights of the kernel's M > 8 path for each compute dtype (the
#: rows of ``kahan_matmul_grid``'s instantiations), and the largest cluster
MAX_SPLIT = 8
TILE_ROWS = {
    torch.float32: (32, 64, 128),
    torch.bfloat16: (32, 64, 128),
    torch.float64: (32, 64),
}


def fitting_plans(batch: int, m: int, k: int, block_k: int,
                  compute_dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """Every ``(rows, split)`` the kernel's M > 8 path takes for a
    ``[batch, M, K]`` call (the C entry refuses any other): a height of
    ``TILE_ROWS[compute_dtype]`` and a cluster of 1 to ``min(K / block_k,
    MAX_SPLIT)`` CTAs with ``batch * split`` within grid z. None at M <=
    8, which runs the rows path."""
    if m <= 8:
        return ()
    splits = range(1, min(k // block_k, MAX_SPLIT) + 1)
    return tuple((rows, split) for rows in TILE_ROWS[compute_dtype]
                 for split in splits if batch * split <= 65535)


def block_product(a: Tensor, b: Tensor) -> Tensor:
    """``[..., M, bk] x [..., bk, N] -> [..., M, N]`` in the dtype of the
    operands: each entry one ascending chain over the block of rounded
    products and rounded adds, starting from zero (the kernel's order)."""
    p = a.new_zeros((*a.shape[:-1], b.shape[-1]))
    for t in range(a.shape[-1]):
        p = add(p, mul(a[..., :, t, None], b[..., None, t, :]))
    return p


def matmul_plain(a: Tensor, b: Tensor, *, scheme: CompensationScheme,
                 block_k: int, compute_dtype: torch.dtype,
                 ) -> Tuple[Tensor, Tensor]:
    """The plain PyTorch version of both kernels: ``[B, M, K] x [B, K,
    N]`` (K a multiple of ``block_k``) -> ``[B, M, N]`` (s, c) grids in the
    compute dtype. A loop over K-blocks; each step updates every cell
    elementwise, so a row rounds exactly as it would alone."""
    a = flush(promote(a, compute_dtype))
    b = flush(promote(b, compute_dtype))
    s = a.new_zeros((a.shape[0], a.shape[1], b.shape[2]))
    c = torch.zeros_like(s)
    for g in range(a.shape[2] // block_k):
        lo, hi = g * block_k, (g + 1) * block_k
        s, c = scheme.update(s, c, block_product(a[:, :, lo:hi],
                                                 b[:, lo:hi, :]), g)
    return s, c


def _launch(a: Tensor, b: Tensor, *, scheme: CompensationScheme,
            block_m: int, block_n: int, block_k: int,
            compute_dtype: torch.dtype, counter,
            plan: Optional[Tuple[int, int]] = None) -> Tuple[Tensor, Tensor]:
    """One counted launch (or, on CPU tensors, the plain version).
    ``plan``: a ``(rows, split)`` of ``fitting_plans`` that replaces the
    kernel's own at M > 8 (for tests and tile sweeps)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(
            f"matmul kernel: want [B, M, K] and [B, K, N] operands, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch, m, k = a.shape
    n = b.shape[2]
    if min(m, n, k) == 0 or n % block_n or k % block_k:
        raise ValueError(
            f"matmul kernel: M={m}, N={n}, K={k} must be positive, N and K "
            f"multiples of the blocks ({block_n}, {block_k}) (the engine "
            f"pads them; M, masked by the kernel, need not be a multiple of "
            f"{block_m})")
    if compute_dtype not in OPERAND_DTYPES:
        raise ValueError(f"matmul kernel: compute dtype {compute_dtype} is "
                         f"not one of {tuple(OPERAND_DTYPES)}")
    allowed = OPERAND_DTYPES[compute_dtype]
    if a.dtype not in allowed or b.dtype not in allowed:
        raise TypeError(
            f"matmul kernel: operands {a.dtype} and {b.dtype} for compute "
            f"dtype {compute_dtype}; it takes {allowed}")
    if a.device != b.device:
        raise ValueError(f"matmul kernel: operands on {a.device} and "
                         f"{b.device}")
    if plan is not None and tuple(plan) not in fitting_plans(
            batch, m, k, block_k, compute_dtype):
        raise ValueError(f"matmul kernel: plan {plan} is not one of "
                         f"{fitting_plans(batch, m, k, block_k, compute_dtype)}"
                         f" for [{batch}, {m}, {k}] at block_k {block_k} in "
                         f"{compute_dtype}")
    if type(a) is not Tensor and abstract.screen(counter.__name__, a, b):
        s, c = (a.new_empty((batch, m, n), dtype=compute_dtype)
                for _ in range(2))
        abstract.record(counter.__name__, 2 * batch * m * n * k,
                        abstract.nbytes(a, b, s, c))
        return s, c
    if a.device.type == "cpu":
        return matmul_plain(a, b, scheme=scheme, block_k=block_k,
                            compute_dtype=compute_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"matmul kernel: unsupported device {a.device}")
    check_device_call(scheme, compute_dtype)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel: operands must be contiguous")
    if batch > 65535 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul kernel: batch={batch} or M, N, K = {m}, "
                         f"{n}, {k} outside the kernel's limits")
    s = torch.empty((batch, m, n), dtype=compute_dtype, device=a.device)
    c = torch.empty_like(s)
    lib = _build.library("kahan_matmul")
    counter.launches += 1
    code = _build.DTYPE_CODE
    err = lib.kahan_matmul_launch(
        scheme.device_id, code[compute_dtype], code[a.dtype], code[b.dtype],
        a.data_ptr(), b.data_ptr(), s.data_ptr(), c.data_ptr(), batch, m, n,
        k, block_k, *(plan or (0, 0)), _build.stream_ptr(a.device))
    _build.check(err, "kahan_matmul_grid")
    return s, c


def grid_plan(batch: int, m: int, n: int, k: int, block_k: int,
              compute_dtype: torch.dtype = torch.float32
              ) -> Tuple[int, int, int]:
    """``(rows, columns, split)`` of the tile that the kernel's M > 8 path
    takes for a ``[batch, M, K] x [batch, K, N]`` call in
    ``compute_dtype``: ``split`` CTAs of a thread-block cluster form a
    tile's K-blocks at once. ``(0, 0, 0)`` at M <= 8 (the rows path).
    Asks the built library, so it needs the card."""
    import ctypes

    lib = _build.library("kahan_matmul")
    out = [ctypes.c_int() for _ in range(3)]
    err = lib.kahan_matmul_plan(_build.DTYPE_CODE[compute_dtype], batch, m,
                                n, k, block_k, *(ctypes.byref(x) for x in out))
    _build.check(err, "kahan_matmul_plan")
    return tuple(x.value for x in out)


def check_device_call(scheme: CompensationScheme,
                      compute_dtype: torch.dtype) -> None:
    """What the kernel refuses before it launches on the card: a scheme
    without a device function, and a compute dtype that is none of the
    reference's (``OPERAND_DTYPES``: float32, float64 and bfloat16 each
    have a CUDA instantiation)."""
    if scheme.device_id is None:
        raise NotImplementedError(
            f"scheme {scheme.name!r} has no CUDA device function (only the "
            f"built-in schemes do); it runs on CPU tensors only")
    if compute_dtype not in OPERAND_DTYPES:
        raise ValueError(f"matmul kernel: compute dtype {compute_dtype} is "
                         f"not one of {tuple(OPERAND_DTYPES)}")


def matmul_accumulators(a: Tensor, b: Tensor, *, scheme: CompensationScheme,
                        block_m: int = 256, block_n: int = 256,
                        block_k: int = 512,
                        compute_dtype: torch.dtype = torch.float32,
                        ) -> Tuple[Tensor, Tensor]:
    """``[M, K] x [K, N]`` (N and K padded by the caller to block
    multiples, operands in ``OPERAND_DTYPES[compute_dtype]``) -> ``[M,
    N]`` (s, c) grids in the compute dtype. Replaces
    ``repro/kernels/kahan_matmul.py:101``."""
    s, c = _launch(a[None], b[None], scheme=scheme, block_m=block_m,
                   block_n=block_n, block_k=block_k,
                   compute_dtype=compute_dtype, counter=matmul_accumulators)
    return s[0], c[0]


def matmul_accumulators_batched(a: Tensor, b: Tensor, *,
                                scheme: CompensationScheme,
                                block_m: int = 256, block_n: int = 256,
                                block_k: int = 512,
                                compute_dtype: torch.dtype = torch.float32,
                                ) -> Tuple[Tensor, Tensor]:
    """``[B, M, K] x [B, K, N]`` -> ``[B, M, N]`` (s, c) grids in one
    launch; each batch index rounds exactly as a single call would.
    Replaces ``repro/kernels/kahan_matmul.py:153``."""
    return _launch(a, b, scheme=scheme, block_m=block_m, block_n=block_n,
                   block_k=block_k, compute_dtype=compute_dtype,
                   counter=matmul_accumulators_batched)


#: kernel launches made by each wrapper (chip_smoke.py reads and resets
#: them to show which path ran)
matmul_accumulators.launches = 0
matmul_accumulators_batched.launches = 0
