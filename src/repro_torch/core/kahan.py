"""Kahan / compensated-summation primitives, in PyTorch.

Counterpart of ``repro/core/kahan.py``: the same error-free
transformations, the same ``total = s + c`` sign convention for the Kahan
step and the same two-sum merge, op for op, so that every function here is
bitwise equal to its JAX twin on IEEE float32 / float64 tensors.

One addition the JAX module does not need: ``fma``. XLA on the CPU
contracts ``a * b + c`` into a fused multiply-add at two sites of the
compensated dot (see ``repro_torch.kernels.schemes``), and PyTorch has no
fused multiply-add operator that is guaranteed to round once. ``fma`` here
is exact: one rounding of the exact ``a * b + c``, emulated with error-free
transformations and round-to-odd (Boldo & Melquiond, "Emulation of FMA and
correctly rounded sums: proved algorithms using rounding to odd", IEEE
Trans. Computers 57(4), 2008).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

# Veltkamp splitting constants 2^ceil(m/2) + 1 (m = significand bits).
_SPLIT32 = 4097.0          # 2^12 + 1
_SPLIT64 = 134217729.0     # 2^27 + 1


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------

def two_sum(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Knuth two-sum: ``(s, e)`` with ``s = fl(a + b)`` and ``a + b = s + e``
    exactly. 6 flops, branch-free, no magnitude precondition."""
    s = a + b
    bp = s - a
    ap = s - bp
    eb = b - bp
    ea = a - ap
    return s, ea + eb


def fast_two_sum(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Dekker fast-two-sum: requires ``|a| >= |b|`` elementwise. 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Error-free product by Veltkamp/Dekker splitting (no fma assumed):
    ``(p, e)`` with ``p = fl(a * b)`` and ``a * b = p + e`` exactly for
    float32 / float64 barring overflow and underflow."""
    c = _SPLIT64 if a.dtype == torch.float64 else _SPLIT32
    p = a * b
    a_big = c * a
    a_hi = a_big - (a_big - a)
    a_lo = a - a_hi
    b_big = c * b
    b_hi = b_big - (b_big - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


# ---------------------------------------------------------------------------
# The paper's Kahan step
# ---------------------------------------------------------------------------

def kahan_step(s: Tensor, c: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
    """One Kahan accumulation step, ``total = s + c`` convention
    (``repro/core/kahan.py:110-123``): ``y = x + c; t = s + y;
    c = y - (t - s); s = t``."""
    y = x + c
    t = s + y
    c = y - (t - s)
    return t, c


def kahan_combine(s1: Tensor, c1: Tensor, s2: Tensor, c2: Tensor,
                  ) -> Tuple[Tensor, Tensor]:
    """Merge two compensated accumulators by two-sum; the compensations
    add to the error term left to right (``e + c1 + c2``)."""
    s, e = two_sum(s1, s2)
    return s, e + c1 + c2


# ---------------------------------------------------------------------------
# Exact fused multiply-add
# ---------------------------------------------------------------------------

_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


def _add_round_to_odd(x: Tensor, y: Tensor) -> Tensor:
    """``x + y`` rounded to odd: the exact sum when it is representable,
    otherwise whichever neighbour of it has an odd last significand bit."""
    s, e = two_sum(x, y)
    even = (s.view(_INT_VIEW[s.dtype]) & 1) == 0
    nudge = (e != 0) & even & torch.isfinite(s)
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(nudge, torch.nextafter(s, toward), s)


def fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c`` with ONE rounding, for float32 and float64 tensors.

    float32: the product of two float32 values is exact in float64; the
    float64 sum is rounded to odd and then to float32, which rounds once
    overall because float64 carries more than 24 + 2 significand bits.

    float64: Boldo & Melquiond's emulation — ``(uh, ul) = two_prod(a, b)``,
    ``(th, tl) = two_sum(c, uh)``, ``v = RO(tl + ul)``, ``RN(th + v)``.
    Exact barring overflow and underflow in the splitting (inputs beyond
    about 1e300 or below about 1e-290 in magnitude).
    """
    if a.dtype == torch.float32:
        p = a.double() * b.double()
        return _add_round_to_odd(p, c.double()).float()
    if a.dtype == torch.float64:
        uh, ul = two_prod(a, b)
        th, tl = two_sum(c, uh)
        return th + _add_round_to_odd(tl, ul)
    raise TypeError(f"fma: float32 or float64 tensors only, got {a.dtype}")
