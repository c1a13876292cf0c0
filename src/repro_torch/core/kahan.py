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

``KahanAccumulator`` and the tree helpers carry the compensated sum over
microbatches (the trainer's gradient fold) and over time (KahanAdamW's
parameter update), on the port's nested-container trees
(``repro_torch.core.tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core import tree as _tree

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


# ---------------------------------------------------------------------------
# Compensated accumulator over trees — grad accumulation / optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KahanAccumulator:
    """A compensated running value ``total ~ value + comp`` over a tree of
    tensors, ``comp`` holding the rounding residue of every ``add``
    (``repro/core/kahan.py:292-366``). The methods return new
    accumulators, as the reference's do; ``add_`` and ``scale_total_`` are
    the in-place ``add`` and ``scale(f).total()`` (the same bits) that the
    trainer folds microbatches with, where the reference's jitted step
    reuses the buffers."""

    value: Any
    comp: Any

    @classmethod
    def zeros_like(cls, tree: Any) -> "KahanAccumulator":
        return cls(_tree.tree_map(torch.zeros_like, tree),
                   _tree.tree_map(torch.zeros_like, tree))

    @classmethod
    def init(cls, tree: Any) -> "KahanAccumulator":
        """Start from an existing value with zero compensation."""
        return cls(tree, _tree.tree_map(torch.zeros_like, tree))

    def add(self, delta: Any) -> "KahanAccumulator":
        """Compensated ``self + delta`` (one Kahan step per leaf, ``delta``
        cast to the value's dtype)."""
        return KahanAccumulator(*tree_kahan_add(self.value, self.comp, delta))

    def add_(self, delta: Any) -> "KahanAccumulator":
        """``add`` in place: the same bits, written into this
        accumulator's tensors."""
        def leaf(s, c, x):
            t, c2 = kahan_step(s, c, x.to(s.dtype))
            s.copy_(t)
            c.copy_(c2)

        _tree.tree_map(leaf, self.value, self.comp, delta)
        return self

    def merge(self, other: "KahanAccumulator") -> "KahanAccumulator":
        """Compensated merge of two accumulators (two-sum based)."""
        return KahanAccumulator(*_unzip(_tree.tree_map(
            kahan_combine, self.value, self.comp, other.value, other.comp),
            self.value))

    def total(self) -> Any:
        """Collapse to the best single-value estimate ``value + comp``."""
        return _tree.tree_map(lambda s, c: s + c, self.value, self.comp)

    def scale(self, factor) -> "KahanAccumulator":
        """Scale both members (one rounding each; the 1/microbatches
        average). A Python ``factor`` is rounded to each leaf's dtype
        first, as JAX rounds a weakly typed scalar."""
        return KahanAccumulator(
            _tree.tree_map(lambda s: s * scalar_like(factor, s), self.value),
            _tree.tree_map(lambda c: c * scalar_like(factor, c), self.comp))

    def scale_total_(self, factor) -> Any:
        """``scale(factor).total()`` in place: the same bits, written into
        this accumulator's value tensors (the trainer's 1/microbatches
        average, where the reference's jitted step reuses the buffers);
        the accumulator is spent."""
        return _tree.tree_map(
            lambda s, c: s.mul_(scalar_like(factor, s)).add_(
                c.mul_(scalar_like(factor, c))), self.value, self.comp)


def scalar_like(x, like: Tensor) -> Tensor:
    """``x`` as a 0-d tensor of ``like``'s dtype and device: the rounding
    JAX gives a Python scalar in an op with an array (torch would compute
    a bf16 op with the scalar in float32)."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _unzip(pairs: Any, like: Any) -> Tuple[Any, Any]:
    """A tree of ``(a, b)`` leaves (shaped as ``like``) -> two trees."""
    return (_tree.tree_map(lambda _, p: p[0], like, pairs),
            _tree.tree_map(lambda _, p: p[1], like, pairs))


def tree_kahan_add(value: Any, comp: Any, delta: Any) -> Tuple[Any, Any]:
    """Compensated ``value += delta`` over matching trees: returns
    ``(new_value, new_comp)``; ``value`` may be bf16, the compensation
    recovers the bits bf16 drops (``repro/core/kahan.py:372-385``)."""
    pairs = _tree.tree_map(lambda s, c, x: kahan_step(s, c, x.to(s.dtype)),
                           value, comp, delta)
    return _unzip(pairs, value)


def column_sq_plain(g: Tensor) -> Tuple[Tensor, Tensor]:
    """Compensated column sums of squares of ``g`` [R, ...] (float32):
    one Kahan chain per trailing element, over the rows in ascending
    order, ``(s, c)`` each ``g.shape[1:]``. The reference's ``lax.scan``
    (``repro/core/kahan.py:398-404``) as XLA compiles it on the CPU: the
    square fuses into the step's first add, ``y = fma(row, row, c)``."""
    s = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
    c = torch.zeros_like(s)
    for row in g:
        y = fma(row, row, c)
        t = s + y
        c = y - (t - s)
        s = t
    return s, c


def tree_kahan_sq_norm(tree: Any) -> Tensor:
    """Compensated global squared L2 norm of a tree (float32 scalar),
    ``repro/core/kahan.py:378-411``: a leaf of two or more axes with a
    leading axis longer than one runs one compensated chain per trailing
    element down its leading axis (``kernels.kahan_columns``: the
    column-scan kernel on a CUDA tensor, ``column_sq_plain`` on the CPU),
    and its two column vectors sum to one partial pair folded by
    two-sum; any other leaf adds its plain sum of squares by one Kahan
    step. Leaves fold in the reference's order."""
    from repro_torch.kernels.kahan_columns import column_sq_accumulators

    s = c = None
    for leaf in _tree.leaves(tree):
        if s is None:
            s = torch.zeros((), dtype=torch.float32, device=leaf.device)
            c = torch.zeros_like(s)
        if leaf.dim() >= 2 and leaf.shape[0] > 1:
            acc_s, acc_c = column_sq_accumulators(leaf)
            s, c = kahan_combine(s, c, torch.sum(acc_s), torch.sum(acc_c))
        else:
            g = leaf.float()
            s, c = kahan_step(s, c, torch.sum(g * g))
    if s is None:
        return torch.zeros((), dtype=torch.float32)
    return s + c
