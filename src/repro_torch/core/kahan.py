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

Subnormals. XLA on the CPU runs with x86's flush-to-zero and
denormals-are-zero modes: a subnormal float32 / bfloat16 input counts as a
zero of its sign, and a result whose magnitude, rounded to 24 significand
bits with an unbounded exponent, is below ``tiny`` = 2^-126 becomes a zero
of its sign. Every float32 / bfloat16 op below goes through ``flush`` /
``add`` / ``sub`` / ``mul`` / ``div`` (and ``fma``, ``promote``), which
emulate that op by op on any device and any number of threads (a
thread-local flush flag would not reach torch's worker threads).
float64 passes through: float64 results of float32 or bfloat16 data
never reach float64's subnormal range, and a float64 subnormal input is
out of scope.

``KahanAccumulator`` and the tree helpers carry the compensated sum over
microbatches (the trainer's gradient fold) and over time (KahanAdamW's
parameter update), on the port's nested-container trees
(``repro_torch.core.tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import tree as _tree

Tensor = torch.Tensor

# Veltkamp splitting constants 2^ceil(m/2) + 1 (m = significand bits).
_SPLIT32 = 4097.0          # 2^12 + 1
_SPLIT64 = 134217729.0     # 2^27 + 1


# ---------------------------------------------------------------------------
# Flush-to-zero arithmetic (the reference's float32 / bfloat16 rounding)
# ---------------------------------------------------------------------------

#: float32's (and bfloat16's) smallest normal magnitude
TINY = 2.0 ** -126
#: the least exact magnitude that rounds to ``TINY`` at 24 significand
#: bits: x86 detects a tiny result after that rounding, so a float32
#: product or fma whose exact value lies in [FLUSH_BELOW, TINY) gives
#: ``TINY``, and one below FLUSH_BELOW gives zero
FLUSH_BELOW = TINY * (1.0 - 2.0 ** -25)

_FLUSHED = (torch.float32, torch.bfloat16)


def _largest_below(bound: float, dtype: torch.dtype) -> float:
    b = torch.tensor(bound, dtype=dtype)
    return torch.nextafter(b, torch.zeros_like(b)).item()


#: the largest magnitude each flush zeroes (``hardshrink`` keeps what
#: lies beyond it): the largest subnormal of float32 and of bfloat16, and
#: in float64 (the wide results of float32 ops) the largest value below
#: FLUSH_BELOW
_ZEROED = {torch.float32: _largest_below(TINY, torch.float32),
           torch.bfloat16: _largest_below(TINY, torch.bfloat16),
           torch.float64: _largest_below(FLUSH_BELOW, torch.float64)}


def flush(x: Tensor) -> Tensor:
    """``x`` with every subnormal replaced by a zero of its sign (float32
    and bfloat16; any other dtype as it is): the DAZ applied to an
    input, and the FTZ of an op whose result is exact."""
    if x.dtype not in _FLUSHED:
        return x
    return F.hardshrink(x, _ZEROED[x.dtype]).copysign_(x)


def promote(x: Tensor, dtype: torch.dtype) -> Tensor:
    """``x`` cast to ``dtype`` as the reference casts it: a float32 or
    bfloat16 subnormal cast to float64 becomes a zero of its sign (x86's
    conversion flushes its input); a cast to float32 or bfloat16 rounds
    as it is, and the next op flushes."""
    if dtype == torch.float64 and x.dtype in _FLUSHED:
        x = flush(x)
    return x.to(dtype)


def _widened(a: Tensor, b: Tensor, wide: torch.dtype):
    """``a`` in ``wide``, and ``b`` as it is unless the op would then run
    in ``b``'s dtype (a 0-d ``a`` does not promote a dimensioned ``b``)."""
    a = a.to(wide)
    return a, (b.to(wide) if a.dim() == 0 and b.dim() > 0 else b)


def _wide_flush(r: Tensor, dtype: torch.dtype) -> Tensor:
    """The wide result ``r`` of one float32 or bfloat16 op as ``dtype``:
    a zero of its sign where the op flushes, else ``r`` rounded once.
    ``r`` is float64 (exact, or rounded to odd, or a quotient: a float32
    op flushes below FLUSH_BELOW) or float32 (an exact product of
    bfloat16 values: below TINY)."""
    return F.hardshrink(r, _ZEROED[r.dtype]).copysign_(r).to(dtype)


def add(a: Tensor, b: Tensor) -> Tensor:
    """``a + b`` as the reference rounds it. float32: a sum that lands
    below ``TINY`` is exact, so the rounded sum flushes. bfloat16: the sum
    in float32, flushed there, then rounded to bfloat16 (a float32
    subnormal must not round up to ``TINY`` first)."""
    if a.dtype == torch.bfloat16:
        wa, wb = _widened(a, b, torch.float32)
        return flush(wa + wb).to(torch.bfloat16)
    return flush(a + b)


def sub(a: Tensor, b: Tensor) -> Tensor:
    """``a - b`` as the reference rounds it (see ``add``)."""
    if a.dtype == torch.bfloat16:
        wa, wb = _widened(a, b, torch.float32)
        return flush(wa - wb).to(torch.bfloat16)
    return flush(a - b)


#: 2^64: a float32 product or quotient whose exact value is scaled by it
#: rounds in the normal range wherever the unscaled one lands near tiny
_UP = 2.0 ** 64


def _ftz32(p: Tensor, q: Tensor) -> Tensor:
    """Flush ``p``, one float32 op's result rounded with gradual
    underflow (torch's), as x86 flushes: ``q`` is the same op on its
    exact value times 2^64, rounded at 24 bits in the normal range, so
    ``|q| >= 2^64 tiny`` exactly where the reference keeps a result. There
    ``p`` is the reference's result (below ``tiny`` that can only be
    ``tiny``, which gradual underflow rounds to as well); elsewhere the
    reference gives a zero of ``p``'s sign. An overflowing ``q`` (inf, or
    NaN from zero times inf) belongs to a ``p`` that is normal or zero."""
    return p * (q.abs() >= TINY * _UP)


def div(a: Tensor, b: Tensor) -> Tensor:
    """``a / b`` as the reference rounds it. float32: torch's quotient,
    flushed (``_ftz32``). bfloat16: the quotient in float64 (whose
    rounding never lands on ``FLUSH_BELOW`` and rounds innocuously
    twice), zero below ``FLUSH_BELOW``, else rounded to bfloat16."""
    if a.dtype == torch.float32:
        return _ftz32(a / b, (a * _UP) / b)
    if a.dtype == torch.bfloat16:
        wa, wb = _widened(a, b, torch.float64)
        return _wide_flush(wa / wb, a.dtype)
    return a / b


def mul(a: Tensor, b: Tensor) -> Tensor:
    """``a * b`` as the reference rounds it. float32: torch's product,
    flushed (``_ftz32``; the 2^64 goes on a 0-d operand where there is
    one). bfloat16: the exact product in float32, zero below ``TINY``,
    else rounded once."""
    if a.dtype == torch.float32:
        q = a * (b * _UP) if b.dim() == 0 else (a * _UP) * b
        return _ftz32(a * b, q)
    if a.dtype == torch.bfloat16:
        wa, wb = _widened(a, b, torch.float32)
        return _wide_flush(wa * wb, a.dtype)
    return a * b


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------
#
# The public functions flush their inputs (DAZ) once; the ``_``-prefixed
# bodies take inputs that are already flushed, as every value of a
# compensated loop is after its first op, and the schemes' updates call
# those.

def two_sum(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Knuth two-sum: ``(s, e)`` with ``s = fl(a + b)`` and ``a + b = s + e``
    exactly. 6 flops, branch-free, no magnitude precondition."""
    return _two_sum(flush(a), flush(b))


def _two_sum(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    s = add(a, b)
    bp = sub(s, a)
    ap = sub(s, bp)
    eb = sub(b, bp)
    ea = sub(a, ap)
    return s, add(ea, eb)


def fast_two_sum(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Dekker fast-two-sum: requires ``|a| >= |b|`` elementwise. 3 flops."""
    a, b = flush(a), flush(b)
    s = add(a, b)
    return s, sub(b, sub(s, a))


def two_prod(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Error-free product by Veltkamp/Dekker splitting (no fma assumed):
    ``(p, e)`` with ``p = fl(a * b)`` and ``a * b = p + e`` exactly for
    float32 / float64 barring overflow and underflow."""
    return _two_prod(flush(a), flush(b))


def _split(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Veltkamp's split ``x = hi + lo``, halves of about half the
    significand each. Takes a flushed ``x``: zero or at least ``TINY``,
    so ``big`` never lands below ``TINY`` and the plain product rounds
    as ``mul``'s would."""
    big = scalar_like(_SPLIT64 if x.dtype == torch.float64
                      else _SPLIT32, x) * x
    hi = sub(big, sub(big, x))
    return hi, sub(x, hi)


def _two_prod(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    p = mul(a, b)
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    e = add(add(add(sub(mul(a_hi, b_hi), p), mul(a_hi, b_lo)),
                mul(a_lo, b_hi)), mul(a_lo, b_lo))
    return p, e


def _two_prod_fused(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """``two_prod`` as XLA compiles it inside a kernel or a scan on the
    CPU: each of the error term's four products is contracted into the
    add it feeds, ``e = fma(a_lo, b_lo, fma(a_lo, b_hi, fma(a_hi, b_lo,
    fma(a_hi, b_hi, -p))))`` in float32. In the normal range those
    products are exact and this equals ``two_prod``; where they underflow
    the fma keeps what a flushed product drops. float64 (whose products
    of halves never underflow here) and bfloat16 (which XLA does not
    contract) keep the separate ops. Takes flushed inputs."""
    if a.dtype != torch.float32:
        return _two_prod(a, b)
    p = mul(a, b)
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    e = _exact_fma(a_lo, b_lo, _exact_fma(a_lo, b_hi, _exact_fma(
        a_hi, b_lo, _exact_fma(a_hi, b_hi, -p))))
    return p, e


def _exact_fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``fma(a, b, c)`` for float32 where ``a * b + c`` is exact in
    float64, as at TwoProd's error sites: products of split halves and
    the partial error terms all lie on the grid of ``ulp(a_lo * b_lo)``
    within 48 bits of it, so one float64 multiply and add are exact, and
    the flush and the one rounding follow (``fma``'s rounding to odd is
    not needed)."""
    return _wide_flush(a.double() * b + c, torch.float32)


# ---------------------------------------------------------------------------
# The paper's Kahan step
# ---------------------------------------------------------------------------

def kahan_step(s: Tensor, c: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
    """One Kahan accumulation step, ``total = s + c`` convention
    (``repro/core/kahan.py:110-123``): ``y = x + c; t = s + y;
    c = y - (t - s); s = t``."""
    return _kahan_step(flush(s), flush(c), flush(x))


def _kahan_step(s: Tensor, c: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
    y = add(x, c)
    t = add(s, y)
    return t, sub(y, sub(t, s))


#: elements an in-place Kahan step takes at a time, so that its flushing
#: temporaries stay small beside a billion-element gradient tree
_STEP_CHUNK = 1 << 24


def kahan_step_(s: Tensor, c: Tensor, x: Tensor) -> None:
    """``kahan_step`` written into ``s`` and ``c`` (the trainer's
    accumulator, KahanAdamW's bf16 update), ``_STEP_CHUNK`` elements at a
    time: the same bits, with a bounded footprint. ``s`` and ``c`` are
    contiguous state that holds flushed values (zeros, or what earlier
    flushing ops wrote); only ``x`` is flushed here."""
    assert s.is_contiguous() and c.is_contiguous()
    fs, fc, fx = s.view(-1), c.view(-1), x.reshape(-1)
    for i in range(0, fs.numel(), _STEP_CHUNK):
        cut = slice(i, i + _STEP_CHUNK)
        t, c2 = _kahan_step(fs[cut], fc[cut], flush(fx[cut]))
        fs[cut].copy_(t)
        fc[cut].copy_(c2)


def kahan_combine(s1: Tensor, c1: Tensor, s2: Tensor, c2: Tensor,
                  ) -> Tuple[Tensor, Tensor]:
    """Merge two compensated accumulators by two-sum; the compensations
    add to the error term left to right (``e + c1 + c2``)."""
    return _kahan_combine(flush(s1), flush(c1), flush(s2), flush(c2))


def _kahan_combine(s1: Tensor, c1: Tensor, s2: Tensor, c2: Tensor,
                   ) -> Tuple[Tensor, Tensor]:
    s, e = _two_sum(s1, s2)
    return s, add(add(e, c1), c2)


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
    float64 sum is rounded to odd (where a plain float64 sum could round
    twice wrongly) and then to float32, which rounds once overall because
    float64 carries more than 24 + 2 significand bits.
    Inputs flush first, and the result flushes as the reference's does
    (``mul``): ``FLUSH_BELOW`` is itself a 24-bit midpoint, which
    rounding to odd never lands on, so the float64 sum that goes on is
    below it exactly when the exact result is.

    float64: Boldo & Melquiond's emulation — ``(uh, ul) = two_prod(a, b)``,
    ``(th, tl) = two_sum(c, uh)``, ``v = RO(tl + ul)``, ``RN(th + v)``.
    Exact barring overflow and underflow in the splitting (inputs beyond
    about 1e300 or below about 1e-290 in magnitude).
    """
    return _fma(flush(a), flush(b), flush(c))


#: the low 29 significand bits of a float64 that lies halfway between
#: two neighbours at 24 bits
_LOW29, _HALF29 = (1 << 29) - 1, 1 << 28


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``fma`` on flushed inputs. float32: the float64 sum ``s`` of the
    exact product and ``c`` rounds once to nearest; rounding ``s`` again
    to 24 bits gives the exact sum's rounding unless ``s`` lies halfway
    between two 24-bit neighbours (any such midpoint strictly between
    the exact sum and ``s`` would be a nearer float64), so only those
    elements take the sum rounded to odd (a few in a million where an
    operand is short, as bf16 params times the weight decay are)."""
    if a.dtype == torch.float32:
        wa, wb = _widened(a, b, torch.float64)
        p = wa * wb
        # a dimensioned float64 ``p`` widens ``c`` inside the add
        s = p + (c.double() if p.dim() == 0 else c)
        mid = (s.view(torch.int64) & _LOW29) == _HALF29
        # a fake tensor (the dry run) has no values: the common branch
        if type(mid) is Tensor and bool(mid.any()):
            at = lambda x: x.expand(mid.shape)[mid]  # noqa: E731
            s[mid] = _add_round_to_odd(at(p), at(c).double())
        return _wide_flush(s, torch.float32)
    if a.dtype == torch.float64:
        uh, ul = two_prod(a, b)
        th, tl = two_sum(c, uh)
        return th + _add_round_to_odd(tl, ul)
    raise TypeError(f"fma: float32 or float64 tensors only, got {a.dtype}")


# ---------------------------------------------------------------------------
# Lane-parallel compensated reductions (the paper's SIMD structure)
# ---------------------------------------------------------------------------
#
# The reference runs these as ``lax.scan`` loops, which XLA compiles: a
# product that feeds an add is contracted into one fma there (float32
# and float64; not bfloat16), as in the kernels (``_mac``).

def _mac(a: Tensor, b: Tensor, acc: Tensor) -> Tensor:
    """``a * b + acc`` at a site XLA contracts: one rounding in float32
    and float64, two in bfloat16. Takes flushed inputs."""
    if acc.dtype == torch.bfloat16:
        return add(mul(a, b), acc)
    return _fma(a, b, acc)


def _lanes_view(x: Tensor, lanes: int) -> Tensor:
    """1-D ``x`` zero-padded to whole rows of ``lanes`` -> [rows, lanes]."""
    pad = (-x.shape[0]) % lanes
    if pad:
        x = torch.cat([x, x.new_zeros((pad,))])
    return x.reshape(-1, lanes)


def _lane_partials_sum(x: Tensor, lanes: int) -> Tuple[Tensor, Tensor]:
    """Fold 1-D ``x`` into ``lanes`` compensated partials: lane j takes
    elements j, j + lanes, ... by Kahan steps, the remainder zero-padded
    (``repro/core/kahan.py:144-167``)."""
    xm = _lanes_view(flush(x), lanes)
    s = x.new_zeros((lanes,))
    c = x.new_zeros((lanes,))
    for row in xm:
        s, c = _kahan_step(s, c, row)
    return s, c


def _merge_lanes(s: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """Tree-reduce lane partials with compensated merges, an odd count
    folding its last lane into lane 0 first (``repro/core/kahan.py:
    170-185``)."""
    s, c = flush(s), flush(c)
    lanes = s.shape[0]
    while lanes > 1:
        if lanes % 2:
            s0, c0 = _kahan_combine(s[0], c[0], s[-1], c[-1])
            s = torch.cat([s0[None], s[1:lanes - 1]])
            c = torch.cat([c0[None], c[1:lanes - 1]])
            lanes -= 1
        half = lanes // 2
        s, c = _kahan_combine(s[:half], c[:half], s[half:], c[half:])
        lanes = half
    return s[0], c[0]


def kahan_sum(x: Tensor, lanes: int = 128) -> Tensor:
    """Compensated sum of ``x`` (raveled) with ``lanes`` lane partials and
    the compensated lane merge; ``s + c`` in x's dtype."""
    x = x.reshape(-1)
    s, c = _lane_partials_sum(x, min(lanes, max(x.shape[0], 1)))
    return add(*_merge_lanes(s, c))


def _lane_operands(a: Tensor, b: Tensor, lanes: int):
    a, b = flush(a.reshape(-1)), flush(b.reshape(-1))
    lanes = min(lanes, max(a.shape[0], 1))
    return _lanes_view(a, lanes), _lanes_view(b, lanes), lanes


def kahan_dot(a: Tensor, b: Tensor, lanes: int = 128) -> Tensor:
    """The paper's compensated dot, lane-parallel: ``y = fma(a, b, c)``
    (the contracted product), then the Kahan step's adds; lanes merged
    by two-sum (``repro/core/kahan.py:199-226``)."""
    am, bm, lanes = _lane_operands(a, b, lanes)
    s = am.new_zeros((lanes,))
    c = am.new_zeros((lanes,))
    for ar, br in zip(am, bm):
        y = _mac(ar, br, c)
        t = add(s, y)
        s, c = t, sub(y, sub(t, s))
    return add(*_merge_lanes(s, c))


def kahan_dot2(a: Tensor, b: Tensor, lanes: int = 128) -> Tensor:
    """Dot2 (Ogita, Rump and Oishi): TwoProd (contracted as in the
    kernel) and TwoSum a lane, ``c += ep + es``; lanes merged by two-sum
    (``repro/core/kahan.py:229-259``)."""
    am, bm, lanes = _lane_operands(a, b, lanes)
    s = am.new_zeros((lanes,))
    c = am.new_zeros((lanes,))
    for ar, br in zip(am, bm):
        p, ep = _two_prod_fused(ar, br)
        s, es = _two_sum(s, p)
        c = add(c, add(ep, es))
    return add(*_merge_lanes(s, c))


def naive_sum(x: Tensor) -> Tensor:
    """Strictly sequential sum, element by element (the accuracy
    baseline, not ``torch.sum``'s blocked reduction)."""
    s = x.new_zeros(())
    for xi in flush(x.reshape(-1)):
        s = add(s, xi)
    return s


def naive_dot(a: Tensor, b: Tensor) -> Tensor:
    """Strictly sequential dot (the paper's Fig. 1a): ``s = fma(a, b,
    s)`` element by element, the product contracted as XLA does."""
    s = a.new_zeros(())
    for ai, bi in zip(flush(a.reshape(-1)), flush(b.reshape(-1))):
        s = _mac(ai, bi, s)
    return s


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
        """Start from an existing value (flushed, as the reference's first
        op reads it) with zero compensation."""
        return cls(_tree.tree_map(flush, tree),
                   _tree.tree_map(torch.zeros_like, tree))

    def add(self, delta: Any) -> "KahanAccumulator":
        """Compensated ``self + delta`` (one Kahan step per leaf, ``delta``
        cast to the value's dtype)."""
        return KahanAccumulator(*tree_kahan_add(self.value, self.comp, delta))

    def add_(self, delta: Any) -> "KahanAccumulator":
        """``add`` in place: the same bits, written into this
        accumulator's tensors."""
        _tree.tree_map(lambda s, c, x: kahan_step_(s, c, x.to(s.dtype)),
                       self.value, self.comp, delta)
        return self

    def merge(self, other: "KahanAccumulator") -> "KahanAccumulator":
        """Compensated merge of two accumulators (two-sum based)."""
        return KahanAccumulator(*_unzip(_tree.tree_map(
            kahan_combine, self.value, self.comp, other.value, other.comp),
            self.value))

    def total(self) -> Any:
        """Collapse to the best single-value estimate ``value + comp``."""
        return _tree.tree_map(add, self.value, self.comp)

    def scale(self, factor) -> "KahanAccumulator":
        """Scale both members (one rounding each; the 1/microbatches
        average). A Python ``factor`` is rounded to each leaf's dtype
        first, as JAX rounds a weakly typed scalar."""
        return KahanAccumulator(
            _tree.tree_map(lambda s: mul(s, scalar_like(factor, s)),
                           self.value),
            _tree.tree_map(lambda c: mul(c, scalar_like(factor, c)),
                           self.comp))

    def scale_total_(self, factor) -> Any:
        """``scale(factor).total()`` in place, ``_STEP_CHUNK`` elements at
        a time: the same bits, written into this accumulator's value
        tensors (the trainer's 1/microbatches average, where the
        reference's jitted step reuses the buffers); the accumulator is
        spent."""
        def fold(s, c):
            f = scalar_like(factor, s)
            fs, fc = s.view(-1), c.view(-1)
            for i in range(0, fs.numel(), _STEP_CHUNK):
                cut = slice(i, i + _STEP_CHUNK)
                fs[cut].copy_(add(mul(fs[cut], f), mul(fc[cut], f)))
            return s

        return _tree.tree_map(fold, self.value, self.comp)


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
    g = flush(g)
    s = torch.zeros(g.shape[1:], dtype=torch.float32, device=g.device)
    c = torch.zeros_like(s)
    for row in g:
        y = _fma(row, row, c)
        t = add(s, y)
        c = sub(y, sub(t, s))
        s = t
    return s, c


def kahan_sq_pair(leaves, device=None) -> Tuple[Tensor, Tensor]:
    """The float32 ``(s, c)`` pair of ``tree_kahan_sq_norm`` over a list
    of tensors (a rank's local shards, in the sharded norm); zeros on
    ``device`` for an empty list."""
    from repro_torch.kernels.kahan_columns import column_sq_accumulators

    s = torch.zeros((), dtype=torch.float32,
                    device=leaves[0].device if leaves else device)
    c = torch.zeros_like(s)
    for leaf in leaves:
        if leaf.dim() >= 2 and leaf.shape[0] > 1:
            acc_s, acc_c = column_sq_accumulators(leaf)
            s, c = kahan_combine(s, c, torch.sum(acc_s), torch.sum(acc_c))
        else:
            g = flush(leaf.float())
            s, c = kahan_step(s, c, torch.sum(mul(g, g)))
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
    s, c = kahan_sq_pair(_tree.leaves(tree))
    return s + c


# ---------------------------------------------------------------------------
# Cross-rank scalar fold
# ---------------------------------------------------------------------------

def gather_ranks(t: Tensor, group=None) -> Tensor:
    """``[n, *t.shape]``: every rank's ``t`` of the process group
    ``group`` (None: the world), in rank order, by one all-gather into a
    tensor (the order ``jax.lax.all_gather`` fixes in the reference)."""
    import torch.distributed as dist

    t = t.contiguous()
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.numel(),))
    dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
    return out.view(n, *t.shape)


def compensated_psum_scalar(s: Tensor, c: Tensor, group=None,
                            ) -> Tuple[Tensor, Tensor]:
    """Deterministic compensated cross-rank reduction of one scalar pair
    (``repro/core/kahan.py:413-437``): every rank's ``(s, c)`` gathered
    in rank order and folded left to right from zero with
    ``kahan_combine``, in float32. Never an ``all_reduce``, whose order is
    the backend's: the result is bitwise the same on every rank and run
    to run for a fixed group size."""
    pair = torch.stack([s.reshape(()), c.reshape(())]).float()
    gathered = flush(gather_ranks(pair, group))
    acc_s = gathered.new_zeros(())
    acc_c = gathered.new_zeros(())
    for si, ci in gathered:
        acc_s, acc_c = _kahan_combine(acc_s, acc_c, si, ci)
    return acc_s, acc_c
