"""Numerical-accuracy substrate: ill-conditioned test data and exact refs.

The paper's motivation is accuracy of long accumulations. To *measure* the
accuracy of naive vs Kahan vs Dot2 implementations we need dot products with
a controllable condition number

    cond(a.b) = 2 * sum(|a_i * b_i|) / |a.b|

and an exact (correctly-rounded) reference. We use the generator of
Ogita, Rump & Oishi (SIAM J. Sci. Comput. 2005, Algorithm 6.1: GenDot),
and ``math.fsum``-based exact evaluation in float64 (exact for the fp32
test data used in benchmarks, since fp32 products are exact in fp64 and
fsum is correctly rounded).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


_SPLIT64 = 134217729.0  # Veltkamp constant for float64: 2**27 + 1
_FMA = getattr(math, "fma", None)  # Python >= 3.13


def _two_prod_err64(x: float, y: float) -> float:
    """Exact error of the rounded float64 product: x*y - fl(x*y).

    Uses ``math.fma`` when the platform provides it (Python >= 3.13);
    otherwise the Dekker/Veltkamp split, which is exactly equivalent for
    finite float64 inputs barring overflow in the split. Either way the
    returned term is EXACT — the fallback never silently degrades to a
    zero error term.
    """
    p = x * y
    if _FMA is not None:
        return _FMA(x, y, -p)
    xb = _SPLIT64 * x
    x_hi = xb - (xb - x)
    x_lo = x - x_hi
    yb = _SPLIT64 * y
    y_hi = yb - (yb - y)
    y_lo = y - y_hi
    return ((x_hi * y_hi - p) + x_hi * y_lo + x_lo * y_hi) + x_lo * y_lo


def exact_dot(a: np.ndarray, b: np.ndarray) -> float:
    """Correctly-rounded (to float64) dot product of fp32/fp64 vectors.

    For float32 inputs each product is exact in float64; math.fsum then
    sums exactly (it maintains full precision internally). For float64
    inputs each product is split into its rounded value plus the exact
    TwoProd error term (``_two_prod_err64``), and fsum adds the 2n exact
    parts — correctly rounded regardless of the Python version.
    """
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    if a.dtype == np.float32 and b.dtype == np.float32:
        return math.fsum((a64 * b64).tolist())
    parts = []
    for x, y in zip(a64.tolist(), b64.tolist()):
        parts.append(x * y)
        parts.append(_two_prod_err64(x, y))
    return math.fsum(parts)


def exact_sum(x: np.ndarray) -> float:
    return math.fsum(np.asarray(x, dtype=np.float64).tolist())


def gen_dot(n: int, cond: float, seed: int = 0,
            dtype=np.float32) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Generate (a, b) with condition number ~``cond`` (GenDot, Ogita et al.).

    Returns (a, b, exact_value, achieved_cond). Works in float64 internally,
    rounds to ``dtype`` at the end (achieved condition recomputed after
    rounding).
    """
    rng = np.random.default_rng(seed)
    n2 = n // 2
    b_exp = math.log2(cond) / 2.0

    # first half: exponents spread in [0, b_exp]. Elements are rounded to
    # the TARGET dtype immediately — the cancellation construction must
    # hold for the rounded data, otherwise fp32 rounding noise (eps *
    # sum|a_i b_i|) dominates the exact value and the achieved condition
    # number explodes far past the request.
    e = np.rint(rng.uniform(0.0, b_exp, size=n2)).astype(np.float64)
    e[0] = b_exp  # ensure the extremes are hit
    if n2 > 1:
        e[-1] = 0.0
    a1 = ((2.0 * rng.uniform(size=n2) - 1.0) * np.exp2(e)).astype(dtype) \
        .astype(np.float64)
    b1 = ((2.0 * rng.uniform(size=n2) - 1.0) * np.exp2(e)).astype(dtype) \
        .astype(np.float64)

    # second half: chosen so partial sums cancel toward ~0. The running dot
    # is tracked incrementally as a double-double (s, c) pair — O(1) per
    # element (the textbook GenDot recomputes an exact prefix sum per
    # element, which is O(n^2) and unusable at our sizes) and accurate to
    # ~106 bits, far beyond what the generator needs.
    def dd_add(s: float, c: float, x: float) -> Tuple[float, float]:
        t = s + x
        bp = t - s
        e_lo = (s - (t - bp)) + (x - bp)
        return t, c + e_lo

    s_run, c_run = 0.0, 0.0
    for x, y in zip(a1.tolist(), b1.tolist()):
        s_run, c_run = dd_add(s_run, c_run, x * y)

    a2 = np.zeros(n - n2)
    b2 = np.zeros(n - n2)
    e2 = np.rint(np.linspace(b_exp, 0.0, n - n2))
    u1 = 2.0 * rng.uniform(size=n - n2) - 1.0
    u2 = 2.0 * rng.uniform(size=n - n2) - 1.0
    for j in range(n - n2):
        a2[j] = float(dtype(u1[j] * 2.0 ** e2[j]))
        b2[j] = float(dtype(
            (u2[j] * 2.0 ** e2[j] - (s_run + c_run)) / a2[j]))
        s_run, c_run = dd_add(s_run, c_run, a2[j] * b2[j])
    a = np.concatenate([a1, a2])
    b = np.concatenate([b1, b2])

    # random permutation, then round to target dtype
    perm = rng.permutation(n)
    a = a[perm].astype(dtype)
    b = b[perm].astype(dtype)

    exact = exact_dot(a, b)
    abs_dot = math.fsum(np.abs(np.asarray(a, np.float64) *
                               np.asarray(b, np.float64)).tolist())
    achieved = 2.0 * abs_dot / abs(exact) if exact != 0 else math.inf
    return a, b, exact, achieved


def gen_sum(n: int, cond: float, seed: int = 0,
            dtype=np.float32) -> Tuple[np.ndarray, float, float]:
    """Ill-conditioned summation data via gen_dot with b folded into a."""
    a, b, exact, achieved = gen_dot(n, cond, seed, np.float64)
    x = (np.asarray(a, np.float64) * np.asarray(b, np.float64)).astype(dtype)
    exact = exact_sum(x)
    abs_sum = math.fsum(np.abs(x.astype(np.float64)).tolist())
    achieved = abs_sum / abs(exact) if exact != 0 else math.inf
    return x, exact, achieved


def relative_error(value: float, exact: float) -> float:
    if exact == 0.0:
        return abs(value)
    return abs((float(value) - exact) / exact)
