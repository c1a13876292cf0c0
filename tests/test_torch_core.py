"""Port numerics core vs the JAX reference (parity tier 1: bitwise).

``repro_torch.core.kahan``'s error-free transformations, Kahan step and
merge are bitwise equal to ``repro.core.kahan`` on random and adversarial
float32 / float64 inputs; the exact ``fma`` is bitwise equal to a
``fractions``-based correctly rounded fused multiply-add.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kahan as JK
from repro.core import numerics as jnum
from repro_torch.core import kahan as TK
from repro_torch.core import numerics as tnum

DTYPES = [np.float32, np.float64]


def _inputs(dtype, n=4096, seed=0):
    """Three operands with exponents spread over 2^-20 .. 2^20, plus
    adversarial rows: exact cancellation, equal magnitudes, zeros, and
    magnitude inversion. Every intermediate stays in the normal range:
    the reference flushes subnormals (see ``test_subnormals_diverge``)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-20, 20, size=(3, n))
    a, b, c = (rng.standard_normal((3, n)) * np.exp2(e)).astype(dtype)
    q = n // 8
    b[:q] = -a[:q]                       # a + b == 0
    b[q:2 * q] = a[q:2 * q]              # doubling
    c[2 * q:3 * q] = 0
    b[3 * q:4 * q] = a[3 * q:4 * q] * dtype(2.0 ** -20)
    c[4 * q:5 * q] = -(a[4 * q:5 * q] * b[4 * q:5 * q])   # fma cancellation
    return a, b, c


def _same(x, y) -> bool:
    x = np.asarray(x)
    y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    return x.dtype == y.dtype and np.array_equal(x.view(np.uint8),
                                                 y.view(np.uint8))


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod",
                                  "kahan_step"])
def test_eft_bitwise(name, dtype):
    """Tier 1: each error-free transformation equals the reference's."""
    a, b, c = _inputs(dtype, seed=hash(name) % 97)
    if name == "fast_two_sum":     # precondition |a| >= |b|
        a, b = np.where(abs(a) >= abs(b), a, b), np.where(abs(a) >= abs(b),
                                                          b, a)
    args = (a, b) if name != "kahan_step" else (a, b, c)
    with _x64(dtype):
        want = getattr(JK, name)(*map(jnp.asarray, args))
        want = [np.asarray(w) for w in want]
    got = getattr(TK, name)(*map(torch.from_numpy, args))
    for w, g in zip(want, got):
        assert _same(w, g), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_kahan_combine_bitwise(dtype):
    """Tier 1: the two-sum merge, compensations added left to right."""
    a, b, c = _inputs(dtype, seed=5)
    d = (c * dtype(1e-7)).astype(dtype)
    with _x64(dtype):
        want = JK.kahan_combine(*map(jnp.asarray, (a, c, b, d)))
        want = [np.asarray(w) for w in want]
    got = TK.kahan_combine(*map(torch.from_numpy, (a, c, b, d)))
    assert _same(want[0], got[0]) and _same(want[1], got[1])


def _fma_exact(x: float, y: float, z: float, dtype) -> float:
    """Correctly rounded x*y + z in ``dtype`` by exact rational arithmetic
    (ties to even)."""
    exact = Fraction(x) * Fraction(y) + Fraction(z)
    approx = dtype(float(exact))
    cands = {float(approx), float(np.nextafter(approx, dtype(np.inf))),
             float(np.nextafter(approx, dtype(-np.inf)))}
    ints = np.int32 if dtype == np.float32 else np.int64

    def key(v):
        return (abs(Fraction(v) - exact),
                int(np.asarray(dtype(v)).view(ints)) & 1)

    return min((v for v in cands if np.isfinite(v)), key=key)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fma_is_correctly_rounded(dtype):
    """Tier 1 against exact arithmetic: one rounding of a*b + c."""
    a, b, c = _inputs(dtype, n=2048, seed=11)
    got = TK.fma(*map(torch.from_numpy, (a, b, c))).numpy()
    for i in range(0, a.shape[0], 3):
        want = _fma_exact(float(a[i]), float(b[i]), float(c[i]), dtype)
        assert float(got[i]) == want, (i, a[i], b[i], c[i])


def test_fma_differs_from_separate_rounding():
    """The emulation is a real fma: it keeps the product's low bits that
    a separate multiply drops (a*b - fl(a*b) == the TwoProd error)."""
    a, b, _ = _inputs(np.float32, n=512, seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    p = ta * tb
    err = TK.fma(ta, tb, -p)
    assert torch.equal(err, TK.two_prod(ta, tb)[1])
    assert bool((err != 0).any())


def test_subnormals_diverge():
    """Documented divergence (ROADMAP section C): XLA on the CPU flushes
    subnormal results to zero, the port keeps IEEE gradual underflow (as
    the CUDA kernels do). The TwoProd error of these float32 operands is
    subnormal: the port returns a subnormal, the reference returns 0."""
    a = np.array([2.4534446e-12], np.float32)
    b = np.array([2.2849483e-21], np.float32)
    _, want = JK.two_prod(jnp.asarray(a), jnp.asarray(b))
    _, got = TK.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert float(np.asarray(want)[0]) == 0.0
    assert 0 < abs(float(got[0])) < np.finfo(np.float32).tiny


def test_numerics_copy_matches_reference():
    """The port's numpy-only copy of core/numerics generates the same
    GenDot data and exact values."""
    for n, cond in ((1000, 1e6), (4097, 1e12)):
        ja, jb, jex, jc = jnum.gen_dot(n, cond, seed=7)
        ta, tb, tex, tc = tnum.gen_dot(n, cond, seed=7)
        assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
        assert jex == tex and jc == tc
    assert tnum.relative_error(1.5, 1.0) == jnum.relative_error(1.5, 1.0)
