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
    magnitude inversion. Every intermediate stays in the normal range;
    ``_sub_inputs`` reaches the subnormal one."""
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


def test_fma_float32_midpoints_round_once():
    """float32: where the float64 sum of the exact product and ``c``
    lands halfway between two float32 neighbours but the exact sum does
    not, the fma rounds the exact sum (a second rounding of the float64
    sum would tie to even). (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is such a
    midpoint; c = +-2^-80 tips it either way, and c = 0 ties to even."""
    one = 1 + 2.0 ** -12
    a = torch.full((3,), one, dtype=torch.float32)
    c = torch.tensor([2.0 ** -80, -2.0 ** -80, 0.0], dtype=torch.float32)
    got = TK.fma(a, a, c)
    want = [_fma_exact(one, one, float(x), np.float32) for x in c]
    assert want == [1 + 2.0 ** -11 + 2.0 ** -23, 1 + 2.0 ** -11,
                    1 + 2.0 ** -11]
    assert got.tolist() == want
    # the float64 sum alone rounds the first case down
    assert float((a.double() * a.double() + c.double()).float()[0]) \
        == 1 + 2.0 ** -11


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
    """Fault C2, repaired: XLA on the CPU flushes subnormal results to
    zero, and so does the port. The TwoProd error of these float32
    operands is subnormal: both return zero. (The name is the fault's;
    the two no longer diverge.)"""
    a = np.array([2.4534446e-12], np.float32)
    b = np.array([2.2849483e-21], np.float32)
    _, want = JK.two_prod(jnp.asarray(a), jnp.asarray(b))
    _, got = TK.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert float(np.asarray(want)[0]) == 0.0
    assert _same(want, got)


TINY32 = np.float32(np.finfo(np.float32).tiny)
#: more elements than one intra-op thread takes: a thread-local flush
#: flag would leave most of them subnormal
N_SUB = (1 << 16) + 4099


def _sub_inputs(dtype, kind, n=N_SUB, seed=0):
    """Three float32 operands (bfloat16 values when ``dtype`` is
    bfloat16) that reach float32's subnormal range:

    * ``inputs``: operands subnormal or just above ``tiny``;
    * ``outputs``: normal operands whose products, sums and differences
      land below ``tiny``;
    * ``boundary``: products whose exact value lies a few units of the
      last place on either side of ``tiny`` (x86 rounds to 24 bits first:
      (1 - 2^-24) * tiny flushes, (1 - 2^-23) * tiny * (1 + 2^-23) gives
      tiny);
    * ``zeros``: signed zeros against subnormals and their negatives."""
    rng = np.random.default_rng(seed)
    bits = 8 if dtype == "bfloat16" else 24
    sign = rng.choice([-1.0, 1.0], size=(3, n))
    frac = rng.integers(0, 1 << (bits - 1), size=(3, n)) / (1 << (bits - 1))
    if kind == "inputs":
        e = rng.integers(-149, -122, size=(3, n))
        x = sign * (1 + frac) * np.exp2(e)
    elif kind == "outputs":
        e = rng.integers(-80, -50, size=(3, n))
        x = sign * (1 + frac) * np.exp2(e)
        x[1] *= np.exp2(-76 - e[0] - e[1] + rng.integers(-30, 8, size=n))
        q = n // 4                          # near-cancelling pairs
        x[0, :q] = sign[0, :q] * (1 + frac[0, :q]) * np.exp2(
            rng.integers(-126, -120, size=q))
        x[1, :q] = -x[0, :q] * (1 + rng.integers(-64, 64, size=q)
                                * 2.0 ** (1 - bits))
        x[2, :q] = -x[0, :q]
    elif kind == "boundary":
        ulp = 2.0 ** (1 - bits)
        j = rng.integers(0, 4, size=n)
        i = rng.integers(0, 4, size=n)
        k = rng.integers(-3, 4, size=n)
        x = np.empty((3, n))
        x[0] = sign[0] * (1 - j * ulp / 2) * np.exp2(k)
        x[1] = sign[1] * float(TINY32) * (1 + i * ulp) * np.exp2(-k)
        x[2] = sign[2] * float(TINY32) * rng.integers(0, 3, size=n)
    elif kind == "zeros":
        x = sign * (1 + frac) * np.exp2(rng.integers(-149, -120,
                                                     size=(3, n)))
        zero = rng.random((3, n)) < 0.4
        x[zero] = np.copysign(0.0, sign[zero])
        x[1, ::3] = -x[0, ::3]
    else:
        raise ValueError(kind)
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).astype(
            np.float32)
    return x


def _as_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _as_torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.bfloat16() if dtype == "bfloat16" else t


def _same_bits(want, got) -> bool:
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    return np.array_equal(w.view(np.uint32), g.view(np.uint32))


def _jax_fused(a, b, c):
    """The reference's fused site: ``a * b + c`` as XLA compiles it on the
    CPU (contracted into one fma in float32, not in bfloat16)."""
    return jax.jit(lambda x, y, z: x * y + z)(a, b, c)


def _torch_fused(a, b, c):
    """The port's fused site (``core.kahan._mac``) on flushed inputs, as
    the plain versions give it them."""
    return TK._mac(TK.flush(a), TK.flush(b), TK.flush(c))


SUB_OPS = {
    "two_sum": (2, JK.two_sum, TK.two_sum),
    "fast_two_sum": (2, JK.fast_two_sum, TK.fast_two_sum),
    "two_prod": (2, JK.two_prod, TK.two_prod),
    "kahan_step": (3, JK.kahan_step, TK.kahan_step),
    "kahan_combine": (4, JK.kahan_combine, TK.kahan_combine),
    "fma": (3, _jax_fused, _torch_fused),
}


@pytest.mark.parametrize("kind", ["inputs", "outputs", "boundary", "zeros"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SUB_OPS))
def test_subnormals_bitwise(name, dtype, kind):
    """Tier 1 on subnormal-reaching data (C2): each EFT, the Kahan step,
    the merge and the fused multiply-add equal the reference bit for bit,
    flushed subnormals, signed zeros and the rounding boundary at ``tiny``
    included, on more elements than one thread takes."""
    arity, jfn, tfn = SUB_OPS[name]
    x = _sub_inputs(dtype, kind, seed=len(name) + len(kind))
    args = [x[0], x[1], x[2], (x[2] * np.float32(0.5)).astype(np.float32)]
    args = args[:arity]
    if name == "fast_two_sum":     # precondition |a| >= |b|
        big = abs(args[0]) >= abs(args[1])
        args = [np.where(big, args[0], args[1]), np.where(big, args[1],
                                                          args[0])]
    want = jfn(*(_as_jax(v, dtype) for v in args))
    got = tfn(*(_as_torch(v, dtype) for v in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for i, (w, g) in enumerate(zip(want, got)):
        assert _same_bits(w, g), (name, dtype, kind, i)
    flushed = [g.float().abs() for g in got]
    assert all(bool(((f == 0) | (f >= float(TINY32))).all())
               for f in flushed), "a subnormal survived"


def test_subnormal_boundary_cases():
    """The two products at the boundary, named: (1 - 2^-24) * tiny is
    exact below tiny at 24 bits and flushes; (1 - 2^-23) * tiny *
    (1 + 2^-23) = tiny * (1 - 2^-46) rounds to tiny at 24 bits and stays,
    in the reference and in the port (``mul`` and ``fma``)."""
    a = np.array([1 - 2.0 ** -24, 1 - 2.0 ** -23], np.float32)
    b = np.array([TINY32, TINY32 * np.float32(1 + 2.0 ** -23)], np.float32)
    z = np.zeros(2, np.float32)
    want = np.asarray(jax.jit(lambda x, y: x * y)(a, b))
    assert want.view(np.uint32).tolist() == [0, 0x800000]
    ta, tb, tz = map(torch.from_numpy, (a, b, z))
    assert _same(want, TK.mul(ta, tb))
    assert _same(want, TK.fma(ta, tb, tz))
    assert _same(want, TK.two_prod(ta, tb)[0])


@pytest.mark.parametrize("kind", ["inputs", "outputs", "boundary", "zeros"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["mul", "div"])
def test_mul_div_subnormals_bitwise(op, dtype, kind):
    """Tier 1 on subnormal-reaching data (C2): the flushing product and
    quotient (``core.kahan.mul`` / ``div``, on flushed inputs as the
    plain versions give them) equal the reference's compiled ``x * y`` /
    ``x / y`` bit for bit, the rounding boundary at ``tiny`` included. A
    quotient's divisor is the reciprocal of the product's factor, so the
    quotients land where the products do."""
    x = _sub_inputs(dtype, kind, seed=len(op) + len(kind))
    a, b = x[0], x[1]
    if op == "div":
        with np.errstate(over="ignore"):
            b = _sub_round(np.float32(1) / np.where(b == 0, 1, b), dtype)
        b = np.where(b == 0, np.float32(1), b)
    jfn = {"mul": lambda u, v: u * v, "div": lambda u, v: u / v}[op]
    want = jax.jit(jfn)(_as_jax(a, dtype), _as_jax(b, dtype))
    tfn = {"mul": TK.mul, "div": TK.div}[op]
    got = tfn(TK.flush(_as_torch(a, dtype)), TK.flush(_as_torch(b, dtype)))
    assert _same_bits(want, got)
    if kind != "inputs":
        w = np.asarray(jnp.asarray(want).astype(jnp.float32))
        exact = a.astype(np.float64) * b if op == "mul" else \
            a.astype(np.float64) / b
        # the data reaches the flush: results the reference zeroes
        assert ((w == 0) & (exact != 0)).any()


def _sub_round(x: np.ndarray, dtype) -> np.ndarray:
    """``x`` rounded to ``dtype``'s values, as float32."""
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).astype(
            np.float32)
    return x


def test_float64_subnormals_out_of_scope():
    """float64 does not flush in the port: float64 results of float32 or
    bfloat16 data never reach float64's subnormal range, so a float64
    subnormal input is out of scope (the reference flushes it; the port
    keeps it)."""
    d = np.array([5e-324, -1e-310])
    ones = np.ones(2)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda x, y: x * y)(d, ones))
    got = TK.mul(torch.from_numpy(d), torch.from_numpy(ones)).numpy()
    assert (want == 0).all()
    assert np.array_equal(got, d)
    assert torch.equal(TK.flush(torch.from_numpy(d)), torch.from_numpy(d))


def test_model_torch_ops_keep_subnormals():
    """C2's remainder, pinned: the model's own torch ops (here the plain
    projection, ``torch.matmul``) keep subnormal products that the
    reference's compiled dot flushes; its compensated projection
    (``kahan_matmul``: the engine, whose plain version flushes) equals
    the reference's. The model is tier 3 against the reference."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    x = np.full((2, 1024), 1e-20, np.float32)
    w = np.full((1024, 3), 1e-20, np.float32)
    for compensated in (False, True):
        want = jax.jit(lambda w, x: JL.dense(
            {"w": w}, x, jnp.float32, compensated=compensated))(
                jnp.asarray(w), jnp.asarray(x))
        got = TL.dense({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                       torch.float32, compensated=compensated)
        assert (np.asarray(want) == 0).all()
        if compensated:
            assert _same_bits(want, got)
        else:       # 1024 products of 1e-40 summed: about 1.024e-37
            assert (got > np.float32(1e-37)).all()


def test_numerics_copy_matches_reference():
    """The port's numpy-only copy of core/numerics generates the same
    GenDot data and exact values."""
    for n, cond in ((1000, 1e6), (4097, 1e12)):
        ja, jb, jex, jc = jnum.gen_dot(n, cond, seed=7)
        ta, tb, tex, tc = tnum.gen_dot(n, cond, seed=7)
        assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
        assert jex == tex and jc == tc
    assert tnum.relative_error(1.5, 1.0) == jnum.relative_error(1.5, 1.0)
