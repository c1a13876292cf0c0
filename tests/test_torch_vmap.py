"""The vmap dispatch of the port's kernel layer vs the JAX reference, on
the CPU, and the compute dtypes of its flash and matmul kernels.

The reference's ``ops.dot``, ``ops.asum`` and ``ops.matmul`` carry
``jax.custom_batching.custom_vmap`` rules that land ``jax.vmap`` on the
batched grids (``repro/kernels/engine.py:549-654``); the port's carry
``torch.autograd.Function`` vmap rules that land ``torch.func.vmap`` on
one batched launch (B2, B4, B6). Inputs are made from a seed with numpy
and go through both packages; the reference runs its Pallas kernels in
interpret mode, the port its plain versions. Parity tiers:

* tier 1 (bitwise against the reference): vmapped dot and asum, every
  built-in scheme x float32, float64 (``jax.enable_x64``) and bfloat16
  compute, with both operands batched, one unbatched, and the batch on a
  non-leading dim.
* tier 2 (bitwise within the port): vmapped == the batched entry point
  == a loop of single calls, in ONE batched wrapper call; ``torch.func.
  grad`` through ``ops.matmul`` == the autograd backward.
* tier 3 (tolerance against the reference): vmapped matmul within
  ``1e-6 * (|a| @ |b|)`` (``tests/test_torch_matmul.py``'s bound: XLA
  forms a block product in its own order). The compute dtypes the card
  now takes (B-7): flash in bfloat16 within 2^-4 of the output's largest
  magnitude, flash in float64 within 1e-12 of it, matmul in bfloat16
  within ``1e-2 * (|a| @ |b|)``. The port rounds every op of a chain to
  the compute dtype (a ``p . v`` chain of 128 adds to bfloat16's 8 bits);
  XLA's ``dot_general`` with a bfloat16 ``preferred_element_type`` sums in
  its own order and width (measured: 3.4e-2 of the largest output in
  bfloat16, 1.8e-16 in float64, 3.5e-3 of ``|a| @ |b|``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels.schemes import Policy as JaxPolicy
from repro_torch.kernels import engine as teng
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kahan_dot as tkd
from repro_torch.kernels import kahan_matmul as tkm
from repro_torch.kernels import kahan_sum as tks
from repro_torch.kernels import ops as tops
from repro_torch.kernels.schemes import Policy

SCHEMES = ["naive", "kahan", "pairwise", "dot2"]
DTYPES = ["float32", "float64", "bfloat16"]
MATMUL_RTOL = 1e-6
BF16_MATMUL_RTOL = 1e-2
BF16_FLASH_RTOL = 2.0 ** -4
F64_FLASH_RTOL = 1e-12


def _data(shape, seed, dtype=np.float32):
    """Normal values scaled by 2^e, e in [-8, 8) (as
    ``tests/test_torch_kernels.py``)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-8, 8, size=shape)
    return (rng.standard_normal(shape) * np.exp2(e)).astype(dtype)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_same(want, got, what):
    w, g = np.atleast_1d(_bits(want)), np.atleast_1d(_bits(got))
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype)
    assert np.array_equal(w.view(np.uint8), g.view(np.uint8)), what


@pytest.fixture
def batched_calls(monkeypatch):
    """Calls of the batched wrappers, by name (the engine reaches them
    through their modules)."""
    calls = []
    for module, name in ((tkd, "dot_accumulators_batched"),
                         (tks, "sum_accumulators_batched"),
                         (tkm, "matmul_accumulators_batched")):
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_vmapped_dot_and_asum_bitwise_vs_reference(scheme, compute_dtype,
                                                   batched_calls):
    """Tier 1 against ``jax.vmap`` of the reference's entry points, and
    tier 2 within the port: one batched launch a vmapped call, equal to
    a loop of single calls. Cases: both operands batched, ``b``
    unbatched, and the batch on dim 1."""
    np_dt = np.float64 if compute_dtype == "float64" else np.float32
    a = _data((4, 3 * 1024 + 11), seed=31, dtype=np_dt)
    b = _data((4, 3 * 1024 + 11), seed=32, dtype=np_dt)
    kw = dict(scheme=scheme, unroll=2, compute_dtype=compute_dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with jax.enable_x64(compute_dtype == "float64"):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        cases = (
            ("both batched", (0, 0), (ja, jb), (ta, tb)),
            ("b unbatched", (0, None), (ja, jb[0]), (ta, tb[0])),
            ("batch on dim 1", (1, 1), (ja.T, jb.T), (ta.T, tb.T)))
        for what, dims, jargs, targs in cases:
            want = jax.vmap(lambda x, y: jops.dot(x, y, **kw),
                            in_axes=dims)(*jargs)
            del batched_calls[:]
            got = torch.func.vmap(lambda x, y: tops.dot(x, y, **kw),
                                  in_dims=dims)(*targs)
            assert batched_calls == ["dot_accumulators_batched"], what
            _assert_same(want, got, f"dot {what}")
            rows = [tops.dot(ta[i], tb[i] if dims[1] is not None else tb[0],
                             **kw) for i in range(4)]
            _assert_same(torch.stack(rows), got, f"dot loop {what}")
        for what, dim, jx, tx in (("batched", 0, ja, ta),
                                  ("batch on dim 1", 1, ja.T, ta.T)):
            want = jax.vmap(lambda x: jops.asum(x, **kw), in_axes=dim)(jx)
            del batched_calls[:]
            got = torch.func.vmap(lambda x: tops.asum(x, **kw),
                                  in_dims=dim)(tx)
            assert batched_calls == ["sum_accumulators_batched"], what
            _assert_same(want, got, f"asum {what}")
            _assert_same(torch.stack([tops.asum(ta[i], **kw)
                                      for i in range(4)]), got,
                         f"asum loop {what}")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_vmapped_matmul_vs_batched_loop_and_reference(scheme,
                                                      batched_calls):
    """Tier 2: ``torch.func.vmap`` of ``ops.matmul`` over 3 products (the
    weight unbatched, then the batch on dim 1 of both) is ONE B6 call,
    bitwise the batched entry point and a loop of ``ops.matmul``; tier
    3: within ``1e-6 * (|a| @ |b|)`` of ``jax.vmap`` of the reference's
    ``ops.matmul``."""
    rng = np.random.default_rng(41)
    a = rng.standard_normal((3, 5, 600)).astype(np.float32)
    b = rng.standard_normal((600, 70)).astype(np.float32)
    kw = dict(scheme=scheme, block_k=256)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = torch.func.vmap(lambda x: tops.matmul(x, tb, **kw))(ta)
    assert batched_calls == ["matmul_accumulators_batched"]
    assert got.shape == (3, 5, 70)
    assert torch.equal(got, tops.batched_matmul(ta, tb.expand(3, 600, 70),
                                                **kw))
    assert torch.equal(got, torch.stack([tops.matmul(ta[i], tb, **kw)
                                         for i in range(3)]))
    bb = np.stack([b, 2 * b, -b], axis=1)             # [600, 3, 70]
    moved = torch.func.vmap(lambda x, y: tops.matmul(x, y, **kw),
                            in_dims=(1, 1))(ta.transpose(0, 1),
                                            torch.from_numpy(bb))
    assert torch.equal(moved[1], tops.matmul(ta[1], 2 * tb, **kw))
    want = jax.vmap(lambda x: jops.matmul(x, jnp.asarray(b), **kw))(
        jnp.asarray(a))
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert np.all(np.abs(got.numpy() - np.asarray(want))
                  <= MATMUL_RTOL * scale)


def test_grad_through_matmul_equals_the_autograd_backward():
    """Tier 2: ``torch.func.grad`` reaches the compensated backward
    through the same Function as ``Tensor.backward``: both gradients
    equal bit for bit, in float32 and float64 compute."""
    rng = np.random.default_rng(43)
    for cd, np_dt in ((torch.float32, np.float32),
                      (torch.float64, np.float64)):
        x = torch.from_numpy(rng.standard_normal((6, 300)).astype(np_dt))
        y = torch.from_numpy(rng.standard_normal((300, 9)).astype(np_dt))
        g = torch.from_numpy(rng.standard_normal((6, 9)).astype(np_dt))
        kw = dict(scheme="kahan", compute_dtype=cd, block_k=128)
        dx, dy = torch.func.grad(
            lambda p, q: (tops.matmul(p, q, **kw) * g).sum(),
            argnums=(0, 1))(x, y)
        px, py = x.clone().requires_grad_(), y.clone().requires_grad_()
        tops.matmul(px, py, **kw).backward(g)
        assert torch.equal(dx, px.grad) and torch.equal(dy, py.grad)
        assert torch.equal(dx, tops.matmul(g, y.T.contiguous(), **kw))


def test_eager_calls_keep_their_bits_and_skip_the_functions(monkeypatch):
    """Tier 2: outside a transform, with no gradient to track, ``dot``,
    ``asum`` and ``matmul`` never enter the Functions, and their results
    are the accumulators' totals, bit for bit."""
    entered = []
    for fn in (teng._CompensatedDot, teng._CompensatedSum,
               teng._CompensatedMatmul):
        monkeypatch.setattr(fn, "apply", classmethod(
            lambda cls, *a: entered.append(cls) or None))
    ta, tb = map(torch.from_numpy, _data((2, 5000), seed=45))
    eng = teng.CompensatedReduction(scheme="dot2", unroll=2)
    _assert_same(eng.dot_accumulators(ta, tb).total(), eng.dot(ta, tb),
                 "dot")
    _assert_same(eng.sum_accumulators(ta).total(), eng.asum(ta), "asum")
    x, y = ta.reshape(10, 500), tb.reshape(500, 10)
    _assert_same(eng._finalized_matmul(x, y, eng._matmul_blocks(
        10, 10, 500, None, None, None)), eng.matmul(x, y), "matmul")
    assert entered == []


# ---------------------------------------------------------------------------
# B-7: the compute dtypes of the flash and matmul kernels, tier 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float64"])
def test_flash_in_bfloat16_and_float64_vs_reference(scheme, compute_dtype):
    """The plain flash (B7, and B8 at offset 100) in bfloat16 and float64
    compute against the reference's Pallas flash in the same dtype: GQA
    G = 2, Sq and Skv off their blocks; the output in the compute dtype,
    within the module's stated tolerance of its largest magnitude."""
    rng = np.random.default_rng(47)
    q = rng.standard_normal((4, 150, 16)).astype(np.float32)
    k = rng.standard_normal((2, 300, 16)).astype(np.float32)
    v = rng.standard_normal((2, 300, 16)).astype(np.float32)
    kw = dict(block_q=64, block_k=128, q_groups=2)
    tol = BF16_FLASH_RTOL if compute_dtype == "bfloat16" else F64_FLASH_RTOL
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with jax.enable_x64(compute_dtype == "float64"):
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        jpol = JaxPolicy(scheme=scheme, compute_dtype=compute_dtype)
        tpol = Policy(scheme=scheme, compute_dtype=compute_dtype)
        pairs = (
            (jfa.flash_attention(jq, jk, jv, scheme=jpol, interpret=True,
                                 causal=True, **kw),
             tfa.flash_attention(tq, tk, tv, scheme=tpol, causal=True, **kw)),
            (jfa.flash_chunk_attention(jq[:, :40], jk, jv,
                                       q_off=jnp.int32(100), scheme=jpol,
                                       interpret=True, **kw),
             tfa.flash_chunk_attention(tq[:, :40], tk, tv, q_off=100,
                                       scheme=tpol, **kw)))
        for want, got in pairs:
            assert got.dtype == getattr(torch, compute_dtype)
            w = np.asarray(want).astype(np.float64)
            assert np.asarray(want).dtype.name == compute_dtype
            g = got.double().numpy()
            assert np.all(np.abs(g - w) <= tol * np.abs(w).max())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_matmul_in_bfloat16_vs_reference(scheme):
    """The plain matmul (B5 at M 5 and 37, and B6) in bfloat16 compute
    against the reference's Pallas matmul in bfloat16, within ``1e-2 *
    (|a| @ |b|)``; B6 equal to a loop of B5, bitwise."""
    rng = np.random.default_rng(49)
    b = rng.standard_normal((700, 70)).astype(np.float32)
    kw = dict(scheme=scheme, block_k=128, compute_dtype="bfloat16")
    for m in (5, 37):
        a = rng.standard_normal((m, 700)).astype(np.float32)
        want = jops.matmul(jnp.asarray(a), jnp.asarray(b), **kw)
        got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b), **kw)
        assert got.dtype == torch.bfloat16
        scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
        err = np.abs(got.double().numpy()
                     - np.asarray(want).astype(np.float64))
        assert np.all(err <= BF16_MATMUL_RTOL * scale), m
    a3 = torch.from_numpy(rng.standard_normal((3, 9, 700)).astype(np.float32))
    b3 = torch.from_numpy(b).expand(3, 700, 70)
    assert torch.equal(tops.batched_matmul(a3, b3, **kw),
                       torch.stack([tops.matmul(a3[i], b3[i], **kw)
                                    for i in range(3)]))
