"""The selective SSM of the hybrid family (``repro_torch.models.ssm``)
against the JAX reference (``repro.models.ssm``), with the reference's
parameters carried over unchanged.

Parity tiers:

* tier 1 (bitwise against the reference): the associative scan's
  products ``a_cum``, at lengths odd and even, short and the chunk's 128:
  the port runs ``jax.lax.associative_scan``'s own odd/even recursion, so
  each output multiplies the same decays in the same order (a product of
  up to 128 decays in another order drifts by up to ~128 ulps).
* tier 3 (tolerance against the reference): the scan's ``b_cum`` within
  rtol 1e-6 of its largest magnitude, and ``ssm_apply``'s decode step
  and chunked prefill (S off the chunk, from zeros and from a carried
  state) -- y, h and conv_buf -- within rtol = atol = 1e-5 of their
  largest magnitude.

Why ``b_cum`` and the SSM are not bitwise: XLA on the CPU contracts a
product into the following add (``jax.jit(lambda a, h, b: a * h + b)``
equals the single-rounding fma on all of 65536 random float32 triples,
the separate ops on 77%; the compiled kernels of ``ssm_apply`` carry
``vfmadd`` instructions), at ``h = decay * h_prev + drive``, the scan's
``a2 * b1 + b2``, the conv window's multiply-adds and ``b_cum + a_cum *
h0``. The port keeps separate multiplies and adds at these sites
(``core/kahan.py::fma`` is not mirrored): XLA's and torch's ``exp``,
``log1p`` and ``sigmoid`` differ by ulps as well, so an fma there would
not make the SSM bitwise, and the tolerances hold without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke
from repro_torch.models import ssm

CPU = torch.device("cpu")
RTOL = 1e-5


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * scale, err_msg=what)


@pytest.fixture(scope="module")
def setup():
    """The smoke config's SSM parameters (the reference's, with a random
    conv bias, dt bias and D so that none is its constant init), as numpy,
    jax and torch trees."""
    jcfg = jax_smoke("hymba-1.5b")
    p, _ = jssm.ssm_init(jax.random.key(0), jcfg)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(4)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(
        np.float32)
    p["dt_proj"]["b"] = (p["dt_proj"]["b"] + 0.1 * rng.standard_normal(
        p["dt_proj"]["b"].shape)).astype(np.float32)
    p["D"] = (1 + 0.1 * rng.standard_normal(p["D"].shape)).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    return dict(jcfg=jcfg, cfg=get_smoke("hymba-1.5b"), rng=rng,
                jp=jax.tree.map(jnp.asarray, p), tp=tp)


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 5, 16, 37, 128])
def test_associative_scan_order(n):
    """Tier 1 on the products, tier 3 on the drives (see the module
    docstring)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.3, 1.0, (2, n, 8, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 8, 4)).astype(np.float32)
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine, (a, b), axis=1))(a, b)
    ta, tb = ssm.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tb.numpy(), jb, rtol=1e-6)


def test_decode_step_within_tolerance(setup):
    """Tier 3: one decode step from a random carried state: y, and h and
    conv_buf updated in place."""
    s = setup
    cfg, rng = s["cfg"], s["rng"]
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    h_shape, conv_shape = ssm.ssm_cache_shapes(cfg, 2)
    h0 = (0.5 * rng.standard_normal(h_shape)).astype(np.float32)
    c0 = rng.standard_normal(conv_shape).astype(np.float32)
    jy, (jh, jc) = jssm.ssm_apply(s["jp"], s["jcfg"], jnp.asarray(x),
                                  cache=(jnp.asarray(h0), jnp.asarray(c0)))
    h, c = torch.from_numpy(h0.copy()), torch.from_numpy(c0.copy())
    y = ssm.ssm_apply(s["tp"], cfg, torch.from_numpy(x), cache=(h, c))
    _close(y.numpy(), jy, what="y")
    _close(h.numpy(), jh, what="h")
    _close(c.numpy(), jc, what="conv_buf")


@pytest.mark.parametrize("seq", [7, 37])
@pytest.mark.parametrize("carried", [False, True])
def test_chunked_prefill_within_tolerance(setup, seq, carried):
    """Tier 3: the chunked scan over S = 7 (one short chunk) and S = 37
    (chunk 16: two full chunks and a padded one), from zeros or from a
    carried state ``h0``; the last state and the last k - 1 pre-conv
    inputs land in the cache."""
    s = setup
    cfg, rng = s["cfg"], s["rng"]
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    h_shape, conv_shape = ssm.ssm_cache_shapes(cfg, 2)
    h0 = ((0.5 * rng.standard_normal(h_shape)) if carried
          else np.zeros(h_shape)).astype(np.float32)
    c0 = np.zeros(conv_shape, np.float32)
    jy, (jh, jc) = jssm.ssm_apply(s["jp"], s["jcfg"], jnp.asarray(x),
                                  cache=(jnp.asarray(h0), jnp.asarray(c0)))
    h, c = torch.from_numpy(h0.copy()), torch.from_numpy(c0.copy())
    y = ssm.ssm_apply(s["tp"], cfg, torch.from_numpy(x), cache=(h, c))
    _close(y.numpy(), jy, what="y")
    _close(h.numpy(), jh, what="h")
    _close(c.numpy(), jc, what="conv_buf")
    if not carried:
        # training mode (no cache) runs the same scan from zeros
        jy2, _ = jssm.ssm_apply(s["jp"], s["jcfg"], jnp.asarray(x))
        y2 = ssm.ssm_apply(s["tp"], cfg, torch.from_numpy(x))
        _close(y2.numpy(), jy2, what="y without a cache")
        assert torch.equal(y2, y)


def test_spec_matches_the_reference_init(setup):
    """The parameter shapes and dtypes equal the reference's ``ssm_init``
    (dt_rank ceil(d / 16), ``A_log`` and ``D`` float32), and the fixed
    inits are the reference's values within an ulp (``A_log`` = log(1..dS)
    and the dt bias log(expm1(0.01)): XLA's and torch's log differ in the
    last place on some inputs)."""
    jp, _ = jssm.ssm_init(jax.random.key(0), setup["jcfg"])
    spec = ssm.ssm_spec(setup["cfg"])
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), jp)

    def walk(node, w):
        if isinstance(node, dict):
            assert set(node) == set(w)
            for k in node:
                walk(node[k], w[k])
            return
        dtype = node[2] if len(node) > 2 else "float32"
        assert (tuple(node[0]), dtype) == w

    walk(spec, want)
    from repro_torch.models.common import init_params

    got = init_params(spec, setup["cfg"], torch.Generator().manual_seed(0),
                      CPU)
    np.testing.assert_allclose(got["A_log"].numpy(),
                               np.asarray(jp["A_log"]), rtol=2e-7)
    np.testing.assert_allclose(got["dt_proj"]["b"].numpy(),
                               np.asarray(jp["dt_proj"]["b"]), rtol=2e-7)
    assert ssm.dt_rank(get_smoke("hymba-1.5b")) == 4
    from repro_torch.configs import get_config

    assert ssm.dt_rank(get_config("hymba-1.5b")) == 100
