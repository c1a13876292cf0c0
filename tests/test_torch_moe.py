"""The port's MoE layer and MLA attention vs the JAX reference, on the smoke
configs of deepseek-v2-lite-16b (8 experts top-2, one shared) and
llama4-maverick-400b-a17b (8 experts top-1, one shared), with the
reference's own initialisation carried over as numpy arrays.

Parity tiers:

* tier 1 (exact against the reference): the routing, and the combine
  (each token's contributions folded from zero in the sorted order equal
  the reference's scatter-add on the same contributions, bit for bit).
  The routing: ``expert_idx`` (the
  reference's, recorded from its ``lax.top_k`` call), the keep mask
  (derived here from ``expert_idx`` and the capacity: an entry is kept
  while fewer than ``capacity`` earlier entries of its group chose its
  expert) and ``dropped_frac``, at capacity 1.25 (entries drop) and 16,
  at ``S == 1`` (dropless) and ``S > 1``; a forced tie in the router picks
  the lower expert first.
* tier 3 (tolerance against the reference): ``y`` within rtol = atol =
  1e-5 (both sides float32; XLA and PyTorch sum the contractions in
  different orders); MLA's absorbed decode, expanded prefill and
  training branches within the same tolerance.
* the reference's invariants replayed on the port
  (``tests/test_invariants.py``): zeroed experts leave the shared path,
  dropless at capacity 16, permutation equivariance; and its
  ``test_decode_matches_prefill`` (prefill(s) then one decode step ==
  prefill(s + 1) at capacity 16, within 2e-3) at the smoke size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import tree as T
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models.layers import mla_attention, mlp_apply, rope_freqs

CPU = torch.device("cpu")
ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]
RTOL = ATOL = 1e-5


def _with_capacity(cfg, factor):
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=factor))


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)),
                      jax.tree.map(np.asarray, tree))


def _layer(name, factor, seed=0):
    """(reference cfg, port cfg, reference MoE params, the port's copy)."""
    jcfg = _with_capacity(jax_smoke(name), factor)
    cfg = _with_capacity(get_smoke(name), factor)
    jp, _ = jax_moe.moe_init(jax.random.key(seed), jcfg)
    return jcfg, cfg, jp, _to_torch(jp)


def _reference(jp, jcfg, x):
    """The reference's (y, metrics) and the expert_idx its top_k chose."""
    seen = []
    top_k = jax.lax.top_k

    def recording(probs, k):
        out = top_k(probs, k)
        seen.append(np.asarray(out[1]))
        return out

    jax.lax.top_k = recording
    try:
        y, met = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    finally:
        jax.lax.top_k = top_k
    assert len(seen) == 1
    return np.asarray(y), met, seen[0]


def _keep(expert_idx, capacity):
    """[G, Tg*k] keep mask in token-major order, from first principles."""
    g = expert_idx.shape[0]
    flat = expert_idx.reshape(g, -1)
    keep = np.zeros(flat.shape, bool)
    for gi in range(g):
        seen = {}
        for i, e in enumerate(flat[gi]):
            keep[gi, i] = seen.get(e, 0) < capacity
            seen[e] = seen.get(e, 0) + 1
    return keep


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("factor", [1.25, 16.0])
@pytest.mark.parametrize("shape", [(4, 1), (2, 16)])
def test_routing_equals_reference_and_output_within_tolerance(name, factor,
                                                              shape):
    jcfg, cfg, jp, p = _layer(name, factor)
    b, s = shape
    x = np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jy, jmet, jidx = _reference(jp, jcfg, x)
    xt = torch.from_numpy(x)
    y, met = moe.moe_apply(p, cfg, xt)
    g = moe.n_groups(b * s, b)
    r = moe.route(p, cfg, xt.reshape(g, -1, cfg.d_model), s)
    np.testing.assert_array_equal(r.expert_idx.numpy(), jidx)
    keep = np.zeros_like(_keep(jidx, r.capacity))
    np.put_along_axis(keep, r.order.numpy(), r.keep.numpy(), axis=-1)
    np.testing.assert_array_equal(keep, _keep(jidx, r.capacity))
    assert float(met["dropped_frac"]) == float(jmet["dropped_frac"])
    assert (float(met["dropped_frac"]) > 0) == (factor < 2 and s > 1)
    np.testing.assert_allclose(float(met["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), jy, rtol=RTOL, atol=ATOL)


def test_capacity_rounds_half_to_even():
    """2.5 rows round to 2, 3.5 to 4 (Python's round), as in the
    reference; decode is dropless."""
    cfg = _with_capacity(get_smoke("deepseek-v2-lite-16b"), 1.25)
    assert moe.capacity(cfg, 16, 2) == 2
    assert moe.capacity(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.75)), 16, 2) == 4
    assert moe.capacity(cfg, 16, 1) == 16
    assert [moe.n_groups(t, b) for t, b in ((32, 2), (64, 64), (7, 1))] == [
        2, 32, 1]


def test_tied_router_picks_the_lower_expert():
    """Identical router columns give equal probabilities: the lower
    expert comes first, in the port as in the reference's top_k."""
    name = "deepseek-v2-lite-16b"
    jcfg, cfg, jp, p = _layer(name, 16.0)
    w = np.array(jp["router"]["w"])
    w[:, 5] = w[:, 2] = 4 * np.abs(w[:, 2]).max()
    jp = dict(jp, router={"w": jnp.asarray(w)})
    p["router"]["w"] = torch.from_numpy(w)
    x = np.abs(np.random.default_rng(2).standard_normal(
        (1, 8, cfg.d_model))).astype(np.float32)
    _, _, jidx = _reference(jp, jcfg, x)
    r = moe.route(p, cfg, torch.from_numpy(x), 8)
    np.testing.assert_array_equal(r.expert_idx.numpy(), jidx)
    assert (r.expert_idx[..., :2].numpy() == [2, 5]).all()


def test_zeroed_experts_leave_the_shared_path():
    cfg = _with_capacity(get_smoke("deepseek-v2-lite-16b"), 8.0)
    _, _, _, p = _layer("deepseek-v2-lite-16b", 8.0)
    p["gate"] = torch.zeros_like(p["gate"])
    p["up"] = torch.zeros_like(p["up"])
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y, _ = moe.moe_apply(p, cfg, x)
    want = mlp_apply(p["shared"], x, torch.float32)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-6)


def test_dropless_at_high_capacity_and_permutation_equivariant():
    cfg = _with_capacity(get_smoke("deepseek-v2-lite-16b"), 16.0)
    _, _, _, p = _layer("deepseek-v2-lite-16b", 16.0)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 32, cfg.d_model), generator=gen)
    _, met = moe.moe_apply(p, cfg, x)
    assert float(met["dropped_frac"]) == 0.0
    x = x[:1, :16]
    y, _ = moe.moe_apply(p, cfg, x)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(16))
    y2, _ = moe.moe_apply(p, cfg, x[:, perm])
    torch.testing.assert_close(y[:, perm], y2, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_combine_equals_the_reference_scatter_add_bitwise(name):
    """The combine alone, on the same contributions: each token's sum
    folded from zero in the sorted order equals the reference's
    ``zeros.at[token].add`` on the CPU bit for bit."""
    _, cfg, _, p = _layer(name, 1.25)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    r = moe.route(p, cfg, x, 16)
    contrib = torch.randn((*r.token.shape, cfg.d_model), generator=gen)
    got = moe.combine(contrib, r.order, cfg.moe.top_k)
    want = jax.vmap(lambda t, u: jnp.zeros((16, cfg.d_model)).at[t].add(u))(
        jnp.asarray(r.token.numpy()), jnp.asarray(contrib.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def mla():
    jcfg = jax_smoke("deepseek-v2-lite-16b")
    cfg = get_smoke("deepseek-v2-lite-16b")
    jp, _ = jax_layers.mla_init(jax.random.key(4), jcfg)
    return jcfg, cfg, jp, _to_torch(jp), rope_freqs(
        cfg.mla.qk_rope_dim, cfg.rope_theta, CPU)


def _mla_cache(cfg, b, s):
    m = cfg.mla
    return (np.zeros((b, s, m.kv_lora_rank), np.float32),
            np.zeros((b, s, m.qk_rope_dim), np.float32))


def test_mla_prefill_and_training_within_tolerance(mla):
    """The expanded branch: whole-prompt prefill into a cache (the cache
    written too) and the training call without one."""
    jcfg, cfg, jp, p, freqs = mla
    x = np.random.default_rng(5).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jcache = tuple(jnp.asarray(c) for c in _mla_cache(cfg, 2, 16))
    jout, (jc, jr) = jax_layers.mla_attention(
        jp, jcfg, jnp.asarray(x), q_pos=jnp.arange(12), cache=jcache,
        cache_index=jnp.int32(0))
    cache = tuple(torch.from_numpy(c) for c in _mla_cache(cfg, 2, 16))
    out = mla_attention(p, cfg, freqs, torch.from_numpy(x), cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(cache[1].numpy(), np.asarray(jr), rtol=RTOL,
                               atol=ATOL)
    jtrain, _ = jax_layers.mla_attention(jp, jcfg, jnp.asarray(x),
                                         q_pos=jnp.arange(12))
    train = mla_attention(p, cfg, freqs, torch.from_numpy(x))
    np.testing.assert_allclose(train.numpy(), np.asarray(jtrain), rtol=RTOL,
                               atol=ATOL)


def test_mla_absorbed_decode_within_tolerance(mla):
    """The absorbed branch at position 9 over a cache holding 9 earlier
    positions (and garbage past the position, which the mask hides)."""
    jcfg, cfg, jp, p, freqs = mla
    rng = np.random.default_rng(6)
    cc, cr = _mla_cache(cfg, 2, 16)
    cc[:] = rng.standard_normal(cc.shape)
    cr[:] = rng.standard_normal(cr.shape)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, (jc, _) = jax_layers.mla_attention(
        jp, jcfg, jnp.asarray(x), q_pos=jnp.asarray([9]),
        cache=(jnp.asarray(cc), jnp.asarray(cr)), cache_index=jnp.int32(9))
    cache = (torch.from_numpy(cc.copy()), torch.from_numpy(cr.copy()))
    out = mla_attention(p, cfg, freqs, torch.from_numpy(x), cache=cache,
                        pos=9)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_prefill(name):
    """prefill(s) then decode(token) == prefill(s + 1) at the new
    position, capacity 16 (nothing drops), within the reference's 2e-3
    (its ``test_decode_matches_prefill``, here on the port)."""
    cfg = _with_capacity(get_smoke(name), 16.0)
    jcfg = _with_capacity(jax_smoke(name), 16.0)
    from repro.models import build_model as jax_build

    jparams, _ = jax_build(jcfg).init(jax.random.key(1))
    model = build_model(cfg, CPU)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    b, s = 2, 24
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, s)))
    logits, cache = model.prefill(params, toks, model.init_cache(b, s + 4))
    tok = torch.argmax(logits, -1)
    step = model.decode_step(params, cache, tok, s)
    full, _ = model.prefill(params, torch.cat([toks, tok[:, None]], 1),
                            model.init_cache(b, s + 4))
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_vmap_slot_loop_against_the_reference_and_scan():
    """The vmapped slot loop on deepseek-v2-lite's smoke config (MLA's
    absorbed decode at a position per row, the MoE layer routing each
    slot's token; dropless at decode): greedy tokens of a staggered
    3-request trace equal the reference's vmapped engine's exactly and
    the port's scan engine's, the telemetry within rtol 1e-5 of both (the
    batched tick rounds the plain matmuls per batch, not per row)."""
    from repro.kernels.schemes import Policy as JaxPolicy
    from repro.models import build_model as jax_build
    from repro.serve import EngineConfig as JaxEngineConfig
    from repro.serve import InferenceEngine as JaxEngine
    from repro.serve import Request as JaxRequest
    from repro.serve import SamplingParams as JaxSampling
    from repro_torch.kernels.schemes import Policy
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    name = "deepseek-v2-lite-16b"
    jcfg, cfg = jax_smoke(name), get_smoke(name)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    model = build_model(cfg, CPU)
    spec, arrivals = [(9, 5), (14, 4), (3, 6)], [0, 1, 3]
    serve = dict(max_slots=2, max_len=24, track_stats=True, prefill_chunk=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32)
               for p, _ in spec]

    def trace(request_cls, sampling_cls):
        return [request_cls(prompt=p, sampling=sampling_cls(max_new_tokens=n),
                            request_id=i)
                for i, (p, (_, n)) in enumerate(zip(prompts, spec))]

    jout = JaxEngine(jcfg, JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                           slot_loop="vmap", **serve),
                     model=jmodel, params=jparams).run(
        trace(JaxRequest, JaxSampling), arrivals)
    out = {loop: InferenceEngine(
        cfg, EngineConfig(policy=Policy(scheme="kahan"), slot_loop=loop,
                          **serve),
        model=model, params=params).run(trace(Request, SamplingParams),
                                        arrivals)
        for loop in ("vmap", "scan")}
    for rid, (_, new) in enumerate(spec):
        got = out["vmap"][rid]
        assert len(got.tokens) == new
        assert got.tokens == jout[rid].tokens == out["scan"][rid].tokens
        for want in (jout[rid].telemetry, out["scan"][rid].telemetry):
            np.testing.assert_allclose(got.telemetry, want, rtol=RTOL)
