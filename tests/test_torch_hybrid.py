"""The hybrid family (``HymbaLM``: parallel attention and selective-SSM
heads, sliding-window ring caches, global-attention layers) and
sliding-window attention, against the JAX reference, on the CPU. The
reference's weights come over through ``repro_torch.bridge`` with the
norm scales, the conv and dt biases and ``D`` drawn at random on both
sides (their constant inits would let a term dropped on one side pass
unseen).

Parity tiers, stated per test:

* tier 3 (tolerance against the reference): attention outputs, prefill
  and decode logits and every cache leaf within rtol = atol = 1e-5 (of
  the largest magnitude for the caches); greedy tokens EXACT and the
  telemetry within rtol 1e-5 on hymba's smoke config, dense and paged;
  ``loss`` within rtol 1e-6 and each gradient leaf within 2e-6 of its
  largest magnitude.
* tier 2 (bitwise within the port): paged == dense, solo ==
  interleaved, a prompt prefilled in chunks == one-shot where it wraps
  the ring mid-chunk; a ring filled by ``prefill`` == the ring the
  decode step fills position by position, on operands whose products are
  exact (see ``test_ring_prefill_equals_ring_decode``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.kernels.schemes import Policy as JaxPolicy
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.core import tree as T
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.common import cache_leaves
from repro_torch.models.hybrid import HymbaLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    Request,
    SamplingParams,
)

CPU = torch.device("cpu")
NAME = "hymba-1.5b"
RTOL = ATOL = 1e-5
#: (prompt_len, max_new_tokens) and arrival step of the staggered trace:
#: request 1's 21 + 3 positions wrap the smoke config's 16-row rings
SPEC = [(12, 4), (21, 3), (9, 5)]
ARRIVALS = [0, 1, 3]
SERVE = dict(max_slots=2, max_len=32, track_stats=True, prefill_chunk=4,
             page_size=4)


def _perturb(tree, rng):
    """Norm scales, ``D`` about 1 and the biases (``b``, ``conv_b``)
    shifted, at random (numpy leaves)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        node = np.asarray(node)
        noise = 0.1 * rng.standard_normal(node.shape)
        if path[-1] in ("scale", "D"):
            return (1.0 + noise).astype(node.dtype)
        if path[-1] in ("b", "conv_b"):
            return (node + noise).astype(node.dtype)
        return node

    return walk(tree, ())


def _pair(jcfg, cfg, seed=0):
    """A reference model and the port's over the same (perturbed)
    weights: (jmodel, jparams, model, params, numpy params)."""
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(seed))
    np_params = _perturb(jax.tree.map(np.asarray, jparams),
                         np.random.default_rng(7))
    return (jmodel, jax.tree.map(jnp.asarray, np_params),
            build_model(cfg, CPU), params_from_jax(np_params, cfg, CPU),
            np_params)


@pytest.fixture(scope="module")
def hymba():
    jmodel, jparams, model, params, np_params = _pair(jax_smoke(NAME),
                                                      get_smoke(NAME))
    return dict(jcfg=jax_smoke(NAME), cfg=get_smoke(NAME), jmodel=jmodel,
                jparams=jparams, model=model, params=params,
                np_params=np_params, runs={})


def _close(got, want, what=""):
    """Within RTOL of the largest magnitude of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


def _jax_cache_leaves(model, jcache):
    """The reference's cache leaves in the port's order (its singles get
    the port's layer axis of 1)."""
    out = []
    for seg in model.segments:
        c = jcache[seg.name]
        for leaf in (*c["kv"], *c["ssm"]):
            leaf = np.asarray(leaf)
            out.append(leaf if seg.scan else leaf[None])
    return out


# ---------------------------------------------------------------------------
# Configs, zoo and bridge
# ---------------------------------------------------------------------------

def test_zoo_builds_hymba_at_published_width():
    """``build_model`` returns the hybrid for an ``ssm`` config: hymba-1.5b
    at 32 layers, d 1600, 25 heads over 5, window 1024 with global layers
    {0, 15, 31} planned as the reference plans them; about 1.41 B
    parameters (spec only: nothing is allocated)."""
    cfg = get_config(NAME)
    model = build_model(cfg, torch.device("meta"))
    assert isinstance(model, HymbaLM) and not model.parallel_prefill_ok
    assert [(s.name, s.n_layers, s.window) for s in model.segments] == [
        ("global_0", 1, 0), ("swa_1_14", 14, 1024), ("global_15", 1, 0),
        ("swa_16_30", 15, 1024), ("global_31", 1, 0)]
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(np.prod(node[0]))

    assert 1.40e9 < count(model.param_spec()) < 1.42e9
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (1600, 25, 5, 64, 5504, 32001)
    assert cfg.ssm.d_state == 16 and cfg.ssm.chunk == 128


def test_params_match_the_reference_tree(hymba):
    """The bridge carries every leaf unchanged: the global singles
    without a layer axis, the window runs stacked, ``A_log`` and ``D``
    float32."""
    want = jax.tree.leaves(hymba["jparams"])
    got = T.leaves(hymba["params"])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert str(g.dtype)[6:] == np.asarray(w).dtype.name
    assert hymba["params"]["global_0"]["attn"]["q"]["w"].dim() == 3
    assert hymba["params"]["swa_1_2"]["attn"]["q"]["w"].shape[0] == 2
    bf16 = params_from_jax(jax.tree.map(np.asarray, jax_build(
        jax_smoke(NAME).replace(param_dtype="bfloat16")).init(
        jax.random.key(0))[0]), get_smoke(NAME).replace(
        param_dtype="bfloat16"), CPU)
    assert bf16["global_0"]["ssm"]["A_log"].dtype == torch.float32
    assert bf16["global_0"]["ssm"]["in_x"]["w"].dtype == torch.bfloat16


def test_bridge_refuses_a_wrong_tree(hymba):
    cfg = hymba["cfg"]
    tree = jax.tree.map(np.array, hymba["np_params"])
    del tree["swa_1_2"]["ssm"]["D"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, cfg, CPU)
    tree = jax.tree.map(np.array, hymba["np_params"])
    tree["global_3"]["ssm"]["A_log"] = tree["global_3"]["ssm"]["A_log"][:1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, cfg, CPU)
    tree = jax.tree.map(np.array, hymba["np_params"])
    tree["swa_1_2"]["ssm"]["A_log"] = tree["swa_1_2"]["ssm"][
        "A_log"].astype(np.float64)
    with pytest.raises(ValueError, match="dtype"):
        params_from_jax(tree, cfg, CPU)


# ---------------------------------------------------------------------------
# Sliding-window attention and ring caches (the attention layer alone)
# ---------------------------------------------------------------------------

def _attn_pair(cfg, seed):
    """One attention layer's reference parameters and statics and the
    port's."""
    jp, _ = JL.attn_init(jax.random.key(seed), jax_smoke(NAME))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    jst = JL.AttnStatic(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.rope_theta, cfg.qkv_bias, jnp.float32)
    st = L.AttnStatic(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      L.rope_freqs(cfg.head_dim, cfg.rope_theta, CPU),
                      torch.float32)
    return jp, jst, tp, st


def _kv(cfg, rows):
    shape = (1, rows, cfg.n_kv_heads, cfg.head_dim)
    return torch.zeros(shape), torch.zeros(shape)


def test_sliding_window_masks_distant_context():
    """Replay of the reference's ``test_sliding_window_masks_distant_
    context``: with window 4 the last position's output does not see
    position 0, position 1's does; and tier 3 against the reference's
    outputs."""
    cfg = get_smoke(NAME)
    jp, jst, tp, st = _attn_pair(cfg, 0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, cfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[0, 0] = 123.0
    w = 4
    outs = [L.attention(tp, st, torch.from_numpy(v), window=w)
            for v in (x, x2)]
    np.testing.assert_allclose(outs[0][0, -1], outs[1][0, -1], rtol=1e-5)
    assert not np.allclose(outs[0][0, 1], outs[1][0, 1], rtol=1e-5)
    for v, out in zip((x, x2), outs):
        want, _ = JL.attention(jp, jst, jnp.asarray(v),
                               q_pos=jnp.arange(32), window=w)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def test_ring_cache_decode_matches_full_cache():
    """Replay of the reference's ``test_ring_cache_decode_matches_full_
    cache``: a 24-token prefill then 4 decode steps through a ring of
    the window's 16 rows and through a full 32-row cache give the same
    outputs (rtol 1e-5, atol 1e-6, the reference's), each step within
    tier 3 of the reference's ring; both caches within tier 3 of the
    reference's after every step."""
    cfg = get_smoke(NAME)
    jp, jst, tp, st = _attn_pair(cfg, 3)
    rng = np.random.default_rng(0)
    w, s0 = cfg.sliding_window, 24
    x_hist = rng.standard_normal((1, s0, cfg.d_model)).astype(np.float32)
    jfull = (jnp.zeros((1, s0 + 8, cfg.n_kv_heads, cfg.head_dim)),) * 2
    jring = (jnp.zeros((1, w, cfg.n_kv_heads, cfg.head_dim)),) * 2
    _, jfull = JL.attention(jp, jst, jnp.asarray(x_hist),
                            q_pos=jnp.arange(s0), window=w, cache=jfull)
    _, jring = JL.attention(jp, jst, jnp.asarray(x_hist),
                            q_pos=jnp.arange(s0), window=w, cache=jring)
    full, ring = _kv(cfg, s0 + 8), _kv(cfg, w)
    L.attention(tp, st, torch.from_numpy(x_hist), cache=full, window=w)
    L.attention(tp, st, torch.from_numpy(x_hist), cache=ring, window=w)
    for step in range(4):
        xt = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
        pos = s0 + step
        out_f = L.attention(tp, st, torch.from_numpy(xt), cache=full,
                            pos=pos, window=w)
        out_r = L.attention(tp, st, torch.from_numpy(xt), cache=ring,
                            pos=pos, window=w)
        np.testing.assert_allclose(out_f.numpy(), out_r.numpy(), rtol=1e-5,
                                   atol=1e-6)
        jout, jring = JL.attention(jp, jst, jnp.asarray(xt),
                                   q_pos=jnp.asarray([pos]), window=w,
                                   cache=jring, cache_index=jnp.asarray(pos))
        _, jfull = JL.attention(jp, jst, jnp.asarray(xt),
                                q_pos=jnp.asarray([pos]), window=w,
                                cache=jfull, cache_index=jnp.asarray(pos))
        np.testing.assert_allclose(out_r.numpy(), np.asarray(jout),
                                   rtol=RTOL, atol=ATOL)
        for got, want in zip((*ring, *full), (*jring, *jfull)):
            _close(got.numpy(), want, f"cache after step {step}")


@pytest.mark.parametrize("seq", [5, 16, 37])
def test_ring_prefill_equals_ring_decode(seq):
    """Tier 2, the ring arithmetic: a ring filled by a whole-prompt
    prefill equals, bitwise, the ring the decode step fills position by
    position, and each row holds the last position congruent to it
    (rows no position reaches stay exact zeros) -- a prompt shorter than
    the window, one of exactly the window and one that wraps it twice.
    The weights and inputs are small integers, so every projection is
    exact whatever the matmul's order of summation (the CPU's product of
    ``[S, d]`` rows and of one row sum in different orders), and only the
    placement can differ."""
    cfg = get_smoke(NAME)
    st = L.AttnStatic(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      L.rope_freqs(cfg.head_dim, cfg.rope_theta, CPU),
                      torch.float32)
    g = torch.Generator().manual_seed(seq)
    shapes = L.attn_spec(cfg)
    p = {k: {"w": torch.randint(-2, 3, v["w"][0], generator=g).float()}
         for k, v in shapes.items()}
    x = torch.randint(-2, 3, (1, seq, cfg.d_model), generator=g).float()
    w = cfg.sliding_window
    by_prefill, by_decode, full = _kv(cfg, w), _kv(cfg, w), _kv(cfg, seq)
    L.attention(p, st, x, cache=by_prefill, window=w)
    L.attention(p, st, x, cache=full, window=w)
    for t in range(seq):
        L.attention(p, st, x[:, t:t + 1], cache=by_decode, pos=t, window=w)
    for a, b, f in zip(by_prefill, by_decode, full):
        assert torch.equal(a, b)
        for j in range(w):
            last = max((t for t in range(seq) if t % w == j), default=None)
            want = torch.zeros_like(a[:, j]) if last is None else f[:, last]
            assert torch.equal(a[:, j], want), j


def test_chunk_prefill_refuses_a_ring():
    cfg = get_smoke(NAME)
    _, _, tp, st = _attn_pair(cfg, 0)
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="ring-buffer"):
        L.attention(tp, st, x, cache=_kv(cfg, cfg.sliding_window), pos=0,
                    chunk_valid=4, window=cfg.sliding_window)


def test_windowed_transformer_keeps_full_caches():
    """A ``TransformerLM`` with ``sliding_window`` keeps full-length caches
    (``max_len`` rows, no ring) and masks by the window in prefill and in
    decode, as the reference does: tier 3 on the whole-prompt prefill,
    the scan chunk and the decode step after each, with a prompt past
    the window."""
    kw = dict(name="dense-swa", family="dense", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
              sliding_window=8, param_dtype="float32",
              compute_dtype="float32", loss_chunk=64)
    jmodel, jparams, model, params, _ = _pair(JaxArchConfig(**kw),
                                              ArchConfig(**kw))
    assert isinstance(model, TransformerLM) and not model.parallel_prefill_ok
    toks = np.random.default_rng(1).integers(0, 128, (1, 19)).astype(
        np.int32)
    t = torch.from_numpy(toks.astype(np.int64))
    n = toks.shape[1]
    cache = model.init_cache(1, 24)
    assert all(leaf.shape[2] == 24 for leaf in cache_leaves(cache))
    for fn in ("prefill", "prefill_chunk"):
        jcache, _ = jmodel.init_cache(1, 24)
        cache = model.init_cache(1, 24)
        if fn == "prefill":
            jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(
                toks)}, jcache)
            log, cache = model.prefill(params, t, cache)
        else:
            jlog, jcache = jmodel.prefill_chunk(
                jparams, {"tokens": jnp.asarray(toks)}, jcache,
                jnp.int32(0), jnp.int32(n))
            log, cache = model.prefill_chunk(params, t, cache, 0, n)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                                   atol=ATOL, err_msg=fn)
        jdec, _ = jmodel.decode_step(jparams, jcache,
                                     jnp.asarray([5], jnp.int32),
                                     jnp.int32(n))
        dec = model.decode_step(params, cache, torch.tensor([5]), n)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                                   atol=ATOL, err_msg=f"decode after {fn}")


# ---------------------------------------------------------------------------
# HymbaLM against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [12, 37])
def test_prefill_and_decode_within_tolerance(hymba, seq):
    """Tier 3: whole-prompt ``prefill`` (a prompt inside the window and
    one that wraps the rings twice) -- logits and every cache leaf: the
    global layers' K/V, the rings, the SSM state and conv window -- then
    two ``decode_step``s; and the scan chunk's logits and cache."""
    a = hymba
    model, jmodel, cfg = a["model"], a["jmodel"], a["cfg"]
    toks = np.random.default_rng(seq).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)
    t = torch.from_numpy(toks.astype(np.int64))
    jcache, _ = jmodel.init_cache(2, 48)
    jlog, jcache = jmodel.prefill(a["jparams"], {"tokens": jnp.asarray(
        toks)}, jcache)
    cache = model.init_cache(2, 48)
    log, cache = model.prefill(a["params"], t, cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(cache_leaves(cache),
                         _jax_cache_leaves(model, jcache)):
        assert got.shape == want.shape
        _close(got.numpy(), want, "prefill cache")
    for i, tok in enumerate(([7, 9], [3, 4])):
        pos = seq + i
        jdec, jcache = jmodel.decode_step(a["jparams"], jcache,
                                          jnp.asarray(tok, jnp.int32),
                                          jnp.int32(pos))
        dec = model.decode_step(a["params"], cache, torch.tensor(tok), pos)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                                   atol=ATOL, err_msg=f"decode at {pos}")
    for got, want in zip(cache_leaves(cache),
                         _jax_cache_leaves(model, jcache)):
        _close(got.numpy(), want, "cache after decode")
    jcache, _ = jmodel.init_cache(1, 48)
    jlog, jcache = jmodel.prefill_chunk(a["jparams"], {"tokens": jnp.asarray(
        toks[:1])}, jcache, jnp.int32(0), jnp.int32(seq))
    cache = model.init_cache(1, 48)
    log, cache = model.prefill_chunk(a["params"], t[:1], cache, 0, seq)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL, err_msg="scan chunk")
    for got, want in zip(cache_leaves(cache),
                         _jax_cache_leaves(model, jcache)):
        _close(got.numpy(), want, "scan chunk cache")


def test_decode_matches_prefill(hymba):
    """The port's own case of the reference's ``test_decode_matches_
    prefill`` for hymba (its tolerance, rtol = atol = 2e-3): prefill(s) +
    decode(token) against prefill(s + 1), at s = 24 past the window."""
    model, params, cfg = hymba["model"], hymba["params"], hymba["cfg"]
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


def test_loss_and_grads_within_tolerance(hymba, monkeypatch):
    """Tier 3: the training loss (float32) within rtol 1e-6, and every
    gradient leaf within 2e-6 of its largest magnitude, the gradients
    taken with float64 params and compute on both sides (jax's x64 mode)
    and every float32 cast of the model widened to float64 as well (the
    reference's model modules see ``jnp.float32`` as float64, the port's
    ``Tensor.float`` returns float64). Over six weight and batch seeds
    (``scripts/hybrid_grad_parity.py``, seed 0 this test's) the two
    sides' gradients part by 2.0e-6 to 4.2e-6 in float32, by 1.4e-6 to
    4.0e-6 in float64 compute with the casts kept (the norms, attention's
    softmax, the SSM and the loss round to float32 on both sides, and the
    SSM's ``A_log``, ``x_proj`` and ``dt_proj`` gradients sum many terms of
    both signs), and by 0.9e-7 to 3.2e-7 with the casts widened: the
    rounding of those casts, not the model, makes the gap, so the
    gradients are held where it is gone."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import SyntheticLM as JaxSyntheticLM
    from repro.models import common, hybrid, layers, ssm
    from repro_torch.train.trainer import batch_to_device

    a = hymba
    cfg = a["cfg"]
    batch = JaxSyntheticLM(JaxDataConfig(
        vocab_size=cfg.vocab_size, seq_len=40, global_batch=2)).batch_at(0)
    jloss, jmet = jax.jit(a["jmodel"].loss)(a["jparams"],
                                            jax.tree.map(jnp.asarray, batch))
    loss, met = a["model"].loss(a["params"], batch_to_device(batch, CPU))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 80

    kw = dict(param_dtype="float64", compute_dtype="float64")
    with jax.enable_x64(True):
        jmodel = jax_build(a["jcfg"].replace(**kw))
        jparams, _ = jmodel.init(jax.random.key(0))
        np_params = _perturb(jax.tree.map(np.asarray, jparams),
                             np.random.default_rng(7))
        wcfg = cfg.replace(**kw)
        params = T.tree_map(lambda p: p.requires_grad_(),
                            params_from_jax(np_params, wcfg, CPU))

        class Wide:
            def __getattr__(self, name):
                return (jnp.float64 if name == "float32"
                        else getattr(jnp, name))

        for module in (common, hybrid, layers, ssm):
            monkeypatch.setattr(module, "jnp", Wide())
        monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
        _, jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
            jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, batch))
        loss, _ = build_model(wcfg, CPU).loss(params,
                                              batch_to_device(batch, CPU))
        grads = torch.autograd.grad(loss, T.leaves(params))
        monkeypatch.undo()
    assert loss.dtype == torch.float64
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(jgrads), grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _trace(cfg, request_cls, sampling_cls, spec=SPEC, seed=0):
    rng = np.random.default_rng(seed)
    return [request_cls(
        prompt=rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32),
        sampling=sampling_cls(max_new_tokens=new), request_id=i)
        for i, (plen, new) in enumerate(spec)]


def _serve(hymba, layout):
    """The trace on the reference engine (dense) and on the port's under
    ``layout`` (cached): (reference handles, port handles, port engine)."""
    runs = hymba["runs"]
    if "reference" not in runs:
        runs["reference"] = JaxEngine(
            hymba["jcfg"], JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                           **SERVE),
            model=hymba["jmodel"], params=hymba["jparams"]).run(
            _trace(hymba["jcfg"], JaxRequest, JaxSampling), ARRIVALS)
    if layout not in runs:
        engine = InferenceEngine(
            hymba["cfg"], EngineConfig(policy=Policy(scheme="kahan"),
                                       kv_layout=layout,
                                       prefill_mode="flash", **SERVE),
            model=hymba["model"], params=hymba["params"])
        out = engine.run(_trace(hymba["cfg"], Request, SamplingParams),
                         ARRIVALS)
        runs[layout] = (out, engine)
    return (runs["reference"], *runs[layout])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_tokens_exact_vs_reference(hymba, layout):
    """Tier 3: greedy tokens of the staggered trace equal the reference
    engine's exactly, under both of the port's layouts, the telemetry
    within rtol 1e-5; flash is asked for and the scan body is served."""
    jout, out, engine = _serve(hymba, layout)
    assert engine.kv_layout == layout and engine.prefill_body == "scan"
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens, rid
        np.testing.assert_allclose(out[rid].telemetry, jout[rid].telemetry,
                                   rtol=RTOL)


def test_vmap_slot_loop_against_the_reference_and_scan(hymba):
    """The vmapped slot loop (dense) on the trace whose request 1 wraps
    the rings: greedy tokens equal the reference's vmapped engine's
    exactly and the port's scan engine's, the telemetry within rtol 1e-5
    of both (the batched tick rounds the plain matmuls of the SSM and
    the attention core per batch, not per row)."""
    jout = JaxEngine(
        hymba["jcfg"], JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                       slot_loop="vmap", **SERVE),
        model=hymba["jmodel"], params=hymba["jparams"]).run(
        _trace(hymba["jcfg"], JaxRequest, JaxSampling), ARRIVALS)
    _, scan, _ = _serve(hymba, "dense")
    out = InferenceEngine(
        hymba["cfg"], EngineConfig(policy=Policy(scheme="kahan"),
                                   slot_loop="vmap", **SERVE),
        model=hymba["model"], params=hymba["params"]).run(
        _trace(hymba["cfg"], Request, SamplingParams), ARRIVALS)
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens == scan[rid].tokens, rid
        for want in (jout[rid].telemetry, scan[rid].telemetry):
            np.testing.assert_allclose(out[rid].telemetry, want, rtol=RTOL)


def test_paged_pages_global_layers_only_bitwise(hymba):
    """Tier 2: under the paged layout the global layers' K/V page, the
    rings and the SSM state keep dense slot rows; tokens and telemetry
    equal the dense run's bitwise and the pool is free at the end."""
    _, dense, _ = _serve(hymba, "dense")
    _, paged, engine = _serve(hymba, "paged")
    axes = {seg: [leaf for leaf in cache_leaves(engine.slots.page_axes[seg])]
            for seg in engine.slots.page_axes}
    assert axes["global_0"] == [2, 2, -1, -1]
    assert axes["swa_1_2"] == [-1, -1, -1, -1]
    for rid in range(len(SPEC)):
        assert paged[rid].tokens == dense[rid].tokens
        assert paged[rid].telemetry == dense[rid].telemetry
    assert engine.pages.free_count == engine.num_pages


def test_solo_equals_interleaved(hymba):
    """Tier 2: request 1 (its 24 positions wrap the rings) served alone
    emits bitwise the tokens and telemetry it emitted interleaved."""
    _, dense, _ = _serve(hymba, "dense")
    req = _trace(hymba["cfg"], Request, SamplingParams)[1]
    solo = InferenceEngine(
        hymba["cfg"], EngineConfig(policy=Policy(scheme="kahan"), **SERVE),
        model=hymba["model"], params=hymba["params"]).run([req])[1]
    assert solo.tokens == dense[1].tokens
    assert solo.telemetry == dense[1].telemetry


def _tiny_hybrid(**kw):
    base = dict(name="tiny-hybrid", family="hybrid", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                sliding_window=8, global_attn_layers=(0,),
                ssm=SSMConfig(d_state=4, d_conv=2), param_dtype="float32",
                compute_dtype="float32", loss_chunk=64)
    base.update(kw)
    cfg = ArchConfig(**base)
    model = build_model(cfg, CPU)
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def test_hybrid_ring_and_ssm_state_bitwise():
    """Tier 2, the replay of the reference's ``test_hybrid_ring_and_ssm_
    state_bitwise``: the slot cache carries ring K/V and SSM state; every
    request alone == interleaved, and chunked prefill (4 tokens a chunk,
    one chunk a step) == one-shot, bitwise, where the 9-token prompt
    wraps the window-8 ring mid-chunk."""
    cfg, model, params = _tiny_hybrid()
    pol = Policy(scheme="kahan", unroll=2)
    reqs = _trace(cfg, Request, SamplingParams, [(4, 3), (9, 2), (3, 3)],
                  seed=2)
    ec = EngineConfig(max_slots=2, max_len=16, track_stats=True,
                      policy=pol, prefill_chunk=None)
    served = InferenceEngine(cfg, ec, model=model, params=params).run(
        reqs, [0, 1, 2])
    for req in reqs:
        solo = InferenceEngine(cfg, ec, model=model, params=params).run(
            [req])[req.request_id]
        assert solo.tokens == served[req.request_id].tokens
        assert solo.telemetry == served[req.request_id].telemetry
    chunked = InferenceEngine(
        cfg, EngineConfig(max_slots=2, max_len=16, track_stats=True,
                          policy=pol, prefill_chunk=4, prefill_budget=1),
        model=model, params=params).run(reqs, [0, 1, 2])
    for req in reqs:
        rid = req.request_id
        assert chunked[rid].tokens == served[rid].tokens
        assert chunked[rid].telemetry == served[rid].telemetry


def test_all_window_hybrid_falls_back_dense():
    """Replay of the reference's ``test_recurrent_families_fall_back_
    dense`` (its hybrid case: every layer windowed, no global layer): the
    paged layout resolves to dense, reported, and ``page_stats`` raises
    naming it; the reference engine resolves the same."""
    kw = dict(name="hyb", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=128, sliding_window=8,
              global_attn_layers=(), param_dtype="float32",
              compute_dtype="float32", loss_chunk=64)
    cfg, model, params = _tiny_hybrid(**kw, ssm=SSMConfig(d_state=4,
                                                          d_conv=2))
    paged = dict(max_slots=2, max_len=16, kv_layout="paged", page_size=4)
    eng = InferenceEngine(cfg, EngineConfig(**paged), model=model,
                          params=params)
    assert eng.kv_layout == "dense" and eng.pages is None
    with pytest.raises(RuntimeError, match="dense"):
        eng.page_stats()
    jcfg = JaxArchConfig(**kw, ssm=JaxSSMConfig(d_state=4, d_conv=2))
    jmodel = jax_build(jcfg)
    jeng = JaxEngine(jcfg, JaxEngineConfig(**paged), model=jmodel,
                     params=jmodel.init(jax.random.key(0))[0])
    assert jeng.kv_layout == eng.kv_layout
    req = _trace(cfg, Request, SamplingParams, [(9, 3)])
    assert len(eng.run(req)[0].tokens) == 3


def test_mixed_hybrid_pages_global_layers_only():
    """Tier 2, the replay of the reference's ``test_mixed_hybrid_pages_
    global_layers_only``: one global layer pages, the ring and SSM leaves
    stay dense, and the paged run equals the dense one bitwise."""
    cfg, model, params = _tiny_hybrid(name="hyb-mix")
    reqs = _trace(cfg, Request, SamplingParams, [(9, 2), (4, 3)], seed=59)
    ec = dict(max_slots=2, max_len=16, track_stats=True, prefill_chunk=4)
    dense = InferenceEngine(cfg, EngineConfig(**ec), model=model,
                            params=params).run(reqs, [0, 1])
    eng = InferenceEngine(cfg, EngineConfig(**ec, kv_layout="paged",
                                            page_size=4),
                          model=model, params=params)
    paged = eng.run(reqs, [0, 1])
    assert eng.kv_layout == "paged"
    assert cache_leaves(eng.slots.page_axes) == [2, 2, -1, -1,
                                                 -1, -1, -1, -1]
    for rid in dense:
        assert paged[rid].tokens == dense[rid].tokens
        assert paged[rid].telemetry == dense[rid].telemetry


def test_prefix_cache_refused_with_recurrent_state(hymba):
    """The reference shares prompt pages of a hybrid through its prefix
    cache and then serves other tokens than without it (hymba's smoke
    config, two requests sharing two full pages: request 1's tokens
    differ from its second on, ``scripts/hymba_prefix_reference.py``): a
    hit resumes past positions whose ring rows and SSM state the request
    never computed. The port refuses the prefix cache for any model with
    state that does not page, all-window ones included."""
    paged = dict(max_slots=2, max_len=32, kv_layout="paged", page_size=4,
                 prefix_cache=True)
    with pytest.raises(ValueError, match="prefix_cache"):
        InferenceEngine(hymba["cfg"], EngineConfig(**paged),
                        model=hymba["model"], params=hymba["params"])
    cfg, model, params = _tiny_hybrid(global_attn_layers=())
    with pytest.raises(ValueError, match="prefix_cache"):
        InferenceEngine(cfg, EngineConfig(**paged), model=model,
                        params=params)


def test_launcher_serves_hymba_on_cpu(capsys):
    """``launch/serve.py --arch hymba-1.5b`` (smoke, paged, flash asked
    for): the scan body and the paged layout are served and reported."""
    from repro_torch.launch import serve

    serve.main(["--arch", NAME, "--smoke", "--device", "cpu", "--trace",
                "0:20:3,1:9:2", "--kv-layout", "paged", "--prefill-mode",
                "flash", "--stats"])
    out = capsys.readouterr().out
    assert "runs the 'scan' body" in out
    assert "kv-layout=paged" in out
    assert "request 0 (arrived t=0, prompt=20, new=3" in out
    assert "|logits|^2 (kahan)" in out
