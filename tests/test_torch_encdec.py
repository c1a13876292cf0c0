"""The encoder-decoder family (``EncDecLM``: a non-causal encoder over
precomputed frames, a decoder with causal self-attention, cached
cross-attention and the GELU MLP) against the JAX reference, on the CPU,
at whisper-large-v3's smoke config (2 + 2 layers, d 64, 24 frames,
float32). The reference's weights come over through
``repro_torch.bridge``, with the norms' scale and bias drawn at random on
both sides.

Parity tiers, stated per test:

* tier 3 (tolerance against the reference): the encoder's output, the
  cross K/V, logits and the self-attention K/V within rtol = atol = 1e-5
  (of the largest magnitude for caches); ``loss`` within rtol 1e-6 and
  each gradient leaf within 2e-6 of its largest magnitude; the GELU MLP's
  activation within 1e-6 of ``jax.nn.gelu``; greedy engine tokens EXACT
  and the telemetry within rtol 1e-5, under the dense and the paged
  layout.
* tier 2 (bitwise within the port): paged == dense, solo ==
  interleaved, ``prefill`` and the chunked path write the same cross K/V
  through one ``prefill_begin``.
* tier 1 (bitwise against the reference): the synthetic batches' frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.kernels.schemes import Policy as JaxPolicy
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ArchConfig, EncoderConfig
from repro_torch.core import tree as T
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.common import cache_leaves
from repro_torch.models.encdec import EncDecLM
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    Request,
    SamplingParams,
)
from repro_torch.train.trainer import batch_to_device

CPU = torch.device("cpu")
NAME = "whisper-large-v3"
RTOL = ATOL = 1e-5
#: (prompt_len, max_new_tokens) and arrival step of the staggered trace
SPEC = [(12, 4), (17, 3), (9, 5)]
ARRIVALS = [0, 1, 3]
SERVE = dict(max_slots=2, max_len=24, track_stats=True, prefill_chunk=4,
             page_size=4)


def _perturb(tree, rng):
    """The norms' scale and bias at random (numpy leaves)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        node = np.asarray(node)
        if path[-1] in ("scale", "bias", "b"):
            base = 1.0 if path[-1] == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(node.shape)).astype(
                node.dtype)
        return node

    return walk(tree, ())


@pytest.fixture(scope="module")
def wh():
    jcfg, cfg = jax_smoke(NAME), get_smoke(NAME)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    np_params = _perturb(jax.tree.map(np.asarray, jparams),
                         np.random.default_rng(7))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel,
                jparams=jax.tree.map(jnp.asarray, np_params),
                model=build_model(cfg, CPU),
                params=params_from_jax(np_params, cfg, CPU),
                np_params=np_params, runs={})


def _close(got, want, what=""):
    """Within RTOL of the largest magnitude of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


def _frames(cfg, rng, b=1):
    return rng.standard_normal((b, cfg.encoder.n_frames,
                                cfg.d_model)).astype(np.float32)


def _jax_cache_leaves(jcache):
    return [np.asarray(leaf) for leaf in (*jcache["kv"], jcache["xk"],
                                          jcache["xv"])]


# ---------------------------------------------------------------------------
# Config, zoo, bridge, layers
# ---------------------------------------------------------------------------

def test_zoo_builds_whisper_at_published_width():
    """``build_model`` returns ``EncDecLM`` for an ``encoder`` config:
    whisper-large-v3 at 32 encoder and 32 decoder layers, d 1280, 20
    heads of 64, d_ff 5120 GELU, 1500 frames; 1,604,733,440 parameters
    (spec only: nothing is allocated)."""
    cfg = get_config(NAME)
    model = build_model(cfg, torch.device("meta"))
    assert isinstance(model, EncDecLM) and model.parallel_prefill_ok
    assert (cfg.encoder.n_layers, cfg.n_layers, cfg.encoder.n_frames) == (
        32, 32, 1500)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.mlp) == (1280, 20, 20, 64, 5120, "gelu")

    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(np.prod(node[0]))

    assert count(model.param_spec()) == 1_604_733_440


def test_params_match_the_reference_tree(wh):
    """The bridge carries every leaf unchanged: the stacked encoder and
    decoder (``xattn`` and ``ln_x`` included), the GELU MLP's up and down
    only."""
    want = jax.tree.leaves(wh["jparams"])
    got = T.leaves(wh["params"])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dec = wh["params"]["decoder"]
    assert sorted(dec) == ["attn", "ln1", "ln2", "ln_x", "mlp", "xattn"]
    assert sorted(dec["mlp"]) == ["down", "up"]
    assert wh["params"]["encoder"]["attn"]["q"]["w"].shape[0] == 2
    bad = jax.tree.map(np.array, wh["np_params"])
    del bad["decoder"]["ln_x"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, wh["cfg"], CPU)


def test_gelu_mlp_against_the_reference(wh):
    """The GELU is the tanh form, ``jax.nn.gelu``'s default, within 1e-6
    (torch's default is the erf form, which differs by up to 5e-4 here);
    the whole MLP within tier 3."""
    x = np.linspace(-6.0, 6.0, 4001).astype(np.float32)
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4
    cfg = wh["cfg"]
    p = {k: {"w": v["w"][0]}
         for k, v in wh["params"]["encoder"]["mlp"].items()}
    jp = jax.tree.map(lambda a: a[0], wh["jparams"]["encoder"]["mlp"])
    h = np.random.default_rng(1).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    out = L.mlp_apply(p, torch.from_numpy(h), torch.float32)
    _close(out.numpy(), JL.mlp_apply(jp, wh["jcfg"], jnp.asarray(h)))


def test_cross_attention_takes_no_rope_and_no_mask(wh):
    """Cross-attention (``cross_kv``) within tier 3 of the reference's:
    queries without RoPE against every row of the given K/V; and the
    non-causal encoder attention against the reference's ``causal=False``."""
    cfg = wh["cfg"]
    jp, _ = JL.attn_init(jax.random.key(3), wh["jcfg"])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    jst = JL.AttnStatic(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.rope_theta, False, jnp.float32)
    st = L.AttnStatic(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      L.rope_freqs(cfg.head_dim, cfg.rope_theta, CPU),
                      torch.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    got = L.attention(tp, st, torch.from_numpy(x),
                      cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    want, _ = JL.attention(jp, jst, jnp.asarray(x), q_pos=jnp.arange(5),
                           cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    _close(got.numpy(), want, "cross")
    got = L.attention(tp, st, torch.from_numpy(x), causal=False)
    want, _ = JL.attention(jp, jst, jnp.asarray(x), q_pos=jnp.arange(5),
                           causal=False)
    _close(got.numpy(), want, "non-causal")


# ---------------------------------------------------------------------------
# EncDecLM against the reference
# ---------------------------------------------------------------------------

def test_encode_and_prefill_begin_within_tolerance(wh):
    """Tier 3: the encoder's output, and every layer's cross K/V that
    ``prefill_begin`` writes."""
    model, jmodel, cfg = wh["model"], wh["jmodel"], wh["cfg"]
    frames = _frames(cfg, np.random.default_rng(4), b=2)
    enc = model.encode(wh["params"], torch.from_numpy(frames))
    _close(enc.numpy(), jmodel.encode(wh["jparams"], jnp.asarray(frames)),
           "encode")
    jcache, _ = jmodel.init_cache(2, 16)
    jcache = jmodel.prefill_begin(
        wh["jparams"], {"frames": jnp.asarray(frames)}, jcache)
    cache = model.prefill_begin(wh["params"], model.init_cache(2, 16),
                                torch.from_numpy(frames))
    for name in ("xk", "xv"):
        _close(cache[name].numpy(), jcache[name], name)
    assert not cache["kv"][0].any()


def test_prefill_and_decode_within_tolerance(wh):
    """Tier 3: whole-prompt ``prefill`` -- logits and every cache leaf --
    then two ``decode_step``s; and the scan and parallel chunk bodies
    over a ``prefill_begin``-filled cache, each with the decode step
    after it."""
    a = wh
    model, jmodel, cfg = a["model"], a["jmodel"], a["cfg"]
    rng = np.random.default_rng(5)
    frames = _frames(cfg, rng, b=2)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    t = torch.from_numpy(toks.astype(np.int64))
    n = toks.shape[1]
    jcache, _ = jmodel.init_cache(2, 20)
    jlog, jcache = jmodel.prefill(a["jparams"], {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, jcache)
    log, cache = model.prefill(a["params"], t, model.init_cache(2, 20),
                               torch.from_numpy(frames))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(cache_leaves(cache), _jax_cache_leaves(jcache)):
        assert got.shape == want.shape
        _close(got.numpy(), want, "prefill cache")
    for i, tok in enumerate(([7, 9], [3, 4])):
        jdec, jcache = jmodel.decode_step(a["jparams"], jcache,
                                          jnp.asarray(tok, jnp.int32),
                                          jnp.int32(n + i))
        dec = model.decode_step(a["params"], cache, torch.tensor(tok), n + i)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                                   atol=ATOL, err_msg=f"decode {i}")
    jb = {"tokens": jnp.asarray(toks[:1]), "frames": jnp.asarray(frames[:1])}
    for body in ("prefill_chunk", "prefill_chunk_parallel"):
        jcache, _ = jmodel.init_cache(1, 20)
        jcache = jmodel.prefill_begin(a["jparams"], jb, jcache)
        jlog, jcache = getattr(jmodel, body)(a["jparams"], jb, jcache,
                                             jnp.int32(0), jnp.int32(n))
        cache = model.prefill_begin(a["params"], model.init_cache(1, 20),
                                    torch.from_numpy(frames[:1]))
        log, cache = getattr(model, body)(a["params"], t[:1], cache, 0, n)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                                   atol=ATOL, err_msg=body)
        jdec, _ = jmodel.decode_step(a["jparams"], jcache,
                                     jnp.asarray([5], jnp.int32),
                                     jnp.int32(n))
        dec = model.decode_step(a["params"], cache, torch.tensor([5]), n)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                                   atol=ATOL, err_msg=f"decode after {body}")


def test_prefill_and_the_chunked_path_share_one_prefill_begin(wh):
    """Tier 2: ``prefill`` writes bitwise the cross K/V that
    ``prefill_begin`` alone writes (it runs that setup, then reads the
    cache), and the chunked path after ``prefill_begin`` reaches
    ``prefill``'s logits within tier 3."""
    model, params, cfg = wh["model"], wh["params"], wh["cfg"]
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(_frames(cfg, rng))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 9)))
    log, whole = model.prefill(params, toks, model.init_cache(1, 16), frames)
    cache = model.prefill_begin(params, model.init_cache(1, 16), frames)
    for name in ("xk", "xv"):
        assert torch.equal(whole[name], cache[name])
    clog, _ = model.prefill_chunk(params, toks[:, :4], cache, 0, 4)
    clog, _ = model.prefill_chunk(params, toks[:, 4:], cache, 4, 5)
    np.testing.assert_allclose(clog.numpy(), log.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_scan_and_parallel_chunk_bodies_agree():
    """The port's case of the reference's ``test_parallel_chunk_body_vlm_
    and_encdec_match_scan`` (its tolerance, rtol = atol = 1e-5): a tiny
    encoder-decoder with ``kahan_attention`` (the self-attention's chunks
    through the chunk flash kernel's plain version on the CPU) over the
    chunks (4, 4), (4, 3), parallel against scan."""
    cfg = ArchConfig(name="tiny-encdec-flash", family="encdec", n_layers=2,
                     d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                     vocab_size=128, mlp="gelu",
                     encoder=EncoderConfig(n_layers=1, n_frames=6),
                     kahan_attention=True, param_dtype="float32",
                     compute_dtype="float32", loss_chunk=64)
    model = build_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(7))
    rng = np.random.default_rng(53)
    prompt = torch.from_numpy(rng.integers(0, 128, (7,)))
    frames = torch.from_numpy(rng.standard_normal((1, 6, 32)).astype(
        np.float32))
    out = {}
    for body in ("prefill_chunk", "prefill_chunk_parallel"):
        cache = model.prefill_begin(params, model.init_cache(1, 16), frames)
        off = 0
        for width, nvalid in ((4, 4), (4, 3)):
            toks = torch.zeros((1, width), dtype=torch.long)
            toks[0, :nvalid] = prompt[off:off + nvalid]
            logits, cache = getattr(model, body)(params, toks, cache, off,
                                                 nvalid)
            off += nvalid
        out[body] = logits
    np.testing.assert_allclose(out["prefill_chunk_parallel"].numpy(),
                               out["prefill_chunk"].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_loss_and_grads_within_tolerance(wh):
    """Tier 3: the training loss within rtol 1e-6 and every gradient leaf
    (the encoder's through the cross K/V) within 2e-6 of its largest
    magnitude."""
    a = wh
    cfg = a["cfg"]
    batch = JaxSyntheticLM(JaxDataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
        n_frames=cfg.encoder.n_frames, d_model=cfg.d_model)).batch_at(0)
    assert batch["frames"].shape == (2, cfg.encoder.n_frames, cfg.d_model)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        a["jmodel"].loss, has_aux=True))(a["jparams"],
                                         jax.tree.map(jnp.asarray, batch))
    params = T.tree_map(lambda p: p.detach().clone().requires_grad_(),
                        a["params"])
    loss, met = a["model"].loss(params, batch_to_device(batch, CPU))
    grads = torch.autograd.grad(loss, T.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 32
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(jgrads), grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("step", [0, 2])
def test_frame_batches_bitwise(step):
    """Tier 1: the synthetic batches of an encoder-decoder config (frames
    drawn after the tokens) equal the reference's bit for bit."""
    kw = dict(vocab_size=512, seq_len=16, global_batch=3, n_frames=24,
              d_model=64)
    want = JaxSyntheticLM(JaxDataConfig(**kw)).batch_at(step)
    got = SyntheticLM(DataConfig(**kw)).batch_at(step)
    assert sorted(got) == sorted(want) and "frames" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _trace(cfg, request_cls, sampling_cls, spec=SPEC, seed=0):
    """Requests with frames drawn before each prompt, as the launchers
    draw them."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (plen, new) in enumerate(spec):
        frames = _frames(cfg, rng)[0]
        out.append(request_cls(
            prompt=rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32),
            sampling=sampling_cls(max_new_tokens=new), request_id=i,
            extras={"frames": frames}))
    return out


def _serve(wh, layout, mode="flash"):
    """The trace on the reference engine (dense, flash) and on the
    port's under ``layout`` and ``mode`` (cached): (reference handles,
    port handles, port engine)."""
    runs = wh["runs"]
    if "reference" not in runs:
        runs["reference"] = JaxEngine(
            wh["jcfg"], JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                        prefill_mode="flash", **SERVE),
            model=wh["jmodel"], params=wh["jparams"]).run(
            _trace(wh["jcfg"], JaxRequest, JaxSampling), ARRIVALS)
    key = (layout, mode)
    if key not in runs:
        engine = InferenceEngine(
            wh["cfg"], EngineConfig(policy=Policy(scheme="kahan"),
                                    kv_layout=layout, prefill_mode=mode,
                                    **SERVE),
            model=wh["model"], params=wh["params"])
        out = engine.run(_trace(wh["cfg"], Request, SamplingParams),
                         ARRIVALS)
        runs[key] = (out, engine)
    return (runs["reference"], *runs[key])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_tokens_exact_vs_reference(wh, layout):
    """Tier 3: greedy tokens of the staggered trace (each request with
    its frames) equal the reference engine's exactly under both of the
    port's layouts, the telemetry within rtol 1e-5; the flash body is
    served."""
    jout, out, engine = _serve(wh, layout)
    assert engine.kv_layout == layout and engine.prefill_body == "flash"
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens, rid
        np.testing.assert_allclose(out[rid].telemetry, jout[rid].telemetry,
                                   rtol=RTOL)


def test_vmap_slot_loop_against_the_reference_and_scan(wh):
    """The vmapped slot loop (dense, flash prefill; each request's cross
    K/V row filled by its first chunk): greedy tokens equal the
    reference's vmapped engine's exactly and the port's scan engine's,
    the telemetry within rtol 1e-5 of both."""
    jout = JaxEngine(
        wh["jcfg"], JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                    prefill_mode="flash", slot_loop="vmap",
                                    **SERVE),
        model=wh["jmodel"], params=wh["jparams"]).run(
        _trace(wh["jcfg"], JaxRequest, JaxSampling), ARRIVALS)
    _, scan, _ = _serve(wh, "dense")
    out = InferenceEngine(
        wh["cfg"], EngineConfig(policy=Policy(scheme="kahan"),
                                prefill_mode="flash", slot_loop="vmap",
                                **SERVE),
        model=wh["model"], params=wh["params"]).run(
        _trace(wh["cfg"], Request, SamplingParams), ARRIVALS)
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens == scan[rid].tokens, rid
        for want in (jout[rid].telemetry, scan[rid].telemetry):
            np.testing.assert_allclose(out[rid].telemetry, want, rtol=RTOL)


def test_paged_pages_only_self_attention_bitwise(wh):
    """Tier 2: under the paged layout only the self-attention K/V page
    (the cross K/V keep dense slot rows); tokens and telemetry equal the
    dense run's bitwise, and the pool is free at the end. The scan body
    gives the flash body's tokens."""
    _, dense, _ = _serve(wh, "dense")
    _, paged, engine = _serve(wh, "paged")
    assert cache_leaves(engine.slots.page_axes) == [2, 2, -1, -1]
    assert engine.slots.cache["xk"].shape[1] == SERVE["max_slots"]
    for rid in range(len(SPEC)):
        assert paged[rid].tokens == dense[rid].tokens
        assert paged[rid].telemetry == dense[rid].telemetry
    assert engine.pages.free_count == engine.num_pages
    _, scan, _ = _serve(wh, "dense", "scan")
    for rid in range(len(SPEC)):
        assert scan[rid].tokens == dense[rid].tokens


def test_solo_equals_interleaved(wh):
    """Tier 2: each request served alone emits bitwise the tokens and
    telemetry it emitted interleaved (its frames encoded in its own
    first chunk, its cross K/V in its own slot)."""
    _, dense, _ = _serve(wh, "dense")
    ec = EngineConfig(policy=Policy(scheme="kahan"), prefill_mode="flash",
                      **SERVE)
    for req in _trace(wh["cfg"], Request, SamplingParams):
        solo = InferenceEngine(wh["cfg"], ec, model=wh["model"],
                               params=wh["params"]).run([req])
        assert solo[req.request_id].tokens == dense[req.request_id].tokens
        assert solo[req.request_id].telemetry == (
            dense[req.request_id].telemetry)


def test_frames_are_checked_at_submit(wh):
    """Frames of the wrong shape, missing frames and extras the model
    does not take raise at ``submit``."""
    cfg = wh["cfg"]
    engine = InferenceEngine(cfg, EngineConfig(max_slots=1, max_len=24),
                             model=wh["model"], params=wh["params"])
    f = cfg.encoder.n_frames
    for extras, match in (
            ({"frames": np.zeros((f - 1, cfg.d_model), np.float32)},
             "frames of shape"),
            ({"frames": np.zeros((1, f, cfg.d_model), np.float32)},
             "frames of shape"),
            (None, "needs 'frames'"),
            ({"frames": np.zeros((f, cfg.d_model), np.float32),
              "vision_embeds": np.zeros((4, cfg.d_model), np.float32)},
             "not taken")):
        with pytest.raises(ValueError, match=match):
            engine.submit(Request(prompt=[1, 2, 3], extras=extras))
    assert not engine.handles


def test_frames_requests_never_share_a_prefix(wh):
    """Two requests with the same prompt and the same frames on a paged
    engine with the prefix cache: no page is adopted by the tree and no
    position is admitted by reference (the cross K/V condition every
    position; the reference excludes ``prefill_begin`` families too), and
    the second request's tokens equal a private run's."""
    cfg = wh["cfg"]
    req = _trace(cfg, Request, SamplingParams, [(12, 3)], seed=3)[0]
    twin = Request(prompt=req.prompt, sampling=req.sampling, request_id=1,
                   extras=req.extras)
    kw = dict(policy=Policy(scheme="kahan"), max_slots=2, max_len=24,
              prefill_chunk=4, kv_layout="paged", page_size=4,
              track_stats=True)
    engine = InferenceEngine(cfg, EngineConfig(prefix_cache=True, **kw),
                             model=wh["model"], params=wh["params"])
    engine.run([req])
    second = engine.run([twin])[1]
    st = engine.page_stats()
    assert st["prefix_hit_tokens"] == 0 and st["prefix_pages"] == 0
    assert st["free_pages"] == st["num_pages"]
    private = InferenceEngine(cfg, EngineConfig(**kw), model=wh["model"],
                              params=wh["params"]).run([twin])[1]
    assert second.tokens == private.tokens
    assert second.telemetry == private.telemetry


def test_launcher_serves_whisper_on_cpu(capsys):
    """``launch/serve.py --arch whisper-large-v3`` (smoke, paged, flash):
    frames from ``--seed``, the flash body and the paged layout served."""
    from repro_torch.launch import serve

    serve.main(["--arch", NAME, "--smoke", "--device", "cpu", "--trace",
                "0:20:3,1:9:2", "--kv-layout", "paged", "--prefill-mode",
                "flash", "--stats"])
    out = capsys.readouterr().out
    assert "kv-layout=paged" in out and "runs the" not in out
    assert "request 0 (arrived t=0, prompt=20, new=3" in out
    assert "|logits|^2 (kahan)" in out


def test_build_requests_draws_frames_before_each_prompt(wh):
    """``launch/serve.py::build_requests`` draws each request's frames
    from the seed just before its prompt, in the reference launcher's
    order (``repro/launch/serve.py:200-215``)."""
    from repro_torch.launch.serve import build_requests

    cfg = wh["cfg"]
    reqs, arrivals = build_requests(cfg, [(0, 5, 2, 0.0), (2, 7, 1, 0.0)],
                                    seed=11)
    rng = np.random.default_rng(11)
    for req in reqs:
        frames = rng.standard_normal((cfg.encoder.n_frames,
                                      cfg.d_model)).astype(np.float32)
        prompt = rng.integers(0, cfg.vocab_size,
                              (len(req.prompt),)).astype(np.int32)
        np.testing.assert_array_equal(req.extras["frames"], frames)
        np.testing.assert_array_equal(req.prompt, prompt)
    assert arrivals == [0, 2]
