"""The dense family beyond OLMo-1B, the VLM splice and the MoE family vs
the JAX reference: the smoke configs of deepseek-7b (rmsnorm),
stablelm-3b (parametric LayerNorm), qwen2.5-3b (extreme GQA, QKV bias,
tied embeddings), internvl2-2b (patch embeddings spliced over the first
positions), deepseek-v2-lite-16b (MLA, a dense first layer, 8 routed
experts top-2 and a shared one) and llama4-maverick-400b-a17b (dense+MoE
superblocks, top-1), with JAX-initialised weights carried over by
``repro_torch.bridge``; the bridge, logits and loss tests also hold the
xLSTM and encoder-decoder families (xlstm-1.3b, whisper-large-v3 with
its frames), whose engines ``tests/test_torch_xlstm.py`` and
``tests/test_torch_encdec.py`` hold. The
q/k/v biases and the norms' scale and bias are drawn at random on both
sides (the reference initialises them to zeros and ones, which would let
a bias dropped on one side pass unseen).

Parity tiers:

* tier 3 (tolerance against the reference): prefill (scan chunk, parallel
  chunk, whole prompt) and decode logits within rtol = atol = 1e-5 (XLA
  and PyTorch sum the matmuls in different orders); the engine's
  telemetry within rtol 1e-5; ``loss`` within rtol 1e-6 and each
  gradient leaf within 2e-6 of its largest magnitude (internvl with its
  ``vision_embeds`` and the loss masked over them); a MoE config's
  ``dropped_frac`` EXACT (the same entries dropped) and ``aux_loss``
  within rtol 1e-6. A MoE config's gradients are compared with both
  sides' parameters and compute in float64 (jax's x64 mode; each side
  still casts to float32 where its code says so: norms, softmax, the
  router, the loss): in float32 the two sides' roundings alone part
  the MoE configs' gradients by 1.4e-6 to 2.9e-6 of a leaf's largest
  magnitude over six weight and batch seeds (2.07e-6 at this test's),
  against 0.8e-6 to 1.8e-6 in float64 compute
  (``scripts/moe_grad_parity.py``); xlstm-1.3b's likewise, with every
  float32 cast of both sides widened to float64 too (its gates and
  states round to float32 on both sides), as ``tests/test_torch_xlstm.py``
  holds them. Greedy tokens of a staggered trace
  must be EXACT, under the port's dense and paged layouts alike.
* tier 1 (bitwise against the reference): the synthetic batches with
  patch embeddings and their loss mask.
"""

import os
import subprocess
import sys
from pathlib import Path

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
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.core import tree as T
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    Request,
    SamplingParams,
)
from repro_torch.train.trainer import batch_to_device

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["deepseek-7b", "stablelm-3b", "qwen2.5-3b", "internvl2-2b",
         "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]
#: the recurrent and encoder-decoder families, in the bridge, logits and
#: loss tests
FAMILIES = ["xlstm-1.3b", "whisper-large-v3"]
#: (prompt_len, max_new_tokens) and arrival step of the staggered trace
SPEC = [(12, 4), (17, 3), (9, 5)]
ARRIVALS = [0, 1, 3]
RTOL = ATOL = 1e-5


def _perturb(tree, rng):
    """Random q/k/v biases and norm scales/biases (numpy leaves), so the
    parity below sees them."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] in ("b", "bias", "scale"):
            base = 1.0 if path[-1] == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(np.shape(node))).astype(
                np.asarray(node).dtype)
        return np.asarray(node)

    return walk(tree, ())


@pytest.fixture(scope="module")
def arch(request):
    """One arch's reference model and weights and the port's, over the
    same (perturbed) numbers."""
    name = request.param
    jcfg = jax_smoke(name)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    np_params = _perturb(jax.tree.map(np.asarray, jparams),
                         np.random.default_rng(7))
    jparams = jax.tree.map(jnp.asarray, np_params)
    cfg = get_smoke(name)
    return dict(name=name, jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                cfg=cfg, model=build_model(cfg, CPU),
                params=params_from_jax(np_params, cfg, CPU), runs={})


def _vision(cfg, rng):
    if cfg.vision is None:
        return None
    return rng.standard_normal((cfg.vision.n_patches,
                                cfg.d_model)).astype(np.float32)


def _frames(cfg, rng):
    if cfg.encoder is None:
        return None
    return rng.standard_normal((cfg.encoder.n_frames,
                                cfg.d_model)).astype(np.float32)


def test_registry_serves_the_dense_family_the_vlm_and_moe():
    # hymba-1.5b (the hybrid family) is held in tests/test_torch_hybrid.py
    assert list_archs() == ("olmo-1b", *ARCHS, "hymba-1.5b", *FAMILIES)
    for name in ARCHS + FAMILIES:
        full, smoke = get_config(name), get_smoke(name)
        assert full.name == smoke.name == name
        build_model(smoke, CPU)          # the zoo accepts each
    assert get_config("qwen2.5-3b").qkv_bias
    assert get_config("internvl2-2b").vision.n_patches == 256
    assert get_config("deepseek-v2-lite-16b").mla.kv_lora_rank == 512
    assert get_config("llama4-maverick-400b-a17b").moe.interleave == 2
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-tiny")


@pytest.mark.parametrize("arch", ARCHS + FAMILIES, indirect=True)
def test_params_match_the_reference_tree(arch):
    """The bridge carried every leaf (biases and parametric norms
    included) unchanged."""
    want = jax.tree.leaves(arch["jparams"])
    got = T.leaves(arch["params"])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert str(g.dtype)[6:] == np.asarray(w).dtype.name
    for seg in getattr(arch["model"], "segments", ()):
        block = arch["params"][seg.name]
        block = block["a"] if seg.kind == "super" else block
        assert ("b" in block["attn"].get("q", {})) == arch["cfg"].qkv_bias
        assert ("bias" in block["ln1"]) == (arch["cfg"].norm == "layernorm")


@pytest.mark.parametrize("arch", ARCHS + FAMILIES, indirect=True)
def test_logits_within_tolerance(arch):
    """Tier 3: a prompt through the scan chunk, the parallel chunk (where
    the reference has one: not xLSTM's) and the whole-prompt prefill, and
    the next decode step; an encoder-decoder's chunks over a cache whose
    cross K/V ``prefill_begin`` filled from the request's frames."""
    a = arch
    cfg, model, jmodel = a["cfg"], a["model"], a["jmodel"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    vis, frames = _vision(cfg, rng), _frames(cfg, rng)
    jbatch = {"tokens": jnp.asarray(toks)}
    extra, begin = {}, {}
    if vis is not None:
        jbatch["vision_embeds"] = jnp.asarray(vis[None])
        extra["vision_embeds"] = torch.from_numpy(vis[None])
    if frames is not None:
        jbatch["frames"] = jnp.asarray(frames[None])
        begin["frames"] = torch.from_numpy(frames[None])
    t = torch.from_numpy(toks.astype(np.int64))
    n = toks.shape[1]
    chunks = [c for c in ("prefill_chunk", "prefill_chunk_parallel")
              if hasattr(jmodel, c)]
    assert chunks == ["prefill_chunk"] or cfg.xlstm is None
    for chunk in chunks:
        jcache, _ = jmodel.init_cache(1, 24)
        cache = model.init_cache(1, 24)
        if begin:
            jcache = jmodel.prefill_begin(a["jparams"], jbatch, jcache)
            cache = model.prefill_begin(a["params"], cache, **begin)
        jlog, jcache = getattr(jmodel, chunk)(
            a["jparams"], jbatch, jcache, jnp.int32(0), jnp.int32(n))
        log, cache = getattr(model, chunk)(a["params"], t, cache, 0, n,
                                           **extra)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                                   atol=ATOL, err_msg=chunk)
        jdec, _ = jmodel.decode_step(a["jparams"], jcache,
                                     jnp.asarray([7], jnp.int32),
                                     jnp.int32(n))
        dec = model.decode_step(a["params"], cache, torch.tensor([7]), n)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                                   atol=ATOL, err_msg=f"decode after {chunk}")
    jcache, _ = jmodel.init_cache(1, n)
    jlog, _ = jmodel.prefill(a["jparams"], jbatch, jcache)
    log, _ = model.prefill(a["params"], t, model.init_cache(1, n), **extra,
                           **begin)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL, err_msg="prefill")


def _trace(cfg, request_cls, sampling_cls):
    rng = np.random.default_rng(0)
    out = []
    for i, (plen, new) in enumerate(SPEC):
        vis = _vision(cfg, rng)
        out.append(request_cls(
            prompt=rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32),
            sampling=sampling_cls(max_new_tokens=new), request_id=i,
            extras=None if vis is None else {"vision_embeds": vis}))
    return out


#: the engines' settings (the paged layout in pages of 4 positions)
SERVE = dict(max_slots=2, max_len=24, track_stats=True, prefill_chunk=4,
             page_size=4)


def _serve(arch, layout):
    """The trace served by the port's engine under ``layout`` and by the
    reference engine on its dense layout (cached per arch): (reference
    handles, port handles, port engine). The reference's own tests hold
    its paged layout bitwise to its dense one, so its dense tokens are
    the target of both of the port's layouts."""
    runs = arch["runs"]
    if "reference" not in runs:
        runs["reference"] = JaxEngine(
            arch["jcfg"], JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                          **SERVE),
            model=arch["jmodel"], params=arch["jparams"]).run(
            _trace(arch["jcfg"], JaxRequest, JaxSampling), ARRIVALS)
    if layout not in runs:
        engine = InferenceEngine(
            arch["cfg"], EngineConfig(policy=Policy(scheme="kahan"),
                                      kv_layout=layout, **SERVE),
            model=arch["model"], params=arch["params"])
        out = engine.run(_trace(arch["cfg"], Request, SamplingParams),
                         ARRIVALS)
        runs[layout] = (out, engine)
    return (runs["reference"], *runs[layout])


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_tokens_exact_vs_reference(arch, layout):
    """Greedy tokens of the staggered trace equal the reference engine's
    exactly, under both of the port's layouts; the telemetry within rtol
    1e-5."""
    jout, out, engine = _serve(arch, layout)
    assert engine.kv_layout == layout
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens, rid
        np.testing.assert_allclose(out[rid].telemetry, jout[rid].telemetry,
                                   rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
def test_paged_equals_dense_bitwise(arch):
    """Tier 2: the same trace's tokens and telemetry, paged vs dense."""
    _, dense, _ = _serve(arch, "dense")
    _, paged, engine = _serve(arch, "paged")
    for rid in range(len(SPEC)):
        assert paged[rid].tokens == dense[rid].tokens
        assert paged[rid].telemetry == dense[rid].telemetry
    assert engine.pages.free_count == engine.num_pages


@pytest.mark.parametrize("arch", ARCHS + FAMILIES, indirect=True)
def test_loss_and_grads_within_tolerance(arch, monkeypatch):
    """Tier 3: the training loss and every gradient leaf (internvl with
    its patch embeddings and the loss masked over them, whisper with its
    frames)."""
    a = arch
    cfg, jcfg = a["cfg"], a["jcfg"]
    vp = cfg.vision.n_patches if cfg.vision else 0
    data = JaxSyntheticLM(JaxDataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
        vision_patches=vp, d_model=cfg.d_model,
        n_frames=cfg.encoder.n_frames if cfg.encoder else 0))
    batch = data.batch_at(0)
    assert ("vision_embeds" in batch) == bool(vp)
    assert ("frames" in batch) == (cfg.encoder is not None)
    (jloss, jmet), jgrads = jax.value_and_grad(a["jmodel"].loss,
                                               has_aux=True)(
        a["jparams"], jax.tree.map(jnp.asarray, batch))
    params = T.tree_map(lambda p: p.detach().clone().requires_grad_(),
                        a["params"])
    loss, met = a["model"].loss(params, batch_to_device(batch, CPU))
    grads = torch.autograd.grad(loss, T.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * (16 - vp)
    assert sorted(met) == sorted(jmet)
    if "dropped_frac" in met:
        assert float(met["dropped_frac"]) == float(jmet["dropped_frac"])
        np.testing.assert_allclose(float(met["aux_loss"]),
                                   float(jmet["aux_loss"]), rtol=1e-6)
        assert (float(met["dropped_frac"]) > 0) == (cfg.moe is not None)
    if cfg.moe is not None:
        jgrads, grads = _grads_in_float64(a, batch)
    if cfg.xlstm is not None:
        jgrads, grads = _grads_widened(a, batch, monkeypatch)
    for want, got in zip(jax.tree.leaves(jgrads), grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())


def _grads_in_float64(arch, batch):
    """Both sides' gradients of ``batch``'s loss with float64 parameters
    and compute (the reference initialised and perturbed as the fixture
    does, under x64)."""
    kw = dict(param_dtype="float64", compute_dtype="float64")
    with jax.enable_x64(True):
        jmodel = jax_build(arch["jcfg"].replace(**kw))
        jparams, _ = jmodel.init(jax.random.key(0))
        np_params = _perturb(jax.tree.map(np.asarray, jparams),
                             np.random.default_rng(7))
        _, jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, batch))
        jgrads = jax.tree.map(np.asarray, jgrads)
    cfg = arch["cfg"].replace(**kw)
    params = T.tree_map(lambda p: p.requires_grad_(),
                        params_from_jax(np_params, cfg, CPU))
    loss, _ = build_model(cfg, CPU).loss(params, batch_to_device(batch, CPU))
    assert loss.dtype == torch.float32 and jgrads["embed"]["table"].dtype == (
        np.float64)
    return jgrads, torch.autograd.grad(loss, T.leaves(params))


def _grads_widened(arch, batch, monkeypatch):
    """Both sides' gradients of ``batch``'s loss with every parameter,
    the compute and every float32 cast of the model in float64 (the
    reference's xLSTM modules see ``jnp.float32`` as float64, the port's
    ``Tensor.float`` returns float64); the parameters skip the bridge,
    which holds the gates' leaves to float32."""
    from repro.models import common, layers, xlstm, xlstm_lm

    kw = dict(param_dtype="float64", compute_dtype="float64")

    class Wide:
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    with jax.enable_x64(True):
        jmodel = jax_build(arch["jcfg"].replace(**kw))
        jparams, _ = jmodel.init(jax.random.key(0))
        np_params = jax.tree.map(
            lambda x: np.asarray(x, np.float64),
            _perturb(jax.tree.map(np.asarray, jparams),
                     np.random.default_rng(7)))
        for module in (common, layers, xlstm, xlstm_lm):
            monkeypatch.setattr(module, "jnp", Wide())
        monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
        _, jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
            jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, batch))
        params = T.tree_map(
            lambda x: torch.from_numpy(x.copy()).requires_grad_(), np_params)
        loss, _ = build_model(arch["cfg"].replace(**kw), CPU).loss(
            params, batch_to_device(batch, CPU))
        grads = torch.autograd.grad(loss, T.leaves(params))
        monkeypatch.undo()
    assert loss.dtype == torch.float64
    return jax.tree.map(np.asarray, jgrads), grads


def test_bridge_refuses_a_tree_without_the_biases():
    cfg = get_smoke("qwen2.5-3b")
    jmodel = jax_build(jax_smoke("qwen2.5-3b"))
    jparams, _ = jmodel.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    params_from_jax(tree, cfg, CPU)
    del tree["blocks"]["attn"]["k"]["b"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, cfg, CPU)
    # nor does a config without qkv_bias take a tree with them
    jparams, _ = jax_build(jax_smoke("deepseek-7b")).init(jax.random.key(0))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(jax.tree.map(np.asarray, jparams),
                        get_smoke("deepseek-7b").replace(qkv_bias=True), CPU)


@pytest.mark.parametrize("step", [0, 3])
def test_vision_batches_bitwise(step):
    """Tier 1: the synthetic batches of a VLM config (patch embeddings
    drawn after the tokens, the loss masked over them) equal the
    reference's bit for bit."""
    kw = dict(vocab_size=512, seq_len=16, global_batch=3, vision_patches=8,
              d_model=64)
    want = JaxSyntheticLM(JaxDataConfig(**kw)).batch_at(step)
    got = SyntheticLM(DataConfig(**kw)).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got["loss_mask"][:, :8].any() and got["loss_mask"][:, 8:].all()


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
def test_engine_refuses_extras_the_model_does_not_take(arch):
    cfg = arch["cfg"]
    engine = InferenceEngine(cfg, EngineConfig(max_slots=1, max_len=24),
                             model=arch["model"], params=arch["params"])
    bad = [{"frames": np.zeros((4, cfg.d_model), np.float32)}]
    if cfg.vision is None:
        bad.append({"vision_embeds": np.zeros((8, cfg.d_model), np.float32)})
    else:
        bad.append({"vision_embeds": np.zeros((3, cfg.d_model), np.float32)})
    for extras in bad:
        with pytest.raises(ValueError, match="extras|vision_embeds"):
            engine.submit(Request(prompt=[1, 2, 3], extras=extras))


def test_launcher_trains_the_vlm_smoke_config_on_the_cpu():
    """The training launcher hands a VLM config's patch embeddings to the
    trainer (``DataConfig.vision_patches``, ``d_model``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internvl2-2b", "--smoke", "--steps", "2", "--seq-len", "16",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final:" in out.stdout
