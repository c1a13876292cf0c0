"""The xLSTM family (``XLSTMLM``: groups of mLSTM blocks and one sLSTM
block, recurrent state only) against the JAX reference, on the CPU, at
xlstm-1.3b's smoke config (one group of 3 mLSTM blocks and an sLSTM,
chunk 16, float32). The reference's weights come over through
``repro_torch.bridge``, with the norm scales and every bias (the conv's,
the gates') drawn at random on both sides.

Parity tiers, stated per test:

* tier 3 (tolerance against the reference): block outputs, logits and
  every state leaf within rtol = atol = 1e-5 (of the largest magnitude
  for the state); ``loss`` within rtol 1e-6 and each gradient leaf
  within 2e-6 of its largest magnitude; greedy engine tokens EXACT and
  the telemetry within rtol 1e-5. XLA's and PyTorch's ``cumsum`` and
  matmuls sum in their own orders, so nothing is bitwise here.
* tier 2 (bitwise within the port): solo == interleaved, and a slot
  reused after an eviction serves the bits of a fresh engine (its state
  reset to the initial row, whose stabiliser ``m`` is -1e30, not zero).
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
from repro.models import xlstm as JX
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import tree as T
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.models import xlstm as X
from repro_torch.models.common import cache_leaves
from repro_torch.models.xlstm_lm import XLSTMLM
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    Request,
    SamplingParams,
)
from repro_torch.train.trainer import batch_to_device

CPU = torch.device("cpu")
NAME = "xlstm-1.3b"
RTOL = ATOL = 1e-5
#: (prompt_len, max_new_tokens) and arrival step of the staggered trace:
#: request 1's prompt spans two of the smoke config's 16-token chunks
SPEC = [(12, 4), (21, 3), (9, 5)]
ARRIVALS = [0, 1, 3]
SERVE = dict(max_slots=2, max_len=32, track_stats=True, prefill_chunk=4)


def _perturb(tree, rng):
    """Norm scales about 1 and every bias shifted, at random (numpy
    leaves)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        node = np.asarray(node)
        noise = 0.1 * rng.standard_normal(node.shape)
        if path[-1] == "scale":
            return (1.0 + noise).astype(node.dtype)
        if path[-1] in ("b", "bias", "conv_b"):
            return (node + noise).astype(node.dtype)
        return node

    return walk(tree, ())


def _pair(jcfg, cfg, seed=0):
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(seed))
    np_params = _perturb(jax.tree.map(np.asarray, jparams),
                         np.random.default_rng(7))
    return (jmodel, jax.tree.map(jnp.asarray, np_params),
            build_model(cfg, CPU), params_from_jax(np_params, cfg, CPU),
            np_params)


@pytest.fixture(scope="module")
def xl():
    jmodel, jparams, model, params, np_params = _pair(jax_smoke(NAME),
                                                      get_smoke(NAME))
    return dict(jcfg=jax_smoke(NAME), cfg=get_smoke(NAME), jmodel=jmodel,
                jparams=jparams, model=model, params=params,
                np_params=np_params, runs={})


def _close(got, want, what=""):
    """Within RTOL of the largest magnitude of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _jax_cache_leaves(jcache):
    """The reference's state leaves in the port's layout: the mLSTM's
    ``[G, M, B, ...]`` stacked as ``[G·M, B, ...]``."""
    out = []
    for leaf in jcache["mlstm"]:
        leaf = np.asarray(leaf)
        out.append(leaf.reshape(-1, *leaf.shape[2:]))
    out.extend(np.asarray(leaf) for leaf in jcache["slstm"])
    return out


def _block(tree, *idx):
    """One block's parameters of a stacked tree (numpy or torch)."""
    if isinstance(tree, dict):
        return {k: _block(v, *idx) for k, v in tree.items()}
    return tree[idx]


# ---------------------------------------------------------------------------
# Config, zoo and bridge
# ---------------------------------------------------------------------------

def test_zoo_builds_xlstm_at_published_width():
    """``build_model`` returns ``XLSTMLM`` for an ``xlstm`` config:
    xlstm-1.3b at 48 blocks (6 groups of 7 mLSTM and one sLSTM), d 2048,
    4 heads, chunk 512; 2,904,994,128 parameters under the reference's
    config (spec only: nothing is allocated)."""
    cfg = get_config(NAME)
    model = build_model(cfg, torch.device("meta"))
    assert isinstance(model, XLSTMLM) and not model.parallel_prefill_ok
    assert (model.n_groups, model.m_per_group) == (6, 7)
    assert cfg.xlstm.chunk == 512 and cfg.xlstm.conv_kernel == 4

    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(np.prod(node[0]))

    assert count(model.param_spec()) == 2_904_994_128
    assert get_smoke(NAME).xlstm.chunk == 16


def test_params_match_the_reference_tree(xl):
    """The bridge carries every leaf unchanged: mLSTM leaves ``[G, M,
    ...]``, sLSTM leaves ``[G, ...]``, the gates' projection, biases and
    the recurrent ``r`` in float32 also under bf16 params."""
    want = jax.tree.leaves(xl["jparams"])
    got = T.leaves(xl["params"])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert str(g.dtype)[6:] == np.asarray(w).dtype.name
    assert xl["params"]["groups"]["mlstm"]["wq"]["w"].shape[:2] == (1, 3)
    cfg16 = get_smoke(NAME).replace(param_dtype="bfloat16")
    bf16 = params_from_jax(jax.tree.map(np.asarray, jax_build(
        jax_smoke(NAME).replace(param_dtype="bfloat16")).init(
        jax.random.key(0))[0]), cfg16, CPU)
    g = bf16["groups"]
    assert g["mlstm"]["w_if"]["w"].dtype == torch.float32
    assert g["slstm"]["r"].dtype == g["slstm"]["w"]["b"].dtype == (
        torch.float32)
    assert g["mlstm"]["wq"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.array, xl["np_params"])
        bad["groups"]["mlstm"]["wq"]["w"] = bad["groups"]["mlstm"]["wq"][
            "w"][0]
        params_from_jax(bad, xl["cfg"], CPU)


def test_init_matches_the_reference_constants():
    """The port's own init draws its constants as the reference does:
    the gate biases (input 0, forget ``linspace(3, 6, H)`` per head), the
    ones of the norms, the zero conv bias; shapes and dtypes as the
    bridge expects."""
    cfg = get_smoke(NAME)
    model = build_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(0))
    jparams, _ = jax_build(jax_smoke(NAME)).init(jax.random.key(0))
    for w, g in zip(jax.tree.leaves(jparams), T.leaves(params)):
        assert tuple(g.shape) == np.shape(w)
    gm, gs = params["groups"]["mlstm"], params["groups"]["slstm"]
    jm, js = jparams["groups"]["mlstm"], jparams["groups"]["slstm"]
    np.testing.assert_array_equal(gm["w_if"]["b"].numpy(), np.asarray(
        jm["w_if"]["b"]))
    np.testing.assert_array_equal(gs["w"]["b"].numpy(), np.asarray(
        js["w"]["b"]))
    assert bool((gm["norm"]["scale"] == 1).all())
    assert not gm["conv_b"].any()


# ---------------------------------------------------------------------------
# The blocks against the reference
# ---------------------------------------------------------------------------

def _mlstm_state(cfg, jcfg, b, rng):
    """A carried mLSTM state, the same numbers on both sides: (port
    tuple, reference tuple)."""
    shapes = X.mlstm_cache_shapes(cfg, b)
    vals = [rng.standard_normal(s).astype(np.float32) * 0.3
            for s in shapes[:3]]
    vals[2] = vals[2] - 2.0
    vals.append(rng.standard_normal(shapes[3]).astype(np.float32))
    return (tuple(torch.from_numpy(v.copy()) for v in vals),
            tuple(jnp.asarray(v) for v in vals))


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_within_tolerance(xl, carried):
    """Tier 3: ``mlstm_apply`` chunkwise over 24 positions at chunk 16
    (the pad path: input gates -1e30, forget gates +30 over the padded
    rows) from a fresh state, and from a carried one with the state and
    conv window written back."""
    cfg, jcfg = xl["cfg"], xl["jcfg"]
    tp = _block(xl["params"]["groups"]["mlstm"], 0, 1)
    jp = _block(xl["jparams"]["groups"]["mlstm"], 0, 1)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    if carried:
        cache, jcache = _mlstm_state(cfg, jcfg, 2, rng)
    else:
        cache, jcache = None, None
    out = X.mlstm_apply(tp, cfg, torch.from_numpy(x), cache=cache)
    want, jnew = JX.mlstm_apply(jp, jcfg, jnp.asarray(x), cache=jcache)
    _close(out.numpy(), want, "mlstm output")
    if carried:
        for got, w in zip(cache, jnew):
            _close(got.numpy(), w, "mlstm state")


def test_mlstm_decode_step_within_tolerance(xl):
    """Tier 3: three mLSTM decode steps (a chunk of length 1 each, the
    conv window from ``conv_buf``) from a carried state."""
    cfg, jcfg = xl["cfg"], xl["jcfg"]
    tp = _block(xl["params"]["groups"]["mlstm"], 0, 2)
    jp = _block(xl["jparams"]["groups"]["mlstm"], 0, 2)
    rng = np.random.default_rng(12)
    cache, jcache = _mlstm_state(cfg, jcfg, 2, rng)
    for step in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out = X.mlstm_apply(tp, cfg, torch.from_numpy(x), cache=cache)
        want, jcache = JX.mlstm_apply(jp, jcfg, jnp.asarray(x), cache=jcache)
        _close(out.numpy(), want, f"decode output {step}")
        for got, w in zip(cache, jcache):
            _close(got.numpy(), w, f"decode state {step}")


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_within_tolerance(xl, carried):
    """Tier 3: ``slstm_apply`` over 9 positions (the recurrence, then the
    gated FFN), fresh and from a carried state written back."""
    cfg, jcfg = xl["cfg"], xl["jcfg"]
    tp = _block(xl["params"]["groups"]["slstm"], 0)
    jp = _block(xl["jparams"]["groups"]["slstm"], 0)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    cache = jcache = None
    if carried:
        vals = [rng.standard_normal((2, cfg.d_model)).astype(np.float32)
                for _ in range(4)]
        vals[1] = np.abs(vals[1]) + 0.5
        cache = tuple(torch.from_numpy(v.copy()) for v in vals)
        jcache = tuple(jnp.asarray(v) for v in vals)
    out = X.slstm_apply(tp, cfg, torch.from_numpy(x), cache=cache)
    want, jnew = JX.slstm_apply(jp, jcfg, jnp.asarray(x), cache=jcache)
    _close(out.numpy(), want, "slstm output")
    if carried:
        for got, w in zip(cache, jnew):
            _close(got.numpy(), w, "slstm state")


# ---------------------------------------------------------------------------
# XLSTMLM against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [12, 37])
def test_prefill_and_decode_within_tolerance(xl, seq):
    """Tier 3: whole-prompt ``prefill`` (inside one chunk, and over three
    with the pad path) -- logits and every state leaf -- then two
    ``decode_step``s; and the scan chunk's logits and state."""
    a = xl
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
    for got, want in zip(cache_leaves(cache), _jax_cache_leaves(jcache)):
        assert got.shape == want.shape
        _close(got.numpy(), want, "prefill state")
    for i, tok in enumerate(([7, 9], [3, 4])):
        jdec, jcache = jmodel.decode_step(a["jparams"], jcache,
                                          jnp.asarray(tok, jnp.int32),
                                          jnp.int32(seq + i))
        dec = model.decode_step(a["params"], cache, torch.tensor(tok),
                                seq + i)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                                   atol=ATOL, err_msg=f"decode {i}")
    for got, want in zip(cache_leaves(cache), _jax_cache_leaves(jcache)):
        _close(got.numpy(), want, "state after decode")
    jcache, _ = jmodel.init_cache(1, 48)
    jlog, jcache = jmodel.prefill_chunk(a["jparams"], {"tokens": jnp.asarray(
        toks[:1])}, jcache, jnp.int32(0), jnp.int32(seq))
    cache = model.init_cache(1, 48)
    log, cache = model.prefill_chunk(a["params"], t[:1], cache, 0, seq)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL, err_msg="scan chunk")
    for got, want in zip(cache_leaves(cache), _jax_cache_leaves(jcache)):
        _close(got.numpy(), want, "scan chunk state")


def test_decode_matches_prefill(xl):
    """The port's own case of the reference's ``test_decode_matches_
    prefill`` for xLSTM (its tolerance, rtol = atol = 2e-3): prefill(s)
    + decode(token) against prefill(s + 1), at s = 24 over two chunks."""
    model, params, cfg = xl["model"], xl["params"], xl["cfg"]
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


def test_loss_and_grads_within_tolerance(xl, monkeypatch):
    """Tier 3: the training loss (float32) within rtol 1e-6, and every
    gradient leaf within 2e-6 of its largest magnitude, the gradients
    taken with float64 params and compute on both sides (jax's x64 mode)
    and every float32 cast of the model widened to float64 as well (as
    the hybrid family's test does). In float32 the two sides' roundings
    alone part the embedding's gradient by 3.0e-6 of its largest
    magnitude at this test's seed (the norms, the gates and every state
    round to float32 on both sides); with the casts widened that gap is
    gone, and the model's gradients are held there."""
    from repro.models import common, layers, xlstm, xlstm_lm

    a = xl
    cfg = a["cfg"]
    batch = JaxSyntheticLM(JaxDataConfig(
        vocab_size=cfg.vocab_size, seq_len=24, global_batch=2)).batch_at(0)
    jloss, jmet = jax.jit(a["jmodel"].loss)(a["jparams"],
                                            jax.tree.map(jnp.asarray, batch))
    loss, met = a["model"].loss(a["params"], batch_to_device(batch, CPU))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 48

    kw = dict(param_dtype="float64", compute_dtype="float64")
    with jax.enable_x64(True):
        jmodel = jax_build(a["jcfg"].replace(**kw))
        jparams, _ = jmodel.init(jax.random.key(0))
        # every leaf in float64, the float32 ones (the gates' projection
        # and biases, ``r``) too: not through the bridge, which holds
        # those to float32
        np_params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                                 _perturb(jax.tree.map(np.asarray, jparams),
                                          np.random.default_rng(7)))
        wcfg = cfg.replace(**kw)
        params = T.tree_map(
            lambda x: torch.from_numpy(x.copy()).requires_grad_(), np_params)

        class Wide:
            def __getattr__(self, name):
                return (jnp.float64 if name == "float32"
                        else getattr(jnp, name))

        for module in (common, layers, xlstm, xlstm_lm):
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


def _serve(xl):
    """The trace on the reference engine and on the port's (flash asked
    for, paged asked for; cached): (reference handles, port handles, port
    engine)."""
    runs = xl["runs"]
    if "reference" not in runs:
        runs["reference"] = JaxEngine(
            xl["jcfg"], JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                        **SERVE),
            model=xl["jmodel"], params=xl["jparams"]).run(
            _trace(xl["jcfg"], JaxRequest, JaxSampling), ARRIVALS)
    if "port" not in runs:
        engine = InferenceEngine(
            xl["cfg"], EngineConfig(policy=Policy(scheme="kahan"),
                                    prefill_mode="flash", kv_layout="paged",
                                    page_size=4, **SERVE),
            model=xl["model"], params=xl["params"])
        out = engine.run(_trace(xl["cfg"], Request, SamplingParams),
                         ARRIVALS)
        runs["port"] = (out, engine)
    return (runs["reference"], *runs["port"])


def test_greedy_tokens_exact_vs_reference(xl):
    """Tier 3: greedy tokens of the staggered trace (its third request
    reuses the slot of the first) equal the reference engine's exactly,
    the telemetry within rtol 1e-5; flash and paged are asked for, the
    scan body and the dense layout are served."""
    jout, out, engine = _serve(xl)
    assert engine.prefill_body == "scan" and engine.kv_layout == "dense"
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens, rid
        np.testing.assert_allclose(out[rid].telemetry, jout[rid].telemetry,
                                   rtol=RTOL)


def test_vmap_slot_loop_against_the_reference_and_scan(xl):
    """The vmapped slot loop (dense; xLSTM's state is row-local and its
    decode step ignores the positions): greedy tokens equal the
    reference's vmapped engine's exactly and the port's scan engine's,
    the telemetry within rtol 1e-5 of both."""
    jout = JaxEngine(
        xl["jcfg"], JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                    slot_loop="vmap", **SERVE),
        model=xl["jmodel"], params=xl["jparams"]).run(
        _trace(xl["jcfg"], JaxRequest, JaxSampling), ARRIVALS)
    _, scan, _ = _serve(xl)
    out = InferenceEngine(
        xl["cfg"], EngineConfig(policy=Policy(scheme="kahan"),
                                slot_loop="vmap", **SERVE),
        model=xl["model"], params=xl["params"]).run(
        _trace(xl["cfg"], Request, SamplingParams), ARRIVALS)
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens == scan[rid].tokens, rid
        for want in (jout[rid].telemetry, scan[rid].telemetry):
            np.testing.assert_allclose(out[rid].telemetry, want, rtol=RTOL)


def test_paged_resolves_dense(xl):
    """Replay of the reference's ``test_recurrent_families_fall_back_
    dense`` (its xLSTM case): no leaf pages, so ``kv_layout="paged"``
    resolves to dense, as the reference's engine resolves it, and
    ``page_stats`` raises naming it."""
    _, _, engine = _serve(xl)
    assert engine.kv_layout == "dense" and engine.pages is None
    with pytest.raises(RuntimeError, match="dense"):
        engine.page_stats()
    jeng = JaxEngine(xl["jcfg"], JaxEngineConfig(
        max_slots=2, max_len=32, kv_layout="paged", page_size=4),
        model=xl["jmodel"], params=xl["jparams"])
    assert jeng.kv_layout == "dense"


def test_solo_equals_interleaved(xl):
    """Tier 2: each request of the trace served alone emits bitwise the
    tokens and telemetry it emitted interleaved."""
    _, served, _ = _serve(xl)
    ec = EngineConfig(policy=Policy(scheme="kahan"), **SERVE)
    for req in _trace(xl["cfg"], Request, SamplingParams):
        solo = InferenceEngine(xl["cfg"], ec, model=xl["model"],
                               params=xl["params"]).run([req])
        assert solo[req.request_id].tokens == served[req.request_id].tokens
        assert solo[req.request_id].telemetry == (
            served[req.request_id].telemetry)


def test_reused_slot_serves_a_fresh_engines_bits(xl):
    """Tier 2, the eviction repair: on one slot, request 1 runs after
    request 0 is evicted and must emit bitwise what a fresh engine emits
    for it. The reset writes the model's initial row (every stabiliser
    ``m`` at -1e30); the slot's state is that row again after the
    trace."""
    cfg, model, params = xl["cfg"], xl["model"], xl["params"]
    reqs = _trace(cfg, Request, SamplingParams, [(11, 3), (14, 4)], seed=4)
    ec = EngineConfig(policy=Policy(scheme="kahan"), max_slots=1,
                      max_len=32, track_stats=True, prefill_chunk=4)
    engine = InferenceEngine(cfg, ec, model=model, params=params)
    both = engine.run(reqs)
    fresh = InferenceEngine(cfg, ec, model=model, params=params).run(
        [reqs[1]])
    assert both[1].tokens == fresh[1].tokens
    assert both[1].telemetry == fresh[1].telemetry
    for got, want in zip(cache_leaves(engine.slots.cache),
                         cache_leaves(model.init_cache(1, 32))):
        assert torch.equal(got, want)
    assert bool((engine.slots.cache["mlstm"][2] == -1e30).all())


def test_prefix_cache_refused(xl):
    """Recurrent state does not page, so the prefix cache is refused, as
    for the hybrid family."""
    with pytest.raises(ValueError, match="prefix_cache"):
        InferenceEngine(xl["cfg"], EngineConfig(
            max_slots=2, max_len=32, kv_layout="paged", page_size=4,
            prefix_cache=True), model=xl["model"], params=xl["params"])


def test_launcher_serves_xlstm_on_cpu(capsys):
    """``launch/serve.py --arch xlstm-1.3b`` (smoke, flash and paged asked
    for): the scan body and the dense layout are served and reported."""
    from repro_torch.launch import serve

    serve.main(["--arch", NAME, "--smoke", "--device", "cpu", "--trace",
                "0:20:3,1:9:2", "--kv-layout", "paged", "--prefill-mode",
                "flash", "--stats"])
    out = capsys.readouterr().out
    assert "runs the 'scan' body" in out
    assert "running the dense layout" in out
    assert "request 1 (arrived t=1, prompt=9, new=2" in out
