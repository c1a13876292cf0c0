"""The port's serving slice vs the JAX reference, on the OLMo-1B smoke
config (2 layers, d=64, float32) with JAX-initialised weights carried
over by ``repro_torch.bridge.params_from_jax``.

Parity tiers:

* tier 3 (tolerance against the reference): prefill and decode logits
  within rtol = atol = 1e-5 — both sides compute in float32, but XLA and
  PyTorch sum the matmuls in different orders (measured: 3.4e-7 max
  abs difference on logits of magnitude ~0.5); end-to-end telemetry
  within rtol = 1e-5 for the same reason. Greedy tokens must be EXACT.
* tier 1 (bitwise against the reference): the telemetry of identical
  logits, for every built-in scheme.
* tier 2 (bitwise within the port): solo vs interleaved serving, and
  chunked (prefill_chunk=4) vs one-shot prefill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.kernels.schemes import Policy as JaxPolicy
from repro.models import build_model as jax_build
from repro.models.layers import activation_sq_norm as jax_sq_norm
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.configs.base import EncoderConfig, SSMConfig, XLSTMConfig
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.models.common import cache_leaves
from repro_torch.models.layers import activation_sq_norm
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    Request,
    SamplingParams,
)
from repro_torch.serve.slots import gather_row, gather_rows

CPU = torch.device("cpu")
#: (prompt_len, max_new_tokens) and arrival step of the staggered trace
SPEC = [(9, 5), (14, 4), (3, 6)]
ARRIVALS = [0, 1, 3]
RTOL = ATOL = 1e-5


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p, _ in SPEC]


def _engine_config(**kw):
    base = dict(max_slots=2, max_len=24, track_stats=True, prefill_chunk=4,
                policy=Policy(scheme="kahan"))
    base.update(kw)
    return EngineConfig(**base)


def _requests(prompts):
    return [Request(prompt=p, sampling=SamplingParams(max_new_tokens=n),
                    request_id=i) for i, (p, (_, n)) in enumerate(zip(prompts,
                                                                      SPEC))]


@pytest.fixture(scope="module")
def served():
    """One JAX smoke engine and one port smoke engine over the same
    weights, each serving the staggered trace once."""
    jcfg = jax_smoke("olmo-1b")
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    cfg = get_smoke("olmo-1b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    model = build_model(cfg, CPU)
    prompts = _prompts(cfg.vocab_size)
    jec = JaxEngineConfig(max_slots=2, max_len=24, track_stats=True,
                          prefill_chunk=4, policy=JaxPolicy(scheme="kahan"))
    jreqs = [JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=n),
                        request_id=i)
             for i, (p, (_, n)) in enumerate(zip(prompts, SPEC))]
    jout = JaxEngine(jcfg, jec, model=jmodel, params=jparams).run(
        jreqs, ARRIVALS)
    engine = InferenceEngine(cfg, _engine_config(), model=model,
                             params=params)
    out = engine.run(_requests(prompts), ARRIVALS)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, cfg=cfg,
                model=model, params=params, prompts=prompts, jout=jout,
                out=out)


def test_prefill_and_decode_logits_within_tolerance(served):
    """Tier 3: logits of a prompt chunk and of the next decode step."""
    s = served
    toks = s["prompts"][1][None]
    n = toks.shape[1]
    jcache, _ = s["jmodel"].init_cache(1, 24)
    jlog, jcache = s["jmodel"].prefill_chunk(
        s["jparams"], {"tokens": jnp.asarray(toks)}, jcache, jnp.int32(0),
        jnp.int32(n))
    cache = s["model"].init_cache(1, 24)
    log, cache = s["model"].prefill_chunk(
        s["params"], torch.from_numpy(toks.astype(np.int64)), cache, 0, n)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    jdec, _ = s["jmodel"].decode_step(s["jparams"], jcache,
                                      jnp.asarray([7], jnp.int32),
                                      jnp.int32(n))
    dec = s["model"].decode_step(s["params"], cache, torch.tensor([7]), n)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=RTOL,
                               atol=ATOL)


def test_greedy_tokens_exact_vs_reference(served):
    """Greedy tokens of the staggered 3-request trace equal the JAX
    engine's exactly."""
    for rid, (_, n) in enumerate(SPEC):
        got, want = served["out"][rid], served["jout"][rid]
        assert len(got.tokens) == n
        assert got.tokens == want.tokens, rid


def test_telemetry_within_tolerance_end_to_end(served):
    """Tier 3: per-token telemetry of the same trace."""
    for rid in range(len(SPEC)):
        np.testing.assert_allclose(served["out"][rid].telemetry,
                                   served["jout"][rid].telemetry, rtol=RTOL)


@pytest.mark.parametrize("scheme", ["naive", "kahan", "pairwise", "dot2"])
def test_telemetry_bitwise_for_identical_logits(scheme):
    """Tier 1: the squared-norm telemetry of the SAME logits (a decode
    tick's [slots, vocab] batch) is bitwise equal to the reference's."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 50304)) * 4).astype(np.float32)
    want = np.asarray(jax_sq_norm(jnp.asarray(logits),
                                  scheme=JaxPolicy(scheme=scheme)))
    got = activation_sq_norm(torch.from_numpy(logits),
                             scheme=Policy(scheme=scheme)).numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


def _serve(s, ec, requests, arrivals=None):
    engine = InferenceEngine(s["cfg"], ec, model=s["model"],
                             params=s["params"])
    return engine.run(requests, arrivals)


def test_solo_vs_interleaved_bitwise(served):
    """Tier 2: each request replayed alone emits bitwise the same tokens
    and telemetry as in the interleaved trace."""
    for req in _requests(served["prompts"]):
        solo = _serve(served, _engine_config(), [req])[req.request_id]
        inter = served["out"][req.request_id]
        assert solo.tokens == inter.tokens
        assert solo.telemetry == inter.telemetry


def test_chunked_vs_one_shot_exact(served):
    """Tier 2: prefill in chunks of 4 (with power-of-two tail buckets) vs
    the whole prompt at once: tokens and telemetry bitwise equal."""
    one_shot = _serve(served, _engine_config(prefill_chunk=None),
                      _requests(served["prompts"]), ARRIVALS)
    for rid in range(len(SPEC)):
        assert one_shot[rid].tokens == served["out"][rid].tokens
        assert one_shot[rid].telemetry == served["out"][rid].telemetry


def test_sampling_is_per_request(served):
    """Sampled tokens depend on the request's own (seed, emit index)
    stream only: alone or beside other traffic, the same draws."""
    reqs = [Request(prompt=p, request_id=i,
                    sampling=SamplingParams(temperature=0.8,
                                            max_new_tokens=n, seed=11 + i))
            for i, (p, (_, n)) in enumerate(zip(served["prompts"], SPEC))]
    inter = _serve(served, _engine_config(), reqs, ARRIVALS)
    solo = _serve(served, _engine_config(), [reqs[2]])[2]
    assert solo.tokens == inter[2].tokens
    assert all(0 <= t < served["cfg"].vocab_size for t in solo.tokens)


def test_slot_cache_rows_and_eviction(served):
    """A drained engine leaves every slot pristine (reset on eviction);
    ``gather_row`` views write through, ``scatter_row`` installs a row."""
    from repro_torch.serve.slots import scatter_row

    engine = InferenceEngine(served["cfg"], _engine_config(),
                             model=served["model"], params=served["params"])
    engine.run(_requests(served["prompts"]), ARRIVALS)
    k, v = engine.slots.cache["blocks"]
    assert not k.any() and not v.any()
    row = served["model"].init_cache(1, 24)
    row["blocks"][0].fill_(2.0)
    scatter_row(engine.slots.cache, row, 1)
    assert bool((gather_row(engine.slots.cache, 1)["blocks"][0] == 2).all())
    assert not gather_row(engine.slots.cache, 0)["blocks"][0].any()
    engine.slots.reset(1)
    assert not k.any()


def test_engine_rejects_later_slices(served):
    """Every slice of the reference's engine is served: the vmapped slot
    loop builds (on the dense layout; with the paged layout it raises, as
    the reference's does), and so do the families and features of ROADMAP
    A5: the paged layout, the prefix cache, QKV bias, the VLM splice, the
    MoE family, the hybrid family with its SSM and sliding windows, the
    xLSTM family, the encoder-decoder family and the GELU MLP.
    ``build_model`` dispatches on the sub-configs in the reference's
    order: ``xlstm``, then ``encoder``, then ``ssm``."""
    assert EngineConfig(slot_loop="vmap").slot_loop == "vmap"
    with pytest.raises(ValueError, match="slot_loop"):
        EngineConfig(slot_loop="vmap", kv_layout="paged")
    with pytest.raises(ValueError, match="slot_loop"):
        JaxEngineConfig(slot_loop="vmap", kv_layout="paged")
    with pytest.raises(ValueError, match="slot_loop"):
        EngineConfig(slot_loop="loop")
    EngineConfig(kv_layout="paged", prefix_cache=True)
    cfg = served["cfg"]
    build_model(cfg.replace(family="moe"), CPU)
    for kw, kind in ((dict(mlp="gelu"), "TransformerLM"),
                     (dict(encoder=EncoderConfig(n_layers=1)), "EncDecLM"),
                     (dict(xlstm=XLSTMConfig(slstm_every=2)), "XLSTMLM"),
                     (dict(xlstm=XLSTMConfig(slstm_every=2),
                           encoder=EncoderConfig(n_layers=1),
                           ssm=SSMConfig()), "XLSTMLM"),
                     (dict(encoder=EncoderConfig(n_layers=1),
                           ssm=SSMConfig()), "EncDecLM")):
        assert type(build_model(cfg.replace(**kw), CPU)).__name__ == kind
    assert "gate" not in build_model(cfg.replace(mlp="gelu"), CPU).block_spec(
        "dense")["ffn"]
    build_model(cfg.replace(qkv_bias=True), CPU)
    # the reference dispatches on the sub-configs, not on the family name
    assert type(build_model(cfg.replace(family="hybrid"), CPU)).__name__ == (
        "TransformerLM")
    assert type(build_model(cfg.replace(sliding_window=8), CPU)).__name__ == (
        "TransformerLM")
    assert type(build_model(cfg.replace(ssm=SSMConfig()), CPU)).__name__ == (
        "HymbaLM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(cfg, _engine_config())


def test_vmap_slot_loop_against_the_reference_and_scan(served):
    """The vmapped slot loop on the staggered trace: greedy tokens equal
    the reference's vmapped engine's exactly and the port's scan
    engine's; the telemetry within rtol 1e-5 of both (a tick over several
    rows lets the plain matmuls round a row other than the one-row body
    does, so against the scan engine this is tier 3 too)."""
    s = served
    jec = JaxEngineConfig(max_slots=2, max_len=24, track_stats=True,
                          prefill_chunk=4, policy=JaxPolicy(scheme="kahan"),
                          slot_loop="vmap")
    jreqs = [JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=n),
                        request_id=i)
             for i, (p, (_, n)) in enumerate(zip(s["prompts"], SPEC))]
    jout = JaxEngine(s["jcfg"], jec, model=s["jmodel"],
                     params=s["jparams"]).run(jreqs, ARRIVALS)
    out = InferenceEngine(s["cfg"], _engine_config(slot_loop="vmap"),
                          model=s["model"], params=s["params"]).run(
        _requests(s["prompts"]), ARRIVALS)
    for rid, (_, new) in enumerate(SPEC):
        assert len(out[rid].tokens) == new
        assert out[rid].tokens == jout[rid].tokens == s["out"][rid].tokens
        for want in (jout[rid].telemetry, s["out"][rid].telemetry):
            np.testing.assert_allclose(out[rid].telemetry, want, rtol=RTOL)


def test_vmapped_tick_keeps_the_rows_it_does_not_run(served):
    """The vmapped tick writes the rows of its running slots only: with
    one prefill chunk a step, slot 1 is PREFILLING between running slots
    0 and 2 for several ticks (the rows gathered by copy and scattered
    back), and every tick leaves the cache row of each slot it does not
    run bitwise as it was; the trace's tokens equal the scan engine's."""
    s = served
    spec = [(3, 12), (3, 2), (3, 12), (20, 2)]
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, s["cfg"].vocab_size, (p,)),
                    sampling=SamplingParams(max_new_tokens=n), request_id=i)
            for i, (p, n) in enumerate(spec)]
    arrivals = [0, 0, 0, 3]
    outs, seen = {}, {"ticks": 0, "between": 0}
    for loop in ("scan", "vmap"):
        engine = InferenceEngine(
            s["cfg"], _engine_config(max_slots=4, prefill_budget=1,
                                     slot_loop=loop),
            model=s["model"], params=s["params"])
        orig = engine._vmapped_step

        def spy(running, logits, _engine=engine, _orig=orig):
            idle = [i for i in range(4) if i not in running]
            before = {i: [t.clone() for t in cache_leaves(
                gather_row(_engine.slots.cache, i))] for i in idle}
            _orig(running, logits)
            for i in idle:
                after = cache_leaves(gather_row(_engine.slots.cache, i))
                assert all(torch.equal(x, y)
                           for x, y in zip(before[i], after)), i
            seen["ticks"] += 1
            seen["between"] += any(min(running) < i < max(running)
                                   for i in _engine.scheduler.prefilling)

        engine._vmapped_step = spy
        outs[loop] = engine.run(reqs, arrivals)
    assert seen["between"] >= 3 and seen["ticks"] > seen["between"]
    for rid in range(len(spec)):
        assert outs["vmap"][rid].tokens == outs["scan"][rid].tokens


def test_gather_rows_views_contiguous_slots_and_scatters_the_rest(served):
    """``slots.gather_rows``: contiguous slots are views of the slot
    cache; other slots are copies that the write-back returns to those
    slots' rows and no other."""
    cache = served["model"].init_cache(4, 8)
    rows, write_back = gather_rows(cache, [1, 2])
    rows["blocks"][0].fill_(1.0)
    write_back()
    assert bool((cache["blocks"][0][:, 1:3] == 1).all())
    rows, write_back = gather_rows(cache, [0, 3])
    rows["blocks"][0].fill_(2.0)
    assert not bool((cache["blocks"][0][:, 0] == 2).any())
    write_back()
    k = cache["blocks"][0]
    assert bool((k[:, 0] == 2).all() and (k[:, 3] == 2).all()
                and (k[:, 1:3] == 1).all())


def test_per_row_decode_positions_match_per_row_calls(served):
    """``decode_step`` with a position tensor: rows at positions 5 and 9
    of a batch-2 cache give the logits of two batch-1 steps at those
    positions (rtol 1e-5: the batch rounds its plain matmuls its own
    way) and write K/V at row ``pos[b]`` of batch row ``b`` only."""
    s = served
    model, params = s["model"], s["params"]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, s["cfg"].vocab_size, (n,)) for n in (5, 9)]
    caches = []
    for p in prompts:
        c = model.init_cache(1, 24)
        model.prefill_chunk(params, torch.from_numpy(p[None]), c, 0, len(p))
        caches.append(c)
    both = model.init_cache(2, 24)
    for b, c in enumerate(caches):
        for big, one in zip(cache_leaves(both), cache_leaves(c)):
            big[:, b] = one[:, 0]
    toks = torch.tensor([3, 7])
    got = model.decode_step(params, both, toks, torch.tensor([5, 9]))
    for b, (c, pos) in enumerate(zip(caches, (5, 9))):
        want = model.decode_step(params, c, toks[b:b + 1], pos)
        np.testing.assert_allclose(got[b].numpy(), want[0].numpy(),
                                   rtol=RTOL, atol=ATOL)
        for big, one in zip(cache_leaves(both), cache_leaves(c)):
            np.testing.assert_allclose(big[:, b].numpy(), one[:, 0].numpy(),
                                       rtol=RTOL, atol=ATOL)
            assert not big[:, b, pos + 1:].any()


def test_bridge_rejects_mismatched_tree(served):
    bad = jax.tree.map(np.asarray, served["jparams"])
    bad["blocks"]["attn"]["q"]["w"] = bad["blocks"]["attn"]["q"]["w"][:1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, served["cfg"], CPU)


def test_launcher_serves_a_trace_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                "--trace", "0:5:3,1:9:2", "--stats", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "request 0 (arrived t=0, prompt=5, new=3" in out
    assert "|logits|^2 (kahan)" in out
    with pytest.raises(ValueError, match="--kv-layout"):
        serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                    "--kv-layout", "ragged"])
    with pytest.raises(ValueError, match="--prefix-cache requires"):
        serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                    "--prefix-cache"])


def test_launcher_serves_paged_with_the_prefix_cache_on_cpu(capsys):
    """``--kv-layout paged --prefix-cache`` on qwen2.5-3b's smoke config:
    the pool's counters each step, and the same tokens and telemetry as
    the dense layout."""
    from repro_torch.launch import serve

    argv = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
            "--trace", "0:20:3,1:9:2", "--prefill-chunk", "4", "--stats"]
    serve.main(argv)
    dense = capsys.readouterr().out
    serve.main(argv + ["--kv-layout", "paged", "--prefix-cache",
                       "--page-size", "4", "--num-pages", "12"])
    paged = capsys.readouterr().out
    assert " pages=" in paged and "prefix-hit=" in paged
    assert "# kv-layout=paged page_size=4 pool=12 free=" in paged

    def results(out):
        return [line for line in out.splitlines()
                if line.startswith("request ")]

    assert results(paged) == results(dense)


# ---------------------------------------------------------------------------
# Finished-handle hygiene: the reference's tests, replayed on the port
# ---------------------------------------------------------------------------

def _spec_requests(cfg, spec, seed):
    """spec: [(prompt_len, max_new), ...] -> deterministic greedy
    requests (the reference's ``tests/test_serve_engine.py::_requests``)."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, (p,)).astype(
                        np.int32),
                    sampling=SamplingParams(max_new_tokens=n), request_id=i)
            for i, (p, n) in enumerate(spec)]


def test_finished_handle_eviction_and_run_returns_driven(served):
    """``max_finished`` bounds the retained FINISHED handles; ``run``
    still returns every handle of the trace it drove (captured at
    submission, surviving eviction); an evicted request_id may be
    resubmitted."""
    cfg = served["cfg"]
    eng = InferenceEngine(cfg, EngineConfig(max_slots=2, max_len=16,
                                            max_finished=1),
                          model=served["model"], params=served["params"])
    reqs = _spec_requests(cfg, [(4, 2), (5, 2), (3, 2)], seed=29)
    done = eng.run(reqs)
    assert sorted(done) == [0, 1, 2]
    assert all(h.done and len(h.tokens) == 2 for h in done.values())
    assert len(eng.handles) == 1                 # bounded retention
    drained = eng.pop_finished()
    assert len(drained) == 1 and not eng.handles
    again = eng.run([reqs[0]])
    assert again[0].done and len(again[0].tokens) == 2


def test_pop_finished_drains_default_retention(served):
    cfg = served["cfg"]
    eng = InferenceEngine(cfg, EngineConfig(max_slots=2, max_len=16),
                          model=served["model"], params=served["params"])
    eng.run(_spec_requests(cfg, [(4, 1), (5, 2)], seed=31))
    assert sorted(eng.pop_finished()) == [0, 1]
    assert eng.handles == {} and eng.pop_finished() == {}


def test_engine_config_validation():
    """The serving knobs validate at construction, as the reference's
    do, ``max_finished`` among them."""
    with pytest.raises(ValueError, match="max_len"):
        EngineConfig(max_len=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        EngineConfig(prefill_chunk=0)
    with pytest.raises(ValueError, match="prefill_budget"):
        EngineConfig(prefill_budget=0)
    with pytest.raises(ValueError, match="max_finished"):
        EngineConfig(max_finished=-1)
    with pytest.raises(ValueError, match="prefill_mode"):
        EngineConfig(prefill_mode="bogus")
    EngineConfig(prefill_chunk=None, prefill_budget=None, max_finished=None)
    EngineConfig(max_finished=0)
    EngineConfig(prefill_mode="flash")
