"""The paged KV layout and the prefix cache of the port (``serve.paging``,
``serve.prefix``): the dense-family tests of the reference's
``tests/test_serve_paging.py``, replayed within the port, and the port's
page bookkeeping held against the reference's.

Parity tiers:

* tier 2 (bitwise within the port): a request's tokens AND telemetry are
  the same bits (a) under the paged layout and the dense oracle, for
  every scheme, under the scan and the flash chunk body, (b) whether its
  pages are contiguous or scattered, (c) alone or interleaved, and (d)
  whether its prompt prefix was prefilled privately or admitted by
  reference from the radix tree (a full-page share, a copy-on-write
  partial page, a fully resident prompt). Around it: reserve-all
  admission, FIFO stalls on page exhaustion, fail-fast impossible
  requests, eviction of cached prefix pages, no leaked page under
  sustained traffic, freed pages returned zeroed, config validation,
  the allocator and the radix tree, and the live footprint.
* against the reference: the allocator and the tree are plain Python, so
  after every ``step()`` of a shared-prefix trace ``page_stats()`` and
  every lease's page table equal the reference engine's, and the paged
  greedy tokens equal its tokens exactly.

The reference's compile-count guard has no analogue here: eager PyTorch
compiles no program per chunk width or page placement. Its hybrid
paging tests (ring buffers and SSM state kept dense beside paged global
layers, an all-window hybrid falling back to dense) are replayed in
``tests/test_torch_hybrid.py``, its xLSTM case in
``tests/test_torch_xlstm.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.kernels.schemes import Policy as JaxPolicy
from repro.models import build_model as jax_build
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.schemes import Policy
from repro_torch.models import build_model
from repro_torch.models.common import cache_batch_axes, cache_page_axes
from repro_torch.serve import (
    EngineConfig,
    InferenceEngine,
    PageAllocator,
    PagedKVCache,
    RadixPrefixTree,
    Request,
    SamplingParams,
)
from repro_torch.serve.paging import NULL_PAGE, pages_for
from repro_torch.serve.slots import gather_row

CPU = torch.device("cpu")
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=128, param_dtype="float32",
            compute_dtype="float32", loss_chunk=64)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = ArchConfig(**TINY)
    model = build_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _requests(cfg, spec, seed=0, temperature=0.5):
    """spec: [(prompt_len, max_new), ...] -> deterministic requests."""
    rng = np.random.default_rng(seed)
    return [
        Request(prompt=rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                sampling=SamplingParams(temperature=temperature,
                                        max_new_tokens=n),
                request_id=i)
        for i, (p, n) in enumerate(spec)
    ]


def _run(cfg, ec, model, params, requests, arrivals=None):
    eng = InferenceEngine(cfg, ec, model=model, params=params)
    out = eng.run(requests, arrivals)
    return {r: (tuple(h.tokens), tuple(h.telemetry))
            for r, h in out.items()}, eng


def _ec(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 16)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("track_stats", True)
    return EngineConfig(**kw)


def _paged(**kw):
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("page_size", 4)
    return _ec(**kw)


def _pool_leaves(eng):
    for leaves, axes in zip(eng.slots.cache.values(),
                            eng.slots.page_axes.values()):
        for leaf, s in zip(leaves, axes):
            if s >= 0:
                yield leaf


# ---------------------------------------------------------------------------
# The contract: paged vs the dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["naive", "kahan", "pairwise", "dot2"])
def test_paged_vs_dense_bitwise(tiny_model, scheme):
    """Tokens AND telemetry bitwise equal under either layout, over a
    staggered mixed trace: the dense ``SlotKVCache`` is the oracle."""
    cfg, model, params = tiny_model
    pol = Policy(scheme=scheme, unroll=2)
    reqs = _requests(cfg, [(5, 3), (9, 2), (3, 4)], seed=len(scheme))
    arr = [0, 1, 2]
    dense, _ = _run(cfg, _ec(policy=pol), model, params, reqs, arr)
    paged, eng = _run(cfg, _paged(policy=pol), model, params, reqs, arr)
    assert eng.kv_layout == "paged"
    assert dense == paged, f"{scheme}: paged trace diverges from dense"
    assert eng.pages.free_count == eng.num_pages


def test_paged_vs_dense_bitwise_under_flash(tiny_model):
    """The parallel chunk body (``prefill_mode="flash"``) between the
    gather and the scatter: the same bits as its dense run, with and
    without the prefix cache, and with ``kahan_attention`` (the flash
    kernel's plain version on the CPU)."""
    cfg, model, params = tiny_model
    for c, m in ((cfg, model),
                 (cfg.replace(kahan_attention=True),
                  build_model(cfg.replace(kahan_attention=True), CPU))):
        reqs = _requests(c, [(5, 3), (11, 2), (3, 4)], seed=5)
        dense, _ = _run(c, _ec(prefill_mode="flash"), m, params, reqs,
                        [0, 1, 2])
        for prefix in (False, True):
            paged, eng = _run(c, _paged(prefill_mode="flash",
                                        prefix_cache=prefix), m, params,
                              reqs, [0, 1, 2])
            assert eng.prefill_body == "flash"
            assert paged == dense, (c.kahan_attention, prefix)
        # shared vs private: under flash the resume offset is aligned to
        # the chunk width (8 of the shared 9 tokens), and no page is copied
        rng = np.random.default_rng(71)
        base = rng.integers(0, c.vocab_size, (9,)).astype(np.int32)
        donor, benef = (
            Request(prompt=np.concatenate([base, tail]).astype(np.int32),
                    sampling=SamplingParams(temperature=0.5,
                                            max_new_tokens=3, seed=rid),
                    request_id=rid)
            for rid, tail in ((0, [4, 4, 4]), (1, [9, 1])))
        priv, _ = _run(c, _paged(prefill_mode="flash"), m, params, [benef])
        eng = InferenceEngine(c, _paged(prefill_mode="flash",
                                        prefix_cache=True),
                              model=m, params=params)
        eng.run([donor])
        served = eng.run([benef])
        assert eng.prefix_hit_tokens == 8
        assert (tuple(served[1].tokens),
                tuple(served[1].telemetry)) == priv[1]


def test_scattered_vs_contiguous_bitwise(tiny_model):
    """Page placement cannot reach the numerics: a request whose pages
    come back scattered (after fragmenting frees) matches the same
    request served contiguously in a fresh pool."""
    cfg, model, params = tiny_model
    reqs = _requests(cfg, [(4, 2), (9, 3), (9, 3)], seed=3)
    ec = _paged()
    solo, _ = _run(cfg, ec, model, params, [reqs[2]])
    # 0 and 1 start together, short 0 frees its low pages first, and 2
    # arrives while 1 still holds the middle of the pool: its
    # reservation straddles the hole
    eng = InferenceEngine(cfg, ec, model=model, params=params)
    scattered = False
    served = {}
    for _t, _events in eng.stream(reqs, [0, 0, 1], _sink=served):
        for lease in eng._leases.values():
            pages = list(lease.table[:lease.n_pages])
            if any(b - a != 1 for a, b in zip(pages, pages[1:])):
                scattered = True
    assert scattered, "trace never produced a scattered page table"
    assert (tuple(served[2].tokens), tuple(served[2].telemetry)) == solo[2]


def test_solo_vs_interleaved_bitwise_paged(tiny_model):
    """Solo replay under the paged layout (slot AND page placement both
    differ between the runs)."""
    cfg, model, params = tiny_model
    reqs = _requests(cfg, [(5, 3), (8, 2), (3, 4)], seed=11)
    ec = _paged()
    served, _ = _run(cfg, ec, model, params, reqs, [0, 1, 1])
    for req in reqs:
        solo, _ = _run(cfg, ec, model, params, [req])
        assert solo[req.request_id] == served[req.request_id]


# ---------------------------------------------------------------------------
# Prefix cache: shared vs private, copy-on-write, accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["naive", "kahan", "pairwise", "dot2"])
def test_shared_vs_private_bitwise(tiny_model, scheme):
    """A request admitted by reference (prompt prefix resident in the
    radix tree) emits the same bits as a private prefill of itself."""
    cfg, model, params = tiny_model
    pol = Policy(scheme=scheme, unroll=2)
    rng = np.random.default_rng(29)
    base = rng.integers(0, cfg.vocab_size, (9,)).astype(np.int32)

    def mk(tail, rid):
        return Request(prompt=np.concatenate([base, tail]).astype(np.int32),
                       sampling=SamplingParams(temperature=0.5,
                                               max_new_tokens=3, seed=rid),
                       request_id=rid)

    donor = mk(rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32), 0)
    benef = mk(rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32), 1)

    priv, _ = _run(cfg, _paged(policy=pol), model, params, [benef])
    eng = InferenceEngine(cfg, _paged(policy=pol, prefix_cache=True),
                          model=model, params=params)
    eng.run([donor])
    assert eng.page_stats()["prefix_cached_pages"] > 0
    served = eng.run([benef])
    assert eng.prefix_hit_tokens > 0, "beneficiary never hit the prefix"
    assert (tuple(served[1].tokens), tuple(served[1].telemetry)) == priv[1]


def test_copy_on_write_partial_page(tiny_model):
    """Scan-body sharing extends INTO the first divergent page: the donor
    page is copied (copy-on-write), the resume offset lands mid-page, and
    the donor's own bits survive: a donor replay after the beneficiary
    matches its first run."""
    cfg, model, params = tiny_model
    rng = np.random.default_rng(31)
    base = rng.integers(0, cfg.vocab_size, (6,)).astype(np.int32)

    def mk(tail, rid, seed):
        return Request(prompt=np.concatenate([base, tail]).astype(np.int32),
                       sampling=SamplingParams(temperature=0.5,
                                               max_new_tokens=3, seed=seed),
                       request_id=rid)

    donor = mk([3, 5, 9], 0, 0)     # diverges from benef inside page 1
    benef = mk([7, 2, 8], 1, 1)

    priv, _ = _run(cfg, _paged(), model, params, [benef])
    eng = InferenceEngine(cfg, _paged(prefix_cache=True),
                          model=model, params=params)
    first_donor = eng.run([donor])
    served = eng.run([benef])
    # 1 full shared page (4 tokens) + 2 copy-on-write overlap tokens
    assert eng.prefix_hit_tokens == 6
    assert (tuple(served[1].tokens), tuple(served[1].telemetry)) == priv[1]
    donor_replay = eng.run([mk([3, 5, 9], 2, 0)])
    assert tuple(donor_replay[2].tokens) == tuple(first_donor[0].tokens)
    assert tuple(donor_replay[2].telemetry) == tuple(
        first_donor[0].telemetry)


def test_prefix_hit_full_prompt_resumes_at_last_position(tiny_model):
    """A fully resident prompt still prefills its last position (the final
    chunk's logits emit token 0), with the bits of its private run."""
    cfg, model, params = tiny_model
    rng = np.random.default_rng(37)
    prompt = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)

    def mk(rid):
        return Request(prompt=prompt, sampling=SamplingParams(
            temperature=0.5, max_new_tokens=3, seed=5), request_id=rid)

    priv, _ = _run(cfg, _paged(), model, params, [mk(0)])
    eng = InferenceEngine(cfg, _paged(prefix_cache=True),
                          model=model, params=params)
    eng.run([mk(0)])
    served = eng.run([mk(1)])
    assert (tuple(served[1].tokens), tuple(served[1].telemetry)) == \
        (priv[0][0], priv[0][1])
    assert eng.prefix_hit_tokens == 7


def test_prefix_eviction_reclaims_cached_pages(tiny_model):
    """Pool pressure evicts refs-0 cached prefix pages (oldest first),
    zero-resets them, and the newcomer is served; free + tree pages stay
    the pool."""
    cfg, model, params = tiny_model
    ec = _paged(max_slots=1, num_pages=4, prefix_cache=True)
    eng = InferenceEngine(cfg, ec, model=model, params=params)
    reqs = _requests(cfg, [(7, 2), (13, 3)], seed=41)
    eng.run([reqs[0]])
    assert eng.page_stats()["prefix_cached_pages"] == 1
    eng.run([reqs[1]])
    st = eng.page_stats()
    assert st["free_pages"] + st["prefix_pages"] == eng.num_pages
    assert st["prefix_pages"] == 3


# ---------------------------------------------------------------------------
# Lifecycle: exhaustion stalls, fail-fast, leaks, hygiene
# ---------------------------------------------------------------------------

def test_page_exhaustion_stalls_fifo(tiny_model):
    """A pool that fits one request at a time serializes admission,
    strict FIFO, stalls counted, every request served, the free list
    back to full."""
    cfg, model, params = tiny_model
    eng = InferenceEngine(cfg, _paged(num_pages=4), model=model,
                          params=params)
    reqs = _requests(cfg, [(12, 3), (12, 3), (12, 3)], seed=43)
    finish_order = []
    served = {}
    for _t, events in eng.stream(reqs, _sink=served):
        finish_order += [e.request_id for e in events if e.done]
    assert finish_order == [0, 1, 2]
    assert eng.page_stalls > 0
    assert all(h.done for h in served.values())
    assert eng.pages.free_count == eng.num_pages


def test_impossible_request_fails_fast_at_submit(tiny_model):
    cfg, model, params = tiny_model
    eng = InferenceEngine(cfg, _paged(num_pages=3), model=model,
                          params=params)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(prompt=list(range(12)),
                           sampling=SamplingParams(max_new_tokens=4)))


def test_sustained_traffic_leaks_no_pages(tiny_model):
    """Waves of mixed traffic (staggered arrivals, slot churn,
    ``pop_finished``) return the free list to its initial size; with the
    prefix cache, free + tree-owned pages always make the pool."""
    cfg, model, params = tiny_model
    for prefix in (False, True):
        eng = InferenceEngine(cfg, _paged(prefix_cache=prefix),
                              model=model, params=params)
        for wave in range(3):
            reqs = _requests(cfg, [(5, 3), (9, 2), (3, 4), (6, 2)],
                             seed=wave)
            eng.run(reqs, [0, 0, 1, 2])
            eng.pop_finished()
            st = eng.page_stats()
            assert st["free_pages"] + st["prefix_pages"] == eng.num_pages
            assert not eng._leases
        if not prefix:
            assert eng.pages.free_count == eng.num_pages


def test_freed_pages_are_pristine(tiny_model):
    """After a drained trace without the prefix cache every pool leaf is
    all zeros again: freed pages re-enter the free list pristine."""
    cfg, model, params = tiny_model
    eng = InferenceEngine(cfg, _paged(), model=model, params=params)
    eng.run(_requests(cfg, [(5, 3), (9, 2)], seed=47), [0, 1])
    assert eng.pages.free_count == eng.num_pages
    leaves = list(_pool_leaves(eng))
    assert leaves, "paged engine has no pool leaves"
    for leaf in leaves:
        assert not leaf.any(), "freed page carries stale bits"


# ---------------------------------------------------------------------------
# Config validation, cache axes, gather / scatter
# ---------------------------------------------------------------------------

def test_config_validation():
    with pytest.raises(ValueError, match="power of two"):
        EngineConfig(kv_layout="paged", page_size=6)
    with pytest.raises(ValueError, match="multiple"):
        EngineConfig(kv_layout="paged", page_size=32, max_len=48)
    with pytest.raises(ValueError, match="kv_layout"):
        EngineConfig(kv_layout="ragged")
    with pytest.raises(ValueError, match="prefix_cache"):
        EngineConfig(prefix_cache=True)
    with pytest.raises(ValueError, match="slot_loop"):
        EngineConfig(kv_layout="paged", page_size=16, max_len=32,
                     slot_loop="vmap")
    with pytest.raises(ValueError, match="num_pages"):
        EngineConfig(kv_layout="paged", num_pages=0)
    EngineConfig(kv_layout="paged", page_size=16, max_len=32,
                 prefix_cache=True, num_pages=3)


def test_cache_axes_mark_the_pageable_leaves(tiny_model, monkeypatch):
    """``cache_page_axes`` pages the position-addressed "kv_seq" leaves,
    keeps a "kv_ring" leaf dense (the pageable=False flag), and refuses a
    "kv_seq" leaf shorter than max_len and a leaf with no "batch" axis;
    the paged layout refuses a cache with no pageable leaf instead of
    serving it dense."""
    cfg, model, _ = tiny_model
    cache, specs = model.init_cache(1, 16), model.cache_specs()
    assert cache_batch_axes(specs) == {"blocks": (1, 1)}
    assert cache_page_axes(cache, specs, 16) == {"blocks": (2, 2)}
    ring = ("layers", "batch", "kv_ring", "kv_heads", None)
    assert cache_page_axes(cache, {"blocks": (ring, ring)}, 16) == {
        "blocks": (-1, -1)}
    with pytest.raises(ValueError, match="kv_ring"):
        cache_page_axes(cache, specs, 32)
    with pytest.raises(ValueError, match="batch"):
        cache_batch_axes({"blocks": (("layers", "kv_seq"),) * 2})
    PagedKVCache(model, 2, 16, 4, 8)
    monkeypatch.setattr(model, "cache_specs",
                        lambda: {"blocks": (ring, ring)})
    with pytest.raises(ValueError, match="no pageable leaf"):
        PagedKVCache(model, 2, 16, 4, 8)


def test_paged_row_equals_the_dense_row(tiny_model):
    """A row written through scattered pages reads back bitwise as the
    dense row: live pages in order, zeros past the live count; a decode
    write lands in the one page holding its position only."""
    cfg, model, params = tiny_model
    paged = PagedKVCache(model, 2, 16, 4, 6)
    assert paged.max_pages == 4
    assert paged.page_bytes == 2 * 2 * 4 * 2 * 8 * 4   # k, v: L*ps*KV*dh*4
    row = model.init_cache(1, 16)
    gen = torch.Generator().manual_seed(1)
    for t in row["blocks"]:
        t[:, :, :11] = torch.randn(t[:, :, :11].shape, generator=gen)
    table = paged.table_tensor([5, 2, 6, NULL_PAGE])
    paged.scatter(row, table, 0, 3)
    got = paged.read(1, [5, 2, 6, NULL_PAGE], 3)
    for g, w in zip(got["blocks"], row["blocks"]):
        assert torch.equal(g, w)
    # a decode write at position 13: page 3 of the table only
    back = paged.gather(1, table, 3)
    for t in back["blocks"]:
        t[:, :, 9] = 7.0
    paged.scatter_decode(back, table, 9)
    pool = paged.cache["blocks"][0]
    assert bool((pool[:, 6, 1] == 7.0).all())
    assert not pool[:, NULL_PAGE].any() and not pool[:, 1].any()
    paged.reset_pages([5, 2, 6])
    assert not pool.any()


def test_live_footprint_scales_with_live_tokens(tiny_model):
    """KV bytes in use follow the live trace (reserved pages), not the
    dense ``max_slots * max_len`` envelope."""
    cfg, model, params = tiny_model
    ec = _paged(max_slots=4, max_len=16, num_pages=16)
    eng = InferenceEngine(cfg, ec, model=model, params=params)
    peak_small = 0
    for _t, _e in eng.stream(_requests(cfg, [(2, 3)], seed=61)):
        peak_small = max(peak_small, eng.page_stats()["pages_in_use"])
    eng.pop_finished()
    peak_big = 0
    for _t, _e in eng.stream(_requests(cfg, [(13, 3), (13, 3)], seed=62),
                             [0, 0]):
        peak_big = max(peak_big, eng.page_stats()["pages_in_use"])
    assert peak_small == pages_for(2 + 3 - 1, 4)
    assert peak_big == 2 * pages_for(13 + 3 - 1, 4)
    assert peak_small < peak_big <= eng.num_pages
    assert eng.page_stats()["kv_bytes_in_use"] == (
        eng.page_stats()["pages_in_use"] * eng.slots.page_bytes)


def test_dense_slot_rows_stay_views(tiny_model):
    """The dense layout still hands out views of its slots (the paged
    layout copies through tables)."""
    cfg, model, params = tiny_model
    eng = InferenceEngine(cfg, _ec(), model=model, params=params)
    row = gather_row(eng.slots.cache, 1)
    row["blocks"][0].fill_(3.0)
    assert bool((eng.slots.cache["blocks"][0][:, 1] == 3.0).all())


# ---------------------------------------------------------------------------
# Unit coverage: allocator + radix tree
# ---------------------------------------------------------------------------

def test_page_allocator_deterministic_lowest_first():
    a = PageAllocator(6)
    assert a.alloc(3) == [1, 2, 3]
    assert a.alloc(2) == [4, 5]
    a.free([2, 4])
    assert a.alloc(2) == [2, 4]
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc(3)
    with pytest.raises(ValueError, match="double free"):
        a.free([6, 6])
    with pytest.raises(ValueError, match="cannot free"):
        a.free([NULL_PAGE])


def test_radix_tree_match_insert_evict():
    t = RadixPrefixTree(4)
    adopted, dups = t.insert(list(range(10)), 2, [5, 9])
    assert adopted == [5, 9] and dups == []
    adopted2, dups2 = t.insert(list(range(10)), 2, [5, 7])
    assert adopted2 == [] and dups2 == [7]
    path = t.match(list(range(10)))
    assert [n.page for n in path] == [5, 9]
    assert t.match([9, 9, 9, 9]) == []
    t.acquire(path)
    assert t.evict(2) == []
    t.release(path)
    assert t.evict(1) == [9]
    assert t.evict(2) == [5]
    assert t.total_pages == 0
    with pytest.raises(RuntimeError, match="underflow"):
        t.release(path)


# ---------------------------------------------------------------------------
# Against the reference: the same page decisions, step by step
# ---------------------------------------------------------------------------

def test_page_decisions_equal_the_reference_step_by_step():
    """A shared-prefix trace (a donor, a full-page share, a copy-on-write
    partial page, a fully resident prompt, a stranger, under a pool small
    enough to stall and evict) through the reference engine and the port's
    in lock step: after every ``step()`` the same ``page_stats()`` and the
    same page table for every live lease; in the end the same greedy
    tokens."""
    cfg = ArchConfig(**TINY)
    jcfg = JaxArchConfig(**TINY)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    rng = np.random.default_rng(67)
    base = rng.integers(0, cfg.vocab_size, (9,)).astype(np.int32)
    tails = [[3, 5, 9], [1, 2], None, [8, 8, 8, 8], [3, 5, 9]]
    prompts = []
    for i, tail in enumerate(tails):
        if tail is None:                        # a stranger
            prompts.append(rng.integers(0, cfg.vocab_size, (7,)).astype(
                np.int32))
        elif i == 3:                            # shares 6 of 9: CoW
            prompts.append(np.concatenate([base[:6], tail]).astype(np.int32))
        else:
            prompts.append(np.concatenate([base, tail]).astype(np.int32))
    arrivals = [0, 5, 6, 6, 9]
    kw = dict(max_slots=2, max_len=16, prefill_chunk=4, track_stats=True,
              kv_layout="paged", page_size=4, num_pages=6, prefix_cache=True)
    jeng = JaxEngine(jcfg, JaxEngineConfig(policy=JaxPolicy(scheme="kahan"),
                                           **kw),
                     model=jmodel, params=jparams)
    eng = InferenceEngine(cfg, EngineConfig(policy=Policy(scheme="kahan"),
                                            **kw),
                          model=build_model(cfg, CPU), params=params)
    jreqs = [JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=3),
                        request_id=i) for i, p in enumerate(prompts)]
    reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=3),
                    request_id=i) for i, p in enumerate(prompts)]
    jout, out = {}, {}
    steps = 0
    for (jt, _), (t, _) in zip(jeng.stream(jreqs, arrivals, _sink=jout),
                               eng.stream(reqs, arrivals, _sink=out)):
        steps += 1
        assert jt == t
        assert eng.page_stats() == jeng.page_stats(), t
        assert sorted(eng._leases) == sorted(jeng._leases), t
        for rid, lease in eng._leases.items():
            want = jeng._leases[rid]
            np.testing.assert_array_equal(lease.table, want.table)
            assert (lease.n_pages, lease.own, lease.resume) == (
                want.n_pages, want.own, want.resume)
    assert not eng.scheduler.busy and not jeng.scheduler.busy
    st = eng.page_stats()
    assert st["prefix_hit_tokens"] > 0 and st["page_stalls"] > 0, st
    assert st["free_pages"] + st["prefix_pages"] == st["num_pages"]
    for rid in range(len(prompts)):
        assert out[rid].tokens == jout[rid].tokens, rid
    assert steps > 9
