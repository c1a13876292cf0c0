"""The yardstick against counts made by hand: the union of device
intervals, the FLOPs of a step, the least time of the projections and of
the norm, and each per-layer metric's reader on a made-up trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench_smoke import ROOT  # noqa: F401  (puts the checkout on the path)

from portbench.harness import yardstick
from portbench.harness.files import Files
from portbench.reference import dense, mla_moe

TINY_DENSE = {"hidden_size": 8, "num_attention_heads": 2,
              "num_key_value_heads": 1, "intermediate_size": 16,
              "num_hidden_layers": 3, "vocab_size": 10,
              "tie_word_embeddings": True, "rope_theta": 10000.0,
              "port": {"fields": {"norm": "layernorm_np",
                                  "param_dtype": "bfloat16"}}}
TINY_MOE = {"hidden_size": 8, "num_attention_heads": 2,
            "num_key_value_heads": 2, "intermediate_size": 12,
            "num_hidden_layers": 3, "vocab_size": 10,
            "tie_word_embeddings": False, "rope_theta": 10000.0,
            "kv_lora_rank": 4, "qk_rope_head_dim": 2, "qk_nope_head_dim": 6,
            "v_head_dim": 5, "n_routed_experts": 4, "num_experts_per_tok": 2,
            "moe_intermediate_size": 3, "n_shared_experts": 1,
            "first_k_dense_replace": 1, "rms_norm_eps": 1e-6,
            "port": {"fields": {"capacity_factor": 1.25,
                                "router_aux_coef": 0.001,
                                "param_dtype": "bfloat16"}}}
TRAFFIC = {"seq_len": 4, "global_batch": 6, "microbatches": 2}


def test_union_counts_overlaps_once():
    # [0, 10) and [5, 12) overlap; [20, 21) alone; [30, 40) holds [31, 33)
    ivs = [(5, 7), (0, 10), (20, 1), (30, 10), (31, 2)]
    assert yardstick.union_ns(ivs) == 12 + 1 + 10
    assert yardstick.union_ns([]) == 0


def test_gaps_and_top_operations():
    ev = [(0, 10, "a"), (5, 7, "b"), (20, 1, "c"), (30, 10, "a")]
    assert yardstick.gaps(ev) == [["c -> a", 9e-9], ["b -> c", 8e-9]]
    assert yardstick.by_name(ev) == [["a", 20e-9], ["b", 7e-9],
                                     ["c", 1e-9]]


def test_dense_step_flops_by_hand():
    # per token: q 8x8, k and v 8x4 each, o 8x8, gate/up 8x16, down 16x8,
    # three layers, and the tied head 8x10 over the real vocabulary
    per_layer = 64 + 32 + 32 + 64 + 128 + 128 + 128
    assert dense.active_weights(TINY_DENSE) == 3 * per_layer + 80
    # causal pairs of 4 positions: 10; q k^T and p v over dh 4, 2 heads
    assert dense.attention_flops(TINY_DENSE, 4) == 2 * 10 * 2 * 8 * 3
    want = 6 * (3 * per_layer + 80) * 24 + 3 * 2 * 10 * 2 * 8 * 3 * 6
    assert yardstick.step_flops(dense, TINY_DENSE, TRAFFIC) == want


def test_moe_step_flops_by_hand():
    # MLA: q 8x(2*8), latent 8x4, rope key 8x2, k and v expansions 4x12
    # and 4x10, o 10x8
    mla = 128 + 32 + 16 + 48 + 40 + 80
    # the dense layer's MLP 3x8x12; a MoE layer: router 8x4, 2 routed and
    # 1 shared expert of 3x8x3
    moe = 32 + 3 * 72
    assert mla_moe.active_weights(TINY_MOE) == (3 * mla + 288 + 2 * moe
                                                + 80)
    assert mla_moe.attention_flops(TINY_MOE, 4) == 2 * 10 * 2 * 13 * 3


def test_projection_least_time_by_hand():
    # one [M, K] x [K, N] at M 12 (3 rows of 4 tokens), bf16: bytes or
    # FLOPs, whichever is slower
    m = 12
    one = yardstick.matmul_least_s
    assert one(2, 3, 5, "bfloat16") == (2 * 5 + 5 * 3 + 2 * 3) * 2 / 3.35e12
    big = 2 * 4096 ** 3 / 989e12
    assert one(4096, 4096, 4096, "bfloat16") == big
    want = 0.0
    for k, n, cnt in dense.projections(TINY_DENSE):
        want += cnt * (one(m, n, k, "bfloat16") + one(m, k, n, "bfloat16")
                       + one(k, n, m, "bfloat16"))
    assert yardstick.projection_least_s(dense, TINY_DENSE, TRAFFIC,
                                        "bfloat16") == pytest.approx(2 * want)


def test_norm_bytes_count_the_leaves_of_two_axes():
    lay = mla_moe.layout(TINY_MOE)
    two = sum(4 * _numel(s[0]) for s in lay.values() if len(s[0]) >= 2)
    assert yardstick.norm_bytes(lay) == two
    assert two < 4 * sum(_numel(s[0]) for s in lay.values())


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _run(**kw):
    base = dict(steps=2, window_s=1.0, enqueue_s=[0.1, 0.3],
                events=[(0, 200_000_000, "gemm"),
                        (100_000_000, 200_000_000, "kahan_sq_columns<f>"),
                        (500_000_000, 100_000_000, "kahan_matmul_grid")],
                optimizer_events=[(0, 50_000_000, "x"),
                                  (10_000_000, 50_000_000, "y")],
                step_metrics=[{"dropped_frac": 0.03},
                              {"dropped_frac": 0.09}],
                moe_layers=3, cfg=TINY_DENSE, fam=dense, traffic=TRAFFIC,
                layout=dense.layout(TINY_DENSE), compute_dtype="bfloat16")
    base.update(kw)
    run = SimpleNamespace(**base)
    run.busy_s = lambda names=None: yardstick.union_ns(
        (s, d) for s, d, n in run.events
        if names is None or any(x in n for x in names)) / 1e9
    return run


def test_metric_readers_by_hand():
    files = Files()
    read = lambda name, run: files.metric(name).read(run)  # noqa: E731
    run = _run()
    # device busy 0-300 ms and 500-600 ms: 400 ms of a 1 s window
    assert read("device_idle_share", run) == pytest.approx(60.0)
    assert read("optimizer_ms", run) == pytest.approx(60.0)
    assert read("fwd_bwd_ms", run) == pytest.approx(200.0 - 60.0)
    assert read("enqueue_ms", run) == pytest.approx(200.0)
    assert read("moe_dropped_share", run) == pytest.approx(2.0)
    least = yardstick.norm_bytes(run.layout) / 3.35e12
    assert read("norm_roofline", run) == pytest.approx(100 * least / 0.1)
    least = yardstick.projection_least_s(dense, TINY_DENSE, TRAFFIC,
                                         "bfloat16")
    assert read("b5_roofline", run) == pytest.approx(100 * least / 0.05)
    flops = yardstick.step_flops(dense, TINY_DENSE, TRAFFIC)
    # 400 ms busy over 2 steps
    assert read("step_mfu", run) == pytest.approx(100 * flops / 0.2 / 989e12)


def test_readers_with_nothing_to_read_return_nothing():
    files = Files()
    run = _run(events=[], optimizer_events=[], moe_layers=0)
    for name in ("device_idle_share", "optimizer_ms", "fwd_bwd_ms",
                 "moe_dropped_share", "norm_roofline", "b5_roofline",
                 "step_mfu"):
        assert files.metric(name).read(run) is None, name
