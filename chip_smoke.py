#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
the port on the card, phase by phase; any failed phase raises and the
script exits non-zero. It exits non-zero before doing anything when
there is no CUDA device or no ``src/repro_torch`` beside it.

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   one ``nvcc`` per source, all started together.
2. Kernel parity. Reductions: for every built-in scheme x U in {1, 8} x
   {float32, float64, bfloat16}, the (s, c) grids of ``kahan_dot_grid``
   and ``kahan_sum_grid`` -- single and batched -- equal their plain
   PyTorch versions bit for bit, and a batched launch equals a loop of
   single ones: [3, n] for n up to 5 steps and for n spanning two full
   load rings of the one-row plan and a partial stage; at U = 8 batch 8
   over two of its rings and the serving shape [4, 57344]; the deep case
   again on operands one element off 16 bytes (the element-copy path).
   Both copy paths and the two-rings case are checked to have run in
   every wrapper; the plans covered are logged. Flash: for every
   built-in scheme x causal / not (B7) x q_groups in {1, 2}, at
   OLMo-1B's head dim with Sq and Skv off their blocks and Skv over 3
   k-blocks, at 4 and 48 head-rows, the raw (l, acc) grids of
   ``flash_accumulators`` (B7) and ``flash_chunk_accumulators`` (B8)
   equal their plain version bit for bit, and B8 rows at block-aligned
   offsets equal B7's rows bit for bit, also where B7 runs 64-row tiles
   and B8 16-row ones. Matmul: for every built-in scheme
   x {float32, float64}, with M, N and K padded by the engine (M 1 and 37,
   N 200, K 1100; and a K of 16 blocks), operands in bf16 and float32, the
   (s, c) grids of ``matmul_accumulators`` (B5) equal ``matmul_plain``
   bit for bit, bf16 operands equal the same operands promoted first,
   ``matmul_accumulators_batched`` (B6) equals its plain version and a
   loop of B5, the rows of an M = 64 product equal M = 1 products of the
   same rows, and the autograd backward of ``ops.matmul`` launches B5
   twice and equals B5 on (g, bT) and (aT, g). The M <= 8 path on
   unpadded rows: M in {1, 3, 8} x 1, 4 and 16 K-blocks x N a multiple of
   the CTA's 16 columns and not, for every scheme, float32 (bf16 and
   float32 operands) and float64, equal to ``matmul_plain`` bit for bit;
   operands whose rows are not 16-byte aligned (staged without cp.async);
   B6 at batch 4 and M 1 equal to a loop of B5. The M > 8 path: M in {9,
   32, 37, 64, 100, 300} x 1, 3, 4, 16 and 17 K-blocks x N 200, every
   scheme, float32 (bf16 and float32 operands) and float64, equal to
   ``matmul_plain`` bit for bit; B6 at batch 3 equal to a loop of B5; rows
   0, 8, 31 and M - 1 of M in {9, 64, 300} equal M = 1 products. The
   column scan of the compensated global norm (``kahan_sq_columns``)
   against its plain loop, bit for bit, on float32 and bf16 leaves
   (tall, one row, ragged rows and columns). Subnormals (the kernels
   are built with ``-ftz=true``; the plain versions flush op for op as
   XLA does on the CPU): every reduction wrapper for every scheme in
   float32 and bf16 on products and sums that underflow, on products a
   few ulps either side of ``tiny`` (x86 flushes (1 - 2^-24) tiny and
   keeps (1 - 2^-23) tiny (1 + 2^-23), and so must the card), and on
   bf16 subnormal operands into a float32 accumulate; B5 at M 3 and 37;
   B7 and B8 where ``exp`` underflows; the column scan; bit for bit.
3. Kernel times: each kernel at the shape its main path gives it (dot and
   sum at the paper's in-memory size n = 2^27 for every scheme, with each
   scheme's time over naive's, the paper's metric; batched dot and sum
   at [8, 2^24], the serving telemetry at [max_slots, 57344]; each with
   its plan, copy path, share of the bytes bound and the time of the
   kernel before its load ring; phase 7 prints the machine model beside
   each), B7 at
   OLMo-1B's head shape [16, 2048, 128] causal, B8 at the serving chunk
   [16, 64, 128] against both serve runs' cache lengths, B5 at OLMo-1B's
   projection shapes at decode (M 1, the served shape, and M 8 for
   comparison with the padded rows of earlier runs) and in a 64- and a
   32-token chunk plus the up projection of a 2048-token prefill, B6 at 4 chunk-sized q projections; each matmul
   and flash row with the tile (and cluster size or ring depth) the
   kernel chose and its share of the mul+add ceiling, 2·M·N·K or
   4·BH·Sq·Skv·dh over half the float32 fma rate; the flash rows also
   with the time of the 16-row kernel they replace), device time of
   launches captured in a CUDA graph (back-to-back launches timed with
   CUDA events beside the reductions and flash),
   beside its bound (bytes or float32 operations),
   its plain version's time and one PyTorch call computing the same
   function (``library_ms``, a yardstick the port never calls:
   ``scaled_dot_product_attention`` in float32 with the same mask for the
   flash kernels, ``torch.matmul`` / ``bmm`` on the operands promoted to
   float32, TF32 off, for the matmul kernels). The training rows: B5 at
   every shape and operand pair a train step gives it (forward and
   recompute bf16 x bf16, dA = g @ W^T float32 x bf16, dB = a^T @ g bf16
   x float32, 1024 tokens a microbatch; the engine copies and widens
   none), with the B5 time a step they add up to; B3 at the largest
   parameter leaf (2^28 float32); the column scan at the embedding's
   [51200, 2048] gradient and a [16, 2048, 8192] one
   (``torch.linalg.vecdot(x, x, dim=0)`` as its library call).
4. The main path's paths, each with every launch count set to 0 just
   before it and read just after it. Serving OLMo-1B at its published
   width (random bf16 weights from a seeded generator, dense KV,
   ``track_stats=True``, scheme kahan): the 4-request trace with chunked
   scan prefill, the same trace with ``kahan_attention=True,
   prefill_mode="flash"``, and one long request (1920-token prompt) under
   flash, and the same trace again with ``kahan_matmul=True`` as well
   (every dense projection through B5). Checked: every request emits its
   tokens, the telemetry is finite, the sum kernel launched once per
   decode tick and finished prefill, B8 exactly n_layers per chunk of
   width > 1 under flash and never under scan, B5 exactly 7 * n_layers
   per prefill chunk and decode position with ``kahan_matmul`` and never
   without it, no other kernel while serving, one tick's telemetry
   equals the plain version's bit for bit, and a 64-token chunk's logits
   with ``kahan_matmul`` are close to the flash run's (relative L2 below
   5e-2, the same argmax). One decode position is profiled with and
   without ``kahan_matmul`` (device kernels, cuBLAS gemm/gemv kernels).
   Entry points: the paper's ``ops.dot / asum / batched_dot /
   batched_asum`` once each, ``TransformerLM.prefill`` on a 2048-token
   prompt (B7 once per layer; its logits finite and close to the
   materialized attention path's), the ``flash_attention`` veneer once,
   ``ops.matmul`` at the 2048-token up projection and
   ``ops.batched_matmul`` once.
5. Solo vs interleaved: request 0 replayed alone emits bitwise the same
   tokens and telemetry, under scan, under flash and with
   ``kahan_matmul``.
6. Training: OLMo-1B at its published width and depth trained by the
   port's ``Trainer`` (random bf16 weights from seed 0, the synthetic
   Markov stream at seq 256 and global batch 8 in 2 microbatches, 4
   steps, warmup 1, KahanAdamW at lr ``TRAIN_LR``), twice, each with the
   launch counts reset just before it: run A (cuBLAS projections, the
   compensated tree norm through the column scan) and run B
   (``kahan_matmul``: every projection, its recompute and its backward
   on B5; ``kahan_norm=False``: B3 once a leaf). Checked: every loss and
   grad norm finite, the step-4 loss below the step-1 loss in both runs,
   run B's step-1 loss and grad norm within ``STEP1_LOSS_RTOL`` and
   ``STEP1_GRAD_NORM_RTOL`` of run A's, B5
   launched 4 * 7 * 16 * 2 = 896 times a step and B3 once a parameter
   leaf in run B, the column scan once a leaf in run A, nothing else;
   the tree norm as the kernel and as the plain loop on a tree of the
   gradients' shapes, every leaf's (s, c) bitwise equal; and at the
   smoke config, a run that crashes after step 2 resumes to step 4 with
   params and optimizer state bitwise equal to the uninterrupted run.
   Logged per run: wall ms a step after the first, tokens/s, device-busy
   ms of one more profiled step, peak memory, losses and grad norms, the
   port's kernels' ms and launches a step.
7. The paper on the card: B1 (dot) and B3 (sum) for every built-in
   scheme x U in {1, 2, 4, 8, 16}, each grid bitwise equal to its plain
   version at n = 2^22; each timed at n = 2^27 float32 (graph time)
   beside its bytes bound, its CTAs and SMs, its time over naive's at the
   same U, and the machine model's prediction and bounding term
   (``repro_torch.core.ecm``) on this card's load-only bandwidth
   (``torch.sum`` over 2^28 float32, a yardstick of the machine, not on
   the port's path) and clock under load, with one SM's load rate fitted
   on the naive dot at U = 1 alone; the saturation U predicted and
   measured (the least U within 5% of U = 16). Then the reference's
   accuracy ladder (GenDot at n = 2^20, conditions 1 and 10 and the
   reference's 1e4 to 1e12) through ``ops.dot`` on the card: every
   a-priori bound at every condition, kahan <= naive and pairwise <=
   1.01 naive where the achieved condition is below 1/eps (only the
   conditions 1 and 10 at this n), dot2 two digits below kahan at 1e10.
   Phase 3's B1-B4 rows beside the model of this run's machine. The
   model's error is printed, not gated. One JSON line ``{"ecm": [...],
   "phase3": [...], "ladder": [...]}``, a row per (op, scheme, U), per
   phase-3 row and per condition.
8. The distributed slice: two ranks share the card over gloo (NCCL
   refuses two ranks on one device), spawned with
   ``torch.multiprocessing`` over a ``FileStore`` under ``build/``.
   Each runs ``sharded_asum`` and ``sharded_dot`` at n = 2^27 (B3, B1 on
   its 2^26 block), ``sharded_matmul`` [1024, 2048] x [2048, 8192] with
   K split 2 (B5), ``activation_sq_norm`` at [4, 57344] on the
   batch-sharded mesh (B4, 2 requests a rank), ``deterministic_mean``
   and ``compressed_psum`` on a [2048, 8192] leaf, twice, then OLMo-1B
   at full width and depth on ``make_local_mesh()`` (phase 6's run A,
   2 steps, twice), its loss folded through ``sharded_asum``. Checked:
   every result the same bits on both ranks and in both runs, equal to
   the same kernels' per-shard grids folded here by
   ``merge_accumulators`` / ``merge_accumulator_grids`` and to the plain
   versions' sharded fold; B1, B3, B4 and B5 twice a rank; the
   trainer's loss the same bits on both ranks and run to run, equal to
   the sharded fold of its microbatch losses recomputed here, within
   1e-6 (relative) of their local Kahan fold, B3 once a step. Logged:
   the gather's µs a call, the sharded sum's ms beside B3's alone, each
   rank's peak memory, the phase's seconds.

The last three lines are the card (``nvidia-smi`` name and power
limit), one JSON object ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. The kernels line has one row per
kernel and path it runs on (``"path"``: "entry", "serve" for the scan
trace, "serve-flash" for the same trace under flash, "serve-matmul" for
it with ``kahan_matmul`` too, "serve-long" for the long request,
"train-a" and "train-b" for the two training runs, "sharded" for phase
8's sharded calls and "sharded-train" for its trainer, both rank 0's
counts): its ``launches`` are that path's count and its times were
taken at that path's shape (B5 on "serve-matmul": the decode q/k/v/o
shape at M 1, the one launched most; on "train-b" the up projection's
forward at 1024 tokens; B3 on "train-b" the largest leaf; the column
scan on "train-a" and "sharded-train" the embedding's gradient; on
"sharded" one rank's block, requests or K-slice; B3 on "sharded-train"
the loss fold's one element a rank, padded to one block).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TRACE = "0:64:16,0:128:16,2:32:16,5:96:16"
LONG_TRACE = "0:1920:64"
PAPER_N = 1 << 27
PREFILL_LEN = 2048          # OLMo-1B's published context
LIBRARIES = ("kahan_reduce", "kahan_flash", "kahan_matmul")
#: dense projections per layer with kahan_matmul (q, k, v, o, gate, up,
#: down), each one B5 launch per prefill chunk and per decode position
PROJECTIONS = 7


#: phase 6: OLMo-1B trained at the reference launcher's defaults (seq
#: 256, global batch 8) in 2 microbatches, 4 steps, warmup 1
TRAIN_STEPS = 4
TRAIN_SEQ = 256
TRAIN_BATCH = 8
TRAIN_MICRO = 2
#: the learning rate of both runs. With warmup 1 the first update runs
#: at rate 0 (warmup_cosine(0, warmup=1) is 0) and the next three at the
#: full rate, cosine-decayed; the launcher's 3e-4 there makes the second
#: update, the first that moves, a step of about the rate on every weight
#: (Adam's first ratios are near +-1), and the loss jumps: in the JAX
#: reference too, which the port follows step for step at full width
#: (tests/test_torch_train.py::test_full_width_at_lr_3e4_follows_the_reference).
#: The launcher's own warmup of 20 steps runs steps 2-4 at 1.5e-5 to
#: 4.5e-5; this rate is of that order
TRAIN_LR = 1e-5
#: run B's (kahan_matmul) step-1 loss and grad norm against run A's, same
#: params and batch, relative: bf16 activations rounded from two float32
#: products (cuBLAS's and B5's) of 16 layers, and two compensated norms
#: (the tree norm and B3's fold). Measured on an H100 at 700 W: 1.29e-5
#: and 7.2e-5; the grad norm is where B5's backward (dA, dB) shows
STEP1_LOSS_RTOL = 1e-4
STEP1_GRAD_NORM_RTOL = 5e-4

#: phase 7: the sweep's parity length (the plain loop at U = 1 and the
#: paper's n would take minutes), a row's time "within" its time at the
#: largest U (the measured saturation U), the load-only bandwidth's length,
#: and the accuracy ladder at the largest power of two whose GenDot draws
#: take at most about 20 s on the host: 2^20 (2^21 takes about twice as
#: long). The ladder is the reference's conditions (tests/test_schemes.py,
#: 1e4 to 1e12) below two more, 1 and 10: GenDot's achieved condition
#: grows with n, and at 2^20 only these two stay below 1/eps (about 3e6
#: and 7e6; 1e4 achieves 2e9), where the orderings can be gated
SWEEP_PARITY_N = 1 << 22
SATURATED_WITHIN = 0.05
LOAD_ONLY_N = 1 << 28
LADDER_N = 1 << 20
LADDER_CONDS = (1e0, 1e1, 1e4, 1e6, 1e8, 1e10, 1e12)

#: phase 8: the sharded slice on two gloo ranks sharing the one card:
#: asum and dot at the paper's n (2^26 a rank), a matmul with K split 2,
#: the serving telemetry's shape (2 requests a rank), a [2048, 8192]
#: leaf through the compressed all-reduce, and OLMo-1B trained on the
#: mesh (phase 6's run A, 2 steps, twice)
DIST_RANKS = 2
DIST_N = 1 << 27
DIST_MATMUL = (1024, 2048, 8192)
DIST_ACT = (4, 57344)
DIST_LEAF = (2048, 8192)
DIST_TRAIN_STEPS = 2

#: the schemes with a device function, and the reduction wrappers
SCHEMES = ("naive", "kahan", "pairwise", "dot2")
REDUCTIONS = ("dot_accumulators", "dot_accumulators_batched",
              "sum_accumulators", "sum_accumulators_batched")

#: device ms of the reduction rows (phase 3, graph-timed) for the kernel
#: before its load ring (one 128-thread CTA a row of cells, 8 steps of
#: loads drained before each chain burst), keyed (wrapper, scheme or
#: label), taken by this script's phase 3 on an NVIDIA H100 80GB HBM3 at
#: 700 W; logged beside each new time
REDUCE_BEFORE_MS = {
    ("dot_accumulators", "naive"): 1.4104,
    ("dot_accumulators", "kahan"): 1.4400,
    ("dot_accumulators", "pairwise"): 1.3799,
    ("dot_accumulators", "dot2"): 1.9964,
    ("sum_accumulators", "naive"): 0.5636,
    ("sum_accumulators", "kahan"): 0.6671,
    ("sum_accumulators", "pairwise"): 0.5691,
    ("sum_accumulators", "dot2"): 1.0572,
    ("dot_accumulators_batched", "kahan"): 0.3664,
    ("sum_accumulators_batched", "kahan"): 0.1794,
    ("sum_accumulators_batched", "serve"): 0.0022,
}

#: device ms of the flash rows (B7 entry, B8 serve, B8 serve-long) for
#: the kernel before its register-tiled redesign (16 query rows a CTA,
#: scalar synchronous staging), taken by this script's graph timing on an
#: NVIDIA H100 80GB HBM3 at 700 W; logged beside each new time
FLASH_BEFORE_MS = {"entry": 7.2962, "serve": 0.0952, "serve-long": 0.8863}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card and the build ------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    log(f"# card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_build.build, LIBRARIES))
    for name in LIBRARIES:
        _build.library(name)
    log(f"# phase 1: built {', '.join(f'{n}.cu' for n in LIBRARIES)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")

    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    kernels = Kernels(torch, dev)
    kernels.parity()
    kernels.flash_parity(cfg.head_dim)
    kernels.times(PAPER_N)
    kernels.flash_times(cfg, PREFILL_LEN, serve_max_len(TRACE),
                        serve_max_len(LONG_TRACE))
    kernels.matmul_parity()
    kernels.matmul_times(cfg, PREFILL_LEN)
    kernels.column_parity()
    kernels.subnormal_parity()
    kernels.train_times(cfg, TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ)
    serve_stats = main_path(torch, kernels, cfg, PAPER_N)
    log(json.dumps({"serve": serve_stats}))
    train_stats = train_path(torch, kernels, cfg)
    train_stats["b5_rows_per_step"] = kernels.train_b5
    log(json.dumps({"train": train_stats}))
    log(json.dumps(paper_path(torch, kernels, card)))
    log(json.dumps({"dist": dist_path(torch, kernels, dist_spec(cfg))}))
    log(card)
    log(json.dumps({"kernels": kernels.rows()}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_max_len(trace: str) -> int:
    """The per-slot cache length a trace is served with (prompt + new
    tokens of its longest request), as the launcher fits it."""
    from repro_torch.launch.serve import parse_trace

    return max(p + n for _, p, n, _ in parse_trace(trace, 0.0))


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events,
    after warm-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, launches: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of ``fn()``: ``launches`` calls captured
    in one CUDA graph (after warm-up), replayed ``replays`` times between
    CUDA events. For kernels shorter than their wrapper's enqueue on the
    host, where back-to-back calls would time the host."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def clock_under_load(torch, fn, launches: int = 20, replays: int = 300):
    """The card's SM clock (MHz) and power draw (W), as ``nvidia-smi``
    reads them while ``replays`` replays of ``launches`` captured calls of
    ``fn()`` run (enqueued first, so the sample falls inside them)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    for _ in range(replays):
        graph.replay()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    torch.cuda.synchronize()
    mhz, watts = (float(v) for v in out.split(","))
    return mhz, watts


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) for ``n_bytes`` moved once and
    ``n_ops`` float32 operations on the H100: its published HBM rate and
    float32 peak, as the machine model (``repro_torch.core.ecm.H100``)
    holds them."""
    from repro_torch.core.ecm import H100

    bytes_ms = n_bytes / (H100.hbm_gbs * 1e6)
    ops_ms = n_ops / (H100.fp32_tflops * 1e9)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def fma_ceiling_ms(flops: float) -> float:
    """``flops`` at half the float32 peak: the mul+add ceiling of a chain
    that may not fuse its products (no fma, no tensor cores)."""
    from repro_torch.core.ecm import H100

    return flops / (H100.fp32_tflops / 2 * 1e9)


class Kernels:
    """Phases 2 and 3, and the JSON rows of the six wrappers."""

    def __init__(self, torch, dev):
        from repro_torch.kernels import (engine, flash_attention, kahan_dot,
                                         kahan_matmul, kahan_sum, schemes)

        self.torch = torch
        self.dev = dev
        self.engine, self.kd, self.ks, self.schemes = (engine, kahan_dot,
                                                       kahan_sum, schemes)
        self.fa = flash_attention
        self.km = kahan_matmul
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.err = {name: 0.0 for name in engine.WRAPPERS}
        self.timing = {}

    def data(self, shape, dtype):
        torch = self.torch
        x = torch.randn(shape, generator=self.gen, device=self.dev,
                        dtype=torch.float64)
        e = torch.randint(-8, 8, shape, generator=self.gen, device=self.dev)
        return (x * torch.exp2(e.double())).to(dtype)

    def normal(self, shape):
        return self.torch.randn(shape, generator=self.gen, device=self.dev)

    def compare(self, name, got, want, what):
        torch = self.torch
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{name} {what}: kernel != plain")
            d = (g.double() - w.double()).abs().max().item()
            self.err[name] = max(self.err[name], d)

    # -- 2. parity ------------------------------------------------------------
    def parity(self):
        """The four reduction wrappers against their plain versions,
        bitwise, for every built-in scheme x U in {1, 8} x {float32,
        float64, bfloat16}: [3, n] for n in 1, 8192 + 5, 3 * 8192 + 37, 5 *
        8192 (padded by the engine) and n spanning two full load rings of
        the one-row plan and a partial stage; at U = 8 also batch 8 over
        two of its rings and the serving shape [4, 57344] (7 steps, one
        partial stage); the deep [3, n] case again on operands one element
        off 16 bytes (views of a larger buffer: the element-copy path). Every
        row of a batched launch equals a single launch of that row, which
        is the batch-1 case."""
        torch = self.torch
        kd, ks = self.kd, self.ks
        seen = {name: set() for name in REDUCTIONS}
        cases = 0
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            for name in SCHEMES:
                sch = self.schemes.get(name)
                for unroll in (1, 8):
                    eng = self.engine.CompensatedReduction(
                        scheme=sch, unroll=unroll, compute_dtype=dtype)
                    cells = 1024 * unroll
                    deep = self.ring_n(1, cells, dtype)
                    shapes = [(3, n) for n in (1, 8192 + 5, 3 * 8192 + 37,
                                               5 * 8192, deep)]
                    if unroll == 8:
                        shapes += [(8, self.ring_n(8, cells, dtype)),
                                   (4, 57344)]
                    for batch, n in shapes:
                        what = f"{name} U={unroll} {dtype} [{batch}, {n}]"
                        a = self.data((batch, n), dtype)
                        b = self.data((batch, n), dtype)
                        ap, bp = eng._prep2d(a), eng._prep2d(b)
                        kw = dict(scheme=sch, unroll=unroll)
                        plain = (kd.dot_plain(ap, bp, **kw),
                                 ks.sum_plain(ap, **kw))
                        self.reduction_case(ap, bp, plain, kw, what, seen)
                        cases += 1
                        if n == deep:
                            self.reduction_case(
                                self.off16(ap), self.off16(bp), plain, kw,
                                f"{what}, one element off 16 bytes", seen)
                            cases += 1
        sync(torch, self.dev)
        for wrapper, runs in seen.items():
            paths = {copy for _, copy, _ in runs}
            check(paths == {"cp.async", "element"},
                  f"{wrapper}: the cp.async and the element-copy paths did "
                  f"not both run ({sorted(paths)})")
            check(any(rings for _, _, rings in runs),
                  f"{wrapper}: no case spanned two full rings and a partial "
                  f"stage")
        plans = sorted({plan for runs in seen.values()
                        for plan, _, _ in runs})
        log(f"# phase 2: {cases} reduction parity cases x 4 wrappers bitwise "
            f"equal to their plain versions; batched == loop of single "
            f"launches; 16-byte and element copies both ran in every "
            f"wrapper, and each spanned two full rings and a partial stage; "
            f"{len(plans)} plans (chains, depth, stages, shared bytes): "
            f"{plans}")

    def ring_n(self, batch, cells, dtype):
        """A row length spanning two full load rings and a partial stage of
        the sum kernel's plan for ``batch`` rows (the dot's ring holds no
        more steps)."""
        itemsize = self.torch.empty((), dtype=dtype).element_size()
        sms = (self.torch.cuda.get_device_properties(
            self.dev).multi_processor_count if self.dev.type == "cuda"
            else 132)
        _, depth, stages, _ = self.kd.reduce_plan(batch, cells, 1 << 30,
                                                  itemsize, 1, sms)
        return (2 * stages * depth + 3) * cells

    def off16(self, x):
        """A copy of ``x`` as a view one element into a larger buffer: the
        same values, not 16-byte aligned."""
        buf = self.torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    def reduction_case(self, ap, bp, plain, kw, what, seen):
        """Single launches of every row and one batched launch of the dot
        and the sum against ``plain`` (the plain versions' grids), and
        batched == the loop; notes each launch's plan, copy path and
        whether it spanned two full rings and a partial stage."""
        torch = self.torch
        kd, ks = self.kd, self.ks
        batch, n = ap.shape
        steps = n // (1024 * kw["unroll"])
        kernels = (
            ("dot_accumulators", "dot_accumulators_batched",
             lambda i: kd.dot_accumulators(ap[i], bp[i], **kw),
             lambda: kd.dot_accumulators_batched(ap, bp, **kw), plain[0]),
            ("sum_accumulators", "sum_accumulators_batched",
             lambda i: ks.sum_accumulators(ap[i], **kw),
             lambda: ks.sum_accumulators_batched(ap, **kw), plain[1]))
        for one, many, single_fn, batched_fn, want in kernels:
            single = []
            for i in range(batch):
                single.append(single_fn(i))
                self.note_plan(one, steps, seen)
                self.compare(one, single[i], (want[0][i], want[1][i]), what)
            batched = batched_fn()
            self.note_plan(many, steps, seen)
            self.compare(many, batched, want, what)
            check(all(torch.equal(batched[0][i], single[i][0])
                      and torch.equal(batched[1][i], single[i][1])
                      for i in range(batch)),
                  f"batched {one} != loop of single launches ({what})")

    def note_plan(self, name, steps, seen):
        fn = self.engine.WRAPPERS[name]
        _, depth, stages, _ = fn.plan
        rings = steps > 2 * stages * depth and steps % depth != 0
        seen[name].add((fn.plan, fn.copy, rings))

    def flash_parity(self, dh: int):
        """B7 and B8 against their plain version, bitwise: Sq = 300 and
        Skv = 600 (blocks 256: Sq padded to 512, Skv to 768 = 3 k-blocks,
        60 padded keys masked), every built-in scheme, q_groups 1 and 2,
        at BH 4 (B7 in 16-row tiles) and BH 48 (B7 in 64-row tiles, B8's
        64-row chunks in 16-row tiles: rows equal across tile heights)."""
        torch, fa = self.torch, self.fa
        sq, skv, bk = 300, 600, 256
        cases = 0
        plans = set()
        for bh, groups in ((4, 1), (4, 2), (48, 1), (48, 2)):
            eng = self.engine.CompensatedReduction(scheme="kahan")
            q, k, v, bq, bk, _, _ = eng._flash_prep(
                "flash_parity", self.normal((bh, sq, dh)),
                self.normal((bh // groups, skv, dh)),
                self.normal((bh // groups, skv, dh)), 256, bk, groups)
            for name in ("naive", "kahan", "pairwise", "dot2"):
                sch = self.schemes.get(name)
                kw = dict(block_q=bq, block_k=bk, scheme=sch, kv_len=skv,
                          q_groups=groups)
                for causal in (True, False):
                    what = f"{name} causal={causal} G={groups}"
                    got = fa.flash_accumulators(q, k, v, causal=causal, **kw)
                    want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk,
                                          kv_len=skv, causal=causal,
                                          q_groups=groups)
                    self.compare("flash_accumulators", got, want, what)
                    cases += 1
                full = fa.flash_accumulators(q, k, v, causal=True, **kw)
                full_rows = fa.flash_accumulators.plan[0]
                for off in (0, 64, 256):
                    w = 64
                    qc = q[:, off:off + w].contiguous()
                    kwc = dict(kw, block_q=w)
                    got = fa.flash_chunk_accumulators(qc, k, v, off, **kwc)
                    want = fa.flash_plain(qc, k, v, scheme=sch, block_k=bk,
                                          kv_len=skv, causal=True, q_off=off,
                                          q_groups=groups)
                    self.compare("flash_chunk_accumulators", got, want,
                                 f"{name} G={groups} q_off={off}")
                    check(all(torch.equal(g, f[:, off:off + w])
                              for g, f in zip(got, full)),
                          f"B8 rows at q_off={off} != B7 rows ({name}, "
                          f"G={groups})")
                    plans.add((bh, full_rows,
                               fa.flash_chunk_accumulators.plan[0]))
                    cases += 1
        sync(torch, self.dev)
        check((48, 64, 16) in plans, f"no parity case ran B7 in 64-row "
              f"tiles beside B8 in 16-row tiles: (BH, B7 rows, B8 rows) "
              f"{sorted(plans)}")
        log(f"# phase 2: {cases} flash parity cases (dh={dh}, Sq={sq}, "
            f"Skv={skv}, block_k={bk}, BH 4 and 48) bitwise equal to the "
            f"plain version; B8 rows at aligned offsets == B7 rows, bitwise "
            f"((BH, B7 tile rows, B8 tile rows): {sorted(plans)})")

    # -- 3. times -------------------------------------------------------------
    def time_one(self, name, scheme, args, plain_fn, library_fn, reps=20,
                 label=None):
        """Kernel / plain / library times of one wrapper on padded
        float32 inputs, plus the kernel-vs-plain check at this shape. The
        kernel and library times are device times of launches captured in
        a CUDA graph; back-to-back launches timed with events beside
        them."""
        torch = self.torch
        sch = self.schemes.get(scheme)
        wrapper = self.engine.WRAPPERS[name]
        kernel = lambda: wrapper(*args, scheme=sch, unroll=8)  # noqa: E731
        got = kernel()
        sync(torch, self.dev)
        t0 = time.perf_counter()
        want = plain_fn(sch)
        sync(torch, self.dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        self.compare(name, got, want, f"{scheme} at {tuple(args[0].shape)}")
        grid_bytes = 2 * got[0].numel() * got[0].element_size()
        del got, want
        ms = graph_ms(torch, kernel, reps)
        events_ms = cuda_ms(torch, kernel, reps)
        library_ms = graph_ms(torch, library_fn, reps)
        numel = sum(a.numel() for a in args)
        n_elem = args[0].numel()
        in_bytes = numel * args[0].element_size()
        mix = sch.instruction_mix
        ops = n_elem * (mix.flops if name.startswith("dot") else mix.adds)
        least, by = bound_ms(in_bytes + grid_bytes, ops)
        key = (name, label or scheme)
        before = REDUCE_BEFORE_MS.get(key)
        row = {"ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": least, "bound_by": by,
               "bound_share": least / ms, "before_ms": before,
               "plan": getattr(wrapper, "plan", None),
               "copy": getattr(wrapper, "copy", None),
               "shape": list(args[0].shape), "scheme": scheme,
               "gbytes_per_s": (in_bytes + grid_bytes) / ms / 1e6}
        self.timing[key] = row
        was = f"; before the ring {before:.4f}" if before else ""
        log(f"# {name} {label or scheme} {row['shape']}: kernel {ms:.4f} ms "
            f"device ({events_ms:.4f} back to back{was}; "
            f"{row['gbytes_per_s']:.0f} GB/s), {by} bound {least:.4f} ms "
            f"({100 * least / ms:.1f}%), plan {row['plan']} "
            f"{row['copy']}, plain "
            f"{plain_ms:.1f} ms, library {library_ms:.4f} ms "
            f"(events {cuda_ms(torch, library_fn, reps):.4f})")

    def times(self, paper_n):
        """Dot and sum at ``paper_n`` for every scheme, with the kahan /
        naive ratio (the paper's metric); the batched wrappers at [8,
        paper_n / 8]; the serving telemetry's launch."""
        torch = self.torch
        kd, ks = self.kd, self.ks
        f32 = torch.float32
        a = self.data((paper_n,), f32)
        b = self.data((paper_n,), f32)
        for scheme in SCHEMES:
            self.time_one(
                "dot_accumulators", scheme, (a, b),
                lambda s: [t[0] for t in kd.dot_plain(a[None], b[None],
                                                       scheme=s)],
                lambda: torch.dot(a, b))
            self.time_one(
                "sum_accumulators", scheme, (a,),
                lambda s: [t[0] for t in ks.sum_plain(a[None], scheme=s)],
                lambda: torch.sum(a))
        # the chain floor depends on the clock: sample it under the sum
        sch = self.schemes.get("kahan")
        mhz, watts = clock_under_load(
            torch, lambda: ks.sum_accumulators(a, scheme=sch))
        self.reduce_clock = {"sm_mhz": mhz, "power_w": watts}
        steps = paper_n // 8192
        for name in ("dot_accumulators", "sum_accumulators"):
            ms = {sch: self.timing[(name, sch)]["ms"] for sch in SCHEMES}
            log(f"# {name} [{paper_n}] over naive: "
                + ", ".join(f"{sch} {ms[sch] / ms['naive']:.3f}"
                            for sch in SCHEMES)
                + "; cycles a chain step at the sampled clock: "
                + ", ".join(f"{sch} {ms[sch] * mhz * 1e3 / steps:.1f}"
                            for sch in SCHEMES))
        log(f"# reductions: SM clock {mhz:.0f} MHz, {watts:.1f} W under the "
            f"kahan sum at [{paper_n}]")
        a2, b2 = a.view(8, -1), b.view(8, -1)
        self.time_one("dot_accumulators_batched", "kahan", (a2, b2),
                      lambda s: kd.dot_plain(a2, b2, scheme=s),
                      lambda: torch.linalg.vecdot(a2, b2))
        self.time_one("sum_accumulators_batched", "kahan", (a2,),
                      lambda s: ks.sum_plain(a2, scheme=s),
                      lambda: torch.sum(a2, dim=1))
        # the serving telemetry's launch: [max_slots, 50304] squared logits,
        # padded to 7 * 8192
        x = self.data((4, 57344), f32)
        self.time_one("sum_accumulators_batched", "kahan", (x,),
                      lambda s: ks.sum_plain(x, scheme=s),
                      lambda: torch.sum(x, dim=1), reps=200, label="serve")
        del a, b, a2, b2

    def time_flash(self, name, label, q, k, v, q_off, reps):
        """One flash wrapper (scheme kahan) at the engine's padded shapes
        for q [BH, Sq, dh] and the cache k/v [BH, Skv, dh]: kernel, plain
        and library (float32 ``scaled_dot_product_attention``, the same
        causal mask on absolute positions) times, and the parity check."""
        torch, fa = self.torch, self.fa
        F = torch.nn.functional
        sch = self.schemes.get("kahan")
        bh, sq, dh = q.shape
        skv = k.shape[1]
        eng = self.engine.CompensatedReduction(scheme=sch)
        qp, kp, vp, bq, bk, _, _ = eng._flash_prep(name, q, k, v, 256, 256, 1)
        kw = dict(block_q=bq, block_k=bk, scheme=sch, kv_len=skv)
        if name == "flash_accumulators":
            kernel = lambda: fa.flash_accumulators(  # noqa: E731
                qp, kp, vp, causal=True, **kw)
        else:
            kernel = lambda: fa.flash_chunk_accumulators(  # noqa: E731
                qp, kp, vp, q_off, **kw)
        got = kernel()
        sync(torch, self.dev)
        t0 = time.perf_counter()
        want = fa.flash_plain(qp, kp, vp, scheme=sch, block_k=bk, kv_len=skv,
                              causal=True, q_off=q_off)
        sync(torch, self.dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        self.compare(name, got, want, f"kahan at {label} {tuple(q.shape)}")
        del got, want
        # device time (launches captured in a CUDA graph: a 64-row B8
        # launch is about as short as its wrapper's host enqueue) and,
        # beside it, back-to-back launches timed with events
        ms = graph_ms(torch, kernel, reps)
        events_ms = cuda_ms(torch, kernel, reps)
        mask = ((q_off + torch.arange(sq, device=self.dev))[:, None]
                >= torch.arange(skv, device=self.dev)[None, :])
        library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask), reps)
        sq_pad, skv_pad = qp.shape[1], kp.shape[1]
        flops = 4 * bh * sq_pad * skv_pad * dh
        n_bytes = 4 * (qp.numel() + kp.numel() + vp.numel()
                       + 2 * (bh * sq_pad + qp.numel()))
        least, by = bound_ms(n_bytes, flops)
        # the fixed chains' own ceiling: a separate rounded multiply and
        # add per term, at half the fma rate
        ceiling = fma_ceiling_ms(flops)
        rows, smem = getattr(fa, name).plan
        row = {"ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": least, "bound_by": by,
               "mul_add_ceiling_ms": ceiling, "ceiling_share": ceiling / ms,
               "tile_rows": rows, "ring_stages": fa.RING_STAGES,
               "smem_bytes": smem,
               "before_ms": FLASH_BEFORE_MS[label],
               "shape": [bh, sq, dh], "skv": skv, "scheme": "kahan",
               "tflops": flops / ms / 1e9}
        self.timing[(name, label)] = row
        log(f"# {name} {label} q {[bh, sq, dh]} kv {skv}: kernel {ms:.4f} ms "
            f"device ({events_ms:.4f} back to back; {row['tflops']:.2f} "
            f"TFLOP/s fp32; 16-row kernel before the redesign "
            f"{FLASH_BEFORE_MS[label]:.4f}), {by} bound {least:.4f} ms, "
            f"mul+add ceiling {ceiling:.4f} ms ({100 * ceiling / ms:.1f}%), "
            f"tile {rows} rows, {fa.RING_STAGES}-stage ring, {smem} B "
            f"shared, plain {plain_ms:.1f} ms, library (sdpa f32) "
            f"{library_ms:.4f} ms")

    def flash_times(self, cfg, prefill_len, serve_len, long_len):
        """B7 at the entry path's shape (every head of a 2048-token
        prefill), B8 at the serving chunk against each serve run's
        cache."""
        h, dh = cfg.n_heads, cfg.head_dim
        self.time_flash("flash_accumulators", "entry",
                        self.normal((h, prefill_len, dh)),
                        self.normal((h, prefill_len, dh)),
                        self.normal((h, prefill_len, dh)), 0, reps=10)
        for label, length in (("serve", serve_len), ("serve-long", long_len)):
            # the last full chunk of a prompt that fills the cache
            off = (length - 64) // 64 * 64
            self.time_flash("flash_chunk_accumulators", label,
                            self.normal((h, 64, dh)),
                            self.normal((h, length, dh)),
                            self.normal((h, length, dh)), off, reps=50)

    # -- matmul (B5, B6) -------------------------------------------------------
    def matmul_parity(self):
        """B5 and B6 against ``matmul_plain``, bitwise, at shapes the
        engine pads (see the module docstring, phase 2)."""
        torch, km = self.torch, self.km
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        cases = 0
        for dtype in (f32, f64):
            for name in ("naive", "kahan", "pairwise", "dot2"):
                eng = self.engine.CompensatedReduction(scheme=name,
                                                       compute_dtype=dtype)
                for m, k, n in ((1, 1100, 200), (37, 1100, 200),
                                (8, 8192, 256)):
                    for odt in ((f32, bf16) if dtype == f32 else (f64,)):
                        what = f"{name} {dtype} operands {odt} {m}x{k}x{n}"
                        a = self.normal((m, k)).to(odt)
                        b = self.normal((k, n)).to(odt)
                        blocks = eng._matmul_blocks(m, n, k, None, None, None)
                        ap, bp = eng._prep_matmul(a, b, blocks)
                        check(ap.dtype == bp.dtype == odt,
                              f"the engine copied {odt} operands ({what})")
                        kw = dict(scheme=eng.scheme, block_m=blocks[0],
                                  block_n=blocks[1], block_k=blocks[2],
                                  compute_dtype=dtype)
                        got = km.matmul_accumulators(ap, bp, **kw)
                        want = km.matmul_plain(ap[None], bp[None],
                                               scheme=eng.scheme,
                                               block_k=blocks[2],
                                               compute_dtype=dtype)
                        self.compare("matmul_accumulators", got,
                                     (want[0][0], want[1][0]), what)
                        if odt == bf16:
                            promoted = km.matmul_accumulators(
                                ap.float(), bp.float(), **kw)
                            check(all(torch.equal(g, p) for g, p in
                                      zip(got, promoted)),
                                  f"bf16 operands != promoted first ({what})")
                        cases += 1
                # B6 against its plain version and a loop of B5
                a = self.normal((3, 37, 1100)).to(dtype)
                b = self.normal((3, 1100, 200)).to(dtype)
                blocks = eng._matmul_blocks(37, 200, 1100, None, None, None)
                ap, bp = eng._prep_matmul(a, b, blocks)
                kw = dict(scheme=eng.scheme, block_m=blocks[0],
                          block_n=blocks[1], block_k=blocks[2],
                          compute_dtype=dtype)
                got = km.matmul_accumulators_batched(ap, bp, **kw)
                want = km.matmul_plain(ap, bp, scheme=eng.scheme,
                                       block_k=blocks[2], compute_dtype=dtype)
                self.compare("matmul_accumulators_batched", got, want,
                             f"{name} {dtype} [3, 37, 1100] x [3, 1100, 200]")
                for i in range(3):
                    one = km.matmul_accumulators(ap[i], bp[i], **kw)
                    check(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                          f"B6 != a loop of B5 ({name}, {dtype})")
                # rows of an M = 64 product == M = 1 products (both tiles)
                a = self.normal((64, 2048)).to(dtype)
                b = self.normal((2048, 512)).to(dtype)
                full = eng.matmul(a, b)
                for r in (0, 31, 63):
                    check(torch.equal(eng.matmul(a[r:r + 1], b),
                                      full[r:r + 1]),
                          f"row {r} of an M = 64 product != its M = 1 product "
                          f"({name}, {dtype})")
                cases += 2
        cases += self.matmul_backward()
        cases += self.matmul_rows_parity()
        cases += self.matmul_grid_parity()
        sync(torch, self.dev)
        log(f"# phase 2: {cases} matmul parity cases bitwise equal to the "
            f"plain version (B5, B6); bf16 operands == promoted first; B6 == "
            f"a loop of B5; rows invariant to M; backward == B5 on (g, bT) "
            f"and (aT, g), 2 launches; the M <= 8 path on unpadded rows; "
            f"the M > 8 tiles (TM 32, 64, 128) over 1-17 K-blocks split "
            f"over clusters")

    def matmul_grid_parity(self):
        """The M > 8 path against ``matmul_plain``, bitwise: M in {9, 32,
        37, 64, 100, 300} (every tile height, masked rows) x 1, 3, 4, 16
        and 17 K-blocks of 128 (cluster splits that do and do not divide
        the K-blocks, and more rounds than ranks) x N = 200 (ragged), for
        every scheme, float32 (bf16 and float32 operands) and float64; B6
        at batch 3 equal to a loop of B5; rows 0, 8, 31 and M - 1 of M in
        {9, 64, 300} equal M = 1 products (across the rows / grid
        boundary)."""
        torch, km = self.torch, self.km
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        cases = 0
        for dtype in (f32, f64):
            for name in ("naive", "kahan", "pairwise", "dot2"):
                sch = self.schemes.get(name)
                kw = dict(scheme=sch, block_m=8, block_n=200, block_k=128,
                          compute_dtype=dtype)
                for odt in ((f32, bf16) if dtype == f32 else (f64,)):
                    for m in (9, 32, 37, 64, 100, 300):
                        for steps in (1, 3, 4, 16, 17):
                            a = self.normal((m, steps * 128)).to(odt)
                            b = self.normal((steps * 128, 200)).to(odt)
                            got = km.matmul_accumulators(a, b, **kw)
                            want = km.matmul_plain(a[None], b[None],
                                                   scheme=sch, block_k=128,
                                                   compute_dtype=dtype)
                            self.compare("matmul_accumulators", got,
                                         (want[0][0], want[1][0]),
                                         f"{name} {dtype} operands {odt} "
                                         f"M={m} {steps} K-blocks, N=200")
                            cases += 1
                for m in (9, 64, 300):
                    a = self.normal((3, m, 2048)).to(dtype)
                    b = self.normal((3, 2048, 200)).to(dtype)
                    got = km.matmul_accumulators_batched(a, b, **kw)
                    for i in range(3):
                        one = km.matmul_accumulators(a[i], b[i], **kw)
                        check(all(torch.equal(g[i], o)
                                  for g, o in zip(got, one)),
                              f"B6 at M {m} != a loop of B5 ({name}, "
                              f"{dtype})")
                    for r in sorted({0, 8, 31, m - 1} & set(range(m))):
                        one = km.matmul_accumulators(a[0, r:r + 1], b[0],
                                                     **kw)
                        check(all(torch.equal(g[0, r:r + 1], o)
                                  for g, o in zip(got, one)),
                              f"row {r} of M = {m} != its M = 1 product "
                              f"({name}, {dtype})")
                    cases += 1
        return cases

    def matmul_rows_parity(self):
        """The M <= 8 path on unpadded rows against ``matmul_plain``,
        bitwise: M in {1, 3, 8} x 1, 4 and 16 K-blocks of 128 x N = 256
        and 200 (a multiple of the CTA's 16 columns and not) for every
        scheme and dtype; rows that are not 16-byte aligned (N 131, K-blocks
        of 100); B6 at batch 4, M 1 == a loop of B5."""
        torch, km = self.torch, self.km
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        cases = 0
        for dtype in (f32, f64):
            for name in ("naive", "kahan", "pairwise", "dot2"):
                sch = self.schemes.get(name)
                for odt in ((f32, bf16) if dtype == f32 else (f64,)):
                    shapes = [(m, steps * 128, n, 128) for m in (1, 3, 8)
                              for steps in (1, 4, 16) for n in (256, 200)]
                    for m, k, n, bk in shapes + [(3, 300, 131, 100)]:
                        a = self.normal((m, k)).to(odt)
                        b = self.normal((k, n)).to(odt)
                        kw = dict(scheme=sch, block_m=8, block_n=n,
                                  block_k=bk, compute_dtype=dtype)
                        got = km.matmul_accumulators(a, b, **kw)
                        want = km.matmul_plain(a[None], b[None], scheme=sch,
                                               block_k=bk,
                                               compute_dtype=dtype)
                        self.compare("matmul_accumulators", got,
                                     (want[0][0], want[1][0]),
                                     f"{name} {dtype} operands {odt} M={m} "
                                     f"{k}x{n} block_k={bk}")
                        cases += 1
                a = self.normal((4, 1, 2048)).to(dtype)
                b = self.normal((4, 2048, 384)).to(dtype)
                kw = dict(scheme=sch, block_m=8, block_n=128, block_k=512,
                          compute_dtype=dtype)
                got = km.matmul_accumulators_batched(a, b, **kw)
                for i in range(4):
                    one = km.matmul_accumulators(a[i], b[i], **kw)
                    check(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                          f"B6 at M 1 != a loop of B5 ({name}, {dtype})")
                cases += 1
        return cases

    def matmul_backward(self):
        """The autograd backward of ``ops.matmul`` (bf16 a, float32 b as
        in a projection) launches B5 twice and equals B5 on (g, bT) and
        (aT, g) at the forward's blocks, bit for bit."""
        torch = self.torch
        from repro_torch.kernels import ops

        a = self.normal((20, 700)).requires_grad_()
        b = self.normal((700, 300)).requires_grad_()
        g = self.normal((20, 300))
        out = ops.matmul(a.bfloat16(), b, scheme="kahan")
        counter = self.engine.WRAPPERS["matmul_accumulators"]
        before = counter.launches
        out.backward(g)
        check(counter.launches == before + 2,
              f"the backward launched B5 {counter.launches - before} times")
        # the forward's blocks: (min(256, 24), min(256, 384), min(512, 768))
        kw = dict(scheme="kahan", block_m=24, block_n=256, block_k=512)
        da = ops.matmul(g, b.detach().T, **kw).bfloat16().float()
        db = ops.matmul(a.detach().bfloat16().T, g, **kw)
        check(torch.equal(a.grad, da) and torch.equal(b.grad, db),
              "matmul backward != B5 on (g, bT) and (aT, g)")
        return 1

    def time_matmul(self, label, m, k, n, batch=None, reps=20,
                    dtypes=None):
        """B5 (or B6 with ``batch``) at ``[M, K] x [K, N]`` with bf16
        operands (or ``dtypes``: the backward's float32 gradient against
        bf16 weights and activations), as the projections give it (the
        engine pads, copies and widens nothing at these widths, which is
        checked): kernel, plain and library (``torch.matmul``
        / ``bmm`` on the operands promoted to float32, TF32 off) times,
        and the parity check. The timed launches cycle through copies of
        the operands that together exceed the 50 MB L2 cache twice, as a
        decode position finds the weights cold, and are captured in a CUDA
        graph: a decode-shape launch is shorter than the wrapper's
        enqueue on the host."""
        torch, km = self.torch, self.km
        lead = () if batch is None else (batch,)
        name = ("matmul_accumulators" if batch is None
                else "matmul_accumulators_batched")
        wrapper = self.engine.WRAPPERS[name]
        eng = self.engine.CompensatedReduction(scheme="kahan")
        a_dt, b_dt = dtypes or (torch.bfloat16, torch.bfloat16)
        a = self.normal((*lead, m, k)).to(a_dt)
        b = self.normal((*lead, k, n)).to(b_dt)
        blocks = eng._matmul_blocks(m, n, k, None, None, None)
        ap, bp = eng._prep_matmul(a, b, blocks)
        check(ap.shape == a.shape and bp.data_ptr() == b.data_ptr(),
              f"the engine padded or copied operands at {label}")
        check(ap.data_ptr() == a.data_ptr() and ap.dtype == a_dt
              and bp.dtype == b_dt,
              f"the engine copied or widened operands at {label}")
        kw = dict(scheme=eng.scheme, block_m=blocks[0], block_n=blocks[1],
                  block_k=blocks[2], compute_dtype=torch.float32)
        got = wrapper(ap, bp, **kw)
        sync(torch, self.dev)
        t0 = time.perf_counter()
        want = km.matmul_plain(ap.reshape(-1, m, k), bp.reshape(-1, k, n),
                               scheme=eng.scheme, block_k=blocks[2],
                               compute_dtype=torch.float32)
        sync(torch, self.dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if batch is None:
            want = (want[0][0], want[1][0])
        self.compare(name, got, want, f"kahan at {label}")
        del want, got
        operands = cold_copies(torch, (ap, bp))
        ms = graph_ms(torch, cycle(lambda x, y: wrapper(x, y, **kw),
                                   operands), reps)
        promoted = cold_copies(torch, (ap.float(), bp.float()))
        library_ms = graph_ms(torch, cycle(torch.matmul, promoted), reps)
        del operands, promoted
        nb = 1 if batch is None else batch
        n_bytes = (ap.numel() * ap.element_size()
                   + bp.numel() * bp.element_size() + 2 * nb * m * n * 4)
        flops = 2 * nb * m * n * k
        least, by = bound_ms(n_bytes, flops)
        # the fixed chain's own ceiling: a separate multiply and add per
        # term, at half the fma rate
        ceiling = fma_ceiling_ms(flops)
        tm, tn, split = km.grid_plan(nb, m, n, k, blocks[2])
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": least, "bound_by": by,
               "shape": [*lead, m, k, n], "scheme": "kahan",
               "operands": [str(a_dt)[6:], str(b_dt)[6:]],
               "block_k": blocks[2], "tflops": flops / ms / 1e9,
               "gbytes_per_s": n_bytes / ms / 1e6,
               "mul_add_ceiling_ms": ceiling,
               "ceiling_share": ceiling / ms,
               "tile": [tm, tn] if tm else None, "cluster": split or None}
        self.timing[(name, label)] = row
        plan = (f"tile {tm}x{tn}, cluster {split}" if tm
                else "rows path (M <= 8)")
        log(f"# {name} {label} {row['shape']}: kernel {ms:.4f} ms "
            f"({row['tflops']:.2f} TFLOP/s, {row['gbytes_per_s']:.0f} GB/s), "
            f"{by} bound {least:.4f} ms, mul+add ceiling {ceiling:.4f} ms "
            f"({100 * ceiling / ms:.1f}%), {plan}, plain {plain_ms:.1f} ms, "
            f"library (f32 matmul) {library_ms:.4f} ms")

    def matmul_times(self, cfg, prefill_len):
        """B5 at every projection shape of OLMo-1B at decode (M 1, as
        served; M 8, the padded rows earlier runs timed) and in a 64- and a
        32-token chunk (the serving trace's chunks), and at the up
        projection of a ``prefill_len``-token prefill; B6 at 4
        chunk-sized q projections."""
        d, f = cfg.d_model, cfg.d_ff
        hd = cfg.n_heads * cfg.head_dim
        shapes = (("qkvo", d, hd), ("gate-up", d, f), ("down", f, d))
        for label, m, reps in (("decode", 1, 50), ("decode8", 8, 50),
                               ("chunk", 64, 20), ("chunk32", 32, 20)):
            for proj, k, n in shapes:
                self.time_matmul(f"{label}-{proj}", m, k, n, reps=reps)
        self.time_matmul("prefill-up", prefill_len, d, f, reps=5)
        self.time_matmul("batched", 64, d, hd, batch=4, reps=10)
        # per layer: 4 q/k/v/o, 2 gate/up and 1 down launch
        per_layer = (("qkvo", 4), ("gate-up", 2), ("down", 1))
        self.matmul_totals = {
            f"{label}_{key}": cfg.n_layers * sum(
                n * self.timing[("matmul_accumulators", f"{label}-{p}")][key]
                for p, n in per_layer)
            for label in ("decode", "decode8", "chunk", "chunk32")
            for key in ("ms", "bound_ms", "library_ms", "mul_add_ceiling_ms")}
        t = self.matmul_totals
        log(f"# B5 per decode position ({PROJECTIONS * cfg.n_layers} "
            f"launches, M 1): {t['decode_ms']:.3f} ms, bound "
            f"{t['decode_bound_ms']:.3f} ms, f32 matmul "
            f"{t['decode_library_ms']:.3f} ms (at M 8: {t['decode8_ms']:.3f} "
            f"ms); per 64-token chunk {t['chunk_ms']:.3f} ms, bound "
            f"{t['chunk_bound_ms']:.3f} ms, mul+add ceiling "
            f"{t['chunk_mul_add_ceiling_ms']:.3f} ms, f32 matmul "
            f"{t['chunk_library_ms']:.3f} ms; per 32-token chunk "
            f"{t['chunk32_ms']:.3f} ms")

    def column_parity(self):
        """The column-scan kernel (``kahan_columns``) against its plain
        loop, bitwise, on float32 and bf16 leaves: tall, wide, one row,
        rows off its 16-row batch, trailing sizes off its 128-thread
        CTA."""
        torch = self.torch
        from repro_torch.core.kahan import column_sq_plain
        from repro_torch.kernels import kahan_columns

        cases = 0
        for rows, trail in ((300, (37, 5)), (2, (65,)), (1, (7,)),
                            (41, (1,)), (17, (129,)), (1000, (2048,))):
            for dtype in (torch.float32, torch.bfloat16):
                x = self.data((rows, *trail), dtype)
                got = kahan_columns.column_sq_accumulators(x)
                want = column_sq_plain(x.float())
                self.compare("column_sq_accumulators", got, want,
                             f"[{rows}, {trail}] {dtype}")
                cases += 1
        log(f"# phase 2: {cases} column-scan cases bitwise equal to the "
            f"plain loop (float32 and bf16 leaves, ragged rows and columns)")

    # -- 2. subnormal-reaching data (C2) --------------------------------------
    def sub_data(self, shape, dtype, lo, hi):
        """Normal values scaled by 2^e, e in [lo, hi), a fifth of them
        scaled into float32's subnormal range and a twentieth signed
        zeros, as ``dtype`` (a bfloat16 subnormal stays one)."""
        torch, gen, dev = self.torch, self.gen, self.dev
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
        e = torch.randint(lo, hi, shape, generator=gen, device=dev)
        sub = torch.rand(shape, generator=gen, device=dev) < 0.2
        e = torch.where(sub, torch.randint(-149, -127, shape, generator=gen,
                                           device=dev), e)
        x = x * torch.exp2(e.double())
        zero = torch.rand(shape, generator=gen, device=dev) < 0.05
        return torch.where(zero, x * 0, x).to(dtype)

    def boundary_pair(self, shape, dtype):
        """(a, b) whose float32 products lie a few units of the last place
        on either side of ``tiny`` = 2^-126: a = +-(1 - j 2^-24) 2^k, b =
        +-tiny (1 + i 2^-23) 2^-k, i, j in 0..3, k in -3..3 (x86, and so
        the reference, flushes (1 - 2^-24) tiny and keeps (1 - 2^-23) tiny
        (1 + 2^-23))."""
        torch, gen, dev = self.torch, self.gen, self.dev

        def ints(lo, hi):
            return torch.randint(lo, hi, shape, generator=gen,
                                 device=dev).double()

        def sign():
            return ints(0, 2) * 2 - 1

        k = ints(-3, 4)
        a = sign() * (1 - ints(0, 4) * 2.0 ** -24) * torch.exp2(k)
        b = sign() * 2.0 ** -126 * (1 + ints(0, 4) * 2.0 ** -23)
        return a.to(dtype), (b * torch.exp2(-k)).to(dtype)

    def subnormal_parity(self):
        """Every kernel against its flushing plain version, bitwise, on
        data that reaches float32's subnormal range: subnormal inputs,
        products and sums that underflow, the products at the ``tiny``
        boundary, bf16 subnormal operands (the kernels are built with
        ``-ftz=true``; the plain versions flush op for op as XLA does on
        the CPU). Returns the number of cases."""
        torch = self.torch
        kd, ks, km, fa = self.kd, self.ks, self.km, self.fa
        f32, bf16 = torch.float32, torch.bfloat16
        cases = 0
        seen = {name: set() for name in REDUCTIONS}
        n = 3 * 8192 + 37
        for dtype in (f32, bf16):
            for name in SCHEMES:
                sch = self.schemes.get(name)
                for unroll in (1, 8):
                    eng = self.engine.CompensatedReduction(
                        scheme=sch, unroll=unroll, compute_dtype=dtype)
                    kw = dict(scheme=sch, unroll=unroll)
                    data = {
                        "products underflow": (
                            self.sub_data((3, n), dtype, -75, -52),
                            self.sub_data((3, n), dtype, -75, -52)),
                        "sums underflow": (
                            self.sub_data((3, n), dtype, -135, -110),
                            self.sub_data((3, n), dtype, -135, -110)),
                        "tiny boundary": self.boundary_pair((3, n), dtype)}
                    for label, (a, b) in data.items():
                        ap, bp = eng._prep2d(a), eng._prep2d(b)
                        plain = (kd.dot_plain(ap, bp, **kw),
                                 ks.sum_plain(ap, **kw))
                        self.reduction_case(
                            ap, bp, plain, kw,
                            f"{name} U={unroll} {dtype} {label}", seen)
                        cases += 1
                # bf16 subnormal operands into a float32 accumulate
                if dtype == bf16:
                    eng = self.engine.CompensatedReduction(scheme=sch,
                                                           unroll=8)
                    a = self.sub_data((3, n), bf16, -75, -52)
                    b = self.sub_data((3, n), bf16, -75, -52)
                    ap, bp = eng._prep2d(a), eng._prep2d(b)
                    kw = dict(scheme=sch, unroll=8)
                    self.reduction_case(
                        ap, bp, (kd.dot_plain(ap, bp, **kw),
                                 ks.sum_plain(ap, **kw)), kw,
                        f"{name} bf16 subnormal operands, float32", seen)
                    cases += 1
        # matmul: both tile paths (M 3 and 37), float32 and bf16 operands
        for name in SCHEMES:
            eng = self.engine.CompensatedReduction(scheme=name)
            for m in (3, 37):
                for odt in (f32, bf16):
                    a = self.sub_data((m, 1100), odt, -75, -52)
                    b = self.sub_data((1100, 200), odt, -75, -52)
                    if odt == f32:
                        a[0], b[:, 0] = self.boundary_pair((1100,), f32)
                    blocks = eng._matmul_blocks(m, 200, 1100, None, None,
                                                None)
                    ap, bp = eng._prep_matmul(a, b, blocks)
                    kw = dict(scheme=eng.scheme, block_m=blocks[0],
                              block_n=blocks[1], block_k=blocks[2],
                              compute_dtype=f32)
                    got = km.matmul_accumulators(ap, bp, **kw)
                    want = km.matmul_plain(ap[None], bp[None],
                                           scheme=eng.scheme,
                                           block_k=blocks[2],
                                           compute_dtype=f32)
                    self.compare("matmul_accumulators", got,
                                 (want[0][0], want[1][0]),
                                 f"{name} {odt} operands M={m}, subnormal")
                    cases += 1
        # flash: scores whose exp underflows, subnormal v
        eng = self.engine.CompensatedReduction(scheme="kahan")
        sq, skv, bh, dh = 300, 600, 4, 128
        q, k, v, bq, bk, _, _ = eng._flash_prep(
            "subnormal_parity", self.normal((bh, sq, dh)) * 6,
            self.normal((bh, skv, dh)) * 6,
            self.sub_data((bh, skv, dh), f32, -130, -100), 256, 256, 1)
        for name in SCHEMES:
            sch = self.schemes.get(name)
            got = fa.flash_accumulators(q, k, v, block_q=bq, block_k=bk,
                                        scheme=sch, kv_len=skv, causal=True,
                                        q_groups=1)
            want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk,
                                  kv_len=skv, causal=True)
            self.compare("flash_accumulators", got, want,
                         f"{name}, exp underflows, subnormal v")
            qc = q[:, 64:128].contiguous()
            got = fa.flash_chunk_accumulators(qc, k, v, 64, block_q=64,
                                              block_k=bk, scheme=sch,
                                              kv_len=skv, q_groups=1)
            want = fa.flash_plain(qc, k, v, scheme=sch, block_k=bk,
                                  kv_len=skv, causal=True, q_off=64)
            self.compare("flash_chunk_accumulators", got, want,
                         f"{name}, exp underflows, subnormal v")
            cases += 2
        # column scan: squares that underflow, subnormal entries
        from repro_torch.core.kahan import column_sq_plain
        from repro_torch.kernels import kahan_columns

        for dtype in (f32, bf16):
            for lo, hi in ((-75, -52), (-140, -100)):
                x = self.sub_data((300, 37, 5), dtype, lo, hi)
                got = kahan_columns.column_sq_accumulators(x)
                self.compare("column_sq_accumulators", got,
                             column_sq_plain(x.float()),
                             f"{dtype} subnormal, e in [{lo}, {hi})")
                cases += 1
        sync(torch, self.dev)
        log(f"# phase 2: {cases} subnormal-reaching cases bitwise equal to "
            f"the flushing plain versions (every reduction x scheme x "
            f"float32 / bf16, products and sums that underflow, products at "
            f"the tiny boundary, bf16 subnormal operands; B5 at M 3 and 37; "
            f"B7 and B8 with exp underflowing; the column scan)")
        return cases

    def dist_times(self, spec):
        """Phase 8's rows, at one rank's shapes: B3 and B1 on its block of
        the sharded sum and dot, B4 on its two requests, B5 on its
        K-slice (float32 operands), and B3 on the trainer's loss fold (one
        microbatch loss a rank, padded to one block)."""
        torch, kd, ks = self.torch, self.kd, self.ks
        f32 = torch.float32
        half = spec["n"] // DIST_RANKS
        x, y = self.data((half,), f32), self.data((half,), f32)
        self.time_one("sum_accumulators", "kahan", (x,),
                      lambda s: [t[0] for t in ks.sum_plain(x[None],
                                                            scheme=s)],
                      lambda: torch.sum(x), label="sharded")
        self.time_one("dot_accumulators", "kahan", (x, y),
                      lambda s: [t[0] for t in kd.dot_plain(
                          x[None], y[None], scheme=s)],
                      lambda: torch.dot(x, y), label="sharded")
        del x, y
        rows, cols = spec["act"]
        sq = self.data((rows // DIST_RANKS, cols), f32)
        self.time_one("sum_accumulators_batched", "kahan", (sq,),
                      lambda s: ks.sum_plain(sq, scheme=s),
                      lambda: torch.sum(sq, dim=1), reps=200,
                      label="sharded")
        one = torch.zeros(8192, device=self.dev)
        one[0] = 2.5
        self.time_one("sum_accumulators", "kahan", (one,),
                      lambda s: [t[0] for t in ks.sum_plain(one[None],
                                                            scheme=s)],
                      lambda: torch.sum(one), reps=200, label="sharded-loss")
        m, k, n = spec["matmul"]
        self.time_matmul("sharded", m, k // DIST_RANKS, n,
                         dtypes=(f32, f32))

    def train_times(self, cfg, tokens):
        """Phase 3's training rows: B5 at every (shape, operand pair) a
        train step of ``tokens`` tokens a microbatch gives it with
        ``kahan_matmul`` (forward and recompute bf16 x bf16; dA = g @ W^T
        float32 x bf16; dB = a^T @ g bf16 x float32), with the totals a
        step predicts; B3 at the largest parameter leaf (2^28 float32
        squares); the column scan at the embedding's [V_pad, d] gradient
        and at a [16, d, d_ff] one."""
        torch = self.torch
        f32, bf16 = torch.float32, torch.bfloat16
        d, f = cfg.d_model, cfg.d_ff
        hd = cfg.n_heads * cfg.head_dim
        t = tokens
        # (label, M, K, N, operand dtypes, launches a layer and microbatch)
        shapes = (
            ("train-qkvo", t, d, hd, (bf16, bf16), 8),
            ("train-up", t, d, f, (bf16, bf16), 4),
            ("train-down", t, f, d, (bf16, bf16), 2),
            ("train-dA-qkvo", t, hd, d, (f32, bf16), 4),
            ("train-dA-up", t, f, d, (f32, bf16), 2),
            ("train-dA-down", t, d, f, (f32, bf16), 1),
            ("train-dB-qkvo", d, t, hd, (bf16, f32), 4),
            ("train-dB-up", d, t, f, (bf16, f32), 2),
            ("train-dB-down", f, t, d, (bf16, f32), 1))
        for label, m, k, n, dts, _ in shapes:
            self.time_matmul(label, m, k, n, reps=3, dtypes=dts)
        per = cfg.n_layers * TRAIN_MICRO
        keys = ("ms", "bound_ms", "library_ms", "mul_add_ceiling_ms")
        self.train_b5 = {
            key: per * sum(self.timing[("matmul_accumulators", lab)][key] * c
                           for lab, *_, c in shapes)
            for key in keys}
        self.train_b5["launches"] = per * sum(c for *_, c in shapes)
        t5 = self.train_b5
        log(f"# B5 per train step ({t5['launches']} launches at {tokens} "
            f"tokens a microbatch, from the rows above): {t5['ms']:.1f} ms, "
            f"operations bound {t5['bound_ms']:.1f} ms, mul+add ceiling "
            f"{t5['mul_add_ceiling_ms']:.1f} ms, f32 matmul "
            f"{t5['library_ms']:.1f} ms")
        x = self.data((1 << 28,), f32)
        self.time_one("sum_accumulators", "kahan", (x,),
                      lambda s: [v[0] for v in self.ks.sum_plain(
                          x[None], scheme=s)],
                      lambda: torch.sum(x), reps=5, label="train")
        del x
        self.time_columns("train", (cfg.padded_vocab, d), plain=False)
        self.time_columns("train-wide", (cfg.n_layers, d, f))

    def time_columns(self, label, shape, plain=True):
        """The column scan on a float32 ``shape`` leaf: kernel (graph-
        timed), its plain loop (host clock, once) bitwise equal, and
        ``torch.linalg.vecdot(x, x, dim=0)`` as the library call. Without
        ``plain`` the loop is left to phase 6, which runs it on the same
        shape (the embedding's gradient) and fills in its time."""
        torch = self.torch
        from repro_torch.core.kahan import column_sq_plain
        from repro_torch.kernels import kahan_columns

        wrapper = kahan_columns.column_sq_accumulators
        x = self.data(shape, torch.float32)
        plain_ms = None
        if plain:
            got = wrapper(x)
            sync(torch, self.dev)
            t0 = time.perf_counter()
            want = column_sq_plain(x)
            sync(torch, self.dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            self.compare("column_sq_accumulators", got, want,
                         f"{label} {shape}")
            del got, want
        ms = graph_ms(torch, lambda: wrapper(x), 5, 3)
        library_ms = graph_ms(torch, lambda: torch.linalg.vecdot(x, x, dim=0),
                              5, 3)
        cols = x.numel() // shape[0]
        n_bytes = x.numel() * 4 + 2 * cols * 4
        least, by = bound_ms(n_bytes, 5 * x.numel())
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": least, "bound_by": by, "shape": list(shape),
               "gbytes_per_s": n_bytes / ms / 1e6}
        self.timing[("column_sq_accumulators", label)] = row
        loop = (f"plain loop {plain_ms:.1f} ms (bitwise equal)" if plain
                else "plain loop in phase 6")
        log(f"# column_sq_accumulators {label} {list(shape)}: kernel "
            f"{ms:.4f} ms ({row['gbytes_per_s']:.0f} GB/s), {by} bound "
            f"{least:.4f} ms, {loop}, library (vecdot) {library_ms:.4f} ms")
        del x

    def rows(self):
        """One JSON row per wrapper and path that launches it, with that
        path's launch count, timed at that path's shape."""
        src = "src/repro_torch/csrc/"
        replaces = {
            "dot_accumulators": "src/repro/kernels/kahan_dot.py:89",
            "dot_accumulators_batched": "src/repro/kernels/kahan_dot.py:139",
            "sum_accumulators": "src/repro/kernels/kahan_sum.py:63",
            "sum_accumulators_batched": "src/repro/kernels/kahan_sum.py:105",
            "flash_accumulators":
                "src/repro/kernels/flash_attention.py:262",
            "flash_chunk_accumulators":
                "src/repro/kernels/flash_attention.py:377",
            "matmul_accumulators": "src/repro/kernels/kahan_matmul.py:101",
            "matmul_accumulators_batched":
                "src/repro/kernels/kahan_matmul.py:153",
            # no pallas_call: the lax.scan of tree_kahan_sq_norm
            "column_sq_accumulators": "src/repro/core/kahan.py:403",
        }
        # every (kernel, path) pair that launched, timed at that path's
        # shape: the reductions at the phase-3 sizes, B4 on every serving
        # path at the telemetry shape, B7 at the prefill shape, B8 at each
        # serving run's cache length, B5 at the decode q/k/v/o shape when
        # serving and at the 2048-token up projection on the entry path,
        # B6 at its batched shape
        special = {("flash_chunk_accumulators", "serve-long"): "serve-long",
                   ("matmul_accumulators", "entry"): "prefill-up",
                   ("matmul_accumulators", "serve-matmul"): "decode-qkvo",
                   ("matmul_accumulators_batched", "entry"): "batched",
                   ("matmul_accumulators", "train-b"): "train-up",
                   ("sum_accumulators", "train-b"): "train",
                   ("column_sq_accumulators", "train-a"): "train",
                   ("sum_accumulators", "sharded"): "sharded",
                   ("dot_accumulators", "sharded"): "sharded",
                   ("sum_accumulators_batched", "sharded"): "sharded",
                   ("matmul_accumulators", "sharded"): "sharded",
                   ("sum_accumulators", "sharded-train"): "sharded-loss",
                   ("column_sq_accumulators", "sharded-train"): "train"}
        rows = []
        for path, counts in self.launches.items():
            for name in replaces:
                if counts[name]:
                    default = ("serve" if path.startswith("serve")
                               else "entry" if name.startswith("flash")
                               else "kahan")
                    rows.append((name, path,
                                 special.get((name, path), default)))
        out = []
        for name, path, label in rows:
            t = self.timing[(name, label)]
            out.append({
                "name": name, "route": "cuda",
                "source": src + ("kahan_flash.cu" if name.startswith("flash")
                                 else "kahan_matmul.cu"
                                 if name.startswith("matmul")
                                 else "kahan_reduce.cu"),
                "replaces": replaces[name], "path": path,
                "launches": self.launches[path][name],
                "max_abs_err": self.err[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"]})
        return out


def paper_path(torch, kernels, card):
    """Phase 7: the paper's question on the card. B1 (dot) and B3 (sum)
    for every built-in scheme at U in ``ecm.UNROLLS``: each (s, c) grid
    bitwise equal to its plain version at ``SWEEP_PARITY_N``; each timed at
    the paper's n = 2^27 float32 (graph time) beside its bytes bound and
    the machine model's prediction (``repro_torch.core.ecm``) on this
    card's measured clock and load-only bandwidth, with one SM's load rate
    fitted on the naive dot at U = 1 and no other row; the saturation U
    predicted and measured; phase 3's B1-B4 rows beside the same model.
    Then the accuracy ladder (``LADDER_CONDS``) through ``ops.dot`` on the
    card. Raises on a parity, bound or ordering failure and on a
    prediction that is not finite; the model's error is recorded, not
    gated. Returns the JSON object ``{"ecm": [...], "phase3": [...],
    "ladder": [...]}``."""
    from repro_torch.core import ecm, numerics
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    dev, kd, ks = kernels.dev, kernels.kd, kernels.ks
    f32 = torch.float32
    wrappers = {"dot": kd.dot_accumulators, "sum": ks.sum_accumulators}
    plains = {"dot": lambda a, b, **kw: kd.dot_plain(a[None], b[None], **kw),
              "sum": lambda a, b, **kw: ks.sum_plain(a[None], **kw)}
    cases = 0
    a = kernels.data((SWEEP_PARITY_N,), f32)
    b = kernels.data((SWEEP_PARITY_N,), f32)
    for op, fn in wrappers.items():
        for name in SCHEMES:
            sch = kernels.schemes.get(name)
            for unroll in ecm.UNROLLS:
                args = (a, b) if op == "dot" else (a,)
                got = fn(*args, scheme=sch, unroll=unroll)
                want = plains[op](a, b, scheme=sch, unroll=unroll)
                kernels.compare(fn.__name__, got, (want[0][0], want[1][0]),
                                f"{name} U={unroll} [{SWEEP_PARITY_N}]")
                cases += 1
    sync(torch, dev)
    log(f"# phase 7: {cases} grids (dot and sum x {len(SCHEMES)} schemes x "
        f"U {list(ecm.UNROLLS)}) at n = {SWEEP_PARITY_N} bitwise equal to "
        f"their plain versions")

    # the machine: load-only bandwidth b_S, and the clock under load
    x = kernels.normal((LOAD_ONLY_N,))
    load_ms = graph_ms(torch, lambda: torch.sum(x))
    load_gbs = x.numel() * x.element_size() / load_ms / 1e6
    del x
    a = kernels.data((PAPER_N,), f32)
    b = kernels.data((PAPER_N,), f32)
    kahan = kernels.schemes.get("kahan")
    mhz, watts = clock_under_load(
        torch, lambda: ks.sum_accumulators(a, scheme=kahan))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    machine = dataclasses.replace(ecm.H100, sms=sms, clock_mhz=mhz,
                                  load_gbs=load_gbs, sm_load_gbs=None)
    log(f"# phase 7 machine: b_S {load_gbs:.1f} GB/s (torch.sum over "
        f"{LOAD_ONLY_N} float32, {load_ms:.4f} ms), SM clock {mhz:.0f} MHz "
        f"and {watts:.1f} W under the kahan sum, {sms} SMs; {card}")

    measured = {}
    for op, fn in wrappers.items():
        args = (a, b) if op == "dot" else (a,)
        for name in SCHEMES:
            sch = kernels.schemes.get(name)
            for unroll in ecm.UNROLLS:
                call = lambda: fn(*args, scheme=sch, unroll=unroll)  # noqa: E731,B023
                ms = graph_ms(torch, call)
                measured[(op, name, unroll)] = (ms, fn.plan, fn.copy)
    fit = ecm.fit_sm_load_gbs(machine, ecm.gpu_kernel_for_scheme(
        "naive", op="dot"), PAPER_N, 1, measured[("dot", "naive", 1)][0])
    machine = dataclasses.replace(machine, sm_load_gbs=fit)
    log(f"# phase 7 model: one SM's load rate fitted on the naive dot at U "
        f"= 1: {fit if fit is None else round(fit, 2)} GB/s (None: no limit "
        f"beyond the other terms)")

    rows = []
    for op in wrappers:
        streams = 2 if op == "dot" else 1
        for name in SCHEMES:
            kern = ecm.gpu_kernel_for_scheme(name, op=op)
            mix = kernels.schemes.get(name).instruction_mix
            top = measured[(op, name, ecm.UNROLLS[-1])][0]
            u_meas = next(u for u in ecm.UNROLLS if measured[(op, name, u)][0]
                          <= (1 + SATURATED_WITHIN) * top)
            for unroll in ecm.UNROLLS:
                ms, plan, copy = measured[(op, name, unroll)]
                r = ecm.ecm_gpu(machine, kern, PAPER_N, unroll)
                check(math.isfinite(r.pred_ms) and r.pred_ms > 0,
                      f"model: no finite prediction for {op} {name} "
                      f"U={unroll}")
                ctas = 1024 * unroll // plan[0]
                check(r.ctas == ctas and r.chains == plan[0],
                      f"model: {op} {name} U={unroll} plans {r.ctas} CTAs of "
                      f"{r.chains} chains, the wrapper launched {ctas} of "
                      f"{plan[0]}")
                cells = 1024 * unroll
                least, by = bound_ms(
                    (PAPER_N * streams + 2 * cells) * 4,
                    PAPER_N * (mix.flops if op == "dot" else mix.adds))
                err = ecm.model_relative_error(r.pred_ms, ms)
                over = ms / measured[(op, "naive", unroll)][0]
                rows.append({
                    "op": op, "scheme": name, "unroll": unroll,
                    "ctas": ctas, "sms": min(ctas, sms), "ms": ms,
                    "bound_ms": least, "model_ms": r.pred_ms,
                    "model_bound": r.bound, "model_error": err,
                    "over_naive": over,
                    "cycles_a_step": ms * mhz * 1e3 / r.steps,
                    "terms_ms": {"hbm": r.t_hbm_ms, "chain": r.t_chain_ms,
                                 "issue": r.t_issue_ms, "sm": r.t_sm_ms},
                    "u_s_model": r.u_s, "u_s_measured": u_meas})
                log(f"# phase 7 {op} {name} U={unroll}: {ctas} CTAs on "
                    f"{min(ctas, sms)} SMs (plan {plan} {copy}), {ms:.4f} "
                    f"ms ({by} bound {least:.4f}, "
                    f"{100 * least / ms:.1f}%), model "
                    f"{r.pred_ms:.4f} ({r.bound}; {r.shorthand()}), error "
                    f"{100 * err:.1f}%, over naive {over:.3f}, "
                    f"{ms * mhz * 1e3 / r.steps:.1f} cycles a step")
            log(f"# phase 7 {op} {name}: u_s model {r.u_s}, measured "
                f"{u_meas} (the least U within {100 * SATURATED_WITHIN:.0f}% "
                f"of U={ecm.UNROLLS[-1]})")
    del a, b
    beside = []
    for (kname, label), t in kernels.timing.items():
        if not kname.startswith(("dot_accumulators", "sum_accumulators")):
            continue
        shape = t["shape"]
        r = ecm.ecm_gpu_for_scheme(
            machine, t["scheme"], shape[-1], 8,
            op="dot" if kname.startswith("dot") else "sum",
            batch=shape[0] if len(shape) == 2 else 1)
        check(math.isfinite(r.pred_ms) and r.pred_ms > 0,
              f"model: no finite prediction for {kname} {label}")
        err = ecm.model_relative_error(r.pred_ms, t["ms"])
        beside.append({"name": kname, "label": label, "shape": shape,
                       "unroll": 8, "ms": t["ms"], "model_ms": r.pred_ms,
                       "model_bound": r.bound, "model_error": err})
        log(f"# phase 7 model beside phase 3: {kname} {label} {shape} U=8: "
            f"{t['ms']:.4f} ms, model {r.pred_ms:.4f} ({r.bound}), error "
            f"{100 * err:.1f}%")

    # the reference's accuracy ladder on GenDot data, through ops.dot
    t1 = time.perf_counter()
    errs, achieved, bounds = {}, {}, {}
    for cond in LADDER_CONDS:
        x, y, exact, achieved[cond] = numerics.gen_dot(
            LADDER_N, cond, seed=int(math.log10(cond)))
        xt, yt = (torch.from_numpy(v).to(dev) for v in (x, y))
        errs[cond] = {name: numerics.relative_error(
            float(ops.dot(xt, yt, scheme=name, unroll=1)), exact)
            for name in SCHEMES}
        bounds[cond] = {name: kernels.schemes.get(name).error_bound(
            LADDER_N, achieved[cond]) for name in SCHEMES}
    gen_s = time.perf_counter() - t1
    saturation = 1.0 / kernels.schemes.EPS32
    live = [c for c in LADDER_CONDS if achieved[c] < saturation]
    check(len(live) >= 2, f"ladder: only {live} of the conditions "
          f"achieved below 1/eps = {saturation:.3e} at n = {LADDER_N}; "
          f"the ordering gates would not run")
    for cond in LADDER_CONDS:
        e, ach = errs[cond], achieved[cond]
        what = f"ladder cond {cond:.0e} (achieved {ach:.3e}): {e}"
        check(e["dot2"] <= 1e-2 * e["kahan"]
              and e["dot2"] <= 1e-2 * e["naive"], what)
        if cond in live:
            check(e["kahan"] <= e["naive"]
                  and e["pairwise"] <= e["naive"] * 1.01, what)
        else:
            check(e["kahan"] <= e["naive"] * 3.0, what)
        for name in SCHEMES:
            bound = bounds[cond][name]
            check(math.isfinite(bound) and e[name] <= bound,
                  f"{name}: error {e[name]:.3e} above its a-priori bound "
                  f"{bound:.3e} at cond {cond:.0e} (achieved {ach:.3e})")
    check(errs[1e10]["kahan"] >= 100.0 * errs[1e10]["dot2"],
          f"dot2 not 2 digits below kahan at cond 1e10: {errs[1e10]}")
    for cond in LADDER_CONDS:
        log(f"# phase 7 ladder n={LADDER_N} cond {cond:.0e} (achieved "
            f"{achieved[cond]:.3e}{'' if cond in live else ', above 1/eps'}"
            f"): " + ", ".join(
                f"{k} {v:.3e} (bound {bounds[cond][k]:.2e})"
                for k, v in errs[cond].items()))
    tight = sorted({(c, k) for c in LADDER_CONDS for k in SCHEMES
                    if bounds[c][k] < 1.0})
    log(f"# phase 7: every a-priori bound holds at every condition; a bound "
        f"below 1 (one that an answer of the right magnitude could break) "
        f"only for {tight}, the others at or above 1 hold by any such "
        f"answer (GenDot's achieved condition grows with n: at least "
        f"{min(achieved.values()):.2e} at n = {LADDER_N}); the orderings "
        f"kahan <= naive and pairwise <= 1.01 naive gated at the "
        f"{len(live)} conditions achieved below 1/eps {live}, kahan <= 3 "
        f"naive above it; dot2 "
        f"{errs[1e10]['kahan'] / errs[1e10]['dot2']:.0f}x below kahan at "
        f"1e10 (GenDot {gen_s:.1f} s on the host); phase 7 took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ecm": rows, "phase3": beside,
            "ladder": [{"cond": c, "achieved": achieved[c],
                        "errors": errs[c], "bounds": bounds[c]}
                       for c in LADDER_CONDS]}


L2_BYTES = 50e6


def cold_copies(torch, tensors):
    """Copies of ``tensors`` (the first is the tensors themselves) that
    together hold at least twice the L2 cache, so that cycling through
    them reads every operand from device memory."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, math.ceil(2 * L2_BYTES / size))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def cycle(fn, operand_sets):
    """``fn`` over the next operand set at each call."""
    state = {"i": 0}

    def call():
        args = operand_sets[state["i"] % len(operand_sets)]
        state["i"] += 1
        return fn(*args)

    return call


def serve_run(torch, kernels, cfg, model, params, trace, prefill_mode):
    """Serve ``trace`` once with every launch count reset just before and
    read just after; times every decode tick and prefill chunk. Checks
    what holds on every serving path: each request emits its tokens, the
    telemetry is finite and positive, and the sum kernel launched once
    per decode tick and once per finished prefill."""
    from repro_torch.kernels import Policy
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_requests, parse_trace
    from repro_torch.serve import EngineConfig, InferenceEngine

    dev = kernels.dev
    cells = parse_trace(trace, 0.0)
    requests, arrivals = build_requests(cfg, cells, seed=0)
    ec = EngineConfig(max_slots=4, max_len=serve_max_len(trace),
                      prefill_chunk=64, track_stats=True,
                      policy=Policy(scheme="kahan"),
                      prefill_mode=prefill_mode)
    engine = InferenceEngine(cfg, ec, model=model, params=params)
    check(engine.prefill_body == prefill_mode,
          f"engine resolved prefill body {engine.prefill_body!r}, wanted "
          f"{prefill_mode!r}")
    tick_ms, chunk_ms, chunk_pos, widths, positions = [], [], [], [], []
    captured = {}
    sum_kernel = kernels.engine.WRAPPERS["sum_accumulators_batched"]
    flash_kernels = [kernels.engine.WRAPPERS[n] for n in
                     ("flash_accumulators", "flash_chunk_accumulators")]

    def timed_tick(running, events, _orig=engine._decode_tick):
        before = sum_kernel.launches
        flash_before = [f.launches for f in flash_kernels]
        sync(torch, dev)
        t0 = time.perf_counter()
        _orig(running, events)
        sync(torch, dev)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        positions.append(len(running))
        check(sum_kernel.launches == before + 1,
              "the telemetry sum kernel did not launch exactly once in a "
              "decode tick")
        check([f.launches for f in flash_kernels] == flash_before,
              "a flash kernel launched in a decode tick")

    def timed_chunk(slot, h, events, _orig=engine._run_chunk):
        start = h.prefill_pos
        sync(torch, dev)
        t0 = time.perf_counter()
        _orig(slot, h, events)
        sync(torch, dev)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        chunk_pos.append(h.prefill_pos - start)
        widths.append(engine.last_chunks[-1][1])

    def captured_norms(logits, _orig=engine._norms):
        out = _orig(logits)
        if logits.shape[0] == ec.max_slots:       # a decode tick's batch
            captured["logits"], captured["norms"] = logits.clone(), out.clone()
        return out

    engine._decode_tick = timed_tick
    engine._run_chunk = timed_chunk
    engine._norms = captured_norms

    reset_launch_counts()
    sync(torch, dev)
    t0 = time.perf_counter()
    served = engine.run(requests, arrivals)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()

    n_tok = 0
    for (arrival, plen, new, _), req in zip(cells, requests):
        h = served[req.request_id]
        check(len(h.tokens) == new, f"request {req.request_id} emitted "
              f"{len(h.tokens)} of {new} tokens")
        check(all(0 <= t < cfg.vocab_size for t in h.tokens),
              f"request {req.request_id}: token outside the vocabulary")
        check(len(h.telemetry) == new and all(math.isfinite(v) and v > 0
                                               for v in h.telemetry),
              f"request {req.request_id}: telemetry not finite")
        n_tok += len(h.tokens)
    n_ticks = len(tick_ms)
    check(counts["sum_accumulators_batched"] == n_ticks + len(cells),
          f"sum kernel launched {counts['sum_accumulators_batched']} times "
          f"for {n_ticks} decode ticks + {len(cells)} finished prefills")
    n_prompt = sum(chunk_pos)
    stats = {
        "trace": trace, "prefill_mode": prefill_mode,
        "kahan_attention": cfg.kahan_attention,
        "kahan_matmul": cfg.kahan_matmul, "requests": len(cells),
        "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "decode_ticks": n_ticks, "decode_positions": sum(positions),
        "decode_tick_ms_mean": sum(tick_ms) / max(n_ticks, 1),
        "decode_tick_ms_min": min(tick_ms, default=None),
        "decode_s": sum(tick_ms) / 1e3,
        "prefill_chunks": len(chunk_ms), "chunk_widths": widths,
        "prefill_s": sum(chunk_ms) / 1e3,
        "prefill_chunk_ms_mean": sum(chunk_ms) / len(chunk_ms),
        "prefill_ms_per_position": sum(chunk_ms) / n_prompt,
        "prefill_positions_per_s": n_prompt / (sum(chunk_ms) / 1e3),
        "launches": counts,
        "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    log(f"# phase 4 [{prefill_mode}, kahan_attention={cfg.kahan_attention}, "
        f"kahan_matmul={cfg.kahan_matmul}] {trace}: {len(cells)} requests, {n_tok} tokens in {wall:.2f} s "
        f"({stats['tokens_per_s']:.1f} tokens/s); {len(chunk_ms)} prefill "
        f"chunks in {stats['prefill_s']:.2f} s "
        f"({stats['prefill_ms_per_position']:.3f} ms per position); "
        f"{n_ticks} decode ticks in {stats['decode_s']:.2f} s "
        f"({stats['decode_tick_ms_mean']:.2f} ms mean); launches {counts}")
    return ec, requests, served, captured, stats


def check_flash_launches(cfg, stats, what):
    """Under flash, B8 ran n_layers times per chunk of width > 1 (a
    width-1 tail runs the decode mode, as in the reference); with
    ``kahan_matmul`` B5 ran once per projection, layer, prefill chunk and
    decode position, and never without it; B6, B7 and the dot / single
    sum kernels never."""
    counts = stats["launches"]
    wide = sum(1 for w in stats["chunk_widths"] if w > 1)
    check(counts["flash_chunk_accumulators"] == cfg.n_layers * wide,
          f"{what}: B8 launched {counts['flash_chunk_accumulators']} times "
          f"for {wide} chunks x {cfg.n_layers} layers")
    units = stats["prefill_chunks"] + stats["decode_positions"]
    want = PROJECTIONS * cfg.n_layers * units if cfg.kahan_matmul else 0
    check(counts["matmul_accumulators"] == want,
          f"{what}: B5 launched {counts['matmul_accumulators']} times, "
          f"want {want} ({PROJECTIONS} x {cfg.n_layers} layers x {units} "
          f"chunks and decode positions)" if cfg.kahan_matmul else
          f"{what}: B5 launched without kahan_matmul")
    for name in ("flash_accumulators", "dot_accumulators",
                 "dot_accumulators_batched", "sum_accumulators",
                 "matmul_accumulators_batched"):
        check(counts[name] == 0,
              f"{what}: {name} launched {counts[name]} times while serving")


def main_path(torch, kernels: Kernels, cfg, paper_n):
    """Phases 4 and 5: the port's main paths, each with the launch counts
    reset just before it, then solo vs interleaved."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.engine import (
        Accumulator,
        CompensatedReduction,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.serve import InferenceEngine

    dev = kernels.dev
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    flash_cfg = cfg.replace(kahan_attention=True)
    flash_model = build_model(flash_cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"# phase 4: OLMo-1B {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"({cfg.padded_vocab} padded), {n_params / 1e9:.3f} B params "
        f"{cfg.param_dtype}")

    # -- serving: scan, flash on the same trace, and one long flash request
    ec, requests, served, captured, scan = serve_run(
        torch, kernels, cfg, model, params, TRACE, "scan")
    for name in kernels.engine.WRAPPERS:
        check((scan["launches"][name] > 0)
              == (name == "sum_accumulators_batched"),
              f"{name} launched {scan['launches'][name]} times while "
              f"serving under scan")
    # one tick's telemetry against the plain version on the same logits
    logits = captured["logits"][:, :cfg.vocab_size]
    eng = CompensatedReduction(scheme=ec.policy)
    sq = eng._prep2d(logits.float() * logits.float())
    s, c = kernels.ks.sum_plain(sq, scheme=eng.scheme, unroll=eng.unroll)
    check(torch.equal(Accumulator(s, c).total(), captured["norms"]),
          "decode-tick telemetry differs from the plain version")
    log("# phase 4: one tick's telemetry bitwise equal to the plain version")
    scan["decode_position"] = profile_decode_step(torch, model, params, dev,
                                                  ec.max_len)

    fec, _, fserved, _, flash = serve_run(
        torch, kernels, flash_cfg, flash_model, params, TRACE, "flash")
    check_flash_launches(flash_cfg, flash, "flash serving")
    flash["chunk_profile"] = profile_flash_chunk(torch, flash_model, params,
                                                 dev, fec.max_len)
    agree = [sum(a == b for a, b in zip(served[r.request_id].tokens,
                                        fserved[r.request_id].tokens))
             for r in requests]
    flash["greedy_tokens_equal_to_scan"] = agree
    log(f"# phase 4: prefill {flash['prefill_ms_per_position']:.3f} ms per "
        f"position under flash vs {scan['prefill_ms_per_position']:.3f} "
        f"under scan; {flash['tokens_per_s']:.1f} vs "
        f"{scan['tokens_per_s']:.1f} tokens/s; greedy tokens equal to scan's "
        f"per request (not checked): {agree}")
    matmul_cfg = flash_cfg.replace(kahan_matmul=True)
    matmul_model = build_model(matmul_cfg, dev)
    mec, _, mserved, _, mm = serve_run(
        torch, kernels, matmul_cfg, matmul_model, params, TRACE, "flash")
    check_flash_launches(matmul_cfg, mm, "kahan_matmul serving")
    mm["decode_position"] = profile_decode_step(torch, matmul_model, params,
                                                dev, mec.max_len)
    mm["chunk_profile"] = profile_flash_chunk(torch, matmul_model, params,
                                              dev, mec.max_len)
    mm["cublas_kernels_dropped_per_position"] = (
        scan["decode_position"]["cublas_kernels"]
        - mm["decode_position"]["cublas_kernels"])
    mm["chunk_logits"] = compare_chunk_logits(torch, kernels, cfg,
                                              flash_model, matmul_model,
                                              params)
    mm["dense_enqueue_us"] = dense_enqueue_cost(torch, kernels, cfg)
    log(f"# phase 4 [kahan_matmul vs flash]: {mm['tokens_per_s']:.1f} vs "
        f"{flash['tokens_per_s']:.1f} tokens/s; decode tick "
        f"{mm['decode_tick_ms_mean']:.2f} vs "
        f"{flash['decode_tick_ms_mean']:.2f} ms mean; prefill "
        f"{mm['prefill_ms_per_position']:.3f} vs "
        f"{flash['prefill_ms_per_position']:.3f} ms per position; gemm/gemv "
        f"kernels per decode position "
        f"{mm['decode_position']['cublas_kernels']} vs "
        f"{scan['decode_position']['cublas_kernels']} (dropped "
        f"{mm['cublas_kernels_dropped_per_position']}; "
        f"{PROJECTIONS * cfg.n_layers} projections)")
    _, _, _, _, long = serve_run(torch, kernels, flash_cfg, flash_model,
                                 params, LONG_TRACE, "flash")
    check_flash_launches(flash_cfg, long, "long flash request")
    long["chunk_profile"] = profile_flash_chunk(
        torch, flash_model, params, dev, serve_max_len(LONG_TRACE))

    # -- the entry points: the paper's reductions, prefill, the veneer
    a = kernels.data((paper_n,), torch.float32)
    b = kernels.data((paper_n,), torch.float32)
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN),
                           generator=kernels.gen, device=dev)
    heads = [kernels.normal((cfg.n_heads, PREFILL_LEN, cfg.head_dim))
             for _ in range(3)]
    hd = cfg.n_heads * cfg.head_dim
    up = [kernels.normal((PREFILL_LEN, cfg.d_model)).bfloat16(),
          kernels.normal((cfg.d_model, cfg.d_ff)).bfloat16()]
    qs = [kernels.normal((4, 64, cfg.d_model)).bfloat16(),
          kernels.normal((4, cfg.d_model, hd)).bfloat16()]
    sync(torch, dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    totals = [ops.dot(a, b), ops.asum(a),
              ops.batched_dot(a.view(8, -1), b.view(8, -1)),
              ops.batched_asum(a.view(8, -1))]
    t1 = time.perf_counter()
    flash_logits, _ = flash_model.prefill(
        params, prompt, flash_model.init_cache(1, PREFILL_LEN))
    sync(torch, dev)
    prefill_ms = (time.perf_counter() - t1) * 1e3
    veneer = flash_attention(*heads, scheme="kahan")
    t2 = time.perf_counter()
    products = [ops.matmul(*up), ops.batched_matmul(*qs)]
    sync(torch, dev)
    matmul_ms = (time.perf_counter() - t2) * 1e3
    entry_counts = launch_counts()
    kernels.launches = {"entry": entry_counts, "serve": scan["launches"],
                        "serve-flash": flash["launches"],
                        "serve-matmul": mm["launches"],
                        "serve-long": long["launches"]}
    log(f"# main path launch counts: the entry points {entry_counts} "
        f"(reductions {1e3 * (t1 - t0):.1f} ms, {PREFILL_LEN}-token flash "
        f"prefill {prefill_ms:.1f} ms)")
    for name in list(kernels.engine.WRAPPERS)[:4]:
        check(entry_counts[name] > 0,
              f"{name} never launched by the paper's entry points")
    check(entry_counts["flash_accumulators"] == cfg.n_layers + 1,
          f"B7 launched {entry_counts['flash_accumulators']} times for "
          f"{cfg.n_layers} prefill layers + 1 veneer call")
    check(entry_counts["flash_chunk_accumulators"] == 0,
          "B8 launched on the entry path")
    check(entry_counts["matmul_accumulators"] == 1
          and entry_counts["matmul_accumulators_batched"] == 1,
          f"B5 / B6 launched {entry_counts['matmul_accumulators']} / "
          f"{entry_counts['matmul_accumulators_batched']} times for one "
          f"ops.matmul and one ops.batched_matmul")
    check(all(bool(torch.isfinite(t).all())
              for t in totals + [veneer] + products),
          "non-finite result from the entry points")
    # the 2048-token up projection against float32 torch.matmul, within
    # 1e-5 of |a| @ |b| (the block products' rounding, fixed order)
    af, bf = up[0].float(), up[1].float()
    scale = torch.matmul(af.abs(), bf.abs())
    up_err = float(((products[0] - torch.matmul(af, bf)).abs()
                    / scale).max())
    log(f"# entry: ops.matmul {list(af.shape)} x {list(bf.shape)} and "
        f"ops.batched_matmul {[4, 64, cfg.d_model, hd]} in {matmul_ms:.1f} "
        f"ms; the product within {up_err:.2e} of |a| @ |b| of float32 "
        f"torch.matmul")
    check(up_err < 1e-5, f"ops.matmul differs from float32 torch.matmul by "
          f"{up_err:.2e} of |a| @ |b|")
    del af, bf, scale, products
    check(flash_logits.shape == (1, cfg.padded_vocab)
          and bool(torch.isfinite(flash_logits[:, :cfg.vocab_size]).all()),
          "prefill logits not finite / of the wrong shape")
    # the same prompt through the materialized attention core
    plain_logits, _ = model.prefill(params, prompt,
                                    model.init_cache(1, PREFILL_LEN))
    fl, pl = (x[0, :cfg.vocab_size].double() for x in (flash_logits,
                                                       plain_logits))
    rel = float((fl - pl).norm() / pl.norm())
    log(f"# entry: {PREFILL_LEN}-token prefill logits, flash vs materialized "
        f"attention: relative L2 {rel:.3e}, argmax {int(fl.argmax())} vs "
        f"{int(pl.argmax())}")
    check(rel < 0.1, f"flash prefill logits differ from the materialized "
          f"path's by {rel:.3e} (relative L2)")
    del a, b, heads

    # -- 5. solo vs interleaved ------------------------------------------------
    req0 = requests[0]
    for what, c, m, e, out in (("scan", cfg, model, ec, served),
                               ("flash", flash_cfg, flash_model, fec,
                                fserved),
                               ("kahan_matmul", matmul_cfg, matmul_model,
                                mec, mserved)):
        solo = InferenceEngine(c, e, model=m, params=params).run(
            [req0])[req0.request_id]
        check(solo.tokens == out[req0.request_id].tokens,
              f"request 0: tokens differ solo vs interleaved ({what})")
        both = out[req0.request_id].telemetry
        differ = [(i, x, y) for i, (x, y) in enumerate(zip(solo.telemetry,
                                                          both)) if x != y]
        check(solo.telemetry == both,
              f"request 0: telemetry differs solo vs interleaved ({what}): "
              f"(position, solo, interleaved) {differ[:4]}, "
              f"{len(solo.telemetry)} and {len(both)} values")
        log(f"# phase 5 [{what}]: request 0 alone == interleaved, bitwise "
            f"({len(solo.tokens)} tokens and telemetry values)")
    return {"scan": scan, "flash": flash, "matmul": mm, "flash_long": long,
            "entry_prefill_ms": prefill_ms, "entry_logits_rel_l2": rel,
            "entry_matmul_ms": matmul_ms, "entry_matmul_err": up_err,
            "b5_totals": kernels.matmul_totals,
            "reduce_clock": kernels.reduce_clock}


def train_path(torch, kernels, cfg):
    """Phase 6: OLMo-1B trained by the port's ``Trainer`` at full width
    and depth, run A (cuBLAS projections, KahanAdamW with the compensated
    tree norm: the column-scan kernel) and run B (``kahan_matmul``: every
    projection, its recompute and its backward on B5; the engine-folded
    norm: B3 once a leaf), each with the launch counts reset just before
    it; then the norm as a loop and as a kernel, and a crash-restart at
    the smoke config."""
    from repro_torch.optim import AdamWConfig

    dev = kernels.dev
    a = train_run(torch, kernels, cfg, AdamWConfig(lr=TRAIN_LR), "A")
    b = train_run(torch, kernels, cfg.replace(kahan_matmul=True),
                  AdamWConfig(lr=TRAIN_LR, kahan_norm=False), "B")
    leaves, tall = a.pop("leaves"), a.pop("tall_leaves")
    b.pop("leaves"), b.pop("tall_leaves")
    for run in (a, b):
        losses = run["loss"]
        check(all(math.isfinite(x) for x in losses + run["grad_norm"]),
              f"run {run['name']}: a loss or grad norm is not finite")
        check(losses[-1] < losses[0],
              f"run {run['name']}: the step-{TRAIN_STEPS} loss "
              f"{losses[-1]:.4f} is not below the step-1 loss "
              f"{losses[0]:.4f}")
    rel = abs(b["loss"][0] - a["loss"][0]) / a["loss"][0]
    check(rel < STEP1_LOSS_RTOL,
          f"run B's step-1 loss {b['loss'][0]:.6f} differs from run A's "
          f"{a['loss'][0]:.6f} by {rel:.2e} (relative)")
    rel_g = abs(b["grad_norm"][0] - a["grad_norm"][0]) / a["grad_norm"][0]
    check(rel_g < STEP1_GRAD_NORM_RTOL,
          f"run B's step-1 grad norm {b['grad_norm'][0]:.6f} differs from "
          f"run A's {a['grad_norm'][0]:.6f} by {rel_g:.2e} (relative)")
    b5 = 4 * PROJECTIONS * cfg.n_layers * TRAIN_MICRO
    ca, cb = a["launches"], b["launches"]
    check(cb["matmul_accumulators"] == TRAIN_STEPS * b5,
          f"run B launched B5 {cb['matmul_accumulators']} times in "
          f"{TRAIN_STEPS} steps, not {TRAIN_STEPS} x {b5}")
    check(cb["sum_accumulators"] == TRAIN_STEPS * leaves,
          f"run B launched B3 {cb['sum_accumulators']} times in "
          f"{TRAIN_STEPS} steps, not {TRAIN_STEPS} x {leaves} leaves")
    check(ca["column_sq_accumulators"] == TRAIN_STEPS * tall,
          f"run A launched the column scan {ca['column_sq_accumulators']} "
          f"times in {TRAIN_STEPS} steps, not {TRAIN_STEPS} x {tall}")
    for run, allowed in ((a, {"column_sq_accumulators"}),
                         (b, {"matmul_accumulators", "sum_accumulators"})):
        for name, n in run["launches"].items():
            check(n == 0 or name in allowed,
                  f"run {run['name']}: {name} launched {n} times")
    log(f"# phase 6: run B's step-1 loss within {rel:.2e} of run A's "
        f"(limit {STEP1_LOSS_RTOL}), its grad norm within {rel_g:.2e} "
        f"(limit {STEP1_GRAD_NORM_RTOL}); B5 {b5} and B3 {leaves} launches a "
        f"step, the column scan {tall}; losses fall in both runs")
    kernels.launches["train-a"] = ca
    kernels.launches["train-b"] = cb
    resume = resume_check(torch, dev)
    return {"A": a, "B": b, "step1_loss_rel": rel,
            "step1_grad_norm_rel": rel_g, "resume": resume,
            "b5_launches_per_step": b5, "b3_launches_per_step": leaves}


def train_run(torch, kernels, cfg, opt, name):
    """One training run of ``TRAIN_STEPS`` steps through ``Trainer.run``,
    launch counts reset just before and read just after; its
    ``failure_hook`` synchronises and marks each step's start. Then one
    more step under the profiler (device-busy time, kernel time by name)
    and, for run A, the norm as a loop and as a kernel."""
    import gc

    from repro_torch.core import tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.optim import apply_update
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import batch_to_device

    dev = kernels.dev
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tc = TrainConfig(steps=TRAIN_STEPS, microbatches=TRAIN_MICRO, warmup=1,
                     log_every=1, ckpt_every=10 ** 9, opt=opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    marks = []

    def mark(step):
        sync(torch, dev)
        marks.append(time.perf_counter())

    trainer = Trainer(cfg, tc, data, failure_hook=mark, seed=0, device=dev)
    sync(torch, dev)
    reset_launch_counts()
    trainer.run()
    sync(torch, dev)
    marks.append(time.perf_counter())
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    step_ms = [(y - x) * 1e3 for x, y in zip(marks, marks[1:])]
    hist = trainer.metrics_history
    t0 = time.perf_counter()
    batch = batch_to_device(data.batch_at(TRAIN_STEPS), dev)
    data_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_once(torch, dev, lambda: trainer.step_fn(
        trainer.params, trainer.opt_state, batch))
    # the optimizer step alone, on a tree of the gradients' shapes (the
    # first moments' copy)
    grads = T.tree_map(torch.clone, trainer.opt_state.m)
    opt_prof = profile_once(torch, dev, lambda: apply_update(
        opt, trainer.params, grads, trainer.opt_state))
    del grads
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = step_ms[1:]
    wall = sum(steady) / len(steady)
    leaves = T.leaves(trainer.params)
    out = {"name": name, "kahan_matmul": cfg.kahan_matmul,
           "kahan_norm": opt.kahan_norm,
           "loss": [m["loss"] for m in hist],
           "grad_norm": [m["grad_norm"] for m in hist],
           "step_ms": step_ms, "wall_ms_per_step": wall,
           "tokens_per_s": tokens / wall * 1e3,
           "batch_host_ms": data_ms,
           "device_busy_ms_per_step": prof["busy_ms"],
           "device_busy_share": prof["busy_ms"] / wall,
           "profiled_step_ms": prof["host_ms"],
           "kernel_ms_per_step": prof["by_kernel"],
           "top_kernels_ms": prof["top"],
           "optimizer_ms": opt_prof["host_ms"],
           "optimizer_device_ms": opt_prof["busy_ms"],
           "optimizer_top_kernels_ms": opt_prof["top"],
           "peak_bytes": peak, "peak_share": peak / total,
           "launches": counts,
           "leaves": len(leaves),
           "tall_leaves": sum(x.dim() >= 2 and x.shape[0] > 1
                              for x in leaves)}
    log(f"# phase 6 run {name} (kahan_matmul={cfg.kahan_matmul}, "
        f"kahan_norm={opt.kahan_norm}): {wall:.1f} ms a step after the "
        f"first ({step_ms[0]:.1f} the first; batch made on the host in "
        f"{data_ms:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, device "
        f"busy {prof['busy_ms']:.1f} ms a step ({100 * out['device_busy_share']:.1f}%), "
        f"peak {peak / 2 ** 30:.2f} GiB ({100 * peak / total:.1f}% of the "
        f"card); loss {[round(x, 4) for x in out['loss']]}, grad norm "
        f"{[round(x, 4) for x in out['grad_norm']]}")
    log(f"# phase 6 run {name}: kernels in the profiled step "
        f"{prof['by_kernel']}; top {prof['top']}; the optimizer step alone "
        f"{opt_prof['host_ms']:.1f} ms, {opt_prof['busy_ms']:.1f} ms of it "
        f"on the device, top {opt_prof['top']}")
    if name == "A":
        out["norm"] = norm_loop_vs_kernel(torch, kernels, trainer.opt_state.m)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: kernel names of the port's wrappers in a profiler trace
PORT_KERNELS = {"kahan_matmul": "B5", "kahan_sum_grid": "B3",
                "kahan_sq_columns": "column scan"}


def device_events(torch, dev, fn):
    """One call of ``fn`` under ``torch.profiler``: its host ms and the
    device kernels it ran, ``[(ms, name, count)]`` (none on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(torch, dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        host_ms = (time.perf_counter() - t0) * 1e3
    return host_ms, [(e.self_device_time_total / 1e3, e.key, e.count)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]


def profile_once(torch, dev, fn):
    """One call of ``fn`` under ``torch.profiler``: host ms, device-busy
    ms (the sum of device kernel times) and the port's kernels' ms and
    counts by name."""
    host_ms, events = device_events(torch, dev, fn)
    by_kernel = {}
    for ms, key, n in events:
        for part, label in PORT_KERNELS.items():
            if part in key:
                got = by_kernel.setdefault(label, [0.0, 0])
                got[0] += ms
                got[1] += n
    top = [[key[:60], ms, n] for ms, key, n in sorted(events,
                                                       reverse=True)[:6]]
    return {"host_ms": host_ms, "busy_ms": sum(e[0] for e in events),
            "by_kernel": by_kernel, "top": top}


def norm_loop_vs_kernel(torch, kernels, tree):
    """The compensated tree norm of a float32 tree of the gradients'
    shapes (run A's first moments) as the kernel runs it
    (``tree_kahan_sq_norm``: one column-scan launch a leaf) and as the
    plain loop over each leaf's rows; the (s, c) vectors bitwise equal.
    Fills in the plain time of the [V_pad, d] column row (phase 3)."""
    from repro_torch.core import tree as T
    from repro_torch.core.kahan import column_sq_plain, tree_kahan_sq_norm
    from repro_torch.kernels.kahan_columns import column_sq_accumulators

    dev = kernels.dev
    tree_kahan_sq_norm(tree)
    sync(torch, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    norm = tree_kahan_sq_norm(tree)
    end.record()
    sync(torch, dev)
    kernel_ms = start.elapsed_time(end)
    loop_ms = 0.0
    for leaf in T.leaves(tree):
        if not (leaf.dim() >= 2 and leaf.shape[0] > 1):
            continue
        want = column_sq_accumulators(leaf)
        sync(torch, dev)
        t0 = time.perf_counter()
        got = column_sq_plain(leaf)
        sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        loop_ms += ms
        kernels.compare("column_sq_accumulators", want, got,
                        f"run A's {list(leaf.shape)} leaf")
        if tuple(leaf.shape) == tuple(kernels.timing[
                ("column_sq_accumulators", "train")]["shape"]):
            kernels.timing[("column_sq_accumulators", "train")][
                "plain_ms"] = ms
    log(f"# phase 6: the compensated tree norm ({float(norm):.6e}) "
        f"{kernel_ms:.3f} ms a step through the column-scan kernel, "
        f"{loop_ms:.1f} ms as the plain loop over the rows; every leaf's "
        f"(s, c) bitwise equal")
    return {"kernel_ms": kernel_ms, "loop_ms": loop_ms}


def resume_check(torch, dev):
    """At the smoke config on the card: a run that crashes after step 2
    (``FailureInjector``) and resumes from its checkpoint under
    ``run_with_restarts`` reaches step 4 with params and optimizer state
    bitwise equal to the uninterrupted run's (``kahan_matmul`` on, so B5
    and the one-hot embedding backward are in the step)."""
    import tempfile

    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.ft import FailureInjector, run_with_restarts
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke("olmo-1b").replace(kahan_matmul=True)

    def make(ckpt_dir, hook=None):
        tc = TrainConfig(steps=4, microbatches=2, warmup=1, log_every=1,
                         ckpt_every=2, ckpt_dir=ckpt_dir,
                         opt=AdamWConfig(lr=1e-3))
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=8))
        return Trainer(cfg, tc, data, failure_hook=hook, seed=0, device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        ref = make(os.path.join(tmp, "ref"))
        ref.run()
        injector = FailureInjector(fail_at=[2])
        resumed, restarts = run_with_restarts(
            lambda: make(os.path.join(tmp, "ft"), injector), max_restarts=2)
    check(restarts == 1 and resumed.step == 4,
          f"crash-restart: {restarts} restarts, step {resumed.step}")
    pairs = list(zip(T.leaves((ref.params, ref.opt_state)),
                     T.leaves((resumed.params, resumed.opt_state))))
    same = sum(torch.equal(x, y) for x, y in pairs)
    check(same == len(pairs),
          f"crash-restart: {len(pairs) - same} of {len(pairs)} param / "
          f"optimizer leaves differ from the uninterrupted run")
    log(f"# phase 6: a smoke-config run crashed after step 2 resumed to step "
        f"4 with all {len(pairs)} param and optimizer leaves bitwise equal "
        f"to the uninterrupted run's")
    return {"leaves": len(pairs), "restarts": restarts}


def dense_enqueue_cost(torch, kernels, cfg, calls=200):
    """Host microseconds to enqueue one decode q projection (``dense`` on
    [1, 1, d] bf16 against [d, H, dh] bf16), plain (cuBLAS) and
    compensated (B5 through ``ops.matmul``): ``calls`` calls on the host
    clock without a synchronise, then the total once the card is done."""
    from repro_torch.models.layers import dense

    x = kernels.normal((1, 1, cfg.d_model)).bfloat16()
    p = {"w": kernels.normal((cfg.d_model, cfg.n_heads,
                              cfg.head_dim)).bfloat16()}
    out = {}
    for compensated in (False, True):
        fn = lambda: dense(p, x, torch.bfloat16,  # noqa: E731
                           compensated=compensated)
        fn()
        sync(torch, kernels.dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        enqueued = time.perf_counter() - t0
        sync(torch, kernels.dev)
        total = time.perf_counter() - t0
        key = "compensated" if compensated else "plain"
        out[key] = {"enqueue_us": enqueued / calls * 1e6,
                    "total_us": total / calls * 1e6}
    log(f"# phase 4: one decode q projection, host us per call (enqueue / "
        f"total): plain {out['plain']['enqueue_us']:.1f} / "
        f"{out['plain']['total_us']:.1f}, compensated "
        f"{out['compensated']['enqueue_us']:.1f} / "
        f"{out['compensated']['total_us']:.1f}")
    return out


def compare_chunk_logits(torch, kernels, cfg, flash_model, matmul_model,
                         params):
    """One 64-token chunk at offset 0 through the flash model and the
    ``kahan_matmul`` model: the last position's logits within 5e-2
    (relative L2) and the same argmax."""
    w = 64
    toks = torch.randint(0, cfg.vocab_size, (1, w), generator=kernels.gen,
                         device=kernels.dev)
    out = []
    for m in (flash_model, matmul_model):
        logits, _ = m.prefill_chunk_parallel(params, toks,
                                             m.init_cache(1, w), 0, w)
        out.append(logits[0, :cfg.vocab_size].double())
    fl, ml = out
    rel = float((ml - fl).norm() / fl.norm())
    same = int(ml.argmax()) == int(fl.argmax())
    log(f"# phase 4: a {w}-token chunk's logits with kahan_matmul vs flash: "
        f"relative L2 {rel:.3e}, argmax {int(ml.argmax())} vs "
        f"{int(fl.argmax())}")
    check(rel < 5e-2 and same, f"kahan_matmul chunk logits differ from the "
          f"flash run's: relative L2 {rel:.3e}, same argmax {same}")
    return {"rel_l2": rel, "same_argmax": same}


def profile_step(torch, dev, step, what, reps=5):
    """Host time and device-busy time of ``step(i)``: host time is the mean
    of ``reps`` unprofiled calls after one warm-up; device-busy time sums
    the device kernels ``torch.profiler`` records in one more call (None
    when it records no device time)."""
    step(0)                                             # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    for i in range(1, reps + 1):
        step(i)
    sync(torch, dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    _, kernels = device_events(torch, dev, lambda: step(reps + 1))
    busy_ms = sum(k[0] for k in kernels)
    top = sorted(kernels, reverse=True)[:6]
    out = {"host_ms": host_ms,
           "device_busy_ms": busy_ms or None,
           "device_idle_share": 1 - busy_ms / host_ms if busy_ms else None,
           "device_kernels": sum(k[2] for k in kernels),
           "cublas_kernels": sum(n for _, key, n in kernels
                                 if is_cublas(key)),
           "top_kernels_ms": [[name[:60], ms, n] for ms, name, n in top]}
    log(f"# {what}: {host_ms:.2f} ms host clock, device busy "
        f"{busy_ms:.3f} ms in {out['device_kernels']} kernels "
        f"({out['cublas_kernels']} gemm/gemv); top {out['top_kernels_ms']}")
    return out


def is_cublas(kernel_name: str) -> bool:
    """A cuBLAS / cuBLASLt product kernel: gemm and gemv kernels, and the
    ``nvjet`` kernels cuBLASLt runs on Hopper."""
    name = kernel_name.lower()
    return any(word in name for word in ("gemm", "gemv", "nvjet"))


def profile_decode_step(torch, model, params, dev, max_len):
    """One batch-1 decode position: the unit a decode tick runs per slot
    and scan prefill per prompt position."""
    cache = model.init_cache(1, max_len)
    tok = torch.tensor([1], device=dev)
    return profile_step(
        torch, dev, lambda i: model.decode_step(params, cache, tok, i),
        "decode position")


def profile_flash_chunk(torch, model, params, dev, max_len):
    """One 64-token flash prefill chunk, the last full chunk of a prompt
    that fills a ``max_len`` cache (the unit flash prefill runs per
    chunk)."""
    w = min(64, max_len)
    off = (max_len - w) // w * w
    cache = model.init_cache(1, max_len)
    toks = torch.ones((1, w), dtype=torch.long, device=dev)
    return profile_step(
        torch, dev,
        lambda i: model.prefill_chunk_parallel(params, toks, cache, off, w),
        f"flash chunk of {w} at offset {off} (cache {max_len})")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- 8. the sharded slice on two ranks ----------------------------------------

def dist_spec(cfg, device="cuda"):
    """What phase 8's ranks run, passed to each (its sizes, the model)."""
    return {"device": device, "n": DIST_N, "matmul": DIST_MATMUL,
            "act": DIST_ACT, "leaf": DIST_LEAF, "cfg": cfg,
            "steps": DIST_TRAIN_STEPS, "micro": TRAIN_MICRO,
            "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "lr": TRAIN_LR}


def dist_inputs(torch, dev, rank, spec):
    """Phase 8's inputs, made on ``dev`` from seeds: the same tensors on
    every rank (each passes the whole tensor and reduces its block), but
    the compressed leaf, which is each rank's own."""
    gen = torch.Generator(device=dev).manual_seed(8)

    def wide(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        e = torch.randint(-8, 8, shape, generator=gen, device=dev)
        return x * torch.exp2(e.float())

    m, k, n = spec["matmul"]
    out = {"x": wide(spec["n"]), "y": wide(spec["n"]), "a": wide(m, k),
           "b": wide(k, n), "act": wide(*spec["act"]),
           "values": torch.tensor([1.25, -3.5e-3], device=dev)}
    leaf = torch.Generator(device=dev).manual_seed(80 + rank)
    out["leaf"] = torch.randn(spec["leaf"], generator=leaf, device=dev)
    return out


def dist_cases(torch, mesh, d):
    """The sharded entry points once each (``repro_torch.distributed``)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.models.layers import activation_sq_norm

    return {"asum": coll.sharded_asum(mesh, d["x"]),
            "dot": coll.sharded_dot(mesh, d["x"], d["y"]),
            "matmul": coll.sharded_matmul(mesh, d["a"], d["b"]),
            "act": activation_sq_norm(d["act"], mesh=mesh),
            "mean": coll.deterministic_mean(mesh, d["values"]),
            "compressed": compressed_psum(d["leaf"], mesh.get_group("data"))}


def dist_rank(rank, store, out, spec):
    """One rank of phase 8, in its own process on the one card: a gloo
    group over a ``FileStore``, the local mesh, the sharded entry points
    twice (launch counts reset just before, read just after), the
    gather's and the sharded sum's times, then OLMo-1B trained at full
    width and depth on the 2-rank mesh, twice. Writes its results to
    ``out`` (``torch.save``). ``spec``: ``dist_spec``."""
    import gc

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import kahan as K
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import engine
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import batch_to_device

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, DIST_RANKS),
                            rank=rank, world_size=DIST_RANKS)
    mesh = make_local_mesh(device=dev)
    group = mesh.get_group("data")
    d = dist_inputs(torch, dev, rank, spec)
    res = {"runs": []}
    engine.reset_launch_counts()
    for _ in range(2):
        res["runs"].append(dist_cases(torch, mesh, d))
    sync(torch, dev)
    res["launches"] = engine.launch_counts()
    # the gather of one U = 8 grid, host clock a call; the sharded sum,
    # device time between events (gloo's host round trip included)
    grid = torch.zeros((64, 128), device=dev)
    for _ in range(3):
        K.gather_ranks(grid, group)
    sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(50):
        K.gather_ranks(grid, group)
    sync(torch, dev)
    res["gather_us"] = (time.perf_counter() - t0) / 50 * 1e6
    from repro_torch.distributed import collectives as coll

    res["sharded_sum_ms"] = cuda_ms(
        torch, lambda: coll.sharded_asum(mesh, d["x"]), reps=10) if cuda \
        else None
    res["runs"] = [{k: v.cpu() for k, v in run.items()}
                   for run in res["runs"]]
    del d, grid
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # OLMo-1B on the mesh: run A's settings (cuBLAS projections, the
    # column-scan norm), the loss folded through the sharded sum
    cfg = spec["cfg"]
    tc = TrainConfig(steps=spec["steps"], microbatches=spec["micro"],
                     warmup=1, log_every=1, ckpt_every=10 ** 9,
                     opt=AdamWConfig(lr=spec["lr"]))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=spec["seq"],
                                  global_batch=spec["batch"]))
    res["train"] = []
    for _ in range(2):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        trainer = Trainer(cfg, tc, data, seed=0, device=dev, mesh=mesh)
        micro = []
        loss_fn = trainer.model.loss

        def recording(params, batch, _f=loss_fn):
            loss, metrics = _f(params, batch)
            micro.append(loss.detach().float().clone())
            return loss, metrics

        trainer.model.loss = recording
        losses = []
        engine.reset_launch_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        for step in range(spec["steps"]):
            batch = batch_to_device(data.batch_at(step), dev)
            trainer.params, trainer.opt_state, m = trainer.step_fn(
                trainer.params, trainer.opt_state, batch)
            losses.append(m["loss"].detach().clone())
        sync(torch, dev)
        res["train"].append({
            "loss": torch.stack(losses).cpu(),
            "micro": torch.stack(micro).cpu(),
            "launches": engine.launch_counts(),
            "seconds": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else 0})
        del trainer, m, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    res["total_bytes"] = (torch.cuda.get_device_properties(dev).total_memory
                          if cuda else 1)
    torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def dist_path(torch, kernels, spec):
    """Phase 8: the sharded compensated reductions over
    ``torch.distributed`` and the trainer's sharded loss fold, on two
    ranks sharing the one card (gloo: NCCL refuses two ranks on one
    device), started with ``torch.multiprocessing`` over a ``FileStore``.
    Gates: every result the same bits on both ranks and in both runs;
    equal to ``merge_accumulators`` / ``merge_accumulator_grids`` over the
    per-shard grids this process computes with the same kernels on the
    same card, and to the plain versions' sharded fold; the trainer's
    loss the same bits on both ranks and run to run, equal to the sharded
    fold of its microbatch losses recomputed here and within 1e-6
    (relative) of their local Kahan fold."""
    import gc
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core import kahan as K

    t_start = time.perf_counter()
    dev = kernels.dev
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    scratch = Path(tempfile.mkdtemp(prefix="dist-", dir=ROOT / "build"))
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=dist_rank, args=(
            r, str(scratch / "store"), str(scratch / f"rank{r}.pt"), spec))
            for r in range(DIST_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
            check(p.exitcode == 0, f"phase 8: rank {r} exited with "
                  f"{p.exitcode}")
        ranks = [torch.load(scratch / f"rank{r}.pt", weights_only=False)
                 for r in range(DIST_RANKS)]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    def same(x, y):
        return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)))

    # 1. the same bits on both ranks and in both runs
    for r, res in enumerate(ranks):
        for key, val in res["runs"][0].items():
            check(same(val, res["runs"][1][key]),
                  f"phase 8: {key} differs run to run on rank {r}")
            if key != "act":
                check(same(val, ranks[0]["runs"][0][key]),
                      f"phase 8: {key} differs between ranks 0 and {r}")
    # 2. against the per-shard grids of the same kernels here, and the
    # plain versions' sharded fold
    want_kernel, want_plain = dist_expected(torch, kernels, dev, spec)
    for key, want in want_kernel.items():
        for r, res in enumerate(ranks):
            got = res["runs"][0][key]
            w = want[r] if key == "act" else want
            check(same(got, w.cpu()),
                  f"phase 8: {key} on rank {r} != the kernels' per-shard "
                  f"grids folded here")
            w = want_plain[key][r] if key == "act" else want_plain[key]
            check(same(got, w.cpu()),
                  f"phase 8: {key} on rank {r} != the plain versions' "
                  f"sharded fold")
    counts = ranks[0]["launches"]
    for name, n in (("sum_accumulators", 2), ("dot_accumulators", 2),
                    ("matmul_accumulators", 2),
                    ("sum_accumulators_batched", 2)):
        check(counts[name] == n, f"phase 8: {name} launched {counts[name]} "
              f"times on rank 0 in two runs of the sharded calls, not {n}")
    # 3. the trainer
    ref = ranks[0]["train"][0]
    eng = kernels.engine.CompensatedReduction()
    for r, res in enumerate(ranks):
        for i, run in enumerate(res["train"]):
            check(same(run["loss"], ref["loss"]),
                  f"phase 8: the trainer's loss on rank {r} run {i} != rank "
                  f"0 run 0's")
            check(bool(torch.isfinite(run["loss"]).all()),
                  "phase 8: a trainer loss is not finite")
    steps, n_micro = spec["steps"], spec["micro"]
    micro = ref["micro"].view(steps, n_micro).to(dev)
    local_rel = []
    for step in range(steps):
        shards = micro[step].view(DIST_RANKS, -1)
        accs = [eng.sum_accumulators(s) for s in shards]
        folded = kernels.engine.merge_accumulators(
            torch.stack([a.s for a in accs]), torch.stack([a.c for a in accs]))
        sharded = folded / n_micro
        check(same(sharded.cpu(), ref["loss"][step]),
              f"phase 8: step {step + 1}'s loss != the sharded fold of its "
              f"microbatch losses recomputed here")
        s = c = torch.zeros((), device=dev)
        for v in micro[step]:
            s, c = K.kahan_step(s, c, v)
        local = (s + c) / n_micro
        local_rel.append(abs(float(sharded) - float(local))
                         / abs(float(local)))
        check(local_rel[-1] <= 1e-6,
              f"phase 8: step {step + 1}'s sharded loss is {local_rel[-1]:.2e}"
              f" (relative) from the local fold's")
    tcounts = ref["launches"]
    check(tcounts["sum_accumulators"] == steps,
          f"phase 8: the trainer launched B3 {tcounts['sum_accumulators']} "
          f"times in {steps} steps, not once a step (the loss fold)")
    for name, n in tcounts.items():
        check(n == 0 or name in ("sum_accumulators", "column_sq_accumulators"),
              f"phase 8: the trainer launched {name} {n} times")
    kernels.launches["sharded"] = counts
    kernels.launches["sharded-train"] = tcounts
    kernels.dist_times(spec)
    b3 = kernels.timing[("sum_accumulators", "kahan")]["ms"]
    peaks = [max(run["peak_bytes"] for run in res["train"]) for res in ranks]
    total = ranks[0]["total_bytes"]
    seconds = time.perf_counter() - t_start
    out = {"seconds": seconds, "gather_us": ranks[0]["gather_us"],
           "sharded_sum_ms": ranks[0]["sharded_sum_ms"],
           "single_rank_b3_ms": b3,
           "train_loss": ref["loss"].tolist(),
           "train_seconds": [run["seconds"] for run in ranks[0]["train"]],
           "local_fold_rel": local_rel,
           "peak_bytes": peaks, "card_bytes": total,
           "launches": counts, "train_launches": tcounts}
    log(f"# phase 8: 2 gloo ranks on the one card; sharded asum and dot at "
        f"n = {spec['n']}, matmul {list(spec['matmul'])} with K split 2, "
        f"activation_sq_norm {list(spec['act'])}, deterministic_mean, "
        f"compressed_psum {list(spec['leaf'])}: the same "
        f"bits on both ranks and in both runs, equal to the kernels' "
        f"per-shard grids folded here and to the plain versions' sharded "
        f"fold; B1, B3, B4, B5 twice each on a rank")
    log(f"# phase 8: the gather {out['gather_us']:.1f} us a call (one "
        f"[64, 128] grid, host clock); the sharded sum at n = {spec['n']} "
        f"{out['sharded_sum_ms']} ms (events, both ranks on one card) "
        f"against the single-rank B3 row {b3} ms (recorded, not gated)")
    log(f"# phase 8: OLMo-1B trained on the 2-rank mesh at full width and "
        f"depth, {steps} steps twice: loss "
        f"{[round(x, 4) for x in out['train_loss']]} the same bits on both "
        f"ranks and run to run, equal to the sharded fold of its microbatch "
        f"losses recomputed here, within {max(local_rel):.1e} of the local "
        f"fold; peak {', '.join(f'{p / 2**30:.2f}' for p in peaks)} GiB a "
        f"rank of {total / 2**30:.1f}; {out['train_seconds'][0]:.1f} s the "
        f"first run's {steps} steps; phase 8 took {seconds:.1f} s")
    return out


def dist_expected(torch, kernels, dev, spec):
    """Phase 8's results as this process computes them on the card from
    the same inputs: the per-shard grids of the same kernels folded by
    ``merge_accumulators`` / ``merge_accumulator_grids``, and the plain
    versions' per-shard grids folded the same way."""
    from repro_torch.core import kahan as K
    from repro_torch.distributed.compression import dequantize, quantize

    engine, kd, ks, km = kernels.engine, kernels.kd, kernels.ks, kernels.km
    eng = engine.CompensatedReduction()
    d = [dist_inputs(torch, dev, r, spec) for r in range(DIST_RANKS)]
    x, y, a, b = d[0]["x"], d[0]["y"], d[0]["a"], d[0]["b"]
    n = DIST_RANKS
    xs, ys = x.view(n, -1), y.view(n, -1)
    kc = a.shape[1] // n
    a_sh = [a[:, r * kc:(r + 1) * kc].contiguous() for r in range(n)]
    b_sh = [b[r * kc:(r + 1) * kc] for r in range(n)]

    def pair(acc):
        return acc.s, acc.c

    def fold(grids):
        return engine.merge_accumulators(torch.stack([g[0] for g in grids]),
                                         torch.stack([g[1] for g in grids]))

    def fold_grids(grids):
        m, cols = a.shape[0], b.shape[1]
        return engine.merge_accumulator_grids(
            torch.stack([g[0] for g in grids]),
            torch.stack([g[1] for g in grids]))[:m, :cols]

    sch, u = eng.scheme, eng.unroll
    blocks = eng._matmul_blocks(a.shape[0], b.shape[1], kc, None, None, None)
    sq = d[0]["act"].reshape(spec["act"][0], -1) ** 2
    per = spec["act"][0] // n
    v = d[0]["values"]
    zero = torch.zeros((), device=dev)
    pairs = [K.kahan_step(zero, zero, v[r]) for r in range(n)]
    s = c = zero
    for ps, pc in pairs:
        s, c = K.kahan_combine(s, c, ps, pc)
    mean = K.div(K.add(s, c), K.scalar_like(n, s))
    scale = torch.max(torch.stack([dd["leaf"].abs().max() for dd in d]))
    total = sum(quantize(dd["leaf"], scale).to(torch.int32) for dd in d)
    compressed = dequantize(total, scale)
    common = {"mean": mean, "compressed": compressed}
    kernel = dict(common)
    kernel["asum"] = fold([pair(eng.sum_accumulators(s_))
                           for s_ in xs])
    kernel["dot"] = fold([pair(eng.dot_accumulators(p, q))
                          for p, q in zip(xs, ys)])
    kernel["matmul"] = fold_grids([pair(eng.matmul_accumulators(p, q))
                                   for p, q in zip(a_sh, b_sh)])
    kernel["act"] = [eng.batched_asum(sq[r * per:(r + 1) * per])
                     for r in range(n)]
    plain = dict(common)
    plain["asum"] = fold([tuple(g[0] for g in ks.sum_plain(
        eng._prep1d(s_)[None], scheme=sch, unroll=u)) for s_ in xs])
    plain["dot"] = fold([tuple(g[0] for g in kd.dot_plain(
        eng._prep1d(p)[None], eng._prep1d(q)[None], scheme=sch, unroll=u))
        for p, q in zip(xs, ys)])
    plain_grids = []
    for p, q in zip(a_sh, b_sh):
        pp, qq = eng._prep_matmul(p, q, blocks)
        gs, gc_ = km.matmul_plain(pp[None], qq[None], scheme=sch,
                                  block_k=blocks[2],
                                  compute_dtype=torch.float32)
        pad = (-a.shape[0]) % blocks[0]
        plain_grids.append(tuple(torch.nn.functional.pad(g[0], (0, 0, 0, pad))
                                 for g in (gs, gc_)))
    plain["matmul"] = fold_grids(plain_grids)
    plain["act"] = []
    for r in range(n):
        grids = ks.sum_plain(eng._prep2d(sq[r * per:(r + 1) * per]),
                             scheme=sch, unroll=u)
        plain["act"].append(engine.Accumulator(*grids).total())
    return kernel, plain


if __name__ == "__main__":
    sys.exit(main())
