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
   0, 8, 31 and M - 1 of M in {9, 64, 300} equal M = 1 products.
3. Kernel times: each kernel at the shape its main path gives it (dot and
   sum at the paper's in-memory size n = 2^27 for every scheme, with each
   scheme's time over naive's, the paper's metric; batched dot and sum
   at [8, 2^24], the serving telemetry at [max_slots, 57344]; each with
   its plan, copy path, share of the bytes bound and the time of the
   kernel before its load ring), B7 at OLMo-1B's head shape [16, 2048,
   128] causal, B8 at the serving chunk [16, 64, 128] against both serve
   runs' cache lengths, B5 at OLMo-1B's projection shapes at decode (M
   1, the served shape, and M 8 for comparison with the padded rows of
   earlier runs) and in a 64- and a 32-token chunk plus the up projection of a
   2048-token prefill, B6 at 4 chunk-sized q projections; each matmul
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
   float32, TF32 off, for the matmul kernels).
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

The last three lines are the card (``nvidia-smi`` name and power
limit), one JSON object ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. The kernels line has one row per
kernel and path it runs on (``"path"``: "entry", "serve" for the scan
trace, "serve-flash" for the same trace under flash, "serve-matmul" for
it with ``kahan_matmul`` too, "serve-long" for the long request): its
``launches`` are that path's count and its times were taken at that
path's shape (B5 on "serve-matmul": the decode q/k/v/o shape at M 1,
the one launched most).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
#: float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

TRACE = "0:64:16,0:128:16,2:32:16,5:96:16"
LONG_TRACE = "0:1920:64"
PAPER_N = 1 << 27
PREFILL_LEN = 2048          # OLMo-1B's published context
LIBRARIES = ("kahan_reduce", "kahan_flash", "kahan_matmul")
#: dense projections per layer with kahan_matmul (q, k, v, o, gate, up,
#: down), each one B5 launch per prefill chunk and per decode position
PROJECTIONS = 7


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
    serve_stats = main_path(torch, kernels, cfg, PAPER_N)
    log(json.dumps({"serve": serve_stats}))
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
    ``n_ops`` float32 operations on the H100."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


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
        ceiling = flops / (FP32_FLOPS_PER_S / 2) * 1e3
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

    def time_matmul(self, label, m, k, n, batch=None, reps=20):
        """B5 (or B6 with ``batch``) at ``[M, K] x [K, N]`` with bf16
        operands, as the projections give it (the engine pads nothing at
        these widths): kernel, plain and library (``torch.matmul``
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
        a = self.normal((*lead, m, k)).bfloat16()
        b = self.normal((*lead, k, n)).bfloat16()
        blocks = eng._matmul_blocks(m, n, k, None, None, None)
        ap, bp = eng._prep_matmul(a, b, blocks)
        check(ap.shape == a.shape and bp.data_ptr() == b.data_ptr(),
              f"the engine padded or copied operands at {label}")
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
        ceiling = flops / (FP32_FLOPS_PER_S / 2) * 1e3
        tm, tn, split = km.grid_plan(nb, m, n, k, blocks[2])
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": least, "bound_by": by,
               "shape": [*lead, m, k, n], "scheme": "kahan",
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
                   ("matmul_accumulators_batched", "entry"): "batched"}
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(0)                                             # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    for i in range(1, reps + 1):
        step(i)
    sync(torch, dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        step(reps + 1)
        sync(torch, dev)
    kernels = [(e.self_device_time_total / 1e3, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
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


if __name__ == "__main__":
    sys.exit(main())
