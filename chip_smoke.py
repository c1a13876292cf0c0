#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
the port on the card, phase by phase; any failed phase raises and the
script exits non-zero. It exits non-zero before doing anything when
there is no CUDA device or no ``src/repro_torch`` beside it.

1. The card (``nvidia-smi`` name and power limit) and the kernel build.
2. Kernel parity: for every built-in scheme x U in {1, 8} x {float32,
   float64, bfloat16}, the (s, c) grids of ``kahan_dot_grid`` and
   ``kahan_sum_grid`` — single and batched — equal their plain PyTorch
   versions bit for bit, and a batched launch equals a loop of single
   ones.
3. Kernel times: each kernel at the shape its main path gives it (dot and
   sum at the paper's in-memory size n = 2^27 for kahan and naive,
   batched dot and sum at [8, 2^24], the serving telemetry at
   [max_slots, 57344]), with CUDA events after warm-up, beside its bytes
   bound, its plain version's time and one PyTorch call computing the
   same function (``library_ms``, a yardstick the port never calls).
4. The main path's two paths, each with every launch count set to 0
   just before it and read just after it. Serving: the engine answers a
   4-request trace with OLMo-1B at its published width (random bf16
   weights from a seeded generator; chunked scan prefill, dense KV,
   ``track_stats=True``, scheme kahan). Entry points: the paper's
   ``ops.dot / asum / batched_dot / batched_asum`` run once each. Checked:
   every request emits its tokens, the telemetry is finite, the sum
   kernel launched once per decode tick and finished prefill and no other
   kernel launched while serving, one tick's telemetry equals the plain
   version's bit for bit on the same logits, and every kernel launched on
   the entry-point path.
5. Solo vs interleaved: request 0 replayed alone emits bitwise the same
   tokens and telemetry.

The last three lines are the card (``nvidia-smi`` name and power
limit), one JSON object ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. The kernels line has one row per
kernel and path it runs on (``"path"``: "entry" or "serve"): its
``launches`` are that path's count and its times were taken at that
path's shape.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
#: float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

TRACE = "0:64:16,0:128:16,2:32:16,5:96:16"
PAPER_N = 1 << 27


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
    _build.library("kahan_reduce")
    log(f"# phase 1: built kahan_reduce.cu in {time.perf_counter() - t0:.1f} s")

    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    kernels = Kernels(torch, dev)
    kernels.parity()
    kernels.times(PAPER_N)
    serve_stats = main_path(torch, kernels, get_config("olmo-1b"), PAPER_N)
    log(json.dumps({"serve": serve_stats}))
    log(card)
    log(json.dumps({"kernels": kernels.rows()}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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


class Kernels:
    """Phases 2 and 3, and the JSON rows of the four wrappers."""

    def __init__(self, torch, dev):
        from repro_torch.kernels import engine, kahan_dot, kahan_sum, schemes

        self.torch = torch
        self.dev = dev
        self.engine, self.kd, self.ks, self.schemes = (engine, kahan_dot,
                                                       kahan_sum, schemes)
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.err = {name: 0.0 for name in engine.WRAPPERS}
        self.timing = {}

    def data(self, shape, dtype):
        torch = self.torch
        x = torch.randn(shape, generator=self.gen, device=self.dev,
                        dtype=torch.float64)
        e = torch.randint(-8, 8, shape, generator=self.gen, device=self.dev)
        return (x * torch.exp2(e.double())).to(dtype)

    def compare(self, name, got, want, what):
        torch = self.torch
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{name} {what}: kernel != plain")
            d = (g.double() - w.double()).abs().max().item()
            self.err[name] = max(self.err[name], d)

    # -- 2. parity ------------------------------------------------------------
    def parity(self):
        torch = self.torch
        kd, ks = self.kd, self.ks
        cases = 0
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            for name in ("naive", "kahan", "pairwise", "dot2"):
                sch = self.schemes.get(name)
                for unroll in (1, 8):
                    eng = self.engine.CompensatedReduction(
                        scheme=sch, unroll=unroll, compute_dtype=dtype)
                    for n in (1, 8192 + 5, 3 * 8192 + 37, 5 * 8192):
                        what = f"{name} U={unroll} {dtype} n={n}"
                        a, b = self.data((3, n), dtype), self.data((3, n), dtype)
                        ap, bp = eng._prep2d(a), eng._prep2d(b)
                        kw = dict(scheme=sch, unroll=unroll)
                        single = [kd.dot_accumulators(ap[i], bp[i], **kw)
                                  for i in range(3)]
                        plain = kd.dot_plain(ap, bp, **kw)
                        for i in range(3):
                            self.compare("dot_accumulators", single[i],
                                         (plain[0][i], plain[1][i]), what)
                        batched = kd.dot_accumulators_batched(ap, bp, **kw)
                        self.compare("dot_accumulators_batched", batched,
                                     plain, what)
                        check(all(torch.equal(batched[0][i], single[i][0])
                                  and torch.equal(batched[1][i], single[i][1])
                                  for i in range(3)),
                              f"batched dot != loop of single dots ({what})")
                        single = [ks.sum_accumulators(ap[i], **kw)
                                  for i in range(3)]
                        plain = ks.sum_plain(ap, **kw)
                        for i in range(3):
                            self.compare("sum_accumulators", single[i],
                                         (plain[0][i], plain[1][i]), what)
                        batched = ks.sum_accumulators_batched(ap, **kw)
                        self.compare("sum_accumulators_batched", batched,
                                     plain, what)
                        check(all(torch.equal(batched[0][i], single[i][0])
                                  and torch.equal(batched[1][i], single[i][1])
                                  for i in range(3)),
                              f"batched sum != loop of single sums ({what})")
                        cases += 1
        sync(torch, self.dev)
        log(f"# phase 2: {cases} parity cases x 4 wrappers bitwise equal to "
            f"their plain versions; batched == loop of single launches")

    # -- 3. times -------------------------------------------------------------
    def time_one(self, name, scheme, args, plain_fn, library_fn, reps=20,
                 label=None):
        """Kernel / plain / library times of one wrapper on padded
        float32 inputs, plus the kernel-vs-plain check at this shape."""
        torch = self.torch
        sch = self.schemes.get(scheme)
        wrapper = self.engine.WRAPPERS[name]
        kernel = lambda: wrapper(*args, scheme=sch, unroll=8)  # noqa: E731
        got = kernel()
        t0 = time.perf_counter()
        want = plain_fn(sch)
        sync(torch, self.dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        self.compare(name, got, want, f"{scheme} at {tuple(args[0].shape)}")
        ms = cuda_ms(torch, kernel, reps)
        library_ms = cuda_ms(torch, library_fn, reps)
        numel = sum(a.numel() for a in args)
        n_elem = args[0].numel()
        grid_bytes = 2 * got[0].numel() * got[0].element_size()
        in_bytes = numel * args[0].element_size()
        mix = sch.instruction_mix
        ops = n_elem * (mix.flops if name.startswith("dot") else mix.adds)
        bytes_ms = (in_bytes + grid_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOPS_PER_S * 1e3
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "shape": list(args[0].shape), "scheme": scheme,
               "gbytes_per_s": (in_bytes + grid_bytes) / ms / 1e6}
        self.timing[(name, label or scheme)] = row
        log(f"# {name} {label or scheme} {row['shape']}: kernel {ms:.4f} ms "
            f"({row['gbytes_per_s']:.0f} GB/s), bytes bound "
            f"{bytes_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, plain "
            f"{plain_ms:.1f} ms, library {library_ms:.4f} ms")

    def times(self, paper_n):
        torch = self.torch
        kd, ks = self.kd, self.ks
        f32 = torch.float32
        a = self.data((paper_n,), f32)
        b = self.data((paper_n,), f32)
        for scheme in ("kahan", "naive"):
            self.time_one(
                "dot_accumulators", scheme, (a, b),
                lambda s: [t[0] for t in kd.dot_plain(a[None], b[None],
                                                       scheme=s)],
                lambda: torch.dot(a, b))
            self.time_one(
                "sum_accumulators", scheme, (a,),
                lambda s: [t[0] for t in ks.sum_plain(a[None], scheme=s)],
                lambda: torch.sum(a))
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

    def rows(self):
        """One JSON row per wrapper and path that launches it, with that
        path's launch count, timed at that path's shape."""
        src = "src/repro_torch/csrc/kahan_reduce.cu"
        replaces = {
            "dot_accumulators": "src/repro/kernels/kahan_dot.py:89",
            "dot_accumulators_batched": "src/repro/kernels/kahan_dot.py:139",
            "sum_accumulators": "src/repro/kernels/kahan_sum.py:63",
            "sum_accumulators_batched": "src/repro/kernels/kahan_sum.py:105",
        }
        # (path, timing label) of each row: the entry points run every
        # kernel at the phase-3 shapes, serving runs the batched sum only
        rows = [(name, "entry", "kahan") for name in replaces]
        rows.append(("sum_accumulators_batched", "serve", "serve"))
        out = []
        for name, path, label in rows:
            t = self.timing[(name, label)]
            out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces[name], "path": path,
                "launches": self.launches[path][name],
                "max_abs_err": self.err[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"]})
        return out


def main_path(torch, kernels: Kernels, cfg, paper_n):
    """Phases 4 and 5: the port's main path with the launch counts reset
    just before it, then solo vs interleaved."""
    from repro_torch.kernels import Policy, ops
    from repro_torch.kernels.engine import (
        Accumulator,
        CompensatedReduction,
        launch_counts,
        reset_launch_counts,
    )
    from repro_torch.launch.serve import build_requests, parse_trace
    from repro_torch.models import build_model
    from repro_torch.serve import EngineConfig, InferenceEngine

    cells = parse_trace(TRACE, 0.0)
    requests, arrivals = build_requests(cfg, cells, seed=0)
    ec = EngineConfig(max_slots=4, max_len=max(p + n for _, p, n, _ in cells),
                      prefill_chunk=64, track_stats=True,
                      policy=Policy(scheme="kahan"))
    dev = kernels.dev
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"# phase 4: OLMo-1B {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"({cfg.padded_vocab} padded), {n_params / 1e9:.3f} B params "
        f"{cfg.param_dtype}")
    engine = InferenceEngine(cfg, ec, model=model, params=params)

    tick_ms, chunk_ms, chunk_pos = [], [], []
    captured = {}
    sum_kernel = kernels.engine.WRAPPERS["sum_accumulators_batched"]

    def timed_tick(running, events, _orig=engine._decode_tick):
        before = sum_kernel.launches
        sync(torch, dev)
        t0 = time.perf_counter()
        _orig(running, events)
        sync(torch, dev)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        check(sum_kernel.launches == before + 1,
              "the telemetry sum kernel did not launch exactly once in a "
              "decode tick")

    def timed_chunk(slot, h, events, _orig=engine._run_chunk):
        start = h.prefill_pos
        sync(torch, dev)
        t0 = time.perf_counter()
        _orig(slot, h, events)
        sync(torch, dev)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        chunk_pos.append(h.prefill_pos - start)

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
    serve_counts = launch_counts()
    for name in kernels.engine.WRAPPERS:
        want = name == "sum_accumulators_batched"
        check((serve_counts[name] > 0) == want,
              f"{name} launched {serve_counts[name]} times while serving")
    # the paper's entry points, at the shapes of phase 3
    a = kernels.data((paper_n,), torch.float32)
    b = kernels.data((paper_n,), torch.float32)
    sync(torch, dev)
    reset_launch_counts()
    totals = [ops.dot(a, b), ops.asum(a),
              ops.batched_dot(a.view(8, -1), b.view(8, -1)),
              ops.batched_asum(a.view(8, -1))]
    sync(torch, dev)
    entry_counts = launch_counts()
    kernels.launches = {"serve": serve_counts, "entry": entry_counts}
    log(f"# main path launch counts: serving {serve_counts}; the paper's "
        f"entry points {entry_counts}")
    for name in kernels.engine.WRAPPERS:
        check(entry_counts[name] > 0,
              f"{name} never launched by the paper's entry points")
    check(all(bool(torch.isfinite(t).all()) for t in totals),
          "non-finite result from the paper's entry points")
    del a, b

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
    check(serve_counts["sum_accumulators_batched"] == n_ticks + len(cells),
          f"sum kernel launched {serve_counts['sum_accumulators_batched']} "
          f"times for {n_ticks} decode ticks + {len(cells)} finished "
          f"prefills")

    # one tick's telemetry against the plain version on the same logits
    logits = captured["logits"][:, :cfg.vocab_size]
    eng = CompensatedReduction(scheme=ec.policy)
    sq = eng._prep2d(logits.float() * logits.float())
    s, c = kernels.ks.sum_plain(sq, scheme=eng.scheme, unroll=eng.unroll)
    plain_norms = Accumulator(s, c).total()
    check(torch.equal(plain_norms, captured["norms"]),
          "decode-tick telemetry differs from the plain version")
    stats = {
        "trace": TRACE, "requests": len(cells), "tokens": n_tok,
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "decode_ticks": n_ticks, "decode_tick_ms_mean": sum(tick_ms) / n_ticks,
        "decode_tick_ms_min": min(tick_ms),
        "prefill_chunks": len(chunk_ms),
        "prefill_chunk_ms_mean": sum(chunk_ms) / len(chunk_ms),
        "prefill_ms_per_position": sum(chunk_ms) / sum(chunk_pos),
        "sum_launches_serving": serve_counts["sum_accumulators_batched"],
        "max_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                          if dev.type == "cuda" else None),
        "decode_position": profile_decode_step(torch, model, params, dev,
                                               ec.max_len),
    }
    log(f"# phase 4: served {len(cells)} requests, {n_tok} tokens in "
        f"{wall:.2f} s ({stats['tokens_per_s']:.1f} tokens/s); decode tick "
        f"{stats['decode_tick_ms_mean']:.2f} ms mean over {n_ticks}; prefill "
        f"chunk {stats['prefill_chunk_ms_mean']:.1f} ms mean over "
        f"{len(chunk_ms)} ({stats['prefill_ms_per_position']:.2f} ms per "
        f"position); one tick's telemetry bitwise equal to the plain version")

    # -- 5. solo vs interleaved ------------------------------------------------
    solo_engine = InferenceEngine(cfg, ec, model=model, params=params)
    req0 = requests[0]
    solo = solo_engine.run([req0])[req0.request_id]
    check(solo.tokens == served[req0.request_id].tokens,
          "request 0: tokens differ solo vs interleaved")
    check(solo.telemetry == served[req0.request_id].telemetry,
          "request 0: telemetry differs solo vs interleaved")
    log(f"# phase 5: request 0 alone == interleaved, bitwise "
        f"({len(solo.tokens)} tokens and telemetry values)")
    return stats


def profile_decode_step(torch, model, params, dev, max_len, reps=5):
    """Host time and device-busy time of one batch-1 decode position (the
    unit a decode tick runs per slot and prefill per prompt position).
    Host time is the mean of ``reps`` unprofiled steps; device-busy time
    sums the device kernels ``torch.profiler`` records in one more step
    (None when it records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(1, max_len)
    tok = torch.tensor([1], device=dev)
    model.decode_step(params, cache, tok, 0)            # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    for pos in range(1, reps + 1):
        model.decode_step(params, cache, tok, pos)
    sync(torch, dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        model.decode_step(params, cache, tok, reps + 1)
        sync(torch, dev)
    kernels = [(e.self_device_time_total / 1e3, e.key[:60], e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(k[0] for k in kernels)
    top = sorted(kernels, reverse=True)[:6]
    out = {"host_ms": host_ms,
           "device_busy_ms": busy_ms or None,
           "device_idle_share": 1 - busy_ms / host_ms if busy_ms else None,
           "device_kernels": sum(k[2] for k in kernels),
           "top_kernels_ms": [[name, ms, n] for ms, name, n in top]}
    log(f"# decode position: {host_ms:.2f} ms host clock, device busy "
        f"{busy_ms:.3f} ms in {out['device_kernels']} kernels; top "
        f"{out['top_kernels_ms']}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
