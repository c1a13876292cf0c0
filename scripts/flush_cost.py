#!/usr/bin/env python3
"""What the subnormal flush costs on the card: one training configuration
and one serving one of the PyTorch/CUDA port, with device time split by
the kind of elementwise work.

    python3 scripts/flush_cost.py [--root DIR] [--label NAME] [--out FILE]

``--root`` is the checkout whose ``src/repro_torch`` is imported (default:
the one holding this script), so the same measurement runs against an
older checkout unpacked beside this one; ``--label`` names it in the
output. Needs one CUDA card; builds the checkout's kernels first.

Measured, on OLMo-1B at its published width and depth (random weights
from seed 0):

* training as ``chip_smoke.py``'s run A (cuBLAS projections, KahanAdamW
  with the column-scan norm; seq 256, global batch 8 in 2 microbatches):
  wall ms a step after the first, then ``torch.profiler`` on one
  ``apply_update`` (the optimizer step alone), on the gradient
  accumulator's ``add_`` (one microbatch) and ``scale_total_`` (the
  average), and on one whole step;
* serving as ``chip_smoke.py``'s flash run (the 4-request trace, chunked
  flash prefill, ``track_stats``): tokens/s of a second pass (the first
  warms up), and the profiler on one decode tick of a third.

Each profile prints host ms, device-busy ms and the device kernels
grouped as ``flush`` (``hardshrink`` and ``copysign``: the two kernels of
``core.kahan.flush``), ``cast`` (dtype copies, as float32 <-> float64)
and ``other``, with the CPU-side count of each group's aten ops. One
JSON line per measurement goes to ``--out`` and to stdout.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

TRACE = "0:64:16,0:128:16,2:32:16,5:96:16"
LIBRARIES = ("kahan_reduce", "kahan_flash", "kahan_matmul")
STEPS, SEQ, BATCH, MICRO, LR = 3, 256, 8, 2, 1e-5
#: which decode tick of the serving pass is profiled
PROFILED_TICK = 10
#: kernel and aten-op name fragments of each group
GROUPS = {"flush": ("hardshrink", "copysign"), "cast": ("copy",)}


def group_of(name: str) -> str:
    low = name.lower()
    for group, parts in GROUPS.items():
        if any(p in low for p in parts):
            return group
    return "other"


def profiled(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: host ms, device-busy
    ms, and per group its device ms, device kernels and aten ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    groups = {g: {"device_ms": 0.0, "kernels": 0, "aten_ops": 0}
              for g in (*GROUPS, "other")}
    busy = 0.0
    for e in prof.key_averages():
        g = groups[group_of(e.key)]
        if e.device_type == DeviceType.CUDA:
            g["device_ms"] += e.self_device_time_total / 1e3
            g["kernels"] += e.count
            busy += e.self_device_time_total / 1e3
        elif e.key.startswith("aten::"):
            g["aten_ops"] += e.count
    return {"host_ms": host_ms, "device_busy_ms": busy, "groups": groups}


def train(torch, dev, cfg):
    from repro_torch.core import tree as T
    from repro_torch.core.kahan import KahanAccumulator
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig, apply_update
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import batch_to_device

    opt = AdamWConfig(lr=LR)
    tc = TrainConfig(steps=STEPS, microbatches=MICRO, warmup=1, log_every=1,
                     ckpt_every=10 ** 9, opt=opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH))
    marks = []

    def mark(step):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    trainer = Trainer(cfg, tc, data, failure_hook=mark, seed=0, device=dev)
    trainer.run()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    grads = T.tree_map(torch.clone, trainer.opt_state.m)
    opt_prof = profiled(torch, lambda: apply_update(
        opt, trainer.params, grads, trainer.opt_state))
    acc = KahanAccumulator.zeros_like(grads)
    add_prof = profiled(torch, lambda: acc.add_(grads))
    fold_prof = profiled(torch, lambda: acc.scale_total_(1.0 / MICRO))
    del grads, acc
    batch = batch_to_device(data.batch_at(STEPS), dev)
    step_prof = profiled(torch, lambda: trainer.step_fn(
        trainer.params, trainer.opt_state, batch))
    out = {"what": "train run A", "ms_per_step": step_ms[1:],
           "loss": [m["loss"] for m in trainer.metrics_history],
           "optimizer": opt_prof, "accumulate": add_prof,
           "average": fold_prof, "step": step_prof,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve(torch, dev, cfg):
    from repro_torch.kernels import Policy
    from repro_torch.launch.serve import build_requests, parse_trace
    from repro_torch.models import build_model
    from repro_torch.serve import EngineConfig, InferenceEngine

    flash_cfg = cfg.replace(kahan_attention=True)
    model = build_model(flash_cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cells = parse_trace(TRACE, 0.0)
    max_len = max(p + n for _, p, n, _ in cells)
    out = {"what": "flash serving"}
    for rep in range(3):
        requests, arrivals = build_requests(flash_cfg, cells, seed=0)
        ec = EngineConfig(max_slots=4, max_len=max_len, prefill_chunk=64,
                          track_stats=True, policy=Policy(scheme="kahan"),
                          prefill_mode="flash")
        engine = InferenceEngine(flash_cfg, ec, model=model, params=params)
        ticks, tick_prof = [], {}

        def tick(running, events, _orig=engine._decode_tick):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rep == 2 and len(ticks) == PROFILED_TICK:
                tick_prof.update(profiled(torch, lambda: _orig(running,
                                                               events)))
                tick_prof["slots"] = len(running)
            else:
                _orig(running, events)
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t0) * 1e3)

        engine._decode_tick = tick
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = engine.run(requests, arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(h.tokens) for h in served.values())
        if rep < 2:
            out[f"pass{rep}"] = {"tokens_per_s": tokens / wall,
                                 "decode_tick_ms_mean":
                                     sum(ticks) / len(ticks)}
    out["tick"] = tick_prof
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flush_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_build.build, LIBRARIES))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    label = args.label or str(args.root)
    for fn in (train, serve):
        row = {"label": label, "card": card.splitlines()[0], **fn(torch, dev,
                                                                  cfg)}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
