#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell, in
one process (the benchmark's own runs do not run this), each with its
loss gap step by step:

    python3 portbench/calibrate.py --workload <cell> --seeds <a,b,...>
        [--control <a,b,...>] [--fault <a,b,...>] [--out <file.jsonl>]

For each seed of ``--seeds``: the program's checked steps (the cell's
set-up, as a run makes it) against the plain reference. For each seed of
``--control``: the reference computed with float8 products (the control,
one precision below the configurations' bfloat16) against the reference.
For each seed of ``--fault``: the reference with half of every batch
left out, the mean taken over the rest, against the reference. Prints
one JSON line a reading and, last, the largest program reading and the
smallest control and fault readings of each number.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import check
    from portbench.harness.cell import Cell, sync
    from portbench.harness.files import Files

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = Cell(Files(), args.workload, device)
    prog = cell.program()
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    rows = []
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, readings, ref, secs):
        row = {"cell": args.workload, "kind": kind, "seed": seed,
               "numbers": check.numbers(readings, ref),
               "loss_by_step": [abs(p - r) / abs(r) for p, r in
                                zip(readings["loss"], ref["loss"])],
               "seconds": secs}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    refs = {}

    def reference(seed, pool):
        if seed not in refs:
            refs[seed] = cell.reference(seed, pool)
        return refs[seed]

    for seed in seeds(args.seeds):
        t = time.perf_counter()
        pool = cell.batches(seed)
        params, state, got = cell.checked_steps(prog, seed, pool, prog.step)
        sync(device)
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
        emit("program", seed, got, reference(seed, pool),
             time.perf_counter() - t)
    for kind, arg, kw in (("control", args.control, {"precision": "fp8"}),
                          ("fault_half_batch", args.fault,
                           {"drop_half": True})):
        for seed in seeds(arg):
            t = time.perf_counter()
            pool = cell.batches(seed)
            got = cell.reference(seed, pool, **kw)
            emit(kind, seed, got, reference(seed, pool),
                 time.perf_counter() - t)
    summary = {}
    for kind in ("program", "control", "fault_half_batch"):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps({"cell": args.workload, "summary": summary,
                      "device": torch.cuda.get_device_name(device)}))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
