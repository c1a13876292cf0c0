#!/usr/bin/env python3
"""Time the compensated dot and sum kernels (B1-B4) under the load rings
and copy paths they have, on one CUDA card.

    PYTHONPATH=src python3 scripts/reduce_rings.py [--out FILE.jsonl]

At the paper's in-memory size (n = 2^27 float32, U = 8, schemes kahan and
naive) and at [8, 2^24], it launches ``kahan_dot_grid`` and
``kahan_sum_grid`` through the wrappers' launch with CTAs of 32, 64 and
128 chains, stages of 16, 32 and 64 steps (8, 16 and 32 at [8, 2^24]),
rings of 32, 64 and 128 KB an SM, and each copy path: 16-byte cp.async
and one element a copy (on the same aligned operands). Every launch's
grids must equal those of the plan ``reduce_plan`` picks bit for bit,
and that plan's must equal the plain version's. Device times come from
launches captured in a CUDA graph. Prints one JSON object a line (card,
then one row per shape, scheme, plan and copy path); ``--out`` also
writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import HBM_BYTES_PER_S, graph_ms  # noqa: E402
from repro_torch.kernels import kahan_dot as kd  # noqa: E402
from repro_torch.kernels import kahan_sum as ks  # noqa: E402
from repro_torch.kernels import schemes  # noqa: E402

N = 1 << 27
UNROLL = 8
CELLS = 1024 * UNROLL


def launch(x, operands, sch, plan=None, copy=None):
    """One launch of the dot (``operands`` 2: x is (a, b)) or the sum."""
    counter = SimpleNamespace(launches=0, plan=None, copy=None)
    if operands == 2:
        return kd._launch(*x, sch, UNROLL, counter, plan=plan, copy=copy)
    return ks._launch(x[0], sch, UNROLL, counter, plan=plan, copy=copy)


def plans(batch, steps, operands, sms):
    """(chains, depth, stages, bytes) for every CTA width, stage depth and
    ring size an SM of 32, 64 and 128 KB (two stages at least)."""
    out = []
    depths = (16, 32, 64) if batch == 1 else (8, 16, 32)
    for chains in kd.CTA_CHAINS:
        per_sm = -(-(batch * CELLS // chains) // sms)
        step_bytes = operands * chains * 4
        for depth in depths:
            for ring_kb in (32, 64, 128):
                stages = min(ring_kb * 1024 // per_sm // step_bytes // depth,
                             -(-steps // depth))
                smem = kd.reduce_smem_bytes(chains, depth, stages, 4,
                                            operands)
                if stages >= 2 and smem * per_sm <= kd.SMEM_LIMIT:
                    out.append((chains, depth, stages, smem))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reduce_rings: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [{"card": card, "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    a = torch.randn((N,), generator=gen, device=dev)
    b = torch.randn((N,), generator=gen, device=dev)
    for batch in (1, 8):
        steps = N // batch // CELLS
        for operands, scheme in ((2, "kahan"), (1, "kahan"), (2, "naive"),
                                 (1, "naive")):
            sch = schemes.get(scheme)
            x = (a.view(batch, -1), b.view(batch, -1))[:operands]
            chosen = kd.reduce_plan(batch, CELLS, steps, 4, operands, sms)
            want = launch(x, operands, sch)
            plain = (kd.dot_plain(*x, scheme=sch) if operands == 2
                     else ks.sum_plain(x[0], scheme=sch))
            if not all(torch.equal(g, w) for g, w in zip(want, plain)):
                raise RuntimeError(f"[{batch}] {scheme}: kernel != plain")
            bound = operands * N * 4 / HBM_BYTES_PER_S * 1e3
            for plan in plans(batch, steps, operands, sms):
                for copy in kd.COPY:
                    got = launch(x, operands, sch, plan, copy)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise RuntimeError(f"{plan} {copy}: bits differ")
                    ms = graph_ms(torch, lambda: launch(x, operands, sch,
                                                        plan, copy), 10, 3)
                    row = {"kernel": "dot" if operands == 2 else "sum",
                           "shape": [batch, N // batch], "scheme": scheme,
                           "plan": plan, "copy": copy,
                           "chosen": plan == chosen and copy == "cp.async",
                           "ms": ms, "bytes_bound_ms": bound,
                           "bound_share": bound / ms}
                    lines.append(row)
                    print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
