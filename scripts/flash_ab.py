#!/usr/bin/env python3
"""Time the flash kernel of two or more checkouts of the repo in one call
on one CUDA card, in turns (pass them as parent, change, change, parent).

    python3 scripts/flash_ab.py ROOT [ROOT ...] [--out FILE.jsonl]

For each ROOT, in the order given, a subprocess imports that checkout's
``chip_smoke.py`` and ``src/repro_torch`` (building its kernels into its
own ``build/``) and times, with its phase-3 timer ``Kernels.time_flash``
(device time of launches captured in a CUDA graph, the parity check
against the plain version first), OLMo-1B's B7 prefill (q, k, v [16,
2048, 128], causal) and B8 serving chunk (q [16, 64, 128] against a
144-row cache in float32, 72 rows in bfloat16 and float64, as phase 3
does) in each compute dtype the checkout's kernel takes. Prints the card,
then one JSON object a ROOT (its ``time_flash`` log lines go to standard
error).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ONE_ROOT = r"""
import json, sys
import torch
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import chip_smoke as cs
k = cs.Kernels(torch, torch.device("cuda"))
h, dh = 16, 128
for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "-bf16"),
                   (torch.float64, "-f64")):
    k.time_flash("flash_accumulators", "entry" + tag,
                 k.normal((h, 2048, dh)), k.normal((h, 2048, dh)),
                 k.normal((h, 2048, dh)), 0, reps=5, dtype=dtype)
    serve_len = 72 if tag else 144
    k.time_flash("flash_chunk_accumulators", "serve" + tag,
                 k.normal((h, 64, dh)), k.normal((h, serve_len, dh)),
                 k.normal((h, serve_len, dh)), (serve_len - 64) // 64 * 64,
                 reps=50, dtype=dtype)
print(json.dumps({label: {key: row[key] for key in (
    "ms", "tile_rows", "smem_bytes", "library_ms", "mul_add_ceiling_ms")}
    for (_, label), row in k.timing.items()}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [{"card": card}]
    print(json.dumps(lines[0]), flush=True)
    for i, root in enumerate(args.roots):
        proc = subprocess.run(
            [sys.executable, "-c", ONE_ROOT, str(Path(root).resolve())],
            capture_output=True, text=True)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(f"flash_ab: {root} failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
        row = {"turn": i, "root": root,
               "times": json.loads(proc.stdout.strip().splitlines()[-1])}
        lines.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
