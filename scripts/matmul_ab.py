#!/usr/bin/env python3
"""Time the compensated matmul kernel (B5/B6) of two or more checkouts of
the repo in one call on one CUDA card, in turns (pass them as parent,
change, change, parent).

    python3 scripts/matmul_ab.py ROOT [ROOT ...] [--out FILE.jsonl]
                                [--ptxas ROOT ...]

For each ROOT, in the order given, a subprocess imports that checkout's
``chip_smoke.py`` and ``src/repro_torch`` (building its kernels into its
own ``build/``) and times, with its phase-3 timer ``Kernels.time_matmul``
(device time of launches captured in a CUDA graph, operands cycled
through copies that exceed the L2 cache, the parity check against the
plain version first), OLMo-1B's decode q/k/v/o ([1, 2048] x [2048,
2048]), a 64-token chunk's gate/up ([64, 2048] x [2048, 8192]) and B6 at
four chunk-sized q projections ([4, 64, 2048] x [4, 2048, 2048]) in float32
compute with bf16 operands (as served), and in bfloat16 and float64
compute with operands in that dtype. Prints the card, then one JSON
object a ROOT (its ``time_matmul`` log lines go to standard error).

``--ptxas ROOT``: also compile that checkout's ``csrc/kahan_matmul.cu``
with ``-Xptxas -v`` (the build's own flags) beside the timing, and print
the registers, spill bytes and stack frame of every ``kahan_matmul_grid``
and ``kahan_matmul_rows`` instantiation, one JSON object a ROOT.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ONE_ROOT = r"""
import json, sys
import torch
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
k = cs.Kernels(torch, torch.device("cuda"))
d, f = 2048, 8192
for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "-bf16"),
                   (torch.float64, "-f64")):
    ops = (torch.bfloat16,) * 2 if dtype == torch.float32 else (dtype,) * 2
    kw = dict(dtypes=ops, compute_dtype=dtype)
    k.time_matmul("decode-qkvo" + tag, 1, d, d, reps=50, **kw)
    k.time_matmul("chunk-gate-up" + tag, 64, d, f, reps=20, **kw)
    k.time_matmul("batched" + tag, 64, d, d, batch=4, reps=10, **kw)
print(json.dumps({label: {key: row[key] for key in (
    "ms", "library_ms", "mul_add_ceiling_ms", "ceiling_share", "tile",
    "cluster")} for (_, label), row in k.timing.items()}))
"""

#: what ``nvcc -Xptxas -v`` says of each function
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(root: Path) -> subprocess.Popen:
    """Starts the ``-Xptxas -v`` compile of ``root``'s matmul source with
    this checkout's build flags."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _build

    out = Path(tempfile.mkdtemp()) / "libmatmul.so"
    src = root / "src" / "repro_torch" / "csrc" / "kahan_matmul.cu"
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def parse_ptxas(text: str) -> dict:
    """function -> {registers, spill_stores, spill_loads, stack} of the
    matmul kernels, demangled where ``cu++filt`` is found."""
    rows, current = {}, None
    for line in text.splitlines():
        for pattern in (_ENTRY, _PROPS):
            m = pattern.search(line)
            if m:
                current = m.group(1)
                rows.setdefault(current, {})
        m = _FRAME.search(line)
        if m and current:
            rows[current].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m and current:
            rows[current]["registers"] = int(m.group(1))
    rows = {fn: v for fn, v in rows.items()
            if "kahan_matmul_grid" in fn or "kahan_matmul_rows" in fn}
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if Path(filt).exists():
        names = subprocess.run([filt], input="\n".join(rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        rows = {name: v for name, v in zip(names, rows.values())}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--ptxas", nargs="*", default=[])
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [{"card": card}]
    print(json.dumps(lines[0]), flush=True)
    compiles = {root: ptxas_report(Path(root).resolve())
                for root in args.ptxas}
    rc = 0
    for i, root in enumerate(args.roots):
        proc = subprocess.run(
            [sys.executable, "-c", ONE_ROOT, str(Path(root).resolve())],
            capture_output=True, text=True)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(f"matmul_ab: {root} failed (exit {proc.returncode})",
                  file=sys.stderr)
            rc = 1
            break
        row = {"turn": i, "root": root,
               "times": json.loads(proc.stdout.strip().splitlines()[-1])}
        lines.append(row)
        print(json.dumps(row), flush=True)
    for root, proc in compiles.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            sys.stderr.write(text)
            print(f"matmul_ab: nvcc -Xptxas -v failed on {root}",
                  file=sys.stderr)
            rc = 1
            continue
        row = {"ptxas": root, "functions": parse_ptxas(text)}
        lines.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return rc


if __name__ == "__main__":
    sys.exit(main())
