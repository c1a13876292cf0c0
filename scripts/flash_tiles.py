#!/usr/bin/env python3
"""Time the compensated flash kernel (B7, B8) under both tile heights it
has, on one CUDA card.

    PYTHONPATH=src python3 scripts/flash_tiles.py [--out FILE.jsonl]

At OLMo-1B's head shapes (B7: q, k, v [16, 2048, 128], causal; B8: a
64-row chunk at the last full chunk of a 144- and a 1984-token cache;
block_k 256, scheme kahan) it launches ``kahan_flash_grid`` through the
wrapper's launch with each tile height that fits, once with k and v
16-byte aligned (the cp.async ring) and once with both one float off in
their storage (plain loads into the same ring). Every launch's grids must
equal those of the plan ``flash_plan`` picks bit for bit, and that plan's
must equal the plain version's. Device times come from launches captured
in a CUDA graph. Prints one JSON object a line (card, then one row per
shape, plan and alignment); ``--out`` also writes them to a file.
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

from chip_smoke import fma_ceiling_ms, graph_ms  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import schemes  # noqa: E402


def off_storage(x: torch.Tensor, floats: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``floats`` floats into its
    storage."""
    buf = x.new_empty(x.numel() + floats)
    buf[floats:] = x.reshape(-1)
    return buf[floats:].view(x.shape)


def launch(q, k, v, plan, *, block_k, q_off, kv_len, scheme):
    """One causal launch of the kernel with the given (rows, bytes)."""
    return fa._launch(q, k, v, block_q=q.shape[1], block_k=block_k,
                      scheme=scheme, kv_len=kv_len, causal=True,
                      q_off=q_off, q_groups=q.shape[0] // k.shape[0],
                      counter=SimpleNamespace(launches=0, plan=None),
                      plan=plan)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [{"card": card, "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sch = schemes.get("kahan")
    bh, dh, bk = 16, 128, 256
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = (("B7 entry", 2048, 2048, 0),
              ("B8 serve", 64, 256, 64),
              ("B8 serve-long", 64, 2048, 1920))
    for label, sq, skv, q_off in shapes:
        # the engine's padded operands: kv_len masks the cache's tail
        kv_len = {"B8 serve": 144, "B8 serve-long": 1984}.get(label, skv)
        q = torch.randn((bh, sq, dh), generator=gen, device=dev)
        k = torch.randn((bh, skv, dh), generator=gen, device=dev)
        v = torch.randn((bh, skv, dh), generator=gen, device=dev)
        kw = dict(block_k=bk, q_off=q_off, kv_len=kv_len, scheme=sch)
        chosen = fa.flash_plan(bh, sq, dh, bk, sms=sms)
        want = launch(q, k, v, chosen, **kw)
        plain = fa.flash_plain(q, k, v, scheme=sch, block_k=bk,
                               kv_len=kv_len, causal=True, q_off=q_off)
        if not all(torch.equal(a, b) for a, b in zip(want, plain)):
            raise RuntimeError(f"{label}: kernel != plain version")
        # the fixed chains' ceiling: a rounded multiply and add per term
        ceiling = fma_ceiling_ms(4 * bh * sq * skv * dh)
        ku, vu = off_storage(k, 1), off_storage(v, 1)
        for rows in fa.TILE_ROWS:
            smem = fa.flash_smem_bytes(rows, dh, bk)
            if smem > fa.SMEM_LIMIT or rows * dh > fa.TILE_OUTPUTS:
                continue
            plan = (rows, smem)
            for aligned, (kk, vv) in ((True, (k, v)), (False, (ku, vu))):
                got = launch(q, kk, vv, plan, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"{label} {plan} aligned={aligned}: "
                                       f"bits differ")
                ms = graph_ms(torch, lambda: launch(q, kk, vv, plan, **kw))
                row = {"shape": label, "q": [bh, sq, dh], "skv": skv,
                       "rows": rows, "ring_stages": fa.RING_STAGES,
                       "smem_bytes": smem, "ctas": -(-sq // rows) * bh,
                       "copy": "cp.async" if aligned else "plain",
                       "chosen": plan == chosen and aligned,
                       "ms": ms, "mul_add_ceiling_ms": ceiling,
                       "ceiling_share": ceiling / ms}
                lines.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
