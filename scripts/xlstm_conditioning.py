#!/usr/bin/env python3
"""How far rounding alone parts xlstm-1.3b's decode step from its
whole-prompt prefill (card and CPU; no jax).

    PYTHONPATH=src python3 scripts/xlstm_conditioning.py --blocks 16

Draws xlstm-1.3b's weights at its published width (bf16, random from
seed 0 on the CPU), cut to ``--blocks`` blocks, and a prompt of
``--prompt`` tokens; on the card and on the CPU, in float32 compute on
the same weights: ``XLSTMLM.prefill`` of the prompt, one greedy
``decode_step``, and a prefill of the prompt plus that token. Prints,
block by block, the relative L2 of the last position's hidden state
between the decode step and the longer prefill on each device, and
between the two devices' prefills and decode steps. A block that
amplifies a perturbation of its input shows as growth down the rows;
the CPU's matmuls round the rows of a longer prompt as they round the
shorter one's, the card's do not, so the card's decode-vs-prefill gap
is the rounding of one implementation run twice, amplified.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=640)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models import build_model, xlstm_lm

    if not torch.cuda.is_available():
        print("xlstm_conditioning: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    cfg = get_config("xlstm-1.3b").replace(n_layers=args.blocks)
    cpu = torch.device("cpu")
    weights = build_model(cfg, cpu).init(torch.Generator().manual_seed(0))
    n = args.prompt
    prompt = torch.randint(0, cfg.vocab_size, (1, n),
                           generator=torch.Generator().manual_seed(0))
    orig = xlstm_lm.XLSTMLM._block
    seen = []

    def block(self, kind, p, x, cache=None):
        y = orig(self, kind, p, x, cache)
        seen.append(y[:, -1].double().cpu())
        return y

    xlstm_lm.XLSTMLM._block = block
    runs = {}
    try:
        for dev in (torch.device("cuda"), cpu):
            params = T.tree_map(lambda t: t.to(dev), weights)
            model = build_model(cfg.replace(compute_dtype="float32"), dev)
            toks = prompt.to(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                seen.clear()
                logits, cache = model.prefill(params, toks,
                                              model.init_cache(1, 0))
                tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
                seen.clear()
                step = model.decode_step(params, cache, tok, n)
                decode = list(seen)
                seen.clear()
                full, _ = model.prefill(params, torch.cat(
                    [toks, tok[:, None]], 1), model.init_cache(1, 0))
                longer = list(seen)
            x, y = (t[0, :cfg.vocab_size].double().cpu() for t in (full, step))
            runs[dev.type] = (decode, longer)
            print(f"{dev.type} ({card if dev.type == 'cuda' else 'host'}), "
                  f"{args.blocks} blocks, prompt {n}, "
                  f"{time.perf_counter() - t0:.1f} s: decode vs prefill, "
                  f"relative L2 by block: "
                  + " ".join(f"{float((a - b).norm() / b.norm()):.2e}"
                             for a, b in zip(decode, longer))
                  + f"; logits {float((y - x).norm() / x.norm()):.3e}",
                  flush=True)
    finally:
        xlstm_lm.XLSTMLM._block = orig
    for i, what in ((1, "prefill"), (0, "decode")):
        print(f"{what}, card vs CPU, relative L2 by block: " + " ".join(
            f"{float((a - b).norm() / b.norm()):.2e}"
            for a, b in zip(runs["cuda"][i], runs["cpu"][i])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
