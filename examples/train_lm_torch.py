"""End-to-end driver of the PyTorch/CUDA port's trainer
(``examples/train_lm.py`` over ``repro_torch``): train a ~100M-parameter
LM for a few hundred steps on synthetic Markov data with the full
technique stack (Kahan loss, microbatch accumulation and optimizer),
checkpointing every 50 steps.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
        [--arch olmo-1b] [--ckpt-dir DIR] [--device cpu]

The config is the assigned olmo-1b architecture scaled to ~100M params
(same family: non-parametric LN, tied embeddings, SwiGLU). Runs on the
card by default. ``--ckpt-dir`` defaults to ``build/train_lm`` beside
this checkout; a directory that holds a checkpoint is resumed from.
Besides the reference's lines it prints the loss at steps 1, 50, 100
and the last, the milliseconds a step after the first (checkpoints
included) and, on the card, the peak memory.
"""

import argparse
import logging
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer

logging.basicConfig(level=logging.INFO, format="%(message)s")

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "train_lm"
#: the steps whose loss the summary line prints (and the last)
REPORT_STEPS = (1, 50, 100)


def lm_config(arch: str, **overrides):
    """The ~100M-param member of ``arch``'s family (the reference
    example's), with ``overrides`` on top (a test's reduced width)."""
    kw = dict(n_layers=8, d_model=1024, n_heads=16, n_kv_heads=16,
              d_ff=2816, vocab_size=8192, loss_chunk=128,
              param_dtype="float32", compute_dtype="float32")
    kw.update(overrides)
    return get_config(arch).replace(**kw)


def train_config(steps: int, ckpt_dir) -> TrainConfig:
    """The reference example's schedule: 2 microbatches (their gradients
    folded by the port's compensated accumulator), warmup 30, KahanAdamW
    at lr 6e-4."""
    return TrainConfig(
        steps=steps,
        microbatches=2,
        ckpt_dir=str(ckpt_dir),
        ckpt_every=50,
        log_every=10,
        warmup=30,
        opt=AdamWConfig(lr=6e-4, weight_decay=0.01, kahan=True),
    )


def train(cfg, tc: TrainConfig, device=None, seq_len=256, global_batch=16):
    """Runs ``tc.steps`` steps; returns (trainer, every step's loss, ms a
    step after the first, peak bytes or None)."""
    dev = resolve_device(device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len, global_batch=global_batch))
    trainer = Trainer(cfg, tc, data, device=dev)
    losses, marks = [], []
    step_fn = trainer.step_fn

    def recorded(params, opt_state, batch):
        out = step_fn(params, opt_state, batch)
        losses.append(out[2]["loss"].detach())
        if len(marks) < 1:               # the first step ends here
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())
        return out

    trainer.step_fn = recorded
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    end = time.perf_counter()
    steps = len(losses)
    ms = (end - marks[0]) * 1e3 / (steps - 1) if steps > 1 else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return trainer, [float(x) for x in losses], ms, peak


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = lm_config(args.arch)
    n = cfg.param_counts()["total"]
    print(f"arch family: {args.arch}; params ~{n / 1e6:.0f}M")
    trainer, losses, ms, peak = train(cfg, train_config(args.steps,
                                                        args.ckpt_dir),
                                      args.device)
    final = trainer.metrics_history[-1]
    print(f"final metrics: {final}")
    first = trainer.metrics_history[0]["loss"]
    print(f"loss: {first:.3f} -> {final['loss']:.3f} "
          f"(delta {first - final['loss']:+.3f})")
    done = trainer.step - len(losses)        # steps resumed past
    at = {s: losses[s - 1 - done] for s in REPORT_STEPS + (trainer.step,)
          if 0 <= s - 1 - done < len(losses)}
    mem = "" if peak is None else f", peak {peak / 2 ** 30:.2f} GiB"
    ms_text = "n/a" if ms is None else f"{ms:.1f}"
    print(f"loss at steps {at}; {ms_text} ms a step after the first "
          f"(checkpoints included){mem}")


if __name__ == "__main__":
    main()
