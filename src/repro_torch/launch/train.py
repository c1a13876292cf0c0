"""Training launcher of the port (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 100 [--smoke] [--ckpt-dir /path] [--microbatches 2]

trains on the card with random weights made from seed 0 on the
synthetic Markov LM stream (``repro_torch.data``); ``--device cpu`` runs
on the CPU (the kernels' plain versions), ``--smoke`` selects the reduced
config. The flags are the reference launcher's, plus ``--device``; one
process, one device.
"""

import argparse
import logging

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=10,
        opt=AdamWConfig(lr=args.lr, kahan=True),
    )
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch,
        vision_patches=cfg.vision.n_patches if cfg.vision else 0,
        n_frames=cfg.encoder.n_frames if cfg.encoder else 0,
        d_model=cfg.d_model))
    trainer = Trainer(cfg, tc, data, device=args.device)
    final = trainer.run()
    print(f"final: {final}")
    return 0


if __name__ == "__main__":
    main()
