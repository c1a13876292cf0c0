"""LR schedules (functions of the step counter), counterpart of
``repro/optim/schedule.py``. A tensor step keeps its device; the scale is
a float32 tensor computed in the reference's op order."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac``: a float32 scale in
    (0, 1] to multiply the base LR."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step):
    del step
    return 1.0
