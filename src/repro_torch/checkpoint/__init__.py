"""Checkpointing: atomic, keep-N, in the reference's on-disk format."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    all_steps,
    latest_step,
    restore,
    save,
)
