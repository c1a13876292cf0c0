"""Optimizers: AdamW and Kahan-compensated AdamW, schedules (counterpart
of ``repro/optim``; ``opt_state_specs`` waits for the mesh work)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    apply_update,
    engine_sq_norm,
    global_norm,
    global_norm_ref,
    init,
)
from repro_torch.optim import schedule  # noqa: F401
