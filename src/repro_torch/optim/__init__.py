"""Optimizers: AdamW and Kahan-compensated AdamW, schedules (counterpart
of ``repro/optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    apply_update,
    engine_sq_norm,
    global_norm,
    global_norm_ref,
    init,
    opt_state_specs,
)
from repro_torch.optim import schedule  # noqa: F401
