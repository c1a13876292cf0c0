"""Distribution: the explicit cross-rank collectives, gradient
compression and the logical-axis sharding rules (counterpart of
``repro/distributed``).

A mesh axis of the reference is a process group here: a
``torch.distributed.device_mesh.DeviceMesh`` names its axes, and an
all-gather on an axis's group fixes the rank-major order that
``jax.lax.all_gather`` fixes. The reference's ``sharding`` rules (the
GSPMD specs of its 256-chip mesh) lay out DTensors here
(``sharding``); where DTensor cannot follow GSPMD, the port lays out by
hand (ROADMAP A8 lists each site).
"""

from repro_torch.distributed import (  # noqa: F401
    collectives,
    compression,
    sharding,
)
