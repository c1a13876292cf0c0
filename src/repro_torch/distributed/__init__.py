"""Distribution: the explicit cross-rank collectives and gradient
compression (counterpart of ``repro/distributed``).

A mesh axis of the reference is a process group here: a
``torch.distributed.device_mesh.DeviceMesh`` names its axes, and an
all-gather on an axis's group fixes the rank-major order that
``jax.lax.all_gather`` fixes. The reference's ``sharding`` rules (the
GSPMD specs of its 256-chip mesh) wait for ROADMAP A8.
"""

from repro_torch.distributed import collectives, compression  # noqa: F401
