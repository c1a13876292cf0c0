"""Local mesh construction (counterpart of ``repro/launch/mesh.py``).

A FUNCTION, not a module-level constant: importing this module touches no
process group. ``make_production_mesh`` (the reference's 16 x 16 and
2 x 16 x 16 meshes) waits for ROADMAP A8 together with
``launch/dryrun.py``, its only caller.
"""

from __future__ import annotations

from repro_torch.device import DeviceSpec, resolve_device


def make_local_mesh(model_parallel: int = 1, device: DeviceSpec = None):
    """A ``DeviceMesh`` named ``("data", "model")`` over the initialised
    world (``torch.distributed.init_process_group`` first), ``world //
    model_parallel`` ranks on "data": each rank one device, on the card
    unless ``device`` says otherwise. Several ranks may share one card
    (a gloo world); the mesh's groups use the world's backend."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world size {n}")
    return init_device_mesh(resolve_device(device).type,
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
