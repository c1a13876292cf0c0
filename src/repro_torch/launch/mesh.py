"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module touches no
process group. Both build a ``DeviceMesh`` over the world that
``torch.distributed.init_process_group`` has already set up.
"""

from __future__ import annotations

from repro_torch.device import DeviceSpec, resolve_device

#: the reference's production meshes: (shape, axis names) by pod count
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh over the initialised world: 16 x 16
    ``("data", "model")``, or with ``multi_pod`` 2 x 16 x 16 ``("pod",
    "data", "model")``. The world must hold exactly that many ranks (the
    dry run's fake process group of 256 or 512); ``device_type`` "cpu"
    for a fake world without a card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_MESHES[bool(multi_pod)]
    n = dist.get_world_size()
    want = 1
    for s in shape:
        want *= s
    if n != want:
        raise ValueError(f"make_production_mesh(multi_pod={multi_pod}) "
                         f"needs a world of {want} ranks, the world size is "
                         f"{n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


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
