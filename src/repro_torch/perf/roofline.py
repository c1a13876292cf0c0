"""Roofline terms of one (arch x shape x mesh) cell of the dry run
(counterpart of ``repro/perf/roofline.py``).

The reference reads per-device FLOPs, bytes and collective bytes from
the compiled HLO of its 256- or 512-device program. The port has no
compiled program: ``launch/dryrun.py`` runs the cell's step once on fake
tensors (``FakeTensorMode``) over a fake process group, and
``DeviceCounter`` counts what each rank's own ops do, below DTensor (the
local shards' aten ops and the functional collectives that DTensor
issues):

- FLOPs: the matmul family and the convolutions, by
  ``torch.utils.flop_counter``'s formulas on the local shapes;
- bytes: the inputs and outputs of every aten op that is no view and no
  bare allocation. Eager PyTorch fuses nothing, so this is what the
  port's step moves through HBM;
- collective bytes: the operands of every collective, by kind, as the
  reference's ``collective_bytes`` sums them;
- the hand-written kernels' own work (``kernels.abstract``): a kernel
  entry on a fake tensor records its FLOPs and bytes and runs nothing.

Three terms, on ``core.ecm.H100`` (989 TFLOP/s bf16, 3350 GB/s HBM, 900
GB/s NVLink for every mesh axis: optimistic for an axis that crosses a
node of 8 cards):

    compute    = FLOPs      / (chips * 989e12)   [s]
    memory     = bytes      / (chips * 3350e9)   [s]
    collective = coll_bytes / (chips * 900e9)    [s]
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.ecm import H100, RooflineTerms

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: collective ops (``_c10d_functional`` and the in-place ``c10d`` ones
#: that ``torch.distributed``'s eager calls reach) -> kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

#: ``c10d`` ops whose second argument holds the input (the first the
#: output)
_OUTPUT_FIRST = {"_allgather_base_", "allgather_", "_reduce_scatter_base_",
                 "reduce_scatter_", "alltoall_base_"}

#: ops that allocate without moving a byte
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class DeviceCounter(FakeTensorMode):
    """A ``FakeTensorMode`` that, inside ``counting()``, adds up one rank's
    FLOPs, HBM bytes and collective operand bytes (see the module
    docstring). DTensor's shape propagation runs its ops on global-shaped
    fake tensors under the same mode; those are not the rank's work and
    are skipped."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self._on = False
        self._meta = 0

    @contextlib.contextmanager
    def counting(self) -> Iterator["DeviceCounter"]:
        """Count inside. Two of DTensor's own helpers are wrapped for the
        duration: its shape propagation, so that its ops are not counted,
        and ``_StridedShard``'s offsets, which it computes with small
        tensors that must hold values (outside the fake mode)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        def counted_out(fn):
            def propagate(*args, **kwargs):
                self._meta += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._meta -= 1
            return propagate

        def with_values(fn):
            def offsets(*args, **kwargs):
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            return offsets

        # the releases name the uncached propagation differently
        meta = next(n for n in ("_propagate_tensor_meta_non_cached",
                                "_propagate_tensor_meta")
                    if hasattr(ShardingPropagator, n))
        wraps = [(ShardingPropagator, meta, counted_out)]
        if hasattr(_StridedShard, "local_shard_size_and_offset"):
            wraps.append((_StridedShard, "local_shard_size_and_offset",
                          with_values))
        inner = [getattr(owner, name) for owner, name, _ in wraps]
        for (owner, name, wrap), fn in zip(wraps, inner):
            setattr(owner, name, wrap(fn))
        self._on = True
        try:
            yield self
        finally:
            self._on = False
            for (owner, name, _), fn in zip(wraps, inner):
                setattr(owner, name, fn)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self._on and not self._meta:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        name = packet.__name__
        if name in _COLLECTIVE_OPS and func.namespace in ("_c10d_functional",
                                                          "c10d"):
            inputs = _tensors(args[1] if func.namespace == "c10d"
                              and name in _OUTPUT_FIRST else args[0])
            self.coll[_COLLECTIVE_OPS[name]] += _nbytes(inputs)
            return
        if (func.namespace != "aten" or func.is_view or name in _ALLOCATIONS
                or not _tensors(out)):
            return
        self.bytes += _nbytes(_tensors(args) + _tensors(kwargs)
                              + _tensors(out))
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    peak_memory_bytes: Optional[float]
    model_flops: float          # 6*N*D (train) or 2*N*D (serve), global
    kernel_work: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    machine: str = H100.name

    def terms(self) -> RooflineTerms:
        return RooflineTerms(
            flops=self.flops_per_device * self.chips,
            hbm_bytes=self.bytes_per_device * self.chips,
            collective_bytes=self.collective_bytes_per_device * self.chips,
            chips=self.chips, machine=H100)

    def to_json(self) -> Dict:
        t = self.terms()
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_flops": self.model_flops,
            "compute_s": t.compute_s,
            "memory_s": t.memory_s,
            "collective_s": t.collective_s,
            "dominant": t.dominant,
            "step_time_s": t.step_time_s,
            "useful_flops_ratio": (self.model_flops / t.flops
                                   if t.flops else 0.0),
            "roofline_fraction": t.roofline_fraction(self.model_flops),
            "kernel_work": self.kernel_work,
            "machine": self.machine,
        }


def analyze(counter: DeviceCounter, kernel_work: Dict[str, Dict[str, float]],
            *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, peak_memory_bytes: Optional[float],
            ) -> CellReport:
    """One rank's counts (the aten ops' and the kernels' own) as a
    report."""
    flops = counter.flops + sum(w["flops"] for w in kernel_work.values())
    byts = counter.bytes + sum(w["bytes"] for w in kernel_work.values())
    coll = dict(counter.coll)
    return CellReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(flops), bytes_per_device=float(byts),
        collective_bytes_per_device=float(sum(coll.values())),
        collective_breakdown=coll, peak_memory_bytes=peak_memory_bytes,
        model_flops=model_flops, kernel_work=kernel_work)
