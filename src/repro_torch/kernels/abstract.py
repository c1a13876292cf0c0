"""Kernel entries handed a tensor subclass.

A kernel wrapper checks ``type(x) is not Tensor`` once per call (its only
cost on the eager path) and, on a subclass, asks ``screen``:

- a DTensor raises ``TypeError`` naming the entry. Sharded callers pass
  their local shards themselves (the sharded norm, attention on each
  rank's heads: ``distributed.sharding.on_local_heads``);
- a ``FakeTensor`` (the dry run, ``launch/dryrun.py``) makes the wrapper
  return empty outputs of the kernel's shapes, dtypes and device, and
  ``record`` its own work under its name: the bytes it must move (each
  input read once, each output written once) and its operations, by the
  formulas of PERF.md's bounds. The plain version never runs on a fake
  tensor.

Work goes to the dict of the innermost ``recording`` context (none: it
is dropped).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator

import torch

_WORK: contextvars.ContextVar = contextvars.ContextVar("kernel_work",
                                                       default=None)


def screen(entry: str, *tensors) -> bool:
    """True when the call is abstract (a fake tensor among ``tensors``);
    a DTensor raises."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{entry}: a DTensor reached the kernel entry; pass each "
                f"rank's local shard (DTensor.to_local())")
    return any(isinstance(t, FakeTensor) for t in tensors)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(entry: str, flops: float, moved: float) -> None:
    """Add one launch of ``entry`` doing ``flops`` operations and moving
    ``moved`` bytes to the ambient recording."""
    work = _WORK.get()
    if work is None:
        return
    row = work.setdefault(entry, {"launches": 0, "flops": 0.0, "bytes": 0.0})
    row["launches"] += 1
    row["flops"] += float(flops)
    row["bytes"] += float(moved)


@contextlib.contextmanager
def recording(work: Dict[str, Dict[str, float]]) -> Iterator[dict]:
    """Record the abstract kernel calls made inside into ``work``."""
    token = _WORK.set(work)
    try:
        yield work
    finally:
        _WORK.reset(token)
