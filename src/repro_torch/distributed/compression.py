"""Gradient compression with error feedback: int8 collective payloads
(counterpart of ``repro/distributed/compression.py``).

Error feedback IS compensated accumulation: the residual each round's
quantization drops is carried forward and re-injected, the Kahan pattern
over time.

* ``quantize`` / ``dequantize``: symmetric int8 with a shared scale, so
  that the integer sum across ranks is exact in int32.
* ``ef_step``: one error-feedback round over a gradient tree.
* ``compressed_psum``: the all-reduce with an int8 payload: a MAX of
  |x| across the group, int8 encode, an int32 SUM, dequantize. Both
  all-reduces are exact in any order (a maximum, an integer sum), which
  is why this one function may use them.

The reference's ``TrainConfig`` has no switch for it, so the trainer
does not call it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import kahan as K
from repro_torch.core import tree as _tree

Tensor = torch.Tensor


def quantize(g: Tensor, scale: Tensor) -> Tensor:
    """Symmetric int8 quantization with an externally supplied scale:
    ``round(g / max(scale, 1e-30) * 127)`` (ties to even), clipped to
    [-127, 127]."""
    g = g.float()
    q = K.mul(K.div(g, torch.clamp_min(scale.float(), 1e-30)),
              K.scalar_like(127.0, g))
    return torch.clamp(torch.round(q), -127, 127).to(torch.int8)


def dequantize(q: Tensor, scale: Tensor) -> Tensor:
    scale = scale.float()
    return K.mul(q.float(), K.div(scale, K.scalar_like(127.0, scale)))


def ef_step(grads: Any, errors: Any) -> Tuple[Any, Any]:
    """One error-feedback round (local, before the collective): per leaf
    ``corrected = g + e``, quantized at ``max|corrected|``; returns (a
    tree of ``(q, scale)``, the new errors ``corrected - dequantized``)."""
    def leaf(g, e):
        corrected = K.add(g.float(), e)
        scale = torch.max(torch.abs(corrected))
        q = quantize(corrected, scale)
        return (q, scale), K.sub(corrected, dequantize(q, scale))

    flat = [leaf(g, e) for g, e in zip(_tree.leaves(grads),
                                       _tree.leaves(errors))]
    return (_tree.unflatten(grads, [f[0] for f in flat]),
            _tree.unflatten(grads, [f[1] for f in flat]))


def compressed_psum(x: Tensor, group=None) -> Tensor:
    """All-reduce over the process group ``group`` (None: the world) with
    an int8 payload: scale = the group's max |x|, int8 encode, exact int32
    sum, dequantize. The mean is NOT taken (the caller divides)."""
    import torch.distributed as dist

    scale = torch.max(torch.abs(x.float())).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale.reshape(())
    total = quantize(x, scale).to(torch.int32)
    # contract: allow-no-raw-psum(int32 payload — integer sum is exact and order-independent, as the reference's compression.py:70)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return dequantize(total, scale)
