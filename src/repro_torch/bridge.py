"""Carry the JAX package's parameters into the port.

``params_from_jax(np_params, cfg, device)`` takes the reference's
parameter tree as numpy arrays (``jax.tree.map(np.asarray, params)``)
and returns the port's: the same nested dict — the port keeps the JAX
layouts at its public functions — of torch tensors on ``device``. Every
leaf is checked against the port's own parameter spec (names, shapes and
dtypes: each segment of the model's ``segments``, a stacked one
(``blocks``, ``moe_blocks``, ``super_blocks``, a hybrid's ``swa_<i>_<j>``)
with its leading layer axis and an unstacked one (``dense_prefix``, a
hybrid's ``global_<i>``) without; the ``[V_pad, d]``
embedding table that doubles as the tied head, q/k/v ``w`` of ``[d, H,
dh]`` and o ``w`` of ``[H*dh, d]``, MLA's q/dkv/kr/uk/uv/o, the experts'
``[E, d, f]`` / ``[E, f, d]`` and the float32 router, the SSM's leaves
with its float32 ``A_log`` and ``D``, an xLSTM's ``groups`` with mLSTM
leaves ``[G, M, ...]`` and sLSTM leaves ``[G, ...]`` (the gates'
projection and bias and the recurrent ``r`` in float32), an
encoder-decoder's stacked ``encoder`` and ``decoder`` with ``xattn``,
``ln_x`` and the GELU MLP's ``up`` and ``down``), so a tree that
does not fit fails here rather than inside a matmul.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import leaf_dtype


def _to_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":      # ml_dtypes.bfloat16: reinterpret
        t = torch.from_numpy(np.array(x.view(np.int16))).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(x))
    return t.to(device)


def params_from_jax(np_params: Dict[str, Any], cfg: ArchConfig,
                    device: DeviceSpec = None) -> Dict[str, Any]:
    """The reference's parameter tree (numpy leaves) -> the port's."""
    dev = resolve_device(device)
    spec = build_model(cfg, dev).param_spec()

    def walk(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"params{path}: want keys {sorted(want)}, "
                                 f"got {got}")
            return {k: walk(node[k], want[k], f"{path}[{k!r}]") for k in want}
        shape = tuple(want[0])
        if tuple(np.shape(node)) != shape:
            raise ValueError(f"params{path}: want shape {shape}, got "
                             f"{tuple(np.shape(node))}")
        t = _to_tensor(node, dev)
        if t.dtype != leaf_dtype(want, cfg):
            raise ValueError(f"params{path}: want dtype "
                             f"{leaf_dtype(want, cfg)}, got {t.dtype}")
        return t

    return walk(np_params, spec, "")
