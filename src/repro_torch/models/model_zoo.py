"""Model factory: ArchConfig -> model instance (counterpart of
``repro/models/model_zoo.py``). The port serves the dense family (QKV bias
included), the VLM splice and the MoE family (MLA, routed and shared
experts, dense+MoE superblocks), with ``kahan_attention`` routing prefill
through the flash kernels and ``kahan_matmul`` the dense projections
through the compensated matmul."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: torch.device) -> TransformerLM:
    """The decoder LM of ``cfg`` (family "dense", "vlm" or "moe"; a
    ``vision`` stub splices patch embeddings, ``moe`` / ``mla`` select the
    MoE layers and latent attention); the families and features the port
    does not carry yet raise, naming ROADMAP A5."""
    later = []
    if cfg.family not in ("dense", "vlm", "moe"):
        later.append(f"family {cfg.family!r}")
    for feature in ("ssm", "xlstm", "encoder"):
        if getattr(cfg, feature) is not None:
            later.append(feature)
    if cfg.sliding_window > 0:
        later.append("sliding-window attention")
    if cfg.mlp != "swiglu":
        later.append(f"mlp {cfg.mlp!r}")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} ported in a later slice — see "
            f"ROADMAP A5")
    return TransformerLM(cfg, device)
