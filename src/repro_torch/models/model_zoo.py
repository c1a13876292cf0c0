"""Model factory: ArchConfig -> model instance (counterpart of
``repro/models/model_zoo.py``). The port serves the dense family, with
``kahan_attention`` routing prefill through the flash kernels and
``kahan_matmul`` the dense projections through the compensated matmul."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: torch.device) -> TransformerLM:
    """The dense decoder LM of ``cfg``; other families and dense features
    the port does not carry yet raise."""
    later = []
    if cfg.family != "dense":
        later.append(f"family {cfg.family!r}")
    for feature in ("moe", "mla", "ssm", "xlstm", "encoder", "vision"):
        if getattr(cfg, feature) is not None:
            later.append(feature)
    if cfg.sliding_window > 0:
        later.append("sliding-window attention")
    if cfg.mlp != "swiglu":
        later.append(f"mlp {cfg.mlp!r}")
    if cfg.qkv_bias:
        later.append("qkv bias")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} ported in a later slice — see "
            f"ROADMAP")
    return TransformerLM(cfg, device)
