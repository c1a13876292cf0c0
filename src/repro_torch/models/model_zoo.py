"""Model factory: ArchConfig -> model instance (counterpart of
``repro/models/model_zoo.py``). The port serves the dense family (QKV bias
and sliding windows included), the VLM splice, the MoE family (MLA,
routed and shared experts, dense+MoE superblocks) and the hybrid family
(parallel attention and SSM heads, ring caches), with
``kahan_attention`` routing prefill through the flash kernels and
``kahan_matmul`` the dense projections through the compensated matmul."""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.hybrid import HymbaLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: torch.device,
                ) -> Union[TransformerLM, HymbaLM]:
    """The model of ``cfg``, dispatched as the reference does: an ``ssm``
    config is the hybrid ``HymbaLM``, anything else a ``TransformerLM``
    (a ``vision`` stub splices patch embeddings, ``moe`` / ``mla`` select
    the MoE layers and latent attention, ``sliding_window`` masks
    attention by a window). xLSTM and encoder-decoder configs and the
    GELU MLP raise, naming ROADMAP A5."""
    later = [feature for feature in ("xlstm", "encoder")
             if getattr(cfg, feature) is not None]
    if cfg.mlp != "swiglu":
        later.append(f"mlp {cfg.mlp!r}")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} ported in a later slice — see "
            f"ROADMAP A5")
    if cfg.ssm is not None:
        return HymbaLM(cfg, device)
    return TransformerLM(cfg, device)
