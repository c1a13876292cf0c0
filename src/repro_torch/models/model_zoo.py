"""Model factory: ArchConfig -> model instance (counterpart of
``repro/models/model_zoo.py``). The port serves every family of the
reference: the dense family (QKV bias, sliding windows and the GELU MLP
included), the VLM splice, the MoE family (MLA, routed and shared
experts, dense+MoE superblocks), the hybrid family (parallel attention
and SSM heads, ring caches), the xLSTM family (mLSTM and sLSTM blocks)
and the encoder-decoder family (an encoder over precomputed frames,
cross-attention), with ``kahan_attention`` routing prefill through the
flash kernels and ``kahan_matmul`` the dense projections through the
compensated matmul."""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HymbaLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.xlstm_lm import XLSTMLM


def build_model(cfg: ArchConfig, device: torch.device,
                ) -> Union[TransformerLM, HymbaLM, XLSTMLM, EncDecLM]:
    """The model of ``cfg``, dispatched on the sub-configs in the
    reference's order: an ``xlstm`` config is ``XLSTMLM``, an ``encoder``
    config ``EncDecLM``, an ``ssm`` config the hybrid ``HymbaLM``,
    anything else a ``TransformerLM`` (a ``vision`` stub splices patch
    embeddings, ``moe`` / ``mla`` select the MoE layers and latent
    attention, ``sliding_window`` masks attention by a window)."""
    if cfg.xlstm is not None:
        return XLSTMLM(cfg, device)
    if cfg.encoder is not None:
        return EncDecLM(cfg, device)
    if cfg.ssm is not None:
        return HymbaLM(cfg, device)
    return TransformerLM(cfg, device)
