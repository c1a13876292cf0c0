"""Architecture / shape configuration schema and registry.

A framework-free copy of ``repro/configs/base.py`` (importing
``repro.configs`` would pull in jax). Every architecture is a module in
``repro_torch.configs`` exporting ``CONFIG`` (the exact published
configuration) and ``SMOKE`` (a reduced same-family configuration for CPU
tests). ``get_config(name)`` / ``get_smoke(name)`` / ``list_archs()`` are
the public API; the launcher's ``--arch <id>`` flag resolves through them.
The port carries the dense family (``olmo-1b``, ``deepseek-7b``,
``stablelm-3b``, ``qwen2.5-3b``), the VLM ``internvl2-2b`` and the MoE
family (``deepseek-v2-lite-16b`` with MLA, ``llama4-maverick-400b-a17b``
with dense+MoE superblocks), the hybrid ``hymba-1.5b`` (parallel
attention and selective-SSM heads, sliding-window ring caches), the
recurrent ``xlstm-1.3b`` (mLSTM and sLSTM blocks) and the
encoder-decoder ``whisper-large-v3`` (precomputed frames, cross-attention):
every architecture of the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared experts applied to every token
    d_ff_shared: int = 0
    interleave: int = 1          # every Nth layer is MoE (llama4: 2)
    first_k_dense: int = 0       # leading dense layers (deepseek-v2: 1)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (used by hymba's parallel SSM heads)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 1              # d_inner = expand * d_model
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    chunk: int = 128             # scan chunk length (memory knob)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack (Beck et al. 2024)."""

    slstm_every: int = 8         # one sLSTM per this many blocks (7:1)
    mlstm_proj_factor: float = 2.0
    mlstm_qk_factor: float = 0.5  # d_qk = qk_factor * d_inner
    slstm_proj_factor: float = 1.3333
    conv_kernel: int = 4
    chunk: int = 256             # mLSTM chunkwise-parallel chunk length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The modality frontend is
    a STUB: input_specs() provides precomputed frame embeddings."""

    n_layers: int
    n_frames: int = 1500         # whisper: 30 s of audio at 50 Hz post-conv


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub: precomputed patch embeddings spliced into the
    token stream (input_specs() provides them)."""

    n_patches: int = 256


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                    # dense-layer FFN hidden size
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    norm: str = "rmsnorm"        # rmsnorm | layernorm | layernorm_np
    mlp: str = "swiglu"          # swiglu | gelu | none
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # attention layout: per-layer sliding windows; 0 = full attention.
    # pattern repeats / is indexed explicitly by build_model.
    sliding_window: int = 0
    global_attn_layers: Tuple[int, ...] = ()   # hymba: full-attn exceptions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
    # numerics / technique knobs (the paper's feature, on by default)
    kahan_loss: bool = True       # compensated chunked cross-entropy
    kahan_grad_accum: bool = True
    kahan_optimizer: bool = True
    # engine-kernel routing (off by default: the Pallas kernels run in
    # interpret mode off-TPU, so these are precision/validation modes,
    # not the fast path). The ambient repro.kernels Policy picks the
    # scheme / blocks / accumulate dtype.
    kahan_matmul: bool = False    # dense projections via ops.matmul
    # parallel (multi-token) prefill attention via the engine flash
    # kernel: model.prefill, and — under EngineConfig.prefill_mode=
    # "flash" — the serving engine's parallel chunk body, which runs
    # each prefill chunk as ONE fused pass through the chunk flash
    # kernel at a traced cache offset (families whose recurrence forces
    # per-position stepping fall back to the scan body)
    kahan_attention: bool = False
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # loss chunking (memory knob for the vocab matmul)
    loss_chunk: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 for clean 16-way TP sharding."""
        return -(-self.vocab_size // 2048) * 2048

    @property
    def subquadratic(self) -> bool:
        """True if long_500k is runnable (no full-attention O(S^2) layer at
        5e5 sequence length, or attention windows bound the KV cost)."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid" and self.sliding_window > 0:
            return True
        return False

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (drives roofline MODEL_FLOPS) -------------------
    def param_counts(self) -> Dict[str, float]:
        """Approximate total and per-token-active parameter counts."""
        d, dh = self.d_model, self.head_dim
        h, hkv = self.n_heads, self.n_kv_heads
        attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
        if self.mla is not None:
            m = self.mla
            attn = (d * m.kv_lora_rank + d * m.qk_rope_dim
                    + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                    + d * h * (m.qk_nope_dim + m.qk_rope_dim)
                    + h * m.v_head_dim * d)
        mlp_dense = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        embed = self.padded_vocab * d * (1 if self.tie_embeddings else 2)

        total = embed
        active = embed
        n_moe = 0
        if self.moe is not None:
            mo = self.moe
            f = 3 if self.mlp == "swiglu" else 2
            expert = f * d * mo.d_ff_expert
            shared = mo.n_shared * f * d * (mo.d_ff_shared or mo.d_ff_expert)
            n_moe = max(0, (self.n_layers - mo.first_k_dense)) // mo.interleave
            n_dense = self.n_layers - n_moe
            total += self.n_layers * attn + n_dense * mlp_dense
            total += n_moe * (mo.n_experts * expert + shared)
            active += self.n_layers * attn + n_dense * mlp_dense
            active += n_moe * (mo.top_k * expert + shared)
        elif self.xlstm is not None:
            xl = self.xlstm
            d_in = int(xl.mlstm_proj_factor * d)
            d_qk = int(xl.mlstm_qk_factor * d_in)
            mblk = d * d_in * 2 + d_in * d + 2 * d * d_qk  # up/gate/down + qk
            d_sin = int(xl.slstm_proj_factor * d)
            sblk = 4 * d * d + 4 * d * d + 2 * d * d_sin   # in + rec + ffn
            n_s = self.n_layers // xl.slstm_every
            total += (self.n_layers - n_s) * mblk + n_s * sblk
            active = total
        else:
            per_layer = attn + mlp_dense
            if self.ssm is not None:  # hybrid: parallel SSM heads
                s = self.ssm
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                per_layer += (2 * d * d_in + d_in * d
                              + d_in * (dt_rank + 2 * s.d_state)
                              + dt_rank * d_in + s.d_conv * d_in)
            total += self.n_layers * per_layer
            if self.encoder is not None:
                enc_layer = attn + mlp_dense
                cross = attn
                total += self.encoder.n_layers * enc_layer + self.n_layers * cross
            active = total
        return {"total": float(total), "active": float(active)}


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 512k KV decode is out of scope (DESIGN.md §5)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = ("olmo-1b", "deepseek-7b", "stablelm-3b", "qwen2.5-3b",
            "internvl2-2b", "deepseek-v2-lite-16b",
            "llama4-maverick-400b-a17b", "hymba-1.5b", "xlstm-1.3b",
            "whisper-large-v3")

_MODULES = {
    "olmo-1b": "olmo_1b",
    "deepseek-7b": "deepseek_7b",
    "stablelm-3b": "stablelm_3b",
    "qwen2.5-3b": "qwen2_5_3b",
    "internvl2-2b": "internvl2_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-large-v3": "whisper_large_v3",
}


def list_archs() -> Tuple[str, ...]:
    return ARCH_IDS


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _load(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _load(name).SMOKE
