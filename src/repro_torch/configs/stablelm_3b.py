"""stablelm-3b — dense decoder, parametric LayerNorm, MHA.

[hf:stabilityai/stablelm-3b-4e1t; unverified] 32L d_model=2560 32H
(GQA kv=32 => MHA) d_ff=6912 vocab=50304.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    mlp="swiglu",
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
