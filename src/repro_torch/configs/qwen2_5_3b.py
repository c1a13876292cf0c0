"""qwen2.5-3b — dense decoder, extreme GQA (kv=2), QKV bias, tied embeddings.

[hf:Qwen/Qwen2.5-3B; hf] 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    norm="rmsnorm",
    mlp="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
