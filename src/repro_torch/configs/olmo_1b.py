"""olmo-1b — dense decoder with NON-PARAMETRIC LayerNorm, tied embeddings.

[arXiv:2402.00838; hf] 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_np",     # OLMo: LN without scale/bias
    mlp="swiglu",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
