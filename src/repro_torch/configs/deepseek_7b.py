"""deepseek-7b — llama-architecture dense decoder.

[arXiv:2401.02954; hf] 30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    norm="rmsnorm",
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
