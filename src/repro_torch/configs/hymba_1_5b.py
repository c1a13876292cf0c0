"""hymba-1.5b — hybrid: PARALLEL attention + mamba heads in every layer.

[arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Sliding-window attention (1024) in all layers except the
global-attention layers {0, 15, 31} (first/middle/last, per the paper).
The per-layer attention and SSM outputs are each normalized and averaged
before the residual add (the paper's fusion rule). Meta-tokens are
omitted: they are a prompt-side additive feature orthogonal to the
backbone shapes exercised here.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    d_head=64,
    norm="rmsnorm",
    mlp="swiglu",
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=1, chunk=128),
)

SMOKE = CONFIG.replace(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    d_head=16,
    vocab_size=512,
    sliding_window=16,
    global_attn_layers=(0, 3),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=1, chunk=16),
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
