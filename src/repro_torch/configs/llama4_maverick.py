"""llama4-maverick-400b-a17b — interleaved MoE, 128 routed experts top-1.

[hf:meta-llama/Llama-4-*; unverified] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1.

Parameter-count derivation (DESIGN.md §5): "MoE 128e top-1" on every layer
with d_ff 8192 would give ~780B; the published Maverick interleaves MoE on
every 2nd layer (interleave_moe_layer_step=2) with a shared expert
(d_ff 8192) on MoE layers and a wider dense MLP (16384) on dense layers:
  24 MoE layers x 128 experts x 3*5120*8192  ≈ 386B routed
  + dense/shared/attn/embed                  ≈  12B
  -> ≈ 398B total, ≈ 14B active (+2B embed tables) — matching 400b-a17b.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,             # dense-layer MLP width (intermediate_size_mlp)
    vocab_size=202048,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1,
                  d_ff_shared=8192, interleave=2, first_k_dense=0,
                  capacity_factor=1.25),
)

SMOKE = CONFIG.replace(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=96, n_shared=1,
                  d_ff_shared=96, interleave=2, first_k_dense=0),
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
