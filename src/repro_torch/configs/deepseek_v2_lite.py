"""deepseek-v2-lite-16b — MLA + fine-grained MoE.

[arXiv:2405.04434; hf] 27L d_model=2048 16H d_ff(expert)=1408 vocab=102400.
MLA: kv_lora_rank=512, decoupled RoPE dim 64, qk_nope 128, v_head 128 (no
q-compression in the Lite variant). MoE: 64 routed experts top-6 + 2 shared,
first layer dense (d_ff 10944); 160 routed experts belong to the full V2,
not to Lite. Total ≈ 16B, active ≈ 2.4B.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MLA: all heads share the latent KV
    d_ff=10944,             # the single leading dense layer
    vocab_size=102400,
    d_head=192,             # qk_nope 128 + rope 64
    norm="rmsnorm",
    mlp="swiglu",
    mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  d_ff_shared=1408, interleave=1, first_k_dense=1),
)

SMOKE = CONFIG.replace(
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    d_head=48,
    vocab_size=512,
    mla=MLAConfig(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
                  v_head_dim=32),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                  d_ff_shared=64, interleave=1, first_k_dense=1),
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
