"""internvl2-2b — InternViT frontend (STUB) + InternLM2-backbone LM.

[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The vision tower is a stub: 256 precomputed patch embeddings per image (a
request's ``extras["vision_embeds"]``, a training batch's
``vision_embeds``) are spliced over the first 256 token positions (loss
masked over the vision positions).
"""

from repro_torch.configs.base import ArchConfig, VisionStubConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1_000_000.0,
    vision=VisionStubConfig(n_patches=256),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    vision=VisionStubConfig(n_patches=8),
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
