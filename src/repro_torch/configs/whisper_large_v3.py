"""whisper-large-v3 — encoder-decoder; conv/audio frontend STUBBED.

[arXiv:2212.04356; unverified] 32L(enc)+32L(dec) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866. ``input_specs()`` provides precomputed frame
embeddings [B, 1500, 1280] (the conv frontend output); decoder shapes follow
the generic LM shape table (mechanical at 32k decode — the real model emits
<=448 tokens; noted in DESIGN.md §5). GELU MLP, parametric LayerNorm,
learned positions (sinusoidal-vs-learned distinction immaterial for the
backbone shapes; absolute learned embeddings used for both stacks).
"""

from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,                 # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    mlp="gelu",
    encoder=EncoderConfig(n_layers=32, n_frames=1500),
)

SMOKE = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    encoder=EncoderConfig(n_layers=2, n_frames=24),
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
