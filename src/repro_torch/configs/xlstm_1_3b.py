"""xlstm-1.3b — sLSTM + mLSTM block stack (xLSTM[7:1]).

[arXiv:2405.04517; unverified] 48 blocks d_model=2048 4H vocab=50304,
d_ff=0 (no separate FFN — the up/down projections live inside the blocks).
One sLSTM block per 8 (paper's 7:1 ratio); mLSTM blocks use the
chunkwise-parallel form for train/prefill and the matrix-memory recurrent
form for decode; sLSTM is inherently sequential over time (recurrent R
matrices) and runs as a lax.scan — the paper itself notes it is not
parallelizable. Sub-quadratic: O(1) state per block — long_500k runs.
"""

from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    mlp="none",
    # chunk=512: §Perf I3b — halves the per-chunk C-state saves in the
    # backward scan (the byte-dominant term) at 2x the (cheap) intra-chunk
    # flops; see EXPERIMENTS.md
    xlstm=XLSTMConfig(slstm_every=8, mlstm_proj_factor=2.0,
                      mlstm_qk_factor=0.5, slstm_proj_factor=1.3333,
                      conv_kernel=4, chunk=512),
)

SMOKE = CONFIG.replace(
    n_layers=4,          # wait-free smoke: one 3:1 group
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    vocab_size=512,
    xlstm=XLSTMConfig(slstm_every=4, mlstm_proj_factor=2.0,
                      mlstm_qk_factor=0.5, slstm_proj_factor=1.3333,
                      conv_kernel=4, chunk=16),
    loss_chunk=64,
    param_dtype="float32",
    compute_dtype="float32",
)
