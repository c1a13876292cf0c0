"""Shared model-assembly pieces of the port (counterpart of
``repro/models/common.py``): chunked scan prefill, the decode and
parallel-chunk logits and the embedding/head initialisation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dtype_of

Params = Dict[str, Any]
Tensor = torch.Tensor

#: additive logit bias of the padded vocabulary rows (``common.py:325``)
PAD_LOGIT = -1e30


# ---------------------------------------------------------------------------
# Chunked (resume-from-offset) prefill
# ---------------------------------------------------------------------------

def prefill_chunk_scan(step_fn: Callable, tokens: Tensor, cache: Any,
                       offset: int, nvalid: int) -> Tuple[Tensor, Any]:
    """Advance a batch-1 decode cache by one prompt chunk.

    ``tokens``: [1, w] — the chunk, zero-padded past ``nvalid`` (the
    serving engine's power-of-two tail bucket). Position ``offset + i`` is
    fed to ``step_fn(cache, token [1], pos) -> logits [1, v_pad]`` one at
    a time — the model's own decode step, so every prompt position runs
    the identical computation whatever chunk width carries it (the
    reference's ``lax.scan`` over ``prefill_chunk_body``). The reference
    computes the padded steps and discards them by an exact select; an
    eager loop simply stops at ``nvalid``. Returns (logits of the last
    valid position [1, v_pad], the cache advanced in place).
    """
    if not 1 <= nvalid <= tokens.shape[-1]:
        raise ValueError(f"nvalid={nvalid} outside [1, {tokens.shape[-1]}]")
    logits = None
    for i in range(nvalid):
        logits = step_fn(cache, tokens[:, i], offset + i)
    return logits, cache


# ---------------------------------------------------------------------------
# Embedding / head helpers
# ---------------------------------------------------------------------------

def parallel_chunk_logits(x: Tensor, params: Params, cfg: ArchConfig,
                          nvalid: int) -> Tensor:
    """Logits of the last VALID position of a parallel prefill chunk
    (``repro/models/common.py:204-220``): ``x`` [1, w, D] final hidden
    states, ``nvalid`` >= 1 real positions; only that one row pays the
    vocabulary projection. Returns [1, V_pad]."""
    idx = min(max(nvalid - 1, 0), x.shape[1] - 1)
    return decode_logits(x[:, idx:idx + 1, :], params, cfg)


def lm_head_weight(params: Params, cfg: ArchConfig) -> Tensor:
    """[D, V_padded] head weight (transposed embed table when tied)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["head"]["w"]


def vocab_bias(cfg: ArchConfig, device) -> Tensor:
    """[V_padded] float32: 0 on the real vocabulary, -1e30 on padding."""
    ids = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(ids < cfg.vocab_size, 0.0, PAD_LOGIT).to(torch.float32)


def decode_logits(x_last: Tensor, params: Params, cfg: ArchConfig,
                  ) -> Tensor:
    """Logits for a single-position hidden state [B,1,D] -> [B,V_padded]
    float32: the product of the compute-dtype operands accumulated in
    float32, as ``preferred_element_type=float32`` does in the reference;
    padded vocabulary rows get -1e30."""
    w = lm_head_weight(params, cfg)
    logits = torch.matmul(x_last[:, 0, :].float(), w.float())
    return logits + vocab_bias(cfg, logits.device)


def embed_and_head_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """Shapes and init scales of the embedding / final norm / head."""
    out: Dict[str, Any] = {"embed": {"table": ((cfg.padded_vocab, cfg.d_model),
                                              0.02)}}
    out["final_norm"] = norm_shapes(cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        out["head"] = {"w": ((cfg.d_model, cfg.padded_vocab), 0.02)}
    return out


def norm_shapes(d: int, kind: str) -> Dict[str, Any]:
    """Norm parameters as (shape, init): "ones" / "zeros" for the affine
    terms; layernorm_np has none."""
    if kind == "rmsnorm":
        return {"scale": ((d,), "ones")}
    if kind == "layernorm":
        return {"scale": ((d,), "ones"), "bias": ((d,), "zeros")}
    if kind == "layernorm_np":
        return {}
    raise ValueError(kind)


def init_params(spec: Dict[str, Any], cfg: ArchConfig,
                generator: torch.Generator, device) -> Params:
    """Materialize a nested dict of (shape, init) leaves: a float scale
    draws ``scale * N(0, 1)`` in float32 from ``generator`` (in the
    dict's order), "ones"/"zeros" are constants; then cast to
    ``cfg.param_dtype``."""
    dt = dtype_of(cfg.param_dtype)

    def one(leaf):
        shape, init = leaf
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * init).to(dt)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return one(node)

    return walk(spec)


def init_embed_and_head(generator: torch.Generator, cfg: ArchConfig,
                        device) -> Params:
    """Embedding table, final norm and (untied) head, drawn from
    ``generator``."""
    return init_params(embed_and_head_spec(cfg), cfg, generator, device)
