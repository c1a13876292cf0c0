"""Model layers of the dense decoder, in PyTorch (counterpart of
``repro/models/layers.py``, dense non-compensated path).

Parameters are plain nested dicts of tensors in the reference's layouts
(q/k/v ``w``: ``[d, H, dh]``, o ``w``: ``[H*dh, d]``, embedding table
``[V_pad, d]``), so weights carry over from the JAX package unchanged
(``repro_torch.bridge``). Dtype policy as in the reference: parameters in
``cfg.param_dtype``, matmuls in ``cfg.compute_dtype``, softmax / norm
statistics / logits in float32.

Attention runs in decode mode against a KV cache: one query position per
call, attending every row of the cache under a causal mask on absolute
positions, as the reference's ``_attn_core`` does (plain matmuls and an
explicit softmax; no fused attention operator). Chunked scan prefill
(``models.common.prefill_chunk_scan``) calls it once per prompt position.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
Tensor = torch.Tensor

#: the reference masks keys outside the causal range by giving them this
#: position (``jnp.iinfo(jnp.int32).max``)
_FAR = 2 ** 31 - 1


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Linear / norms / embeddings
# ---------------------------------------------------------------------------

def dense(p: Params, x: Tensor, compute_dtype: torch.dtype) -> Tensor:
    """Dense projection ``x @ w`` contracting the last axis of ``x`` with
    the first of ``w`` (whose trailing axes may be fused, e.g. (H, dh))."""
    w = p["w"].to(compute_dtype)
    y = torch.matmul(x.to(compute_dtype), w.reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def norm_apply(p: Params, x: Tensor, kind: str) -> Tensor:
    """rmsnorm / layernorm / layernorm_np (OLMo's non-parametric LN), with
    float32 statistics."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    else:
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        if kind == "layernorm":
            y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def embed_lookup(p: Params, tokens: Tensor, compute_dtype) -> Tensor:
    return p["table"][tokens].to(compute_dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> Tensor:
    """The [d_head // 2] float32 RoPE frequencies, computed once on the CPU
    (the same bits on every device) and moved to ``device``."""
    half = d_head // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32)
                      / half)
    return freqs.to(device)


def rope_apply(x: Tensor, pos: Tensor, freqs: Tensor) -> Tensor:
    """x: [..., S, H, dh] (dh even); pos: broadcastable to [..., S];
    freqs: ``rope_freqs(dh, theta, x.device)``."""
    half = x.shape[-1] // 2
    ang = pos[..., :, None].float() * freqs                 # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                   # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, decode against a KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttnStatic:
    """Static attention wiring derived from the ArchConfig; ``freqs`` are
    the RoPE frequencies on the model's device (``rope_freqs``)."""

    n_heads: int
    n_kv: int
    d_head: int
    freqs: Tensor
    compute_dtype: torch.dtype


def _attn_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
               k_pos: Tensor, compute_dtype) -> Tensor:
    """Causal grouped-query attention. q: [B,Sq,KV,G,dh]; k/v:
    [B,Skv,KV,dh]. Scores in float32, masked by absolute positions,
    softmax with the reference's guards (``m >= -1e30``, ``l >= 1e-30``).
    Returns [B,Sq,KV,G,dh] in the compute dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    ok = (q_pos[:, None] - k_pos[None, :]) >= 0
    bias = torch.where(ok, 0.0, float("-inf")).to(torch.float32)
    scores = scores + bias
    m = torch.amax(scores, dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    p = (p / l.clamp_min(1e-30)).to(compute_dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v)


def attention(p: Params, st: AttnStatic, x: Tensor, *, pos: int,
              cache: Tuple[Tensor, Tensor]) -> Tensor:
    """One decode position: x [B,1,D] at absolute position ``pos``.

    Writes this position's K/V into ``cache`` ([B,S,KV,dh] each) IN PLACE
    (the reference returns an updated copy; a PyTorch eager step saves
    copying the whole cache), then attends every cache row, keys past
    ``pos`` masked. Returns [B,1,D].
    """
    cd = st.compute_dtype
    b = x.shape[0]
    q_pos = torch.tensor([pos], device=x.device)
    q = rope_apply(dense(p["q"], x, cd), q_pos, st.freqs)   # [B,1,H,dh]
    k = rope_apply(dense(p["k"], x, cd), q_pos, st.freqs)   # [B,1,KV,dh]
    v = dense(p["v"], x, cd)
    ck, cv = cache
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    s_kv = ck.shape[1]
    k_pos = torch.arange(s_kv, device=x.device)
    k_pos = torch.where(k_pos <= pos, k_pos, _FAR)
    groups = st.n_heads // st.n_kv
    qg = q.reshape(b, 1, st.n_kv, groups, st.d_head)
    out = _attn_core(qg, ck.to(cd), cv.to(cd), q_pos, k_pos, cd)
    return dense(p["o"], out.reshape(b, 1, -1), cd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_apply(p: Params, x: Tensor, compute_dtype) -> Tensor:
    """SwiGLU: ``down(silu(gate(x)) * up(x))``, silu in float32."""
    g = F.silu(dense(p["gate"], x, compute_dtype).float()).to(compute_dtype)
    u = dense(p["up"], x, compute_dtype)
    return dense(p["down"], g * u, compute_dtype)


# ---------------------------------------------------------------------------
# Compensated activation telemetry
# ---------------------------------------------------------------------------

def activation_sq_norm(x: Tensor, *, scheme=None) -> Tensor:
    """Per-request compensated squared L2 norm: ``x`` [B, ...] -> [B]
    float32 (``repro/models/layers.py:648-680``). Squares in torch, then
    ONE batched sum launch over the whole batch — bitwise equal to a
    per-request loop. ``scheme``: name / CompensationScheme / Policy, None
    -> the ambient policy."""
    from repro_torch.kernels.engine import CompensatedReduction

    eng = CompensatedReduction(scheme=scheme)
    flat = x.reshape(x.shape[0], -1).float()
    return eng.batched_asum(flat * flat)
