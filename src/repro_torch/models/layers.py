"""Model layers of the dense decoder, in PyTorch (counterpart of
``repro/models/layers.py``, dense path).

Parameters are plain nested dicts of tensors in the reference's layouts
(q/k/v ``w``: ``[d, H, dh]``, o ``w``: ``[H*dh, d]``, embedding table
``[V_pad, d]``), so weights carry over from the JAX package unchanged
(``repro_torch.bridge``). Dtype policy as in the reference: parameters in
``cfg.param_dtype``, matmuls in ``cfg.compute_dtype``, softmax / norm
statistics / logits in float32.

Attention against a KV cache has the reference's three modes
(``repro/models/layers.py:306-462``): decode (one position, attending every
cache row under a causal mask on absolute positions), whole-prompt
prefill (fill the cache prefix, attend the in-flight k/v) and chunk
prefill (one prompt chunk at an offset, attending the whole cache). With
``kahan_attention`` the two prefill modes run the compensated flash
kernels (``_flash_core``: B7, ``_flash_chunk_core``: B8); otherwise, and
always in decode, the materialized ``_attn_core`` (plain matmuls and an
explicit softmax, q-chunked at ``ATTN_Q_CHUNK``). With ``kahan_matmul``
every dense projection (q, k, v, o, gate, up, down) runs the engine's
compensated matmul (B5); the tied head stays a plain matmul, as the
reference computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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

def dense(p: Params, x: Tensor, compute_dtype: torch.dtype, *,
          compensated: bool = False) -> Tensor:
    """Dense projection ``x @ w`` contracting the last axis of ``x`` with
    the first of ``w`` (whose trailing axes may be fused, e.g. (H, dh)).
    With ``compensated`` (ArchConfig ``kahan_matmul``) the contraction is
    ``ops.matmul`` on ``[B*S, d_in] x [d_in, prod(out)]`` (differentiable),
    scheme / blocks / accumulate dtype from the ambient Policy, the result
    cast to the compute dtype (``repro/models/layers.py:63-87``)."""
    w = p["w"].to(compute_dtype)
    w2 = w.reshape(w.shape[0], -1)
    if compensated:
        from repro_torch.kernels import ops

        x2 = x.to(compute_dtype).reshape(-1, x.shape[-1])
        y = ops.matmul(x2, w2).to(compute_dtype)
    else:
        y = torch.matmul(x.to(compute_dtype), w2)
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
    kahan_attention: bool = False
    kahan_matmul: bool = False


#: q-chunk of the materialized attention core: bounds the float32 score
#: slab to [B, KV, G, ATTN_Q_CHUNK, S_kv] per chunk
ATTN_Q_CHUNK = 512


def _flatten_heads(qg: Tensor, k: Tensor, v: Tensor):
    """qg [B,S,KV,G,dh] -> [B*KV*G, S, dh] ([batch, kv_head, group]-major);
    k/v [B,Skv,KV,dh] -> [B*KV, Skv, dh] once: the kernel reads k/v row
    ``bh // G``, so grouped k/v are never repeated."""
    b, s, kvh, g, dh = qg.shape
    skv = k.shape[1]
    qf = qg.permute(0, 2, 3, 1, 4).reshape(b * kvh * g, s, dh)
    kf = k.permute(0, 2, 1, 3).reshape(b * kvh, skv, dh)
    vf = v.permute(0, 2, 1, 3).reshape(b * kvh, skv, dh)
    return qf, kf, vf


def _unflatten_heads(out: Tensor, qg: Tensor, compute_dtype) -> Tensor:
    b, s, kvh, g, dh = qg.shape
    out = out.reshape(b, kvh, g, s, dh).permute(0, 3, 1, 2, 4)
    return out.to(compute_dtype)


def _flash_core(qg: Tensor, k: Tensor, v: Tensor, compute_dtype) -> Tensor:
    """Causal GQA through the engine's flash kernel (B7). qg [B,Sq,KV,G,dh];
    k/v [B,Skv,KV,dh]. The ambient Policy selects scheme and accumulate
    dtype (``repro/models/layers.py:201-224``)."""
    from repro_torch.kernels.flash_attention import flash_attention

    qf, kf, vf = _flatten_heads(qg, k, v)
    out = flash_attention(qf, kf, vf, causal=True, q_groups=qg.shape[3])
    return _unflatten_heads(out, qg, compute_dtype)


def _flash_chunk_core(qg: Tensor, k: Tensor, v: Tensor, q_off: int,
                      compute_dtype) -> Tensor:
    """Chunked-prefill GQA through the chunk flash kernel (B8): qg
    [B,W,KV,G,dh] at absolute positions ``q_off + i`` against the slot's
    whole cache k/v [B,Skv,KV,dh] (``repro/models/layers.py:227-249``)."""
    from repro_torch.kernels.flash_attention import flash_chunk_attention

    qf, kf, vf = _flatten_heads(qg, k, v)
    out = flash_chunk_attention(qf, kf, vf, q_off=q_off,
                                q_groups=qg.shape[3])
    return _unflatten_heads(out, qg, compute_dtype)


def _attn_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
               k_pos: Tensor, compute_dtype) -> Tensor:
    """Causal grouped-query attention, q-chunked at ``ATTN_Q_CHUNK``
    (``repro/models/layers.py:252-303``). q: [B,Sq,KV,G,dh]; k/v:
    [B,Skv,KV,dh]. Scores in float32, masked by absolute positions,
    softmax with the reference's guards (``m >= -1e30``, ``l >= 1e-30``).
    Returns [B,Sq,KV,G,dh] in the compute dtype."""
    if q.shape[1] > ATTN_Q_CHUNK:
        return torch.cat([
            _attn_core(q[:, i:i + ATTN_Q_CHUNK], k, v,
                       q_pos[i:i + ATTN_Q_CHUNK], k_pos, compute_dtype)
            for i in range(0, q.shape[1], ATTN_Q_CHUNK)], dim=1)
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


def attention(p: Params, st: AttnStatic, x: Tensor, *,
              cache: Tuple[Tensor, Tensor], pos: Optional[int] = None,
              chunk_valid: Optional[int] = None) -> Tensor:
    """Attention against a KV cache ([B,S,KV,dh] each), in one of three
    modes. The cache is written IN PLACE (the reference returns an
    updated copy; PyTorch eager saves copying the whole cache).

    decode          ``pos`` given, x [B,1,D]: write position ``pos``,
                    attend every cache row, keys past ``pos`` masked.
    prefill         ``pos`` None, x [B,S,D] at positions 0..S-1: fill the
                    cache prefix, attend the in-flight k/v causally.
    chunk prefill   ``pos`` and ``chunk_valid`` given, x [B,W,D] (W > 1)
                    at positions ``pos + i``, the first ``chunk_valid``
                    real (the rest bucket padding): write cache rows
                    ``[pos, pos + chunk_valid)`` only, so padding never
                    touches the cache, then attend the whole cache read
                    back in the compute dtype, causal on absolute
                    positions (which also excludes rows not yet written).

    Prefill and chunk prefill run the flash kernels when
    ``st.kahan_attention``; decode always runs ``_attn_core``, as in the
    reference. The q, k, v and o projections run the compensated matmul
    when ``st.kahan_matmul``. Returns [B,S,D].
    """
    cd = st.compute_dtype
    cmp = st.kahan_matmul
    b, s, _ = x.shape
    start = 0 if pos is None else pos
    q_pos = torch.arange(start, start + s, device=x.device)
    q = rope_apply(dense(p["q"], x, cd, compensated=cmp), q_pos,
                   st.freqs)                                # [B,S,H,dh]
    k = rope_apply(dense(p["k"], x, cd, compensated=cmp), q_pos,
                   st.freqs)                                # [B,S,KV,dh]
    v = dense(p["v"], x, cd, compensated=cmp)
    ck, cv = cache
    s_kv = ck.shape[1]
    groups = st.n_heads // st.n_kv
    qg = q.reshape(b, s, st.n_kv, groups, st.d_head)
    if pos is None:                                         # prefill
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
        if st.kahan_attention:
            out = _flash_core(qg, k, v, cd)
        else:
            out = _attn_core(qg, k, v, q_pos, q_pos, cd)
    elif chunk_valid is not None and s > 1:                 # chunk prefill
        ck[:, pos:pos + chunk_valid] = k[:, :chunk_valid].to(ck.dtype)
        cv[:, pos:pos + chunk_valid] = v[:, :chunk_valid].to(cv.dtype)
        if st.kahan_attention:
            out = _flash_chunk_core(qg, ck.to(cd), cv.to(cd), pos, cd)
        else:
            out = _attn_core(qg, ck.to(cd), cv.to(cd), q_pos,
                             torch.arange(s_kv, device=x.device), cd)
    else:                                                   # decode
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        k_pos = torch.arange(s_kv, device=x.device)
        k_pos = torch.where(k_pos <= pos, k_pos, _FAR)
        out = _attn_core(qg, ck.to(cd), cv.to(cd), q_pos, k_pos, cd)
    return dense(p["o"], out.reshape(b, s, -1), cd, compensated=cmp)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_apply(p: Params, x: Tensor, compute_dtype, *,
              compensated: bool = False) -> Tensor:
    """SwiGLU: ``down(silu(gate(x)) * up(x))``, silu in float32; the three
    projections compensated when ``compensated`` (``kahan_matmul``)."""
    cd, cmp = compute_dtype, compensated
    g = F.silu(dense(p["gate"], x, cd, compensated=cmp).float()).to(cd)
    u = dense(p["up"], x, cd, compensated=cmp)
    return dense(p["down"], g * u, cd, compensated=cmp)


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
