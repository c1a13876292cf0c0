"""Model layers of the decoder LMs, in PyTorch (counterpart of
``repro/models/layers.py``: GQA and MLA attention, the MLP, the norms).

Parameters are plain nested dicts of tensors in the reference's layouts
(q/k/v ``w``: ``[d, H, dh]``, o ``w``: ``[H*dh, d]``, embedding table
``[V_pad, d]``), so weights carry over from the JAX package unchanged
(``repro_torch.bridge``). Dtype policy as in the reference: parameters in
``cfg.param_dtype``, matmuls in ``cfg.compute_dtype``, softmax / norm
statistics / logits in float32.

MLA (``mla_attention``, DeepSeek-V2's latent attention) caches the
latent and the shared rope key, decodes in the weight-absorbed form and
prefills by expanding K/V once. Attention against a KV cache has the
reference's three modes
(``repro/models/layers.py:306-462``): decode (one position, attending every
cache row under a causal mask on absolute positions), whole-prompt
prefill (fill the cache prefix, attend the in-flight k/v) and chunk
prefill (one prompt chunk at an offset, attending the whole cache). With
``kahan_attention`` the two prefill modes run the compensated flash
kernels (``_flash_core``: B7, ``_flash_chunk_core``: B8); otherwise, and
always in decode, the materialized ``_attn_core`` (plain matmuls and an
explicit softmax, q-chunked at ``ATTN_Q_CHUNK``). Without a cache
(training) attention is that core, unchunked. A positive ``window``
(sliding-window attention) masks keys ``window`` or more positions back,
and a cache of exactly ``window`` rows is a ring buffer. With ``kahan_matmul``
every dense projection (q, k, v, o, gate, up, down) runs the engine's
compensated matmul (B5, its backward too); the tied head stays a plain
matmul, as the reference computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
Tensor = torch.Tensor
#: a decode call's position: one for every row, or a LongTensor [B] of
#: one a row (the vmapped slot loop)
Position = Union[int, Tensor]

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
    """Rows ``tokens`` of the table in the compute dtype. Differentiable
    with a deterministic backward (``_Lookup``)."""
    table = p["table"]
    if torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, tokens).to(compute_dtype)
    return table[tokens].to(compute_dtype)


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` whose backward is a one-hot product: ``onehot(
    tokens)ᵀ @ g`` in the gradient's dtype. Indexing's own backward
    accumulates repeated tokens with atomic adds on CUDA, in an order that
    changes from run to run; a matrix product sums each row in a fixed
    order, so a step's gradient, and a resumed run, repeat bit for bit.
    The reference's gather transposes to a scatter-add in token order;
    the two differ by rounding only."""

    @staticmethod
    def forward(ctx, table: Tensor, tokens: Tensor) -> Tensor:
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g: Tensor):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1, 1).long()
        onehot = torch.zeros((flat.shape[0], ctx.rows), dtype=g.dtype,
                             device=g.device).scatter_(1, flat, 1.0)
        return onehot.T @ g.reshape(flat.shape[0], -1), None


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

def attn_spec(cfg) -> Params:
    """(shape, init) of one GQA attention's parameters, scaled as the
    reference's ``attn_init`` (``repro/models/layers.py:161-179``): q/k/v
    ``w`` ``[d, heads, dh]`` (with a zero ``b`` of ``[heads, dh]`` under
    ``qkv_bias``), o ``w`` ``[H * dh, d]``."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    deep = (2 * cfg.n_layers) ** 0.5

    def proj(heads):
        out = {"w": ((d, heads, dh), d ** -0.5)}
        if cfg.qkv_bias:
            out["b"] = ((heads, dh), "zeros")
        return out

    return {"q": proj(h), "k": proj(kv), "v": proj(kv),
            "o": {"w": ((h * dh, d), (h * dh) ** -0.5 / deep)}}


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


def _causal_bias(q_pos: Tensor, k_pos: Tensor, window: int = 0,
                 causal: bool = True) -> Tensor:
    """[Sq, Sk] float32 (``[B, Sq, Sk]`` for per-row positions ``[B, Sq]``
    and ``[B, Sk]``): 0 where the key's position is at or before the
    query's (every key when ``causal`` is False; and, with ``window > 0``,
    fewer than ``window`` positions before it), -inf elsewhere
    (``repro/models/layers.py:182-195``)."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window > 0:
        ok = ok & (diff < window)
    return torch.where(ok, 0.0, float("-inf")).to(torch.float32)


def _attn_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
               k_pos: Tensor, compute_dtype, chunked: bool = True,
               window: int = 0, causal: bool = True) -> Tensor:
    """Grouped-query attention, q-chunked at ``ATTN_Q_CHUNK`` unless
    ``chunked`` is False (training, the encoder and cross-attention, as
    in the reference) (``repro/models/layers.py:252-303``). q:
    [B,Sq,KV,G,dh]; k/v: [B,Skv,KV,dh]. Scores in float32, masked by
    absolute positions when ``causal`` (and by ``window`` when it is
    positive), softmax with the reference's guards (``m >= -1e30``, ``l
    >= 1e-30``: a ring slot not filled yet masks a whole row's keys only
    before the first position). Returns [B,Sq,KV,G,dh] in the compute
    dtype."""
    if chunked and q.shape[1] > ATTN_Q_CHUNK:
        return torch.cat([
            _attn_core(q[:, i:i + ATTN_Q_CHUNK], k, v,
                       q_pos[..., i:i + ATTN_Q_CHUNK], k_pos, compute_dtype,
                       window=window, causal=causal)
            for i in range(0, q.shape[1], ATTN_Q_CHUNK)], dim=1)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    bias = _causal_bias(q_pos, k_pos, window, causal)
    if bias.dim() == 3:                     # per-row positions: [B, Sq, Sk]
        bias = bias[:, None, None]
    scores = scores + bias
    m = torch.amax(scores, dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    p = (p / l.clamp_min(1e-30)).to(compute_dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v)


def attention(p: Params, st: AttnStatic, x: Tensor, *,
              cache: Optional[Tuple[Tensor, Tensor]] = None,
              pos: Optional[Position] = None,
              chunk_valid: Optional[int] = None,
              window: int = 0, causal: bool = True,
              cross_kv: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Attention in one of five modes. With no ``cache`` (training) x
    [B,S,D] at positions 0..S-1 attends itself causally (every position,
    with ``causal`` False: an encoder) through the materialized
    ``_attn_core``, unchunked, never through flash (the reference's flash
    kernel has no backward), and writes nothing. With ``cross_kv``
    (cross-attention: k/v [B,F,KV,dh] computed elsewhere, an encoder's
    memory) the queries carry no RoPE and attend every row of ``cross_kv``
    through the materialized core, unchunked, without a cache or a
    position mask (``repro/models/layers.py:348-356, 412-416``).
    Against a KV cache ([B,S,KV,dh] each) the other three; the cache is
    written IN PLACE (the reference returns an updated copy; PyTorch
    eager saves copying the whole cache).

    decode          ``pos`` given, x [B,1,D]: write position ``pos``,
                    attend every cache row, keys past ``pos`` masked.
                    ``pos`` may be a LongTensor [B] (a position per
                    row, the vmapped slot loop's): row ``b`` writes
                    ``pos[b]`` (``pos[b] % W`` in a ring) and masks keys
                    past ``pos[b]``.
    prefill         ``pos`` None, x [B,S,D] at positions 0..S-1: fill the
                    cache prefix, attend the in-flight k/v causally.
    chunk prefill   ``pos`` and ``chunk_valid`` given, x [B,W,D] (W > 1)
                    at positions ``pos + i``, the first ``chunk_valid``
                    real (the rest bucket padding): write cache rows
                    ``[pos, pos + chunk_valid)`` only, so padding never
                    touches the cache, then attend the whole cache read
                    back in the compute dtype, causal on absolute
                    positions (which also excludes rows not yet written).

    ``window > 0`` (sliding-window attention) also masks keys ``window``
    or more positions before the query, in every mode. A cache of
    exactly ``window`` rows is a RING (``repro/models/layers.py:357-432``):
    position ``t`` lives in row ``t % window``. Decode writes that row and
    rebuilds each row's position as ``pos - ((pos - j) mod window)``
    (rows not filled yet get the far position ``_FAR``, outside the
    causal range); prefill keeps the prompt's last ``window`` positions
    and zeroes the rows no position fills; chunk prefill refuses a ring.
    A windowed cache of any other length is position-addressed as
    without a window.

    Prefill and chunk prefill run the flash kernels when
    ``st.kahan_attention``, prefill only without a window (the kernel has
    no window mask, nor has the reference's); decode always runs
    ``_attn_core``, as in the reference. The q, k, v and o projections
    run the compensated matmul when ``st.kahan_matmul``. Returns [B,S,D].
    """
    cd = st.compute_dtype
    cmp = st.kahan_matmul
    b, s, _ = x.shape
    q_pos = _query_positions(pos, s, chunk_valid, x.device)
    groups = st.n_heads // st.n_kv
    if cross_kv is not None:                                # cross
        k, v = cross_kv
        qg = dense(p["q"], x, cd, compensated=cmp).reshape(
            b, s, st.n_kv, groups, st.d_head)
        out = _attn_core(qg, k, v, q_pos,
                         torch.arange(k.shape[1], device=x.device), cd,
                         chunked=False, causal=False)
        return dense(p["o"], out.reshape(b, s, -1), cd, compensated=cmp)
    q = rope_apply(dense(p["q"], x, cd, compensated=cmp), q_pos,
                   st.freqs)                                # [B,S,H,dh]
    k = rope_apply(dense(p["k"], x, cd, compensated=cmp), q_pos,
                   st.freqs)                                # [B,S,KV,dh]
    v = dense(p["v"], x, cd, compensated=cmp)
    qg = q.reshape(b, s, st.n_kv, groups, st.d_head)
    if cache is None:                                       # training
        if pos is not None:
            raise ValueError("attention: training mode (no cache) runs "
                             "positions 0..S-1; pos must be None")
        out = _attn_core(qg, k, v, q_pos, q_pos, cd, chunked=False,
                         window=window, causal=causal)
        return dense(p["o"], out.reshape(b, s, -1), cd, compensated=cmp)
    if not causal:
        raise ValueError("attention: a cached call is causal (only the "
                         "encoder, without a cache, attends every position)")
    ck, cv = cache
    s_kv = ck.shape[1]
    ring = window > 0 and s_kv == window
    if pos is None:                                         # prefill
        if ring:
            # row j holds the last position p < s with p = j (mod W);
            # rows no position reaches stay exact zeros
            j = torch.arange(s_kv, device=x.device)
            src = (s - 1) - torch.remainder(s - 1 - j, s_kv)
            filled = (src >= 0)[None, :, None, None]
            src = src.clamp_min(0)
            ck.copy_(torch.where(filled, k[:, src].to(ck.dtype), 0))
            cv.copy_(torch.where(filled, v[:, src].to(cv.dtype), 0))
        else:
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)
        if st.kahan_attention and window <= 0:
            out = _flash_core(qg, k, v, cd)
        else:
            out = _attn_core(qg, k, v, q_pos, q_pos, cd, window=window)
    elif chunk_valid is not None and s > 1:                 # chunk prefill
        if ring:
            raise ValueError(
                "chunk-parallel prefill does not support ring-buffer "
                "caches; window layers' families must fall back to the "
                "per-position scan body")
        ck[:, pos:pos + chunk_valid] = k[:, :chunk_valid].to(ck.dtype)
        cv[:, pos:pos + chunk_valid] = v[:, :chunk_valid].to(cv.dtype)
        if st.kahan_attention:
            out = _flash_chunk_core(qg, ck.to(cd), cv.to(cd), pos, cd)
        else:
            out = _attn_core(qg, ck.to(cd), cv.to(cd), q_pos,
                             torch.arange(s_kv, device=x.device), cd)
    else:                                                   # decode
        _write_position(ck, pos % s_kv if ring else pos, k[:, 0])
        _write_position(cv, pos % s_kv if ring else pos, v[:, 0])
        j = torch.arange(s_kv, device=x.device)
        last = pos[:, None] if isinstance(pos, Tensor) else pos
        if ring:
            k_pos = last - torch.remainder(last - j, s_kv)
            k_pos = torch.where(k_pos >= 0, k_pos, _FAR)
        else:
            k_pos = torch.where(j <= last, j, _FAR)
        out = _attn_core(qg, ck.to(cd), cv.to(cd), q_pos, k_pos, cd,
                         window=window)
    return dense(p["o"], out.reshape(b, s, -1), cd, compensated=cmp)


def _query_positions(pos: Optional[Position], s: int,
                     chunk_valid: Optional[int], device) -> Tensor:
    """Absolute positions of the S queries: ``[S]`` from ``pos`` (0 when
    None), or ``[B, 1]`` for a per-row position tensor ``pos`` [B], which
    only a decode call (S = 1) takes."""
    if isinstance(pos, Tensor):
        if s != 1 or chunk_valid is not None:
            raise ValueError("a per-row position tensor is a decode call's "
                             "(one token a row)")
        return pos[:, None]
    start = 0 if pos is None else pos
    return torch.arange(start, start + s, device=device)


def _write_position(leaf: Tensor, row, value: Tensor) -> None:
    """``leaf[:, row] = value`` for a cache leaf [B, S, ...]; with a row
    tensor [B], row ``row[b]`` of batch row ``b``."""
    if isinstance(row, Tensor):
        leaf[torch.arange(leaf.shape[0], device=leaf.device), row] = (
            value.to(leaf.dtype))
    else:
        leaf[:, row] = value.to(leaf.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_spec(cfg) -> Params:
    """(shape, init) of one MLA block's parameters, scaled as the
    reference's ``mla_init`` (``repro/models/layers.py:469-492``): q ``[d,
    H, nope + rope]``, dkv ``[d, r]``, kr ``[d, dr]``, uk ``[r, H, nope]``,
    uv ``[r, H, v]``, o ``[H * v, d]`` and the latent's rmsnorm scale."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    r, hv = m.kv_lora_rank, h * m.v_head_dim
    return {
        "q": {"w": ((d, h, m.qk_nope_dim + m.qk_rope_dim), d ** -0.5)},
        "dkv": {"w": ((d, r), d ** -0.5)},
        "kr": {"w": ((d, m.qk_rope_dim), d ** -0.5)},
        "uk": {"w": ((r, h, m.qk_nope_dim), r ** -0.5)},
        "uv": {"w": ((r, h, m.v_head_dim), r ** -0.5)},
        "o": {"w": ((hv, d), hv ** -0.5 / (2 * cfg.n_layers) ** 0.5)},
        "kv_norm": {"scale": ((r,), "ones")},
    }


def mla_attention(p: Params, cfg, freqs: Tensor, x: Tensor, *,
                  cache: Optional[Tuple[Tensor, Tensor]] = None,
                  pos: Optional[Position] = None) -> Tensor:
    """MLA (``repro/models/layers.py:495-598``) with the cache holding the
    latent ``c_kv`` [B,S,r] and the shared rope key ``k_rope`` [B,S,dr],
    written in place; ``freqs`` are ``rope_freqs(dr, theta)``. Modes as in
    ``attention``, without chunk prefill (MLA has no chunk-at-offset
    form, so the engine runs its scan):

    decode          ``pos`` given, x [B,1,D]: the weight-absorbed form,
                    ``q_c = q_nope W_ukᵀ`` scored against the latent and
                    the rope keys, the context through ``W_uv``. ``pos``
                    may be a LongTensor [B], a position per row.
    prefill         ``pos`` None with a cache: fill the prefix, expand K/V
                    from the latent once, attend the cache causally,
                    q-chunked at ``ATTN_Q_CHUNK``.
    training        no cache: the expanded form over x itself, unchunked.

    The q, dkv, kr and o projections run the compensated matmul with
    ``cfg.kahan_matmul``; the latent einsums stay plain, as the reference
    computes them outside any kernel. Returns [B,S,D]."""
    m = cfg.mla
    cd = dtype_of(cfg.compute_dtype)
    cmp = cfg.kahan_matmul
    b, s, _ = x.shape
    h, nope = cfg.n_heads, m.qk_nope_dim
    q_pos = _query_positions(pos, s, None, x.device)
    q = dense(p["q"], x, cd, compensated=cmp)           # [B,S,H,nope+rope]
    q_nope = q[..., :nope]
    q_rope = rope_apply(q[..., nope:], q_pos, freqs)
    c_kv = norm_apply(p["kv_norm"], dense(p["dkv"], x, cd, compensated=cmp),
                      "rmsnorm")                          # [B,S,r]
    k_rope = rope_apply(dense(p["kr"], x, cd, compensated=cmp)[:, :, None],
                        q_pos, freqs)[:, :, 0]            # [B,S,dr]
    if cache is None:
        if pos is not None:
            raise ValueError("mla_attention: training mode (no cache) runs "
                             "positions 0..S-1; pos must be None")
        c_all, r_all = c_kv, k_rope
    else:
        cc, cr = cache
        if pos is None:
            cc[:, :s] = c_kv.to(cc.dtype)
            cr[:, :s] = k_rope.to(cr.dtype)
        elif s == 1:
            _write_position(cc, pos, c_kv[:, 0])
            _write_position(cr, pos, k_rope[:, 0])
        else:
            raise ValueError("mla_attention: a cached call at a position "
                             "takes one token (MLA has no chunk prefill)")
        c_all, r_all = cc.to(cd), cr.to(cd)
    k_pos = torch.arange(c_all.shape[1], device=x.device)
    w_uk = p["uk"]["w"].to(cd)                            # [r,H,nope]
    w_uv = p["uv"]["w"].to(cd)                            # [r,H,v]
    scale = (nope + m.qk_rope_dim) ** -0.5
    if pos is not None:                                   # absorbed decode
        last = pos[:, None] if isinstance(pos, Tensor) else pos
        bias = _causal_bias(q_pos, torch.where(k_pos <= last, k_pos, _FAR))
        if bias.dim() == 3:                 # per-row positions: [B, 1, Sk]
            bias = bias[:, None]
        q_c = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
        sc = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c_all.float())
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                             r_all.float())) * scale + bias
        probs = torch.softmax(sc, dim=-1).to(cd)
        ctx_c = torch.einsum("bhqs,bsr->bqhr", probs, c_all)
        ctx = torch.einsum("bqhr,rhv->bqhv", ctx_c, w_uv)
    else:                                                 # expanded K/V
        k_nope = torch.einsum("bsr,rhn->bshn", c_all, w_uk)
        v = torch.einsum("bsr,rhv->bshv", c_all, w_uv)

        def one_chunk(lo, hi):
            sc = (torch.einsum("bqhn,bshn->bhqs", q_nope[:, lo:hi].float(),
                               k_nope.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_rope[:, lo:hi].float(),
                                 r_all.float())) * scale
            sc = sc + _causal_bias(q_pos[lo:hi], k_pos)
            pr = torch.softmax(sc, dim=-1).to(cd)
            return torch.einsum("bhqs,bshv->bqhv", pr, v)

        chunk = s if cache is None else ATTN_Q_CHUNK
        ctx = torch.cat([one_chunk(i, i + chunk)
                         for i in range(0, s, chunk)], dim=1)
    return dense(p["o"], ctx.reshape(b, s, h * m.v_head_dim), cd,
                 compensated=cmp)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_spec(cfg, d_ff: int) -> Params:
    """(shape, init) of an MLP of width ``d_ff`` (the reference's
    ``mlp_init``): SwiGLU's gate, up and down, or with ``cfg.mlp ==
    "gelu"`` only up and down."""
    d = cfg.d_model
    deep = (2 * cfg.n_layers) ** 0.5
    if cfg.mlp not in ("swiglu", "gelu"):
        raise ValueError(f"mlp {cfg.mlp!r}")
    out = {"gate": {"w": ((d, d_ff), d ** -0.5)}} if cfg.mlp == "swiglu" \
        else {}
    out["up"] = {"w": ((d, d_ff), d ** -0.5)}
    out["down"] = {"w": ((d_ff, d), d_ff ** -0.5 / deep)}
    return out


def mlp_apply(p: Params, x: Tensor, compute_dtype, *,
              compensated: bool = False) -> Tensor:
    """SwiGLU ``down(silu(gate(x)) * up(x))`` when ``p`` has a gate, else
    the GELU MLP ``down(gelu(up(x)))``; the activation in float32 and the
    GELU in its tanh form, ``jax.nn.gelu``'s default (the reference's
    ``mlp_apply``). The projections compensated when ``compensated``
    (``kahan_matmul``)."""
    cd, cmp = compute_dtype, compensated
    u = dense(p["up"], x, cd, compensated=cmp)
    if "gate" not in p:
        h = F.gelu(u.float(), approximate="tanh").to(cd)
        return dense(p["down"], h, cd, compensated=cmp)
    g = F.silu(dense(p["gate"], x, cd, compensated=cmp).float()).to(cd)
    return dense(p["down"], g * u, cd, compensated=cmp)


# ---------------------------------------------------------------------------
# Compensated activation telemetry
# ---------------------------------------------------------------------------

def activation_sq_norm(x: Tensor, *, scheme=None, mesh=None,
                       axis: str = "data") -> Tensor:
    """Per-request compensated squared L2 norm: ``x`` [B, ...] -> [B]
    float32 (``repro/models/layers.py:648-680``). Squares in torch, then
    ONE batched sum launch over the whole batch — bitwise equal to a
    per-request loop. ``scheme``: name / CompensationScheme / Policy, None
    -> the ambient policy.

    With a ``mesh`` (a ``DeviceMesh``), ``x`` is batch-sharded over
    ``axis`` (every rank passes the whole batch and takes its contiguous
    block of requests): each rank reduces its own requests with one launch
    and gets their norms, ``[B / n]``. No cross-rank fold: the norm is per
    request (for a scalar one, ``distributed.collectives.sharded_asum``)."""
    from repro_torch.kernels.engine import CompensatedReduction

    eng = CompensatedReduction(scheme=scheme)
    if mesh is not None:
        import torch.distributed as dist

        group = mesh.get_group(axis)
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[0] % n:
            raise ValueError(f"activation_sq_norm: batch {x.shape[0]} does "
                             f"not divide by the axis size {n}")
        x = x[r * (x.shape[0] // n):(r + 1) * (x.shape[0] // n)]
    flat = x.reshape(x.shape[0], -1).float()
    return eng.batched_asum(flat * flat)
