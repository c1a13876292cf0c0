"""xLSTM blocks (Beck et al., arXiv:2405.04517), mLSTM and sLSTM, in
PyTorch (counterpart of ``repro/models/xlstm.py``).

mLSTM (matrix memory): a whole prompt runs the chunkwise-parallel form,
an intra-chunk term with exponential-gate decays plus the inter-chunk
recurrent state (C, n, m), stabilised in log space; a decode position is
the same function on a chunk of length 1 (``_mlstm_chunk``: one formula
for both, as in the reference). A prompt that is not a multiple of the
chunk is padded with input gates of -1e30 and forget gates of +30, and
the padded rows are sliced off. The up, q/k/v and down projections
accumulate in the compute dtype; the gates, the conv window and every
state are float32.

sLSTM (scalar memory, exponential gating, block-diagonal recurrent
matrices ``r`` [H, dh, 4dh]): sequential over time, a Python loop over
positions with max-stabilised gates, then the gated FFN.

A block's cache is a tuple of views of the model's stacked cache, written
IN PLACE (the reference returns updated copies): the mLSTM's (C
[B,H,dqk,dv], n [B,H,dqk], m [B,H], conv_buf [B,k-1,dI]) and the sLSTM's
(c, n, m, h) each [B, d]; every ``m`` starts at -1e30
(``XLSTMLM.init_cache``), not at zero.

The projections are einsums in the reference, not ``layers.dense``, so
``kahan_matmul`` never reaches them and xLSTM runs no compensated kernel
but the engine's telemetry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import on_local_rows, unshard
from repro_torch.models.layers import (Leaf, Params, dtype_of, norm_apply,
                                      project)

Tensor = torch.Tensor

#: the stabiliser's floor and the initial ``m`` of every state
NEG = -1e30


def _dims(cfg):
    """(d_in, d_qk, per-head qk, per-head v) of the mLSTM."""
    xl = cfg.xlstm
    d_in = int(xl.mlstm_proj_factor * cfg.d_model)
    d_qk = int(xl.mlstm_qk_factor * d_in)
    return d_in, d_qk, d_qk // cfg.n_heads, d_in // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _if_bias(shape) -> Tensor:
    """The gates' bias: input 0, forget ``linspace(3, 6, H)``."""
    h = shape[-1] // 2
    b = torch.cat([torch.zeros(h), torch.linspace(3.0, 6.0, h)])
    return b.expand(shape).clone()


def mlstm_spec(cfg) -> Params:
    """The ``Leaf``s of one mLSTM block, scaled as the
    reference's ``mlstm_init`` (``repro/models/xlstm.py:50-77``); the
    gate projection and its bias in float32."""
    d, h = cfg.d_model, cfg.n_heads
    d_in, d_qk, _, _ = _dims(cfg)
    xi = "xl_inner"
    return {
        "norm": {"scale": Leaf((d,), "ones", (None,))},
        "up_u": {"w": Leaf((d, d_in), d ** -0.5, ("embed", xi))},
        "up_z": {"w": Leaf((d, d_in), d ** -0.5, ("embed", xi))},
        "conv_w": Leaf((cfg.xlstm.conv_kernel, d_in), 0.5, (None, xi)),
        "conv_b": Leaf((d_in,), "zeros", (xi,)),
        "wq": {"w": Leaf((d_in, d_qk), d_in ** -0.5, (xi, None))},
        "wk": {"w": Leaf((d_in, d_qk), d_in ** -0.5, (xi, None))},
        "wv": {"w": Leaf((d_in, d_in), d_in ** -0.5, (xi, xi))},
        "w_if": {"w": Leaf((d_in, 2 * h), d_in ** -0.5, (xi, None),
                           "float32"),
                 "b": Leaf((2 * h,), _if_bias, (None,), "float32")},
        "out_norm": {"scale": Leaf((d_in,), "ones", (xi,))},
        "down": {"w": Leaf((d_in, d),
                           d_in ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                           (xi, "embed"))},
    }


def mlstm_cache_shapes(cfg, batch_size: int):
    """(C, n, m, conv_buf) shapes of one block's state."""
    d_in, _, kq, kv = _dims(cfg)
    h, b = cfg.n_heads, batch_size
    return ((b, h, kq, kv), (b, h, kq), (b, h),
            (b, cfg.xlstm.conv_kernel - 1, d_in))


def _conv_causal(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv along S, the reference's unrolled k-tap sum
    (``xlstm.py:92-97``), in ``x``'s dtype."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _mlstm_chunk(state, q, k, v, i_raw, f_raw):
    """One chunk of the chunkwise-parallel mLSTM, all float32
    (``xlstm.py:100-148``). state: (C [B,H,K,V], n [B,H,K], m [B,H]);
    q/k: [B,H,L,K]; v: [B,H,L,V]; i_raw/f_raw: [B,H,L]. Returns (the
    state after the chunk, h [B,H,L,V])."""
    c_in, n_in, m_in = state
    scale = q.shape[-1] ** -0.5
    lf = F.logsigmoid(f_raw)
    # contract: allow-no-uncompensated-reduction(log-domain forget-gate prefix; chunk-length fp32 terms defining the decay, as the reference's xlstm.py:110)
    b_cum = torch.cumsum(lf, dim=-1)                  # [B,H,L]
    total_g = b_cum[..., -1:]
    # intra-chunk decay logD[j, t] = i[t] + b[j] - b[t], t <= j
    logd = (i_raw[:, :, None, :] + b_cum[:, :, :, None]
            - b_cum[:, :, None, :])
    n = q.shape[2]
    tri = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    logd = torch.where(tri, logd, float("-inf"))
    m_intra = torch.amax(logd, dim=-1)
    m_inter = m_in[..., None] + b_cum
    m_new = torch.maximum(m_intra, m_inter).clamp_min(NEG)

    d_mat = torch.exp(logd - m_new[..., None])        # [B,H,L,L]
    # contract: allow-no-uncompensated-reduction(mLSTM intra-chunk scores; fp32 over head_dim terms, as the reference's xlstm.py:125)
    s_mat = torch.einsum("bhld,bhtd->bhlt", q, k) * scale * d_mat
    # contract: allow-no-uncompensated-reduction(mLSTM intra-chunk mix; fp32, chunk-bounded terms, as the reference's xlstm.py:126)
    h_intra = torch.einsum("bhlt,bhtv->bhlv", s_mat, v)
    inter_scale = torch.exp(m_inter - m_new)
    # contract: allow-no-uncompensated-reduction(mLSTM state readout; fp32 over head_dim terms, as the reference's xlstm.py:129)
    h_inter = (torch.einsum("bhld,bhdv->bhlv", q, c_in) * scale
               * inter_scale[..., None])
    num = h_intra + h_inter
    # contract: allow-no-uncompensated-reduction(mLSTM normalizer; fp32, chunk-bounded terms, as the reference's xlstm.py:134)
    n_intra = torch.sum(s_mat, dim=-1)
    # contract: allow-no-uncompensated-reduction(mLSTM normalizer readout; fp32 over head_dim terms, as the reference's xlstm.py:135)
    n_inter = torch.einsum("bhld,bhd->bhl", q, n_in) * scale * inter_scale
    denom = torch.maximum(torch.abs(n_intra + n_inter), torch.exp(-m_new))
    h = num / denom[..., None]

    m_out = torch.maximum(m_in + total_g[..., 0],
                          torch.amax(i_raw + total_g - b_cum, dim=-1))
    w_t = torch.exp(i_raw + total_g - b_cum - m_out[..., None])
    carry = torch.exp(m_in + total_g[..., 0] - m_out)
    c_out = (carry[..., None, None] * c_in
             # contract: allow-no-uncompensated-reduction(mLSTM state update; fp32, chunk-bounded terms, as the reference's xlstm.py:144)
             + torch.einsum("bhl,bhld,bhlv->bhdv", w_t, k, v))
    # contract: allow-no-uncompensated-reduction(mLSTM normalizer update; fp32, chunk-bounded terms, as the reference's xlstm.py:146)
    n_out = carry[..., None] * n_in + torch.einsum("bhl,bhld->bhd", w_t, k)
    return (c_out, n_out, m_out), h


def mlstm_apply(p: Params, cfg, x: Tensor, *,
                cache: Optional[Tuple[Tensor, ...]] = None) -> Tensor:
    """One mLSTM block (pre-norm; the caller adds the residual). With a
    ``cache`` and one position, the decode step: the conv window from
    ``conv_buf``, one chunk of length 1 from the state. Otherwise the
    chunkwise form over x [B,S,D] from the cache's state (fresh state
    without one), and with a cache the state and the last k-1 inputs of
    the conv are written into it. Returns [B,S,D]."""
    xl = cfg.xlstm
    cd = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nh = cfg.n_heads
    d_in, _, kq, kv = _dims(cfg)

    xn = norm_apply(p["norm"], x, "rmsnorm").to(cd)
    u = project(xn, p["up_u"]["w"].to(cd))
    z = project(xn, p["up_z"]["w"].to(cd))

    decode = cache is not None and s == 1
    if decode:
        c_st, n_st, m_st, conv_buf = cache
        win = torch.cat([conv_buf, u], dim=1)
        # contract: allow-no-uncompensated-reduction(depthwise conv window; fp32, kernel-width terms, as the reference's xlstm.py:171)
        cu = (torch.einsum("bki,ki->bi", win.float(),
                           p["conv_w"].float()) + p["conv_b"].float())
        cu = F.silu(cu)[:, None, :].to(cd)
    else:
        cu = F.silu(_conv_causal(u, p["conv_w"].to(cd), p["conv_b"].to(cd))
                    .float()).to(cd)

    q = project(cu, p["wq"]["w"].to(cd))
    k = project(cu, p["wk"]["w"].to(cd))
    v = project(u, p["wv"]["w"].to(cd))
    gates = project(cu.float(), p["w_if"]["w"]) + p["w_if"]["b"]
    i_raw = gates[..., :nh].transpose(1, 2)          # [B,H,S]
    f_raw = gates[..., nh:].transpose(1, 2)

    def heads(t, dh):
        return unshard(t, -1).reshape(b, s, nh, dh).transpose(1, 2).float()

    qh, kh, vh = heads(q, kq), heads(k, kq), heads(v, kv)

    if decode:
        (c_new, n_new, m_new), h = _mlstm_chunk(
            (c_st, n_st, m_st), qh, kh, vh, i_raw, f_raw)
        c_st.copy_(c_new)
        n_st.copy_(n_new)
        m_st.copy_(m_new)
        conv_buf.copy_(win[:, 1:])
    else:
        chunk = min(xl.chunk, s)
        pad = (-s) % chunk
        if pad:
            qh, kh, vh = (F.pad(t, (0, 0, 0, pad)) for t in (qh, kh, vh))
            i_raw = F.pad(i_raw, (0, pad), value=NEG)
            f_raw = F.pad(f_raw, (0, pad), value=30.0)
        if cache is None:
            state = (qh.new_zeros((b, nh, kq, kv)), qh.new_zeros((b, nh, kq)),
                     qh.new_full((b, nh), NEG))
        else:
            state = tuple(cache[:3])
        outs = []
        for lo in range(0, s + pad, chunk):
            sl = slice(lo, lo + chunk)
            state, h = _mlstm_chunk(state, qh[:, :, sl], kh[:, :, sl],
                                    vh[:, :, sl], i_raw[:, :, sl],
                                    f_raw[:, :, sl])
            outs.append(h)
        h = torch.cat(outs, dim=2)[:, :, :s]
        if cache is not None:
            for dst, src in zip(cache[:3], state):
                dst.copy_(src)
            conv_buf = cache[3]
            conv_buf.copy_(torch.cat([conv_buf, u], dim=1)
                           [:, -conv_buf.shape[1]:])

    h_flat = unshard(h, -1).transpose(1, 2).reshape(b, s, d_in).to(cd)
    h_flat = norm_apply(p["out_norm"], h_flat, "rmsnorm")
    h_gated = h_flat * F.silu(z.float()).to(cd)
    return project(h_gated, p["down"]["w"].to(cd))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_bias(cfg):
    """The gate bias [z | i | f | o]: zeros but the forget gate's
    ``linspace(3, 6, H)``, each head's value over its dh units."""
    d, h = cfg.d_model, cfg.n_heads

    def init(shape) -> Tensor:
        f = torch.linspace(3.0, 6.0, h)[:, None].expand(h, d // h).reshape(d)
        z = torch.zeros(d)
        return torch.cat([z, z, f, z]).expand(shape).clone()

    return init


def slstm_spec(cfg) -> Params:
    """The ``Leaf``s of one sLSTM block, scaled as the
    reference's ``slstm_init`` (``xlstm.py:244-275``); the gate bias and
    the recurrent matrices in float32."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    f = int(cfg.xlstm.slstm_proj_factor * d)
    return {
        "norm": {"scale": Leaf((d,), "ones", (None,))},
        "w": {"w": Leaf((d, 4 * d), d ** -0.5, ("embed", None)),
              "b": Leaf((4 * d,), _slstm_bias(cfg), (None,), "float32")},
        "r": Leaf((h, dh, 4 * dh), dh ** -0.5, (None, None, None), "float32"),
        "up_g": {"w": Leaf((d, f), d ** -0.5, ("embed", "mlp"))},
        "up_u": {"w": Leaf((d, f), d ** -0.5, ("embed", "mlp"))},
        "down": {"w": Leaf((f, d), f ** -0.5 / (2 * cfg.n_layers) ** 0.5,
                           ("mlp", "embed"))},
    }


def _slstm_step(r: Tensor, heads: int, carry, wx_t: Tensor):
    """One sLSTM position (``xlstm.py:278-300``): carry (c, n, m, h) each
    [B, d] float32, ``wx_t`` [B, 4d], ``r`` the recurrent matrices.
    Returns the new carry."""
    c, n, m, h = carry
    b, d = h.shape
    dh = d // heads
    # contract: allow-no-uncompensated-reduction(sLSTM recurrent product; fp32 over head_dim terms, as the reference's xlstm.py:284)
    rh = torch.einsum("bhd,hdg->bhg", h.reshape(b, heads, dh), r)
    rh = rh.reshape(b, heads, 4, dh).transpose(1, 2).reshape(b, 4 * d)
    pre = wx_t + rh                                   # [z | i | f | o]
    z_t = torch.tanh(pre[:, :d])
    i_t = pre[:, d:2 * d]
    f_t = F.logsigmoid(pre[:, 2 * d:3 * d])
    o_t = torch.sigmoid(pre[:, 3 * d:])
    m_new = torch.maximum(f_t + m, i_t)
    decay = torch.exp(f_t + m - m_new)
    inject = torch.exp(i_t - m_new)
    c_new = decay * c + inject * z_t
    n_new = decay * n + inject
    h_new = o_t * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, m_new, h_new


def slstm_apply(p: Params, cfg, x: Tensor, *,
                cache: Optional[Tuple[Tensor, ...]] = None) -> Tensor:
    """One sLSTM block (pre-norm, the recurrence position by position
    from the cache's state or a fresh one, then the gated FFN; the caller
    adds the residual). With a ``cache`` the state after the last
    position is written into it. Returns [B,S,D]."""
    cd = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    xn = norm_apply(p["norm"], x, "rmsnorm").to(cd)
    wx = project(xn, p["w"]["w"].to(cd)).float() + p["w"]["b"]
    if cache is None:
        zero = wx.new_zeros((b, d))
        carry = (zero, zero, wx.new_full((b, d), NEG), zero)
    else:
        carry = tuple(cache)

    def scan(wx, c, n, m, h, r):
        carry, hs = (c, n, m, h), []
        for t in range(s):
            carry = _slstm_step(r, cfg.n_heads, carry, wx[:, t])
            hs.append(carry[3])
        return carry, torch.stack(hs, dim=1)

    carry, h_seq = on_local_rows(scan, (wx, *carry), (p["r"],))
    if cache is not None:
        for dst, src in zip(cache, carry):
            dst.copy_(src)
    h_seq = h_seq.to(cd)                              # [B,S,d]
    g = F.silu(project(h_seq, p["up_g"]["w"].to(cd)).float()).to(cd)
    u = project(h_seq, p["up_u"]["w"].to(cd))
    return project(g * u, p["down"]["w"].to(cd))


def slstm_cache_shapes(cfg, batch_size: int):
    """(c, n, m, h) shapes of one sLSTM block's state."""
    return ((batch_size, cfg.d_model),) * 4

