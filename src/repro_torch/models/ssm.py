"""Mamba-style selective SSM, the SSM half of hymba's parallel heads, in
PyTorch (counterpart of ``repro/models/ssm.py``).

Prefill and training run the CHUNKED scan: the [B, L, dI, dS] decay and
drive tensors are split into chunks of ``cfg.ssm.chunk`` positions,
each chunk is scanned with the reference's associative scan (its
odd/even recursion, combine for combine, so that the up to ``chunk``
decays a state carries multiply in the reference's order) and the state
``h`` is carried from chunk to chunk. Decode is the O(1) recurrent step
on the serving cache's ``(h [B, dI, dS] float32, conv_buf [B, k-1, dI])``,
which it updates IN PLACE (the reference returns a new pair).

The contractions (the in/gate, x and dt projections, the conv window, the
readout and the output projection) are plain PyTorch: the reference
computes each with ``jnp.einsum`` outside any kernel, so
``kahan_matmul`` does not reach them (``repro/models/ssm.py:90-175``).
Activations follow the reference's formulas: softplus as
``logaddexp(x, 0)``, silu as ``x * sigmoid(x)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of

Params = Dict[str, Any]
Tensor = torch.Tensor


def dt_rank(cfg) -> int:
    """The dt projection's rank: ``cfg.ssm.dt_rank`` or ceil(d / 16)."""
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def _a_log(shape) -> Tensor:
    """S4D-real init: ``A = -(1..dS)`` per channel, stored as its log."""
    a = torch.arange(1, shape[-1] + 1, dtype=torch.float32)
    return torch.log(a).expand(shape).clone()


def _dt_bias(shape) -> Tensor:
    """``log(expm1(0.01))``: softplus of the bias is the initial step 0.01,
    computed in float32 and then cast, as the reference does."""
    return torch.log(torch.expm1(torch.full(shape, 0.01,
                                            dtype=torch.float32)))


def ssm_spec(cfg) -> Params:
    """(shape, init[, dtype]) of one SSM's parameters, scaled as the
    reference's ``ssm_init`` (``repro/models/ssm.py:28-54``): ``A_log``
    and ``D`` in float32, everything else in ``cfg.param_dtype``."""
    s, d = cfg.ssm, cfg.d_model
    d_in, r = s.expand * d, dt_rank(cfg)
    return {
        "in_x": {"w": ((d, d_in), d ** -0.5)},
        "in_z": {"w": ((d, d_in), d ** -0.5)},
        "conv_w": ((s.d_conv, d_in), s.d_conv ** -0.5),
        "conv_b": ((d_in,), "zeros"),
        "x_proj": {"w": ((d_in, r + 2 * s.d_state), d_in ** -0.5)},
        "dt_proj": {"w": ((r, d_in), r ** -0.5), "b": ((d_in,), _dt_bias)},
        "A_log": ((d_in, s.d_state), _a_log, "float32"),
        "D": ((d_in,), "ones", "float32"),
        "out": {"w": ((d_in, d),
                      d_in ** -0.5 / (2 * cfg.n_layers) ** 0.5)},
    }


def ssm_cache_shapes(cfg, batch_size: int):
    """The decode state's shapes: ``h`` [B, dI, dS] and ``conv_buf`` [B,
    k-1, dI]."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return (batch_size, d_in, s.d_state), (batch_size, s.d_conv - 1, d_in)


def silu(x: Tensor) -> Tensor:
    """``x * sigmoid(x)`` (``jax.nn.silu``)."""
    return x * torch.sigmoid(x)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv along S: x [B,S,dI], w [k,dI]; the unrolled
    k-tap window sum of the reference (``ssm.py:69-76``)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + b


def _combine(e1, e2):
    """The scan's combine: (a1, b1) then (a2, b2) is (a1 a2, a2 b1 + b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of ``_combine`` along axis 1, in
    ``jax.lax.associative_scan``'s order: combine adjacent pairs, scan the
    half-length result recursively (the odd outputs), then combine each
    odd output with the next even input (the even outputs), and
    interleave. Every output is the same rounded products and sums as the
    reference's, combine for combine."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, e, o in zip((a, b), even, odd):
        e = torch.cat([first[:, :1], e], dim=1)
        full = first.new_empty(first.shape)
        full[:, 0::2] = e
        full[:, 1::2] = o
        out.append(full)
    return out[0], out[1]


def _ssm_chunk(h0: Tensor, a: Tensor, bx: Tensor, c: Tensor, du: Tensor):
    """One chunk of the selective scan from state ``h0`` [B,dI,dS]
    float32: a, bx [B,L,dI,dS]; c [B,L,dS]; du [B,L,dI]. Returns (the
    last state, y [B,L,dI])."""
    a_cum, b_cum = associative_scan(a, bx)
    h = b_cum + a_cum * h0[:, None]
    y = torch.einsum("blds,bls->bld", h, c) + du
    return h[:, -1], y


def ssm_apply(p: Params, cfg, x: Tensor, *,
              cache: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """x [B,S,D] -> y [B,S,D] (``repro/models/ssm.py:79-175``). With a
    ``cache`` (``h``, ``conv_buf``) and S = 1: the decode step, reading
    and then overwriting both in place. With a cache and S > 1: the
    chunked scan from ``h``, leaving the last state in ``h`` and the
    prompt's last ``k - 1`` pre-conv inputs (in the compute dtype) in
    ``conv_buf``. Without a cache (training): the chunked scan from
    zeros."""
    s_cfg = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    b, s, _ = x.shape
    d_in = s_cfg.expand * cfg.d_model
    r = dt_rank(cfg)

    xc = x.to(cd)
    x_in = torch.matmul(xc, p["in_x"]["w"].to(cd))
    z = torch.matmul(xc, p["in_z"]["w"].to(cd))

    decode = cache is not None and s == 1
    if decode:
        h_prev, conv_buf = cache
        window = torch.cat([conv_buf, x_in], dim=1)           # [B,k,dI]
        u = (torch.einsum("bki,ki->bi", window.float(),
                          p["conv_w"].float())
             + p["conv_b"].float())
        u = silu(u)[:, None, :]                               # [B,1,dI]
    else:
        u = silu(_causal_conv(x_in, p["conv_w"].to(cd),
                              p["conv_b"].to(cd)).float())

    u = u.float()
    dbc = torch.matmul(u.to(cd), p["x_proj"]["w"].to(cd)).float()
    dt_in = dbc[..., :r]
    b_ssm = dbc[..., r:r + s_cfg.d_state]
    c_ssm = dbc[..., r + s_cfg.d_state:]
    dt = torch.logaddexp(
        torch.matmul(dt_in, p["dt_proj"]["w"].float())
        + p["dt_proj"]["b"].float(), torch.zeros((), dtype=f32,
                                                 device=x.device))

    a_mat = -torch.exp(p["A_log"])                            # [dI,dS]
    decay = torch.exp(dt[..., None] * a_mat)                  # [B,S,dI,dS]
    drive = (dt * u)[..., None] * b_ssm[:, :, None, :]        # [B,S,dI,dS]
    du = p["D"] * u

    if decode:
        h = decay[:, 0] * h_prev + drive[:, 0]                # [B,dI,dS]
        y = (torch.einsum("bds,bs->bd", h, c_ssm[:, 0])[:, None, :]
             + du)
        h_prev.copy_(h)
        conv_buf.copy_(window[:, 1:])
    else:
        chunk = min(s_cfg.chunk, s)
        pad = (-s) % chunk
        if pad:
            decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)
            drive = F.pad(drive, (0, 0, 0, 0, 0, pad))
            c_ssm = F.pad(c_ssm, (0, 0, 0, pad))
            du = F.pad(du, (0, 0, 0, pad))
        h = (cache[0] if cache is not None
             else torch.zeros((b, d_in, s_cfg.d_state), dtype=f32,
                              device=x.device))
        ys = []
        for lo in range(0, decay.shape[1], chunk):
            hi = lo + chunk
            h, y = _ssm_chunk(h, decay[:, lo:hi], drive[:, lo:hi],
                              c_ssm[:, lo:hi], du[:, lo:hi])
            ys.append(y)
        y = torch.cat(ys, dim=1)[:, :s]
        if cache is not None:
            h_cache, conv_buf = cache
            h_cache.copy_(h)
            # the last k - 1 pre-conv inputs; a prompt shorter than that
            # keeps the older rows of the buffer before it
            k1 = conv_buf.shape[1]
            tail = torch.cat([conv_buf, x_in.to(conv_buf.dtype)], dim=1)
            conv_buf.copy_(tail[:, tail.shape[1] - k1:])

    y = y.to(cd) * silu(z.float()).to(cd)
    return torch.matmul(y, p["out"]["w"].to(cd))
