"""Whisper-style encoder-decoder LM, in PyTorch (counterpart of
``repro/models/encdec.py``; the audio frontend is stubbed, as there).

A request brings precomputed frame embeddings ``frames`` [B, F, D] (the
conv frontend's output). The encoder is a stack of non-causal
self-attention and GELU MLP blocks over them; each decoder block runs
causal self-attention (KV-cached for serving), cross-attention to the
encoder's output (its K/V cached once per request), then the MLP. RoPE
stands in for learned absolute positions, and the cross-attention's
queries and keys carry none (the reference's stubs: ``encdec.py:1-8``).

Parameters keep the reference's tree: ``embed``, ``final_norm``,
``head``, ``encoder`` (stacked ``[L_enc, ...]``: ``ln1``, ``attn``,
``ln2``, ``mlp``) and ``decoder`` (stacked ``[L, ...]``: ``ln1``,
``attn``, ``ln_x``, ``xattn``, ``ln2``, ``mlp``). The cache is
``{"kv": (k, v), "xk": ..., "xv": ...}``: the self-attention's k/v
``[L, B, max_len, KV, dh]`` (its ``"kv_seq"`` axis pages under the paged
layout) and the cross K/V ``[L, B, F, KV, dh]``, both in the compute
dtype; the cross K/V name no sequence axis and stay dense slot rows.

``prefill_begin`` encodes the frames and fills the cross K/V; the
serving engine runs it once, in a request's first prefill chunk, and
both ``prefill`` and the chunk bodies read the cached K/V afterwards
(``prefill`` calls the same ``prefill_begin``). ``prefill_chunk`` is the
per-position scan (the oracle), ``prefill_chunk_parallel`` one forward
pass over the chunk (its self-attention through the chunk flash kernel,
B8, with ``kahan_attention``). ``prefill``'s decoder self-attention runs
B7 with ``kahan_attention``; the encoder and every cross-attention stay
on the materialized core, as in the reference. With ``kahan_matmul`` the
encoder's and decoder's q/k/v/o and MLP projections run B5; the cross
K/V fill is a plain product, as the reference computes it
(``encdec.py:233-234``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    Params,
    chunked_ce_loss,
    decode_logits,
    embed_and_head_spec,
    init_embed_and_head,
    init_params,
    lm_head_weight,
    norm_shapes,
    parallel_chunk_logits,
    prefill_chunk_scan,
    stack_spec,
    unbind_layers,
)
from repro_torch.models.layers import (
    AttnStatic,
    Position,
    attention,
    attn_spec,
    dense,
    dtype_of,
    embed_lookup,
    mlp_apply,
    mlp_spec,
    norm_apply,
    rope_freqs,
)

Tensor = torch.Tensor


class EncDecLM:
    """The encoder-decoder LM on one device: ``TransformerLM``'s serving
    and training API, with ``frames`` where a VLM takes patch embeddings,
    plus ``encode`` and ``prefill_begin``."""

    #: the decoder is plain self-attention and cached cross-attention:
    #: a chunk runs in one forward pass
    parallel_prefill_ok = True

    def __init__(self, cfg: ArchConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.st = AttnStatic(
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_freqs(cfg.head_dim, cfg.rope_theta, self.device),
            self.compute_dtype, kahan_attention=cfg.kahan_attention,
            kahan_matmul=cfg.kahan_matmul)

    # ------------------------------------------------------------------ init
    def enc_block_spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        return {"ln1": norm_shapes(d, cfg.norm), "attn": attn_spec(cfg),
                "ln2": norm_shapes(d, cfg.norm),
                "mlp": mlp_spec(cfg, cfg.d_ff)}

    def dec_block_spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        return {"ln1": norm_shapes(d, cfg.norm), "attn": attn_spec(cfg),
                "ln_x": norm_shapes(d, cfg.norm), "xattn": attn_spec(cfg),
                "ln2": norm_shapes(d, cfg.norm),
                "mlp": mlp_spec(cfg, cfg.d_ff)}

    def stack_specs(self) -> Dict[str, Any]:
        return {"encoder": stack_spec(self.enc_block_spec(),
                                      self.cfg.encoder.n_layers),
                "decoder": stack_spec(self.dec_block_spec(),
                                      self.cfg.n_layers)}

    def param_spec(self) -> Dict[str, Any]:
        """(shape, init) of every parameter."""
        spec = embed_and_head_spec(self.cfg)
        spec.update(self.stack_specs())
        return spec

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator`` (on the model's
        device); weights that must match the JAX package come through
        ``repro_torch.bridge``."""
        params = init_embed_and_head(generator, self.cfg, self.device)
        params.update(init_params(self.stack_specs(), self.cfg, generator,
                                  self.device))
        return params

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Zero caches (``repro/models/encdec.py:181-200``)."""
        cfg, cd = self.cfg, self.compute_dtype
        kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
              cfg.head_dim)
        xs = (cfg.n_layers, batch_size, cfg.encoder.n_frames,
              cfg.n_kv_heads, cfg.head_dim)

        def zeros(shape):
            return torch.zeros(shape, dtype=cd, device=self.device)

        return {"kv": (zeros(kv), zeros(kv)), "xk": zeros(xs),
                "xv": zeros(xs)}

    def cache_specs(self) -> Dict[str, Any]:
        """Each cache leaf's axis names: the self-attention K/V's
        position-addressed ``"kv_seq"`` (pageable), the cross K/V's frame
        axis unnamed (dense per slot)."""
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        x = ("layers", "batch", None, "kv_heads", None)
        return {"kv": (kv, kv), "xk": x, "xv": x}

    # --------------------------------------------------------------- encoder
    def _frames(self, frames: Optional[Tensor]) -> Tensor:
        """``frames`` checked against the config: [B, n_frames, D]."""
        enc = self.cfg.encoder
        want = (enc.n_frames, self.cfg.d_model)
        if frames is None or tuple(frames.shape[-2:]) != want:
            got = None if frames is None else tuple(frames.shape)
            raise ValueError(f"{self.cfg.name}: frames of shape {got}, want "
                             f"[B, {want[0]}, {want[1]}]")
        return frames

    def _enc_block(self, p: Params, x: Tensor) -> Tensor:
        cfg = self.cfg
        a_in = norm_apply(p["ln1"], x, cfg.norm)
        x = x + attention(p["attn"], self.st, a_in, causal=False)
        m_in = norm_apply(p["ln2"], x, cfg.norm)
        return x + mlp_apply(p["mlp"], m_in, self.compute_dtype,
                             compensated=cfg.kahan_matmul)

    def encode(self, params: Params, frames: Tensor) -> Tensor:
        """The encoder over ``frames`` [B, F, D]: [B, F, D] in the compute
        dtype (``repro/models/encdec.py:107-123``)."""
        x = self._frames(frames).to(self.compute_dtype)
        for p in unbind_layers(params["encoder"], self.cfg.encoder.n_layers):
            x = self._enc_block(p, x)
        return x

    # --------------------------------------------------------------- decoder
    def _dec_block(self, p: Params, x: Tensor, xk: Tensor, xv: Tensor,
                   kv=None, pos=None, chunk_valid=None) -> Tensor:
        """One decoder layer: self-attention (against ``kv`` when given,
        the mode picked by ``pos`` / ``chunk_valid`` as in
        ``layers.attention``), cross-attention to ``xk`` / ``xv``, the
        MLP."""
        cfg = self.cfg
        a_in = norm_apply(p["ln1"], x, cfg.norm)
        x = x + attention(p["attn"], self.st, a_in, cache=kv, pos=pos,
                          chunk_valid=chunk_valid)
        xa_in = norm_apply(p["ln_x"], x, cfg.norm)
        x = x + attention(p["xattn"], self.st, xa_in, cross_kv=(xk, xv))
        m_in = norm_apply(p["ln2"], x, cfg.norm)
        return x + mlp_apply(p["mlp"], m_in, self.compute_dtype,
                             compensated=cfg.kahan_matmul)

    def _cross_kv(self, p: Params, enc_out: Tensor) -> Tuple[Tensor, Tensor]:
        """One layer's cross K/V from the encoder's output: plain
        products, also under ``kahan_matmul``."""
        cd = self.compute_dtype
        return (dense(p["xattn"]["k"], enc_out, cd),
                dense(p["xattn"]["v"], enc_out, cd))

    def _dec_run(self, params: Params, x: Tensor, cache, pos=None,
                 chunk_valid=None) -> Tensor:
        """The decoder over [B,S,D] against ``cache`` (its cross K/V
        filled by ``prefill_begin``); returns the final-normed hidden
        states."""
        layers = unbind_layers(params["decoder"], self.cfg.n_layers)
        for i, p in enumerate(layers):
            kv = tuple(t[i] for t in cache["kv"])
            x = self._dec_block(p, x, cache["xk"][i], cache["xv"][i], kv,
                                pos, chunk_valid)
        return norm_apply(params["final_norm"], x, self.cfg.norm)

    # ----------------------------------------------------------------- steps
    def loss(self, params: Params, batch: Dict[str, Tensor],
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean masked next-token cross-entropy of ``batch`` (``frames``,
        ``tokens``, ``labels``, ``loss_mask``) and its metrics
        (``repro/models/encdec.py:165-179``): the encoder once, each
        decoder layer recomputed in the backward pass (the reference's
        ``remat``) with its cross K/V from the encoder's output."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = embed_lookup(params["embed"], batch["tokens"], self.compute_dtype)

        def block(p, x):
            return self._dec_block(p, x, *self._cross_kv(p, enc_out))

        for p in unbind_layers(params["decoder"], cfg.n_layers):
            x = checkpoint(block, p, x, use_reentrant=False,
                           preserve_rng_state=False)
        x = norm_apply(params["final_norm"], x, cfg.norm)
        sum_loss, cnt = chunked_ce_loss(x, lm_head_weight(params, cfg),
                                        batch["labels"], batch["loss_mask"],
                                        cfg)
        ce = sum_loss / torch.clamp_min(cnt, 1.0)
        return ce, {"ce_loss": ce.detach(), "tokens": cnt.detach()}

    def prefill_begin(self, params: Params, cache, frames: Tensor):
        """The one-time setup of a request's prefill
        (``repro/models/encdec.py:224-239``): encode ``frames`` [B, F, D]
        and write every layer's cross K/V into ``cache`` (in place), so
        that chunks and decode steps read the cached memory. Returns the
        cache."""
        enc_out = self.encode(params, frames)
        for i, p in enumerate(unbind_layers(params["decoder"],
                                            self.cfg.n_layers)):
            xk, xv = self._cross_kv(p, enc_out)
            cache["xk"][i].copy_(xk)
            cache["xv"][i].copy_(xv)
        return cache

    def prefill(self, params: Params, tokens: Tensor, cache, frames: Tensor,
                ) -> Tuple[Tensor, Any]:
        """Whole-prompt prefill: ``prefill_begin`` on ``frames``, then the
        decoder over ``tokens`` [B, S] at positions 0..S-1 filling the
        K/V prefix; returns (logits of the last position [B, V_pad],
        cache)."""
        cache = self.prefill_begin(params, cache, frames)
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        x = self._dec_run(params, x, cache)
        return decode_logits(x[:, -1:, :], params, self.cfg), cache

    def decode_step(self, params: Params, cache, tokens: Tensor,
                    pos: Position) -> Tensor:
        """One position for a batch: ``tokens`` [B] at position ``pos`` (an
        int, or a LongTensor [B] of one a row) -> logits [B, V_pad]
        float32; K/V written into ``cache``."""
        x = embed_lookup(params["embed"], tokens[:, None], self.compute_dtype)
        return decode_logits(self._dec_run(params, x, cache, pos=pos),
                             params, self.cfg)

    def prefill_chunk(self, params: Params, tokens: Tensor, cache,
                      offset: int, nvalid: int) -> Tuple[Tensor, Any]:
        """Resume-from-offset prefill of a batch-1 cache whose cross K/V
        ``prefill_begin`` filled, position by position through
        ``decode_step``."""
        return prefill_chunk_scan(
            lambda c, tok, pos: self.decode_step(params, c, tok, pos),
            tokens, cache, offset, nvalid)

    def prefill_chunk_parallel(self, params: Params, tokens: Tensor, cache,
                               offset: int, nvalid: int,
                               ) -> Tuple[Tensor, Any]:
        """Multi-token chunk prefill: ONE forward pass over ``tokens`` [1,
        w] at positions ``offset + i``, the first ``nvalid`` real
        (``repro/models/encdec.py:248-265``); a width-1 chunk runs the
        decode mode, as in the reference."""
        if not 1 <= nvalid <= tokens.shape[-1]:
            raise ValueError(
                f"nvalid={nvalid} outside [1, {tokens.shape[-1]}]")
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        x = self._dec_run(params, x, cache, pos=offset, chunk_valid=nvalid)
        return parallel_chunk_logits(x, params, self.cfg, nvalid), cache
