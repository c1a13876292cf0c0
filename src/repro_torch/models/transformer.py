"""Dense decoder-only transformer LM, in PyTorch (counterpart of
``repro/models/transformer.py``, dense segment only).

Parameters keep the reference's tree: ``embed``, ``final_norm`` and one
stacked ``blocks`` segment whose leaves carry a leading layer axis. The
KV cache is ``{"blocks": (k, v)}`` with k/v ``[L, B, S, KV, dh]`` in the
compute dtype, as the reference's ``init_cache`` builds it; the request
axis is 1. Where the reference scans over layers, the port loops.

    init(generator)                               -> params
    init_cache(batch_size, max_len)               -> cache
    prefill(params, tokens, cache)                -> (logits [B, V_pad], cache)
    decode_step(params, cache, tokens, pos)       -> logits [B, V_pad]
    prefill_chunk(params, tokens, cache, offset, nvalid)
                                                  -> (logits [1, V_pad], cache)
    prefill_chunk_parallel(params, tokens, cache, offset, nvalid)
                                                  -> (logits [1, V_pad], cache)

Every step writes the cache in place. ``prefill_chunk`` is the
per-position scan (the oracle); ``prefill_chunk_parallel`` runs the whole
chunk in ONE forward pass, its attention through the chunk flash kernel
when ``kahan_attention``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    Params,
    decode_logits,
    embed_and_head_spec,
    init_embed_and_head,
    init_params,
    norm_shapes,
    parallel_chunk_logits,
    prefill_chunk_scan,
)
from repro_torch.models.layers import (
    AttnStatic,
    attention,
    dtype_of,
    embed_lookup,
    mlp_apply,
    norm_apply,
    rope_freqs,
)

Tensor = torch.Tensor


class TransformerLM:
    """Dense decoder-only LM on one device."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.st = AttnStatic(
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_freqs(cfg.head_dim, cfg.rope_theta, self.device),
            self.compute_dtype, kahan_attention=cfg.kahan_attention,
            kahan_matmul=cfg.kahan_matmul)
        # one forward pass over a chunk is position-independent only
        # without MLA, MoE capacity routing or sliding-window ring caches
        # (``repro/models/transformer.py:91-99``); other configs keep the
        # per-position scan
        self.parallel_prefill_ok = (cfg.mla is None and cfg.moe is None
                                    and cfg.sliding_window <= 0)

    # ------------------------------------------------------------------ init
    def block_spec(self) -> Dict[str, Any]:
        """(shape, init) of one block's parameters, without the layer
        axis; init scales as the reference's ``attn_init`` / ``mlp_init``."""
        cfg = self.cfg
        d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff)
        deep = (2 * cfg.n_layers) ** 0.5
        return {
            "ln1": norm_shapes(d, cfg.norm),
            "attn": {"q": {"w": ((d, h, dh), d ** -0.5)},
                     "k": {"w": ((d, kv, dh), d ** -0.5)},
                     "v": {"w": ((d, kv, dh), d ** -0.5)},
                     "o": {"w": ((h * dh, d), (h * dh) ** -0.5 / deep)}},
            "ln2": norm_shapes(d, cfg.norm),
            "ffn": {"gate": {"w": ((d, f), d ** -0.5)},
                    "up": {"w": ((d, f), d ** -0.5)},
                    "down": {"w": ((f, d), f ** -0.5 / deep)}},
        }

    def param_spec(self) -> Dict[str, Any]:
        """(shape, init) of every parameter, stacked blocks included."""
        n = self.cfg.n_layers

        def stack(node):
            if isinstance(node, dict):
                return {k: stack(v) for k, v in node.items()}
            shape, init = node
            return ((n, *shape), init)

        spec = embed_and_head_spec(self.cfg)
        spec["blocks"] = stack(self.block_spec())
        return spec

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator`` (which must live on
        the model's device). Not the reference's numbers: weights that must
        match the JAX package come through ``repro_torch.bridge``."""
        params = init_embed_and_head(generator, self.cfg, self.device)
        blocks = {"blocks": self.param_spec()["blocks"]}
        params.update(init_params(blocks, self.cfg, generator, self.device))
        return params

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int,
                   ) -> Dict[str, Tuple[Tensor, Tensor]]:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        mk = lambda: torch.zeros(shape, dtype=self.compute_dtype,  # noqa: E731
                                 device=self.device)
        return {"blocks": (mk(), mk())}

    # --------------------------------------------------------------- forward
    def _run_blocks(self, params: Params, cache, x: Tensor, *, pos=None,
                    chunk_valid=None) -> Tensor:
        """The layer loop over [B,S,D] hidden states; ``pos`` /
        ``chunk_valid`` select the attention mode (``layers.attention``).
        Returns the final-normed hidden states."""
        cfg = self.cfg
        blocks = params["blocks"]
        ck_all, cv_all = cache["blocks"]
        for layer in range(cfg.n_layers):
            p = _index(blocks, layer)
            a_in = norm_apply(p["ln1"], x, cfg.norm)
            x = x + attention(p["attn"], self.st, a_in,
                              cache=(ck_all[layer], cv_all[layer]), pos=pos,
                              chunk_valid=chunk_valid)
            m_in = norm_apply(p["ln2"], x, cfg.norm)
            x = x + mlp_apply(p["ffn"], m_in, self.compute_dtype,
                              compensated=cfg.kahan_matmul)
        return norm_apply(params["final_norm"], x, cfg.norm)

    def prefill(self, params: Params, tokens: Tensor, cache,
                ) -> Tuple[Tensor, Any]:
        """Whole-prompt prefill: ``tokens`` [B, S] at positions 0..S-1 fill
        the cache prefix (``cache`` from ``init_cache(B, max_len >= S)``);
        returns (logits of the last position [B, V_pad], cache). With
        ``kahan_attention`` every layer's attention is one flash launch."""
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        x = self._run_blocks(params, cache, x)
        return decode_logits(x[:, -1:, :], params, self.cfg), cache

    def decode_step(self, params: Params, cache, tokens: Tensor, pos: int,
                    ) -> Tensor:
        """One position for a batch: ``tokens`` [B] at absolute position
        ``pos`` -> logits [B, V_pad] float32; K/V written into ``cache``."""
        x = embed_lookup(params["embed"], tokens[:, None], self.compute_dtype)
        x = self._run_blocks(params, cache, x, pos=pos)
        return decode_logits(x, params, self.cfg)

    def prefill_chunk(self, params: Params, tokens: Tensor, cache,
                      offset: int, nvalid: int) -> Tuple[Tensor, Any]:
        """Resume-from-offset prefill of a batch-1 cache: ``tokens`` [1, w]
        at positions ``offset + i``, the first ``nvalid`` real."""

        def step(c, tok, pos):
            return self.decode_step(params, c, tok, pos)

        return prefill_chunk_scan(step, tokens, cache, offset, nvalid)

    def prefill_chunk_parallel(self, params: Params, tokens: Tensor, cache,
                               offset: int, nvalid: int,
                               ) -> Tuple[Tensor, Any]:
        """Multi-token chunk prefill: ONE forward pass over the chunk
        ``tokens`` [1, w] at positions ``offset + i`` (same contract as
        ``prefill_chunk``; ``repro/models/transformer.py:362-401``). Only
        the first ``nvalid`` positions write the cache, and the logits come
        from the last valid one. A width-1 chunk runs the decode mode, as
        in the reference; configs without ``parallel_prefill_ok`` take the
        per-position scan."""
        if not self.parallel_prefill_ok:
            return self.prefill_chunk(params, tokens, cache, offset, nvalid)
        if not 1 <= nvalid <= tokens.shape[-1]:
            raise ValueError(
                f"nvalid={nvalid} outside [1, {tokens.shape[-1]}]")
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        x = self._run_blocks(params, cache, x, pos=offset,
                             chunk_valid=nvalid)
        return parallel_chunk_logits(x, params, self.cfg, nvalid), cache


def _index(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
