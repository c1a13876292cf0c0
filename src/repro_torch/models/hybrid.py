"""Hymba-style hybrid LM: PARALLEL attention and selective-SSM heads in
every layer, in PyTorch (counterpart of ``repro/models/hybrid.py``).

A layer is pre-norm -> {attention (sliding-window or global), the SSM}
on the same normed input -> each path RMS-normed -> their mean ->
residual; then a pre-norm SwiGLU MLP. The stack is planned as the
reference plans it (``plan_hymba_segments``): each global-attention
layer is an unstacked single ``global_<i>`` (window 0), each run of
window layers between them a stacked ``swa_<i>_<j>`` (window
``cfg.sliding_window``). Parameters keep that tree (the singles without
a layer axis, the runs with it), so ``repro_torch.bridge`` maps the
reference's parameters unchanged.

The cache is one entry a segment, ``{"kv": (k, v), "ssm": (h,
conv_buf)}`` with a layer axis in front of EVERY leaf (1 for a single,
unlike the reference, so that each leaf's request axis is 1):
k/v ``[L, B, S, KV, dh]`` in the compute dtype, where ``S`` is
``window`` for a window segment (a RING: position ``t`` in row ``t %
window``, ``layers.attention``) and ``max_len`` for a global one; ``h``
``[L, B, dI, dS]`` in float32 and ``conv_buf`` ``[L, B, k-1, dI]`` in the
compute dtype. ``cache_specs`` names the ring axis ``"kv_ring"`` and the
global one ``"kv_seq"``: under the paged layout the global layers page,
the rings and the SSM state stay dense per slot.

There is no parallel chunk prefill (``parallel_prefill_ok`` False): the
SSM recurrence is position-sequential and a ring has no chunk-at-offset
write, so the engine resolves ``prefill_mode="flash"`` to the scan body,
whose per-position step IS ``decode_step``. ``prefill`` runs the whole
prompt at once: the window layers' attention through the materialized
core with the window mask, the global layers' through the flash kernel
(B7) with ``kahan_attention``, the SSM through its chunked scan. With
``kahan_matmul`` attention's q/k/v/o and the MLP run the compensated
matmul (B5); the SSM's contractions stay plain, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

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
    prefill_chunk_scan,
    stack_spec,
    unbind_layers,
)
from repro_torch.models.layers import (
    AttnStatic,
    Position,
    attention,
    attn_spec,
    dtype_of,
    embed_lookup,
    mlp_apply,
    mlp_spec,
    norm_apply,
    rope_freqs,
)
from repro_torch.models.ssm import ssm_apply, ssm_cache_shapes, ssm_spec

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HSegment:
    """A global-attention single (``window`` 0, ``scan`` False) or a
    stacked run of sliding-window layers."""

    name: str
    n_layers: int
    window: int
    scan: bool


def plan_hymba_segments(cfg: ArchConfig) -> List[HSegment]:
    """The reference's segments (``repro/models/hybrid.py:47-66``)."""
    segs: List[HSegment] = []
    globals_ = set(cfg.global_attn_layers)
    i = 0
    while i < cfg.n_layers:
        if i in globals_:
            segs.append(HSegment(f"global_{i}", 1, 0, False))
            i += 1
        else:
            j = i
            while j < cfg.n_layers and j not in globals_:
                j += 1
            segs.append(HSegment(f"swa_{i}_{j - 1}", j - i,
                                 cfg.sliding_window, True))
            i = j
    return segs


class HymbaLM:
    """The hybrid LM on one device; the serving and training API of
    ``TransformerLM`` (without the parallel chunk)."""

    #: the SSM recurrence and the ring caches run the per-position scan
    parallel_prefill_ok = False

    def __init__(self, cfg: ArchConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.st = AttnStatic(
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_freqs(cfg.head_dim, cfg.rope_theta, self.device),
            self.compute_dtype, kahan_attention=cfg.kahan_attention,
            kahan_matmul=cfg.kahan_matmul)
        self.segments = plan_hymba_segments(cfg)

    # ------------------------------------------------------------------ init
    def block_spec(self) -> Dict[str, Any]:
        """(shape, init) of one layer's parameters, without the layer
        axis (the reference's ``_block_init``)."""
        cfg = self.cfg
        d = cfg.d_model
        return {"ln1": norm_shapes(d, cfg.norm), "attn": attn_spec(cfg),
                "ssm": ssm_spec(cfg), "na": norm_shapes(d, "rmsnorm"),
                "ns": norm_shapes(d, "rmsnorm"),
                "ln2": norm_shapes(d, cfg.norm),
                "mlp": mlp_spec(cfg, cfg.d_ff)}

    def segment_spec(self) -> Dict[str, Any]:
        """Every segment's parameters, a stacked run's with its layer
        axis."""
        block = self.block_spec()
        return {seg.name: stack_spec(block, seg.n_layers) if seg.scan
                else block for seg in self.segments}

    def param_spec(self) -> Dict[str, Any]:
        """(shape, init) of every parameter, the segments included."""
        spec = embed_and_head_spec(self.cfg)
        spec.update(self.segment_spec())
        return spec

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator`` (on the model's
        device); weights that must match the JAX package come through
        ``repro_torch.bridge``."""
        params = init_embed_and_head(generator, self.cfg, self.device)
        params.update(init_params(self.segment_spec(), self.cfg, generator,
                                  self.device))
        return params

    def layers(self, params: Params):
        """(segment, one layer's parameters) for every layer in order."""
        for seg in self.segments:
            if seg.scan:
                for p in unbind_layers(params[seg.name], seg.n_layers):
                    yield seg, p
            else:
                yield seg, params[seg.name]

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Zero caches, one ``{"kv", "ssm"}`` entry a segment
        (``repro/models/hybrid.py:176-215``), a layer axis in front of
        every leaf."""
        cfg, cd = self.cfg, self.compute_dtype
        h_shape, conv_shape = ssm_cache_shapes(cfg, batch_size)

        def zeros(n, shape, dtype):
            return torch.zeros((n, *shape), dtype=dtype, device=self.device)

        out = {}
        for seg in self.segments:
            n = seg.n_layers
            rows = seg.window if seg.window > 0 else max_len
            kv = (batch_size, rows, cfg.n_kv_heads, cfg.head_dim)
            out[seg.name] = {
                "kv": (zeros(n, kv, cd), zeros(n, kv, cd)),
                "ssm": (zeros(n, h_shape, torch.float32),
                        zeros(n, conv_shape, cd))}
        return out

    def cache_specs(self) -> Dict[str, Any]:
        """Each cache leaf's axis names, in ``init_cache``'s structure:
        ``"kv_ring"`` on a window segment's K/V (modular rows: the
        pageable=False flag), ``"kv_seq"`` on a global one's."""
        out = {}
        for seg in self.segments:
            axis = "kv_ring" if seg.window > 0 else "kv_seq"
            kv = ("layers", "batch", axis, "kv_heads", None)
            out[seg.name] = {"kv": (kv, kv),
                             "ssm": (("layers", "batch", "mlp", None),
                                     ("layers", "batch", None, "mlp"))}
        return out

    def cache_layers(self, cache):
        """Each layer's cache, in ``layers``' order: views of the layer
        axis."""
        for seg in self.segments:
            c = cache[seg.name]
            for i in range(seg.n_layers):
                yield {"kv": tuple(t[i] for t in c["kv"]),
                       "ssm": tuple(t[i] for t in c["ssm"])}

    # ---------------------------------------------------------------- blocks
    def _block(self, p: Params, x: Tensor, window: int, cache=None,
               pos=None) -> Tensor:
        """One layer (the reference's ``_apply_block``): attention and
        the SSM on the same normed input, each output RMS-normed, their
        mean added to the residual, then the MLP."""
        cfg = self.cfg
        a_in = norm_apply(p["ln1"], x, cfg.norm)
        attn_out = attention(p["attn"], self.st, a_in,
                             cache=None if cache is None else cache["kv"],
                             pos=pos, window=window)
        ssm_out = ssm_apply(p["ssm"], cfg, a_in,
                            cache=None if cache is None else cache["ssm"])
        x = x + 0.5 * (norm_apply(p["na"], attn_out, "rmsnorm")
                       + norm_apply(p["ns"], ssm_out, "rmsnorm"))
        m_in = norm_apply(p["ln2"], x, cfg.norm)
        return x + mlp_apply(p["mlp"], m_in, self.compute_dtype,
                             compensated=cfg.kahan_matmul)

    def loss(self, params: Params, batch: Dict[str, Tensor],
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean masked next-token cross-entropy of ``batch`` (``tokens``,
        ``labels`` [B,S], ``loss_mask`` [B,S]) and its metrics
        (``repro/models/hybrid.py:161-175``); each layer recomputed in the
        backward pass (the reference's ``remat``)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"], self.compute_dtype)
        for seg, p in self.layers(params):
            x = checkpoint(self._block, p, x, seg.window,
                           use_reentrant=False, preserve_rng_state=False)
        x = norm_apply(params["final_norm"], x, cfg.norm)
        sum_loss, cnt = chunked_ce_loss(x, lm_head_weight(params, cfg),
                                        batch["labels"], batch["loss_mask"],
                                        cfg)
        ce = sum_loss / torch.clamp_min(cnt, 1.0)
        return ce, {"ce_loss": ce.detach(), "tokens": cnt.detach()}

    # --------------------------------------------------------------- forward
    def _run_blocks(self, params: Params, cache, x: Tensor, pos=None,
                    ) -> Tensor:
        for (seg, p), c in zip(self.layers(params), self.cache_layers(cache)):
            x = self._block(p, x, seg.window, c, pos)
        return norm_apply(params["final_norm"], x, self.cfg.norm)

    def prefill(self, params: Params, tokens: Tensor, cache,
                ) -> Tuple[Tensor, Any]:
        """Whole-prompt prefill of ``tokens`` [B, S] at positions 0..S-1:
        the global layers fill their cache prefix, the window layers their
        rings (the last ``window`` positions), the SSMs their state;
        returns (logits of the last position [B, V_pad], cache)."""
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        x = self._run_blocks(params, cache, x)
        return decode_logits(x[:, -1:, :], params, self.cfg), cache

    def decode_step(self, params: Params, cache, tokens: Tensor,
                    pos: Position) -> Tensor:
        """One position for a batch: ``tokens`` [B] at position ``pos`` (an
        int, or a LongTensor [B] of one a row: each row writes its own
        ring row; the SSM state is row-local) -> logits [B, V_pad]
        float32; the caches advanced in place."""
        x = embed_lookup(params["embed"], tokens[:, None], self.compute_dtype)
        x = self._run_blocks(params, cache, x, pos)
        return decode_logits(x, params, self.cfg)

    def prefill_chunk(self, params: Params, tokens: Tensor, cache,
                      offset: int, nvalid: int) -> Tuple[Tensor, Any]:
        """Resume-from-offset prefill of a batch-1 cache, position by
        position through ``decode_step``: ring writes wrap and the SSM
        state advances exactly as in decode."""
        return prefill_chunk_scan(
            lambda c, tok, pos: self.decode_step(params, c, tok, pos),
            tokens, cache, offset, nvalid)
