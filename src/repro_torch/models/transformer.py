"""Decoder-only transformer LMs: dense, VLM splice and MoE, in PyTorch
(counterpart of ``repro/models/transformer.py``).

The model is assembled from SEGMENTS (``plan_segments``), as in the
reference: a dense config has one stacked ``blocks`` segment; a MoE
config a ``dense_prefix`` of its leading dense layer (unstacked), then
``moe_blocks`` (stacked MoE layers) or ``super_blocks`` (stacked pairs
``{"a": dense, "b": moe}``, llama4's interleave). Parameters keep the
reference's tree: ``embed``, ``final_norm`` and one entry a segment whose
stacked leaves carry a leading layer axis (q/k/v carry a ``b`` leaf too
under ``qkv_bias``; MLA's leaves are ``layers.mla_spec``'s; the MoE
router is float32). The KV cache is one entry a segment, ``(k, v)`` with
k/v ``[L, B, S, KV, dh]`` in the compute dtype (MLA: the latent ``[L, B,
S, r]`` and the rope key ``[L, B, S, dr]``), a superblock's a pair of
those; unlike the reference, the unstacked ``dense_prefix`` caches under
a layer axis of 1 too, so every leaf's request axis is 1. ``cache_specs``
names each leaf's axes as the reference's logical specs do (request axis
"batch", the position-addressed history "kv_seq"). Where the reference
scans over layers, the port loops.

    init(generator)                               -> params
    loss(params, batch)                           -> (loss, metrics)
    init_cache(batch_size, max_len)               -> cache
    cache_specs()                                 -> axis names per leaf
    prefill(params, tokens, cache[, vision_embeds])
                                                  -> (logits [B, V_pad], cache)
    decode_step(params, cache, tokens, pos)       -> logits [B, V_pad]
    prefill_chunk(params, tokens, cache, offset, nvalid[, vision_embeds])
                                                  -> (logits [1, V_pad], cache)
    prefill_chunk_parallel(params, tokens, cache, offset, nvalid
                           [, vision_embeds])     -> (logits [1, V_pad], cache)

A VLM config (``cfg.vision``) splices ``vision_embeds`` ``[B, n_patches,
D]`` (cast to the compute dtype) over the token embeddings of positions
``p < n_patches``, at the reference's three sites: the whole sequence in
``loss`` / ``prefill`` (its ``_embed``), position by position in the scan
chunk and at the chunk's positions in the parallel one
(``repro/models/transformer.py:228-238, 336-400``). Without
``vision_embeds`` the tokens are embedded as they are, as in the
reference.

``loss`` is the training forward: every block recomputed in the backward
pass (the reference's ``remat=True``), attention unchunked through the
materialized core, the compensated chunked cross-entropy, and for a MoE
config the router's load-balance loss averaged over the MoE layers. The
serving steps write the cache in place. ``prefill_chunk`` is the
per-position scan (the oracle); ``prefill_chunk_parallel`` runs the whole
chunk in ONE forward pass, its attention through the chunk flash kernel
when ``kahan_attention``. A ``sliding_window`` masks attention by the
window in every mode while the caches stay full-length (no ring: the
hybrid family's rings are ``models/hybrid.py``'s), and such a config
keeps the per-position scan.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe as moe_lib

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
    attn_spec,
    attention,
    dtype_of,
    embed_lookup,
    mla_attention,
    mla_spec,
    mlp_apply,
    mlp_spec,
    norm_apply,
    rope_freqs,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of layers of one kind: "dense", "moe" or "super" (a
    dense+MoE pair counted as one layer); ``scan`` False for the
    unstacked ``dense_prefix``."""

    name: str
    kind: str
    n_layers: int
    scan: bool = True


def plan_segments(cfg: ArchConfig) -> List[Segment]:
    """The reference's segments (``repro/models/transformer.py:61-78``)."""
    if cfg.moe is None:
        return [Segment("blocks", "dense", cfg.n_layers)]
    mo = cfg.moe
    segs: List[Segment] = []
    if mo.first_k_dense:
        segs.append(Segment("dense_prefix", "dense", mo.first_k_dense,
                            scan=False))
    remaining = cfg.n_layers - mo.first_k_dense
    if mo.interleave == 1:
        segs.append(Segment("moe_blocks", "moe", remaining))
    elif mo.interleave == 2:
        if remaining % 2:
            raise ValueError(f"{cfg.name}: {remaining} layers after the "
                             f"dense prefix do not pair into superblocks")
        segs.append(Segment("super_blocks", "super", remaining // 2))
    else:
        raise NotImplementedError(f"interleave={mo.interleave}")
    return segs


class TransformerLM:
    """Dense / MoE / VLM decoder-only LM on one device."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.st = AttnStatic(
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_freqs(cfg.head_dim, cfg.rope_theta, self.device),
            self.compute_dtype, kahan_attention=cfg.kahan_attention,
            kahan_matmul=cfg.kahan_matmul)
        self.segments = plan_segments(cfg)
        #: MoE layers (a superblock holds one)
        self.moe_layers = sum(seg.n_layers for seg in self.segments
                              if seg.kind in ("moe", "super"))
        #: MLA's rope runs over its decoupled rope dims only
        self.mla_freqs = (None if cfg.mla is None else rope_freqs(
            cfg.mla.qk_rope_dim, cfg.rope_theta, self.device))
        # one forward pass over a chunk is position-independent only
        # without MLA, MoE capacity routing or sliding-window ring caches
        # (``repro/models/transformer.py:91-99``); other configs keep the
        # per-position scan
        self.parallel_prefill_ok = (cfg.mla is None and cfg.moe is None
                                    and cfg.sliding_window <= 0)

    # ------------------------------------------------------------------ init
    def block_spec(self, kind: str) -> Dict[str, Any]:
        """(shape, init) of one block's parameters, without the layer
        axis; init scales as the reference's ``attn_init`` / ``mla_init``
        / ``mlp_init`` / ``moe_init``. ``kind`` "super" pairs a dense and
        a MoE block as ``{"a", "b"}``."""
        cfg = self.cfg
        if kind == "super":
            return {"a": self.block_spec("dense"),
                    "b": self.block_spec("moe")}
        d = cfg.d_model
        attn = mla_spec(cfg) if cfg.mla is not None else attn_spec(cfg)
        return {
            "ln1": norm_shapes(d, cfg.norm),
            "attn": attn,
            "ln2": norm_shapes(d, cfg.norm),
            "ffn": (moe_lib.moe_spec(cfg) if kind == "moe"
                    else mlp_spec(cfg, cfg.d_ff)),
        }

    def segment_spec(self) -> Dict[str, Any]:
        """(shape, init) of every segment's parameters, a stacked
        segment's with its leading layer axis."""
        return {seg.name: (stack_spec(self.block_spec(seg.kind),
                                      seg.n_layers)
                           if seg.scan else self.block_spec(seg.kind))
                for seg in self.segments}

    def param_spec(self) -> Dict[str, Any]:
        """(shape, init) of every parameter, the segments included."""
        spec = embed_and_head_spec(self.cfg)
        spec.update(self.segment_spec())
        return spec

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator`` (which must live on
        the model's device). Not the reference's numbers: weights that must
        match the JAX package come through ``repro_torch.bridge``."""
        params = init_embed_and_head(generator, self.cfg, self.device)
        params.update(init_params(self.segment_spec(), self.cfg, generator,
                                  self.device))
        return params

    def layers(self, params: Params):
        """(segment, one layer's parameter tree) for every layer in order,
        a superblock as one layer; views of the stacked leaves."""
        for seg in self.segments:
            if seg.scan:
                for p in unbind_layers(params[seg.name], seg.n_layers):
                    yield seg, p
            else:
                yield seg, params[seg.name]

    # ----------------------------------------------------------------- cache
    def _cache_shapes(self, batch_size: int, max_len: int):
        """One layer's cache leaves as shapes (the reference's
        ``_cache_one``): MLA's latent and rope key, else k and v."""
        cfg = self.cfg
        if cfg.mla is not None:
            m = cfg.mla
            return ((batch_size, max_len, m.kv_lora_rank),
                    (batch_size, max_len, m.qk_rope_dim))
        kv = (batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        return kv, kv

    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Zero caches, one entry a segment (a superblock's a pair)."""
        def one(n):
            return tuple(torch.zeros((n, *shape), dtype=self.compute_dtype,
                                     device=self.device)
                         for shape in self._cache_shapes(batch_size,
                                                         max_len))

        out = {}
        for seg in self.segments:
            n = seg.n_layers if seg.scan else 1
            out[seg.name] = (one(n), one(n)) if seg.kind == "super" else one(n)
        return out

    def cache_specs(self) -> Dict[str, Any]:
        """The axis names of every cache leaf, in ``init_cache``'s
        structure: the reference's logical specs (``_cache_one`` under the
        layer axis). ``"batch"`` marks the request axis, ``"kv_seq"`` the
        position-addressed history the paged layout may re-home into
        pages (``models.common.cache_page_axes``): MLA's latent leaves
        page as K/V do."""
        if self.cfg.mla is not None:
            leaf = ("layers", "batch", "kv_seq", None)
        else:
            leaf = ("layers", "batch", "kv_seq", "kv_heads", None)
        out = {}
        for seg in self.segments:
            pair = (leaf, leaf)
            out[seg.name] = (pair, pair) if seg.kind == "super" else pair
        return out

    def cache_layers(self, cache):
        """Each layer's cache, in ``layers``' order: views of the layer
        axis, a superblock's a pair."""
        for seg in self.segments:
            c = cache[seg.name]
            n = seg.n_layers if seg.scan else 1
            for i in range(n):
                if seg.kind == "super":
                    yield tuple(tuple(t[i] for t in half) for half in c)
                else:
                    yield tuple(t[i] for t in c)

    # ------------------------------------------------------------------ loss
    def _block(self, kind: str, p: Params, x: Tensor, cache=None,
               pos=None, chunk_valid=None):
        """One layer (the reference's ``_apply_block``): (x, aux_loss,
        dropped_frac), the last two 0.0 for a dense layer; a
        "super" layer runs its dense and its MoE half in turn, each on
        its half of ``cache``."""
        if kind == "super":
            ca, cb = cache if cache is not None else (None, None)
            x, aux_a, drop_a = self._block("dense", p["a"], x, ca, pos,
                                           chunk_valid)
            x, aux_b, drop_b = self._block("moe", p["b"], x, cb, pos,
                                           chunk_valid)
            return x, aux_a + aux_b, drop_a + drop_b
        cfg = self.cfg
        a_in = norm_apply(p["ln1"], x, cfg.norm)
        if cfg.mla is not None:
            x = x + mla_attention(p["attn"], cfg, self.mla_freqs, a_in,
                                  cache=cache, pos=pos)
        else:
            x = x + attention(p["attn"], self.st, a_in, cache=cache, pos=pos,
                              chunk_valid=chunk_valid,
                              window=cfg.sliding_window)
        m_in = norm_apply(p["ln2"], x, cfg.norm)
        if kind == "moe":
            y, met = moe_lib.moe_apply(p["ffn"], cfg, m_in)
            return x + y, met["aux_loss"], met["dropped_frac"]
        return (x + mlp_apply(p["ffn"], m_in, self.compute_dtype,
                              compensated=cfg.kahan_matmul), 0.0, 0.0)

    def loss(self, params: Params, batch: Dict[str, Tensor],
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean masked next-token cross-entropy of ``batch`` (``tokens``,
        ``labels`` [B,S] int, ``loss_mask`` [B,S]) and its metrics
        (``repro/models/transformer.py:240-261``): ``ce_loss``,
        ``tokens``, and ``aux_loss`` / ``dropped_frac`` summed over the
        layers (0 for a dense model). A MoE config adds
        ``router_aux_coef`` times the mean aux loss of its MoE layers to
        the loss. Each layer runs under ``torch.utils.checkpoint`` and is
        recomputed in the backward pass, as the reference's ``remat``."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch.get("vision_embeds"))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        drop = torch.zeros_like(aux)
        # one view per layer: the stacked leaves' gradient is ONE stack of
        # the layers' (unbind's backward), not a full-size sum per layer
        for seg, p in self.layers(params):
            x, a, d = checkpoint(self._block, seg.kind, p, x,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
            if seg.kind != "dense":
                aux, drop = aux + a, drop + d
        x = norm_apply(params["final_norm"], x, cfg.norm)
        sum_loss, cnt = chunked_ce_loss(x, lm_head_weight(params, cfg),
                                        batch["labels"], batch["loss_mask"],
                                        cfg)
        ce = sum_loss / torch.clamp_min(cnt, 1.0)
        loss = ce
        if self.moe_layers:
            loss = loss + cfg.moe.router_aux_coef * aux / self.moe_layers
        metrics = {"ce_loss": ce.detach(), "aux_loss": aux.detach(),
                   "dropped_frac": drop.detach(), "tokens": cnt.detach()}
        return loss, metrics

    # --------------------------------------------------------------- forward
    def _embed(self, params: Params, tokens: Tensor,
               vision_embeds=None) -> Tensor:
        """Token embeddings [B, S, D] in the compute dtype, the first
        ``n_patches`` positions replaced by ``vision_embeds`` when the
        config has a vision stub and they are given (the reference's
        ``_embed``)."""
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        if vision_embeds is None:
            return x
        npch = self._n_patches(vision_embeds)
        vis = vision_embeds.to(self.compute_dtype)
        return torch.cat([vis, x[:, npch:, :]], dim=1)

    def _n_patches(self, vision_embeds: Tensor) -> int:
        """The config's patch count, checked against ``vision_embeds``:
        only a VLM config takes them, at its own patch count."""
        vision = self.cfg.vision
        if vision is None:
            raise ValueError(f"{self.cfg.name}: vision_embeds given to a "
                             f"config without a vision stub")
        if vision_embeds.shape[-2:] != (vision.n_patches, self.cfg.d_model):
            raise ValueError(
                f"{self.cfg.name}: vision_embeds of shape "
                f"{tuple(vision_embeds.shape)}, want [B, {vision.n_patches}, "
                f"{self.cfg.d_model}]")
        return vision.n_patches

    def _run_blocks(self, params: Params, cache, x: Tensor, *, pos=None,
                    chunk_valid=None) -> Tensor:
        """The layer loop over [B,S,D] hidden states; ``pos`` /
        ``chunk_valid`` select the attention mode (``layers.attention``).
        Returns the final-normed hidden states."""
        for (seg, p), c in zip(self.layers(params), self.cache_layers(cache)):
            x, _, _ = self._block(seg.kind, p, x, c, pos, chunk_valid)
        return norm_apply(params["final_norm"], x, self.cfg.norm)

    def prefill(self, params: Params, tokens: Tensor, cache,
                vision_embeds=None) -> Tuple[Tensor, Any]:
        """Whole-prompt prefill: ``tokens`` [B, S] at positions 0..S-1 fill
        the cache prefix (``cache`` from ``init_cache(B, max_len >= S)``);
        returns (logits of the last position [B, V_pad], cache). With
        ``kahan_attention`` every layer's attention is one flash launch."""
        x = self._embed(params, tokens, vision_embeds)
        x = self._run_blocks(params, cache, x)
        return decode_logits(x[:, -1:, :], params, self.cfg), cache

    def decode_step(self, params: Params, cache, tokens: Tensor,
                    pos: Position) -> Tensor:
        """One position for a batch: ``tokens`` [B] at absolute position
        ``pos`` (an int, or a LongTensor [B] of one a row: the vmapped
        slot loop) -> logits [B, V_pad] float32; K/V written into
        ``cache``."""
        x = embed_lookup(params["embed"], tokens[:, None], self.compute_dtype)
        return self._decode_x(params, cache, x, pos)

    def _decode_x(self, params: Params, cache, x: Tensor, pos: Position,
                  ) -> Tensor:
        """One position from an already-embedded [B, 1, D] input (shared
        by ``decode_step`` and the scan chunk, which embeds per position
        so that it can splice patch embeddings)."""
        x = self._run_blocks(params, cache, x, pos=pos)
        return decode_logits(x, params, self.cfg)

    def prefill_chunk(self, params: Params, tokens: Tensor, cache,
                      offset: int, nvalid: int, vision_embeds=None,
                      ) -> Tuple[Tensor, Any]:
        """Resume-from-offset prefill of a batch-1 cache: ``tokens`` [1, w]
        at positions ``offset + i``, the first ``nvalid`` real; position
        ``p < n_patches`` takes patch ``p`` of ``vision_embeds`` [1,
        n_patches, D] in place of its token."""
        cd = self.compute_dtype
        npch = 0
        if vision_embeds is not None:
            npch = self._n_patches(vision_embeds)
            vis = vision_embeds.to(cd)

        def step(c, tok, pos):
            if pos < npch:
                x = vis[:, pos:pos + 1, :]
            else:
                x = embed_lookup(params["embed"], tok[:, None], cd)
            return self._decode_x(params, c, x, pos)

        return prefill_chunk_scan(step, tokens, cache, offset, nvalid)

    def prefill_chunk_parallel(self, params: Params, tokens: Tensor, cache,
                               offset: int, nvalid: int, vision_embeds=None,
                               ) -> Tuple[Tensor, Any]:
        """Multi-token chunk prefill: ONE forward pass over the chunk
        ``tokens`` [1, w] at positions ``offset + i`` (same contract as
        ``prefill_chunk``; ``repro/models/transformer.py:362-401``). Only
        the first ``nvalid`` positions write the cache, and the logits come
        from the last valid one. Positions below ``n_patches`` take their
        patch of ``vision_embeds`` (an exact gather and select, as in the
        reference). A width-1 chunk runs the decode mode, as in the
        reference; configs without ``parallel_prefill_ok`` take the
        per-position scan."""
        if not self.parallel_prefill_ok:
            return self.prefill_chunk(params, tokens, cache, offset, nvalid,
                                      vision_embeds)
        if not 1 <= nvalid <= tokens.shape[-1]:
            raise ValueError(
                f"nvalid={nvalid} outside [1, {tokens.shape[-1]}]")
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        if vision_embeds is not None:
            npch = self._n_patches(vision_embeds)
            pos = offset + torch.arange(tokens.shape[-1], device=x.device)
            v = vision_embeds.to(self.compute_dtype)[
                :, torch.clamp(pos, 0, npch - 1), :]
            x = torch.where((pos < npch)[None, :, None], v, x)
        x = self._run_blocks(params, cache, x, pos=offset,
                             chunk_valid=nvalid)
        return parallel_chunk_logits(x, params, self.cfg, nvalid), cache

