"""xLSTM LM: groups of (``slstm_every`` - 1) mLSTM blocks and one sLSTM
block, in PyTorch (counterpart of ``repro/models/xlstm_lm.py``).

48 blocks at 7:1 are 6 groups. Parameters keep the reference's tree:
``groups`` holds ``mlstm`` leaves stacked ``[G, M, ...]`` and ``slstm``
leaves stacked ``[G, ...]``, so ``repro_torch.bridge`` carries the
reference's parameters unchanged. A residual wraps every block (the
blocks are pre-norm inside).

The cache is recurrent state only, O(1) in the sequence (``max_len`` is
ignored): ``{"mlstm": (C, n, m, conv_buf), "slstm": (c, n, m, h)}``.
Unlike the reference's ``[G, M, B, ...]`` the mLSTM leaves are stacked
``[G·M, B, ...]`` (block ``j`` of group ``g`` at ``g·M + j``) and the
sLSTM's ``[G, B, ...]``, so that every leaf keeps the port's convention
of one leading layer axis with the request axis at 1
(``serve/slots.py``). Every ``m`` starts at -1e30; a slot evicted by the
engine is reset to this initial row, not to zeros. No leaf names a
``"kv_seq"`` axis: nothing pages, so the engine serves ``kv_layout=
"paged"`` on the dense layout and refuses the prefix cache.

There is no parallel chunk prefill (``parallel_prefill_ok`` False): the
recurrence folds the previous state position by position, so the engine
resolves ``prefill_mode="flash"`` to the scan body, whose per-position
step IS ``decode_step``. ``prefill`` runs the whole prompt at once: the
mLSTM's chunkwise form (``cfg.xlstm.chunk``), the sLSTM's loop.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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
    prefill_chunk_scan,
    stack_spec,
    unbind_layers,
)
from repro_torch.models.layers import (
    Position,
    dtype_of,
    embed_lookup,
    norm_apply,
)
from repro_torch.models.xlstm import (
    NEG,
    mlstm_apply,
    mlstm_cache_shapes,
    mlstm_spec,
    slstm_apply,
    slstm_cache_shapes,
    slstm_spec,
)

Tensor = torch.Tensor


class XLSTMLM:
    """The xLSTM LM on one device; the serving and training API of
    ``TransformerLM`` without the parallel chunk."""

    #: the recurrence runs the per-position scan
    parallel_prefill_ok = False

    def __init__(self, cfg: ArchConfig, device: torch.device):
        xl = cfg.xlstm
        if cfg.n_layers % xl.slstm_every:
            raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                             f"multiple of slstm_every={xl.slstm_every}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.n_groups = cfg.n_layers // xl.slstm_every
        self.m_per_group = xl.slstm_every - 1

    # ------------------------------------------------------------------ init
    def group_spec(self) -> Dict[str, Any]:
        """The stacked ``groups`` subtree: mLSTM leaves ``[G, M, ...]``,
        sLSTM leaves ``[G, ...]``."""
        cfg, g = self.cfg, self.n_groups
        return {"mlstm": stack_spec(stack_spec(mlstm_spec(cfg),
                                               self.m_per_group), g),
                "slstm": stack_spec(slstm_spec(cfg), g)}

    def param_spec(self) -> Dict[str, Any]:
        """(shape, init) of every parameter."""
        spec = embed_and_head_spec(self.cfg)
        spec["groups"] = self.group_spec()
        return spec

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator`` (on the model's
        device); weights that must match the JAX package come through
        ``repro_torch.bridge``."""
        params = init_embed_and_head(generator, self.cfg, self.device)
        params["groups"] = init_params(self.group_spec(), self.cfg,
                                       generator, self.device)
        return params

    def blocks(self, params: Params):
        """("mlstm" or "slstm", the block's parameters, its cache index)
        for every block in order: each group's M mLSTM blocks, then its
        sLSTM block."""
        groups = params["groups"]
        mls = unbind_layers(groups["mlstm"], self.n_groups)
        sls = unbind_layers(groups["slstm"], self.n_groups)
        for g in range(self.n_groups):
            for j, p in enumerate(unbind_layers(mls[g], self.m_per_group)):
                yield "mlstm", p, g * self.m_per_group + j
            yield "slstm", sls[g], g

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """Fresh recurrent state (``repro/models/xlstm_lm.py:110-144``):
        zeros but every ``m`` at -1e30; ``max_len`` is ignored."""
        del max_len
        cfg, dev = self.cfg, self.device
        n_m = self.n_groups * self.m_per_group
        c, n, m, conv = mlstm_cache_shapes(cfg, batch_size)
        f32 = torch.float32
        mlstm = (torch.zeros((n_m, *c), dtype=f32, device=dev),
                 torch.zeros((n_m, *n), dtype=f32, device=dev),
                 torch.full((n_m, *m), NEG, dtype=f32, device=dev),
                 torch.zeros((n_m, *conv), dtype=self.compute_dtype,
                             device=dev))
        s = (self.n_groups, *slstm_cache_shapes(cfg, batch_size)[0])
        slstm = (torch.zeros(s, dtype=f32, device=dev),
                 torch.zeros(s, dtype=f32, device=dev),
                 torch.full(s, NEG, dtype=f32, device=dev),
                 torch.zeros(s, dtype=f32, device=dev))
        return {"mlstm": mlstm, "slstm": slstm}

    def cache_specs(self) -> Dict[str, Any]:
        """Each cache leaf's axis names: the request axis "batch" behind
        the layer axis; no sequence axis (nothing pages)."""
        return {"mlstm": (("layers", "batch", None, None, "xl_inner"),
                          ("layers", "batch", None, None),
                          ("layers", "batch", None),
                          ("layers", "batch", None, "xl_inner")),
                "slstm": (("layers", "batch", None),) * 4}

    # --------------------------------------------------------------- forward
    def _block(self, kind: str, p: Params, x: Tensor, cache=None) -> Tensor:
        apply = mlstm_apply if kind == "mlstm" else slstm_apply
        return x + apply(p, self.cfg, x, cache=cache)

    def _run(self, params: Params, x: Tensor, cache) -> Tensor:
        """Every block over [B,S,D] hidden states, each state advanced in
        place; returns the final-normed hidden states."""
        for kind, p, i in self.blocks(params):
            x = self._block(kind, p, x, tuple(t[i] for t in cache[kind]))
        return norm_apply(params["final_norm"], x, self.cfg.norm)

    def loss(self, params: Params, batch: Dict[str, Tensor],
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Mean masked next-token cross-entropy of ``batch`` and its
        metrics (``repro/models/xlstm_lm.py:94-108``); each block
        recomputed in the backward pass (the reference's ``remat``)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"], self.compute_dtype)
        for kind, p, _ in self.blocks(params):
            x = checkpoint(self._block, kind, p, x, use_reentrant=False,
                           preserve_rng_state=False)
        x = norm_apply(params["final_norm"], x, cfg.norm)
        sum_loss, cnt = chunked_ce_loss(x, lm_head_weight(params, cfg),
                                        batch["labels"], batch["loss_mask"],
                                        cfg)
        ce = sum_loss / torch.clamp_min(cnt, 1.0)
        return ce, {"ce_loss": ce.detach(), "tokens": cnt.detach()}

    def prefill(self, params: Params, tokens: Tensor, cache,
                ) -> Tuple[Tensor, Any]:
        """Whole-prompt prefill of ``tokens`` [B, S] from the state in
        ``cache`` (fresh from ``init_cache``): the mLSTMs chunkwise, the
        sLSTMs position by position; returns (logits of the last
        position [B, V_pad], the advanced cache)."""
        x = embed_lookup(params["embed"], tokens, self.compute_dtype)
        x = self._run(params, x, cache)
        return decode_logits(x[:, -1:, :], params, self.cfg), cache

    def decode_step(self, params: Params, cache, tokens: Tensor,
                    pos: Position) -> Tensor:
        """One position for a batch: ``tokens`` [B] -> logits [B, V_pad]
        float32, the state advanced in place (``pos`` is unused: the
        state is positionless)."""
        del pos
        x = embed_lookup(params["embed"], tokens[:, None], self.compute_dtype)
        return decode_logits(self._run(params, x, cache), params, self.cfg)

    def prefill_chunk(self, params: Params, tokens: Tensor, cache,
                      offset: int, nvalid: int) -> Tuple[Tensor, Any]:
        """Resume-from-offset prefill of a batch-1 cache, position by
        position through ``decode_step`` (the offset is implicit in the
        state)."""
        return prefill_chunk_scan(
            lambda c, tok, pos: self.decode_step(params, c, tok, pos),
            tokens, cache, offset, nvalid)
