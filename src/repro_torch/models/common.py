"""Shared model-assembly pieces of the port (counterpart of
``repro/models/common.py``): chunked scan prefill, the decode and
parallel-chunk logits, the compensated chunked cross-entropy of training
and the embedding/head initialisation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.kahan import kahan_step
from repro_torch.models.layers import dtype_of

Params = Dict[str, Any]
Tensor = torch.Tensor

#: additive logit bias of the padded vocabulary rows (``common.py:325``)
PAD_LOGIT = -1e30


# ---------------------------------------------------------------------------
# Cache axes: request slots and pages
# ---------------------------------------------------------------------------

def _is_node(x) -> bool:
    """A dict or a tuple of caches, as against a leaf: a tensor, an axis
    index, or one leaf's axis names (a tuple that holds a name or None)."""
    if isinstance(x, dict):
        return True
    return isinstance(x, tuple) and not any(
        isinstance(e, str) or e is None for e in x)


def map_cache_leaves(fn, *trees):
    """``fn`` over the leaves of caches shaped like ``init_cache``'s (a
    dict of tuples of leaves, a tuple nesting tuples where a segment
    pairs two layers), keeping that structure."""
    def walk(*nodes):
        if isinstance(nodes[0], dict):
            return {k: walk(*(n[k] for n in nodes)) for k in nodes[0]}
        if _is_node(nodes[0]):
            return tuple(walk(*z) for z in zip(*nodes))
        return fn(*nodes)

    return walk(*trees)


def cache_leaves(tree) -> list:
    """The leaves of a cache-shaped tree, in ``map_cache_leaves``'s
    order."""
    out = []
    map_cache_leaves(out.append, tree)
    return out


def _axis_of(names, name: str) -> int:
    """Index of the axis called ``name`` in one leaf's axis names (an
    entry may be a tuple of names), or -1."""
    for i, n in enumerate(names):
        if n == name or (isinstance(n, tuple) and name in n):
            return i
    return -1


def cache_batch_axes(cache_specs) -> Any:
    """Per-leaf index of the request ("batch") axis, in the cache's
    structure (``repro/models/common.py::cache_batch_axes``): the slot
    axis of every per-slot read, write and reset. A leaf that marks no
    "batch" axis fails here, at engine construction."""
    def one(names) -> int:
        axis = _axis_of(names, "batch")
        if axis < 0:
            raise ValueError(
                f"cache spec {names} does not mark a 'batch' axis; every "
                f"cache leaf must be slot-addressable for request-level "
                f"serving")
        return axis

    return map_cache_leaves(one, cache_specs)


def cache_page_axes(cache, cache_specs, max_len: int) -> Any:
    """Per-leaf index of the PAGEABLE sequence axis, -1 for a leaf that
    stays dense per slot (``repro/models/common.py::cache_page_axes``).

    A leaf is pageable exactly when its spec names a ``"kv_seq"`` axis
    and it allocates the full ``max_len`` positions along it: position
    ``pos`` lives at index ``pos``, so page-granular gather and scatter
    are pure data movement. Everything else keeps its dense slot rows,
    and the axis name is the ``pageable=False`` flag: ring-buffer window
    caches name their length axis ``"kv_ring"`` (modular addressing, a
    page is no contiguous position range), recurrent state and one-shot
    cross-attention K/V name no sequence axis. A ``"kv_seq"`` leaf
    shorter than ``max_len`` (a ring buffer under the wrong name) fails
    here, at engine construction."""
    def one(leaf, names) -> int:
        axis = _axis_of(names, "kv_seq")
        if axis >= 0 and leaf.shape[axis] != max_len:
            raise ValueError(
                f"cache leaf {tuple(leaf.shape)} marks axis {axis} as "
                f"'kv_seq' but allocates {leaf.shape[axis]} != "
                f"max_len={max_len} positions: ring-buffer caches must use "
                f"the 'kv_ring' axis name (the pageable=False spec flag)")
        return axis

    return map_cache_leaves(one, cache, cache_specs)


# ---------------------------------------------------------------------------
# Chunked (resume-from-offset) prefill
# ---------------------------------------------------------------------------

def prefill_chunk_scan(step_fn: Callable, tokens: Tensor, cache: Any,
                       offset: int, nvalid: int) -> Tuple[Tensor, Any]:
    """Advance a batch-1 decode cache by one prompt chunk.

    ``tokens``: [1, w] — the chunk, zero-padded past ``nvalid`` (the
    serving engine's power-of-two tail bucket). Position ``offset + i`` is
    fed to ``step_fn(cache, token [1], pos) -> logits [1, v_pad]`` one at
    a time — the model's own decode step, so every prompt position runs
    the identical computation whatever chunk width carries it (the
    reference's ``lax.scan`` over ``prefill_chunk_body``). The reference
    computes the padded steps and discards them by an exact select; an
    eager loop simply stops at ``nvalid``. Returns (logits of the last
    valid position [1, v_pad], the cache advanced in place).
    """
    if not 1 <= nvalid <= tokens.shape[-1]:
        raise ValueError(f"nvalid={nvalid} outside [1, {tokens.shape[-1]}]")
    logits = None
    for i in range(nvalid):
        logits = step_fn(cache, tokens[:, i], offset + i)
    return logits, cache


# ---------------------------------------------------------------------------
# Compensated chunked cross-entropy
# ---------------------------------------------------------------------------

def chunked_ce_loss(x: Tensor, head_w: Tensor, labels: Tensor, mask: Tensor,
                    cfg: ArchConfig) -> Tuple[Tensor, Tensor]:
    """Cross-entropy chunked over the sequence
    (``repro/models/common.py:242-305``): x [B,S,D] final hidden states,
    head_w [D, V_pad], labels [B,S] int, mask [B,S] {0,1}. Returns
    float32 (sum_loss, sum_count); the caller divides.

    Each chunk's float32 logits [B, chunk, V_pad] exist only inside a
    ``torch.utils.checkpoint`` region, recomputed in the backward pass
    (the reference's ``jax.checkpoint``). The logits are the product of
    the compute-dtype operands summed in float32 (the reference's
    ``preferred_element_type``), padded vocabulary rows at -1e30. Chunk
    partial losses fold by ``kahan_step`` when ``cfg.kahan_loss``."""
    b, s, d = x.shape
    chunk = min(cfg.loss_chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    bias = vocab_bias(cfg, x.device)

    def chunk_loss(xc, lc, mc):
        logits = torch.matmul(xc.float(), head_w.to(xc.dtype).float()) + bias
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        mcf = mc.float()
        return torch.sum((lse - gold) * mcf), torch.sum(mcf)

    s_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    c_acc = torch.zeros_like(s_acc)
    cnt = torch.zeros_like(s_acc)
    for i in range(0, x.shape[1], chunk):
        part, n = checkpoint(chunk_loss, x[:, i:i + chunk],
                             labels[:, i:i + chunk], mask[:, i:i + chunk],
                             use_reentrant=False, preserve_rng_state=False)
        if cfg.kahan_loss:
            s_acc, c_acc = kahan_step(s_acc, c_acc, part)
        else:
            s_acc = s_acc + part
        cnt = cnt + n
    return s_acc + c_acc, cnt


# ---------------------------------------------------------------------------
# Embedding / head helpers
# ---------------------------------------------------------------------------

def parallel_chunk_logits(x: Tensor, params: Params, cfg: ArchConfig,
                          nvalid: int) -> Tensor:
    """Logits of the last VALID position of a parallel prefill chunk
    (``repro/models/common.py:204-220``): ``x`` [1, w, D] final hidden
    states, ``nvalid`` >= 1 real positions; only that one row pays the
    vocabulary projection. Returns [1, V_pad]."""
    idx = min(max(nvalid - 1, 0), x.shape[1] - 1)
    return decode_logits(x[:, idx:idx + 1, :], params, cfg)


def lm_head_weight(params: Params, cfg: ArchConfig) -> Tensor:
    """[D, V_padded] head weight (transposed embed table when tied)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["head"]["w"]


def vocab_bias(cfg: ArchConfig, device) -> Tensor:
    """[V_padded] float32: 0 on the real vocabulary, -1e30 on padding."""
    ids = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(ids < cfg.vocab_size, 0.0, PAD_LOGIT).to(torch.float32)


def decode_logits(x_last: Tensor, params: Params, cfg: ArchConfig,
                  ) -> Tensor:
    """Logits for a single-position hidden state [B,1,D] -> [B,V_padded]
    float32: the product of the compute-dtype operands accumulated in
    float32, as ``preferred_element_type=float32`` does in the reference;
    padded vocabulary rows get -1e30."""
    w = lm_head_weight(params, cfg)
    logits = torch.matmul(x_last[:, 0, :].float(), w.float())
    return logits + vocab_bias(cfg, logits.device)


def embed_and_head_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """Shapes and init scales of the embedding / final norm / head."""
    out: Dict[str, Any] = {"embed": {"table": ((cfg.padded_vocab, cfg.d_model),
                                              0.02)}}
    out["final_norm"] = norm_shapes(cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        out["head"] = {"w": ((cfg.d_model, cfg.padded_vocab), 0.02)}
    return out


def norm_shapes(d: int, kind: str) -> Dict[str, Any]:
    """Norm parameters as (shape, init): "ones" / "zeros" for the affine
    terms; layernorm_np has none."""
    if kind == "rmsnorm":
        return {"scale": ((d,), "ones")}
    if kind == "layernorm":
        return {"scale": ((d,), "ones"), "bias": ((d,), "zeros")}
    if kind == "layernorm_np":
        return {}
    raise ValueError(kind)


def leaf_dtype(leaf, cfg: ArchConfig) -> torch.dtype:
    """The dtype of a (shape, init[, dtype]) leaf: its own where it names
    one (the MoE router's float32), else ``cfg.param_dtype``."""
    return dtype_of(leaf[2] if len(leaf) > 2 else cfg.param_dtype)


def init_params(spec: Dict[str, Any], cfg: ArchConfig,
                generator: torch.Generator, device) -> Params:
    """Materialize a nested dict of (shape, init[, dtype]) leaves: a float
    scale draws ``scale * N(0, 1)`` in float32 from ``generator`` (in the
    dict's order), scaled in place, "ones"/"zeros" are constants, a
    callable ``init(shape)`` returns the float32 values (the SSM's fixed
    ``A_log`` and ``dt_proj`` bias); then cast to the leaf's dtype
    (``leaf_dtype``). The largest leaf costs its float32 draw and its
    cast at once, no second float32 copy."""
    def one(leaf):
        shape, init = leaf[:2]
        dt = leaf_dtype(leaf, cfg)
        if callable(init):
            return init(shape).to(device=device, dtype=dt)
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(init).to(dt)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return one(node)

    return walk(spec)


def stack_spec(node, n: int):
    """A spec tree of (shape, init[, dtype]) leaves with a leading layer
    axis of ``n`` on every shape: a stacked segment's parameters."""
    if isinstance(node, dict):
        return {k: stack_spec(v, n) for k, v in node.items()}
    return ((n, *node[0]), *node[1:])


def unbind_layers(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, as a list of trees
    of views."""
    if isinstance(tree, dict):
        per_key = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def init_embed_and_head(generator: torch.Generator, cfg: ArchConfig,
                        device) -> Params:
    """Embedding table, final norm and (untied) head, drawn from
    ``generator``."""
    return init_params(embed_and_head_spec(cfg), cfg, generator, device)
