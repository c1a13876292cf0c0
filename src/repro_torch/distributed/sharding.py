"""Logical-axis sharding rules on ``DeviceMesh`` / ``DTensor``
(counterpart of ``repro/distributed/sharding.py``).

Models name each parameter's and cache leaf's dimensions with LOGICAL
axes ("embed", "heads", "mlp", ...): a spec is a tuple with one entry a
dimension, a name or None. A rule table maps each logical name to mesh
axes, with the reference's shape-aware degradation: a mapping is dropped
when its mesh axes are absent, of size one, already used by an earlier
dimension, or do not divide the dimension (batch 1 on long_500k,
kv_heads 5 on a 16-way axis), so the dimension is replicated instead of
an error.

``physical_spec`` gives the reference's answer dim for dim (a tuple,
trailing Nones dropped, a multi-axis entry as a tuple of mesh axis
names). ``placements`` turns it into DTensor placements: ``Shard(d)`` on
every mesh dimension that tensor dimension ``d`` maps to (``("pod",
"data")`` shards one dimension over two mesh dimensions, pod-major as
``jax.sharding`` does), ``Replicate()`` on the rest.

TRAIN_RULES: batch over (pod, data); FSDP over data for the "embed"
weight dimension; heads / mlp / vocab / expert over model;
sequence-parallel activations ("seq" over model). SERVE_RULES: batch
over (pod, data); the KV cache's SEQUENCE over model (flash-decoding
style); weights over model plus "embed" over data.

``constrain(x, *logical)`` is the reference's
``with_sharding_constraint``: inside ``activation_rules(mesh, rules)`` it
redistributes a DTensor to the spec's placements; outside, or on a plain
tensor, it returns ``x`` itself. Importing this module touches no process
group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

AxisMap = Union[None, str, Tuple[str, ...]]
#: a logical or physical spec: one entry a tensor dimension
Spec = Tuple[AxisMap, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    name: str
    table: Dict[str, AxisMap]

    def lookup(self, logical: Optional[str]) -> AxisMap:
        if logical is None:
            return None
        return self.table.get(logical)


TRAIN_RULES = Rules("train", {
    "batch": ("pod", "data"),
    "seq": "model",            # sequence-parallel activations
    "embed": "data",           # FSDP / ZeRO-3 weight dim
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "moe_group": ("pod", "data"),
    "kv_lora": None,
    "xl_inner": "model",
    "kv_seq": None,
    "kv_ring": None,
    "frames": None,
})

# no-SP variant: sequence-local architectures (xLSTM's chunked recurrence)
# lose the seq sharding at every chunk reshape anyway
TRAIN_NOSP_RULES = Rules("train_nosp",
                         {**TRAIN_RULES.table, "seq": None})

SERVE_RULES = Rules("serve", {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",
    "heads": "model",
    "kv_heads": None,          # decode shards the cache by SEQUENCE instead
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "moe_group": ("pod", "data"),
    "kv_lora": None,
    "xl_inner": "model",
    "kv_seq": "model",         # flash-decoding: shard KV positions
    "kv_ring": "model",        # ring windows shard like KV positions
    "frames": None,
})

RULES = {r.name: r for r in (TRAIN_RULES, TRAIN_NOSP_RULES, SERVE_RULES)}


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size. A ``DeviceMesh`` names its axes in
    ``mesh_dim_names`` (its ``shape`` is a plain tuple); anything else
    duck-types the reference's ``mesh.shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axes(axes: AxisMap) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def physical_spec(mesh, rules: Rules, logical: Spec,
                  shape: Tuple[int, ...]) -> Spec:
    """The mesh axes of each dimension of a ``shape`` tensor whose logical
    spec is ``logical``, dropping absent, size-one, reused or
    non-dividing mappings; trailing Nones dropped
    (``repro/distributed/sharding.py::physical_spec``)."""
    sizes = mesh_axes(mesh)
    out = []
    used: set = set()
    for dim, name in enumerate(logical):
        kept = tuple(a for a in _axes(rules.lookup(name)) if a in sizes)
        size = 1
        for a in kept:
            size *= sizes[a]
        if (not kept or size <= 1 or dim >= len(shape)
                or shape[dim] % size != 0 or any(a in used for a in kept)):
            out.append(None)
        else:
            out.append(kept if len(kept) > 1 else kept[0])
            used.update(kept)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of a physical spec on ``mesh``: ``Shard(d)`` on
    each mesh dimension that tensor dimension ``d`` maps to,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {a: d for d, entry in enumerate(spec) for a in _axes(entry)}
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh.mesh_dim_names)


def spec_placements(mesh, rules: Rules, logical: Spec,
                    shape: Tuple[int, ...]) -> tuple:
    """``placements`` of ``physical_spec``."""
    return placements(mesh, physical_spec(mesh, rules, logical, shape))


def distribute(mesh, rules: Rules, logical: Optional[Spec],
               tensor: torch.Tensor):
    """``tensor`` (every rank's full copy) as a DTensor laid out by its
    logical spec (None: replicated); the counterpart of
    ``named_sharding``."""
    from torch.distributed.tensor import distribute_tensor

    spec = () if logical is None else logical
    return distribute_tensor(
        tensor, mesh, spec_placements(mesh, rules, spec, tuple(tensor.shape)))


def is_spec(x) -> bool:
    """A logical spec leaf: a tuple of axis names and Nones (a tuple that
    holds a tuple is a node of specs, as a cache's ``(k, v)`` pair)."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def map_specs(fn, spec_tree, tree):
    """``fn(spec, leaf)`` over a tree and its logical spec tree (dicts,
    tuples and NamedTuples of specs), keeping the tree's structure. A
    None spec covers its whole subtree: ``fn(None, leaf)`` for each
    leaf below it."""
    if spec_tree is None:
        if isinstance(tree, dict):
            return {k: map_specs(fn, None, v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return _rebuild(tree, [map_specs(fn, None, v) for v in tree])
        return fn(None, tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, spec_tree[k], tree[k]) for k in tree}
    if is_spec(spec_tree):
        return fn(spec_tree, tree)
    return _rebuild(tree, [map_specs(fn, s, v)
                           for s, v in zip(spec_tree, tree)])


def _rebuild(like: tuple, items: list) -> tuple:
    if hasattr(like, "_fields"):                # a NamedTuple
        return type(like)(*items)
    return tuple(items)


def distribute_tree(mesh, rules: Rules, spec_tree, tree):
    """Every leaf of ``tree`` distributed by its logical spec (the
    counterpart of ``tree_shardings``); None leaves stay None."""
    return map_specs(
        lambda spec, t: None if t is None else distribute(mesh, rules, spec, t),
        spec_tree, tree)


# ---------------------------------------------------------------------------
# Activation constraints (used by the models through ``constrain``)
# ---------------------------------------------------------------------------

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx",
                                                      default=None)


_RULES_ADDED = []


#: elementwise ops the port runs on DTensors that some torch releases
#: have no DTensor rule for (torch 2.11 lacks the flush's ``hardshrink``):
#: (overload, outputs, tensor inputs, other inputs) of each
_ELEMENTWISE = {
    "hardshrink": ("default", 1, 1, 1),              # the flush
    "hardshrink_backward": ("default", 1, 2, 1),     # its gradient
    "copysign": ("Tensor", 1, 2, 0),                 # the flush's sign
    "copysign_": ("Tensor", 1, 2, 0),
    "log_sigmoid_forward": ("default", 2, 1, 0),     # xLSTM's gates
    "log_sigmoid_backward": ("default", 1, 3, 0),
}


def _add_missing_rules() -> None:
    """DTensor sharding rules for the elementwise ops of ``_ELEMENTWISE``:
    every operand sharded alike on any dimension, or replicated (a
    Partial operand is reduced first). Added once, through the public
    ``register_sharding``, over any rule the release has."""
    if _RULES_ADDED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def rule(n_out, n_in, n_other):
        def strategies(x, *rest):
            out = []
            for pl in [Replicate()] + [Shard(d) for d in range(x.ndim)]:
                out.append(([pl] * n_out, [pl] * n_in + [None] * n_other))
            return out
        return strategies

    for name, (overload, *arity) in _ELEMENTWISE.items():
        op = getattr(getattr(torch.ops.aten, name), overload)
        register_sharding(op)(rule(*arity))
    _RULES_ADDED.append(True)


@contextlib.contextmanager
def activation_rules(mesh, rules: Rules):
    """The ambient (mesh, rules) of ``constrain``; also adds the DTensor
    rules the port's ops lack (``_add_missing_rules``)."""
    _add_missing_rules()
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to its logical spec's placements under the
    ambient ``activation_rules``; ``x`` itself outside a context or when
    it is no DTensor (so single-device and CPU paths are untouched)."""
    ctx = _CTX.get()
    if ctx is None or type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = spec_placements(mesh, rules, logical, tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def unshard(x, *dims: int):
    """A DTensor ``x`` with its shards of ``dims`` gathered (Replicate);
    anything else as it is. Before a reshape splits a sharded dimension
    into heads fewer than its shards (xLSTM's 4 heads on a 16-way axis):
    DTensor would carry a strided shard, whose every redistribution it
    plans by a graph search."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if pl.is_shard() and pl.dim in dims else pl
                 for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def splittable(x, dim: int, outer: int):
    """``x`` ready for a reshape that splits dimension ``dim`` into
    ``outer`` x the rest: a DTensor whose shards of ``dim`` do not divide
    ``outer`` (16 heads over 2 KV heads on a 16-way axis) has them
    gathered (``unshard``); anything else as it is."""
    if not is_dtensor(x):
        return x
    shards = 1
    for m, pl in enumerate(x.placements):
        if pl.is_shard(dim % x.dim()):
            shards *= x.device_mesh.size(m)
    return x if outer % shards == 0 else unshard(x, dim)


def gather_inner(x):
    """A DTensor ``x`` [B, ..., d_in] about to be folded into matmul rows,
    with its shards of the middle dimensions gathered (Replicate): DTensor
    has no sharding rule for a matmul whose rows fold two sharded
    dimensions (batch over data and seq over model give a strided shard),
    where GSPMD's has one. Megatron's sequence parallelism gathers the
    sequence before a projection the same way; the gradient is
    reduce-scattered back (the redistribution's backward)."""
    from torch.distributed.tensor import Replicate

    inner = range(1, x.dim() - 1)
    want = tuple(Replicate() if pl.is_shard() and pl.dim in inner else pl
                 for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def local_matmul(x, w, product):
    """``product(x_local, w_local)`` of a projection: x a DTensor [..., K]
    (its middle dimensions unsharded, ``gather_inner``), w [K, N] (a
    DTensor, or a plain tensor taken as replicated), laid out mesh
    dimension by mesh dimension as FSDP and Megatron's tensor parallelism
    do: where x's rows are sharded the weight is gathered (FSDP); where
    the contraction is sharded (x's K or w's K) both take K shards and the
    output is ``Partial``; where w's columns are sharded x is replicated
    and the output sharded on N; else both are replicated. The output is
    a DTensor of the local products. DTensor's own choice here may shard
    an output on a fused dimension that the next reshape cannot split
    (heads fewer than the axis); this is the port's ``local_map`` site for
    projections, and the product may be the compensated matmul (B5 on each
    rank's shards)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    w = _replicated(w, mesh)
    last = x.dim() - 1
    # per mesh dimension: x's and w's placements, their gradients' (a
    # local product over sharded rows or columns is a partial sum of the
    # other operand's gradient), the output's
    x_pl, w_pl, dx_pl, dw_pl, y_pl = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp.is_shard(0):
            xw, dxw, y = (xp, Replicate()), (xp, Partial()), Shard(0)
        elif wp.is_shard(0) or xp.is_shard(last):
            xw = dxw = (Shard(last), Shard(0))
            y = Partial()
        elif wp.is_shard(1):
            xw, dxw, y = (Replicate(), wp), (Partial(), wp), Shard(last)
        else:
            xw = dxw = (Replicate(), Replicate())
            y = Replicate()
        x_pl.append(xw[0]), w_pl.append(xw[1])
        dx_pl.append(dxw[0]), dw_pl.append(dxw[1]), y_pl.append(y)
    x = x.redistribute(mesh, x_pl).to_local(grad_placements=dx_pl)
    w = w.redistribute(mesh, w_pl).to_local(grad_placements=dw_pl)
    return DTensor.from_local(product(x, w), mesh, y_pl, run_check=False)


def local_lookup(table, tokens, lookup):
    """``lookup(table_local, tokens_local)`` of an embedding: tokens a
    DTensor whose rows (dimension 0) may be sharded, table [V, D]. Where
    the rows are sharded the table is gathered (FSDP); elsewhere the
    tokens are replicated, the table's vocabulary gathered and its D
    shards kept (the output sharded on its last dimension). The outputs
    form a DTensor. DTensor's own index op refuses rows sharded over two
    mesh dimensions (("pod", "data")) in some releases; this is the
    port's ``local_map`` site for the embedding (GSPMD's is
    vocabulary-parallel)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = tokens.device_mesh
    table = _replicated(table, mesh)
    last = tokens.dim()
    tok_pl, tab_pl, dtab_pl, y_pl = [], [], [], []
    for tp, wp in zip(tokens.placements, table.placements):
        if tp.is_shard(0):
            tok_pl.append(tp), tab_pl.append(Replicate())
            dtab_pl.append(Partial()), y_pl.append(Shard(0))
        elif wp.is_shard(1):
            tok_pl.append(Replicate()), tab_pl.append(wp)
            dtab_pl.append(wp), y_pl.append(Shard(last))
        else:
            tok_pl.append(Replicate()), tab_pl.append(Replicate())
            dtab_pl.append(Replicate()), y_pl.append(Replicate())
    tokens = tokens.redistribute(mesh, tok_pl).to_local()
    table = table.redistribute(mesh, tab_pl).to_local(
        grad_placements=dtab_pl)
    return DTensor.from_local(lookup(table, tokens), mesh, y_pl,
                              run_check=False)


def on_local_rows(fn, rows, weights=()):
    """``fn(*rows, *weights)`` of a computation independent per row (a
    recurrence run position by position) on each rank's own rows: every
    tensor of ``rows`` keeps the first one's row (dimension 0) shards and
    is gathered elsewhere, ``weights`` are replicated, and each output
    (a tensor, or a tuple of them, nested) forms a DTensor with those row
    shards. One DTensor dispatch a position would make the recurrence's
    host time the step's; this is the port's ``local_map`` site for the
    sLSTM's scan. Plain tensors call ``fn`` as they are."""
    if not is_dtensor(rows[0]):
        return fn(*rows, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = rows[0].device_mesh
    r_pl = tuple(pl if pl.is_shard(0) else Replicate()
                 for pl in rows[0].placements)
    dw_pl = tuple(Partial() if pl.is_shard(0) else Replicate()
                  for pl in r_pl)
    local = [_replicated(x, mesh).redistribute(mesh, r_pl).to_local()
             for x in rows]
    local += [_replicated(w, mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=dw_pl)
        for w in weights]

    def wrap(out):
        if isinstance(out, tuple):
            return tuple(wrap(o) for o in out)
        return DTensor.from_local(out, mesh, r_pl, run_check=False)

    return wrap(fn(*local))


def on_local_experts(fn, buf, *weights):
    """``fn(buf, *weights)`` of the expert FFN on each rank's own groups
    and experts: buf [G, E, C, D] keeps its group and expert shards (its
    other dimensions gathered), each weight [E, ...] takes buf's expert
    shards and is gathered elsewhere (FSDP), and the local outputs form a
    DTensor laid out as buf. DTensor's einsum over a group- and
    expert-sharded buffer folds two sharded dimensions into one; this is
    the port's ``local_map`` site for the experts. Plain tensors call
    ``fn`` as they are."""
    if not is_dtensor(buf):
        return fn(buf, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = buf.device_mesh
    b_pl, w_pl, dw_pl = [], [], []
    for pl in buf.placements:
        if pl.is_shard(0):                      # groups: FSDP-gather
            b_pl.append(pl), w_pl.append(Replicate()), dw_pl.append(Partial())
        elif pl.is_shard(1):                    # experts
            b_pl.append(pl), w_pl.append(Shard(0)), dw_pl.append(Shard(0))
        else:
            b_pl.append(Replicate()), w_pl.append(Replicate())
            dw_pl.append(Replicate())
    buf = buf.redistribute(mesh, b_pl)
    local = [_replicated(w, mesh).redistribute(mesh, w_pl).to_local(
        grad_placements=dw_pl) for w in weights]
    return DTensor.from_local(fn(buf.to_local(), *local), mesh, b_pl,
                              run_check=False)


def _replicated(t, mesh):
    """A plain tensor as a replicated DTensor (a DTensor as it is)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def is_dtensor(x) -> bool:
    """A DTensor (a plain tensor answers on its type alone)."""
    return type(x) is not torch.Tensor and hasattr(x, "device_mesh")


def on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` of an attention core (q [B, S, KV, G, dh], k / v
    [B, Skv, KV, dh], output shaped as q) on each rank's own rows and
    heads when q is a DTensor. Under the ambient rules q is laid out as
    ``("batch", None, "heads", None, None)`` (the group axis takes
    "heads" under GQA, G > 1), else it keeps its batch and head shards;
    k and v follow q's batch and KV-head shards and are replicated
    elsewhere (a sequence-sharded cache is gathered), and the local
    outputs form a DTensor laid out as q. Attention is independent per
    (row, head), so no collective runs inside. DTensor has no rule for
    the einsums that fold two sharded dimensions into one: this is the
    port's ``local_map`` site for attention, where GSPMD keeps a
    sequence-sharded cache sharded and reduces the softmax partials.
    Plain tensors call ``fn`` as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(q):
        return fn(q, k, v)
    mesh = q.device_mesh
    ctx = _CTX.get()
    if ctx is not None:
        heads = ("batch", None, "heads", None, None) if q.shape[3] == 1 \
            else ("batch", None, None, "heads", None)
        q_pl = spec_placements(mesh, ctx[1], heads, tuple(q.shape))
    else:
        q_pl = tuple(pl if pl.is_shard() and pl.dim in (0, 2, 3)
                     else Replicate() for pl in q.placements)
    kv_pl = tuple(pl if pl.is_shard() and pl.dim != 3 else Replicate()
                  for pl in q_pl)
    q = q.redistribute(mesh, q_pl)
    k, v = (t.redistribute(mesh, kv_pl) for t in (k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local())
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def write_rows(dst, dim: int, start: int, src) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim``, in place, on
    a DTensor ``dst`` (a cache leaf): each rank writes the positions that
    fall in its own shard of ``dim`` into its local tensor. DTensor would
    run a slice of a sharded dimension on a gathered copy and drop the
    write; this is the port's site for cache writes. ``src`` is laid out
    as ``dst`` but whole along ``dim`` first (a plain ``src`` counts as
    replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = dst.device_mesh
    want = tuple(Replicate() if pl.is_shard() and pl.dim == dim else pl
                 for pl in dst.placements)
    src = _replicated(src, mesh).to(dst.dtype).redistribute(mesh, want).to_local()
    coord, index, shards = mesh.get_coordinate(), 0, 1
    for m, pl in enumerate(dst.placements):
        if pl.is_shard() and pl.dim == dim:
            index = index * mesh.size(m) + coord[m]
            shards *= mesh.size(m)
    length = dst.shape[dim] // shards
    off = index * length
    lo, hi = max(start, off), min(start + src.shape[dim], off + length)
    if lo < hi:
        dst.to_local().narrow(dim, lo - off, hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------

BATCH_LOGICAL = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "loss_mask": ("batch", None),
    "vision_embeds": ("batch", None, None),
    "frames": ("batch", None, None),
}


def batch_shardings(mesh, rules: Rules, batch_shapes: Dict[str, Any],
                    ) -> Dict[str, tuple]:
    """Each batch entry's placements (a tensor, or anything with a
    ``shape``)."""
    return {k: spec_placements(mesh, rules, BATCH_LOGICAL[k], tuple(v.shape))
            for k, v in batch_shapes.items()}


def distribute_batch(mesh, rules: Rules, batch: Dict[str, torch.Tensor],
                     ) -> Dict[str, Any]:
    """Each batch entry distributed by ``BATCH_LOGICAL``."""
    return {k: distribute(mesh, rules, BATCH_LOGICAL[k], v)
            for k, v in batch.items()}
