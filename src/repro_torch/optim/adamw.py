"""AdamW and Kahan-compensated AdamW, in PyTorch (counterpart of
``repro/optim/adamw.py``).

With bf16 parameters a step's update is about 1e-3 of a parameter's
magnitude, below bf16's 2^-8 relative resolution, so ``p += update``
drops most of it. KahanAdamW keeps a bf16 compensation buffer (2 bytes a
parameter, against fp32 master weights' 4) that carries the dropped bits
across steps: the paper's compensated accumulation applied over time.

States:
  AdamW      : m, v (``moment_dtype``: fp32, or bf16 under kahan),
               params in their own dtype
  KahanAdamW : m, v (``moment_dtype``), params + comp in the param dtype

Sharded (DTensor) parameters: every leaf of params, grads and state is
a DTensor laid out by ``opt_state_specs``. The global norm is one
compensated reduction over every rank's local shards (``global_norm``),
bitwise the same on every rank; the update is elementwise, so it runs on
each leaf's local shard and gives each element its unsharded update.

The step updates params, m, v and comp IN PLACE: the reference's train
step donates them, so XLA reuses their buffers; eager PyTorch says so
explicitly. The arithmetic follows the reference op for op, and the
sites where XLA on the CPU fuses a product into the following add take
an exact fused multiply-add (``_fused``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree as _tree
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.core.kahan import (_fma, add, div, flush, gather_ranks,
                                    kahan_sq_pair, kahan_step_, mul, sub,
                                    tree_kahan_sq_norm)
from repro_torch.kernels.engine import (LANES, SUBLANES, CompensatedReduction,
                                        merge_accumulators)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    kahan: bool = True               # compensated bf16 parameter updates
    moment_dtype: str = "float32"    # bf16 moments are viable under kahan
    kahan_norm: bool = True          # compensated global-norm computation

    def __post_init__(self):
        if self.moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"moment_dtype {self.moment_dtype!r}: float32 "
                             f"or bfloat16")


class OptState(NamedTuple):
    step: Tensor                     # int32 scalar
    m: Any
    v: Any
    comp: Optional[Any]              # Kahan compensation buffer (or None)


@torch.no_grad()
def init(cfg: AdamWConfig, params: Any) -> OptState:
    """The optimizer state for ``params``. Flushes every float32 and
    bfloat16 parameter in place (a subnormal parameter is a zero to each
    op of the reference's step), so ``apply_update`` can take params, as
    its other state, as flushed values: every value it writes is."""
    for p in _tree.leaves(params):
        p.copy_(flush(p))
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda: _tree.tree_map(  # noqa: E731
        lambda p: torch.zeros_like(p, dtype=mdt, requires_grad=False),
        params)
    comp = None
    if cfg.kahan:
        comp = _tree.tree_map(lambda p: torch.zeros_like(p,
                                                         requires_grad=False),
                              params)
    device = _tree.leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=zeros(), v=zeros(), comp=comp)


def opt_state_specs(params_specs: Any, cfg: AdamWConfig) -> OptState:
    """Logical specs matching ``init``: moments and comp shard like the
    params, the step is replicated (``repro/optim/adamw.py:63-68``)."""
    comp = params_specs if cfg.kahan else None
    return OptState(step=(), m=params_specs, v=params_specs, comp=comp)


def _square_sums(eng: CompensatedReduction, leaves) -> Tuple[Tensor, Tensor]:
    """Each leaf's squares through ``sum_accumulators`` (B3), the (s, c)
    grids flattened and concatenated in leaf order."""
    accs = []
    for g in leaves:
        gf = flush(g.float())
        accs.append(eng.sum_accumulators(_sliced(mul, gf, gf)))
    return (torch.cat([a.s.reshape(-1) for a in accs]),
            torch.cat([a.c.reshape(-1) for a in accs]))


def engine_sq_norm(grads: Any) -> Tensor:
    """Sum of squares of every leaf through the engine's compensated fold
    (``repro/optim/adamw.py:71-85``): each leaf's squares go through
    ``sum_accumulators`` (B3, one launch a leaf on the card), the
    per-leaf ``(s, c)`` grids concatenate in leaf order, and ONE
    ``merge_accumulators`` tree collapses them."""
    return merge_accumulators(*_square_sums(CompensatedReduction(),
                                            _tree.leaves(grads)))


def _owned_shard(t) -> Optional[Tensor]:
    """A DTensor's local shard where this rank holds its first copy
    (coordinate 0 on every mesh dimension it is replicated over), else
    None: each element then counts once in a sharded norm."""
    coord = t.device_mesh.get_coordinate()
    if any(c and pl.is_replicate() for c, pl in zip(coord, t.placements)):
        return None
    return t.to_local().contiguous()


def sharded_sq_norm(cfg: AdamWConfig, grads: Any) -> Tensor:
    """The squared global norm of DTensor ``grads`` whose mesh spans the
    world. Every rank reduces the shards it owns (``_owned_shard``; the
    other leaves count zero), with ``kahan_norm`` as ``kahan_sq_pair``
    (the column scan) into one (s, c) pair, without it through B3 into
    one (s, c) grid a leaf. The pairs or grids are gathered in rank order
    (``core.kahan.gather_ranks``) and folded by the engine's two-sum tree
    (``merge_accumulators``), as ``distributed.collectives.sharded_asum``
    folds: bitwise the same on every rank and from run to run."""
    flat = _tree.leaves(grads)
    owned = [_owned_shard(g) for g in flat]
    device = flat[0].to_local().device
    if cfg.kahan_norm:
        s, c = kahan_sq_pair([x for x in owned if x is not None], device)
    else:
        eng = CompensatedReduction()
        grid = SUBLANES * eng.unroll * LANES
        mine = [x for x in owned if x is not None]
        s, c = (torch.zeros(grid * len(flat), dtype=torch.float32,
                            device=device) for _ in range(2))
        if mine:
            done = torch.tensor([x is not None for x in owned],
                                device=device).repeat_interleave(grid)
            s[done], c[done] = _square_sums(eng, mine)
    return merge_accumulators(gather_ranks(s.reshape(1, -1)),
                              gather_ranks(c.reshape(1, -1)))


def _like_param(g, p):
    """A DTensor gradient redistributed to its parameter's placements."""
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _local(leaves: list) -> list:
    """DTensor leaves as their local shards (views: writes go through)."""
    return [t.to_local() if is_dtensor(t) else t for t in leaves]


def global_norm(cfg: AdamWConfig, grads: Any) -> Tensor:
    if is_dtensor(_tree.leaves(grads)[0]):
        return torch.sqrt(sharded_sq_norm(cfg, grads))
    if cfg.kahan_norm:
        return torch.sqrt(tree_kahan_sq_norm(grads))
    return torch.sqrt(engine_sq_norm(grads))


def global_norm_ref(grads: Any) -> Tensor:
    """Uncompensated oracle for the engine-folded global norm."""
    # contract: allow-no-uncompensated-reduction(reference oracle for engine_sq_norm; not a hot path, as the reference's adamw.py:98)
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in _tree.leaves(grads)))


#: elements a flushing op handles at a time: the exact fma works in
#: float64 temporaries and each flushing op in a few full-size ones, so a
#: [16, 2048, 8192] leaf goes in slices
_FMA_CHUNK = 1 << 22


def _sliced(op, *args) -> Tensor:
    """``op(*args)`` for an elementwise ``op`` whose tensor arguments share
    one shape or are 0-d (a Python scalar becomes a 0-d tensor of that
    shape's dtype), in slices of about ``_FMA_CHUNK`` elements along the
    leading axis when the shape is larger: the same bits as one call."""
    like = max((x for x in args if isinstance(x, Tensor)), key=Tensor.dim)
    args = [x if isinstance(x, Tensor)
            else torch.tensor(x, dtype=like.dtype, device=like.device)
            for x in args]
    if like.dim() == 0 or like.numel() <= _FMA_CHUNK:
        return op(*args)
    rows = max(1, _FMA_CHUNK * like.shape[0] // like.numel())
    out = None
    for i in range(0, like.shape[0], rows):
        part = op(*(x[i:i + rows] if x.dim() else x for x in args))
        if out is None:
            out = part.new_empty(like.shape)
        out[i:i + rows] = part
    return out


def _fused(a, b, c: Tensor) -> Tensor:
    """``a * b + c`` with one rounding, at a site where XLA on the CPU
    fuses the product into the add in the compiled step: the two moment
    updates (``m * b1 + ...``, ``v * b2 + ...``), the weight decay into
    the direction (``ratio + wd * p``) and, where the update needs no
    cast (float32 params), ``-lr * dir`` into the add that applies it.
    Found by comparing the jitted reference with each candidate set: bf16
    and float32 params, m, v and comp then match bit for bit. ``a`` or
    ``b`` may be a scalar; tensors share ``c``'s shape, and hold flushed
    values (the step's state, or what its flushing ops wrote)."""
    return _sliced(_fma, a, b, c)


def _sqrt(x: Tensor) -> Tensor:
    """The correctly rounded float32 square root. torch's float32 ``sqrt``
    on the CPU is not always (it differs from XLA's in the last bit on a
    few inputs); the float64 root of a float32 value, rounded once to
    float32, is. On the card ``torch.sqrt`` is already correctly rounded."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
                 lr_scale=1.0) -> Tuple[Any, OptState, dict]:
    """One optimizer step (``repro/optim/adamw.py:95-159``). ``grads`` may
    be any float dtype (upcast to fp32 for the moment math). Updates
    ``params`` and the state's tensors in place and returns (params, the
    new state, metrics). DTensor gradients are first laid out as their
    params (the reduce-scatter of ZeRO: ``grads`` in the params' specs)."""
    if is_dtensor(state.step):
        grads = _tree.tree_map(_like_param, grads, params)
    step = state.step + 1
    if is_dtensor(step):
        step = step.to_local()
    if is_dtensor(lr_scale):
        lr_scale = lr_scale.to_local()
    gnorm = global_norm(cfg, grads)
    clip_scale = 1.0
    if cfg.grad_clip > 0:
        clip_scale = torch.minimum(
            gnorm.new_tensor(1.0),
            gnorm.new_tensor(cfg.grad_clip) / (gnorm + 1e-12))
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    flat_p = _local(_tree.leaves(params))
    flat_g = _local(_tree.leaves(grads))
    flat_m = _local(_tree.leaves(state.m))
    flat_v = _local(_tree.leaves(state.v))
    flat_c = (_local(_tree.leaves(state.comp)) if cfg.kahan
              else [None] * len(flat_p))
    for p, g, m, v, c in zip(flat_p, flat_g, flat_m, flat_v, flat_c):
        # every float32 op flushes as the reference's does (C2); the
        # grads are the one input from outside, flushed here once
        gf = flush(g.float())
        if cfg.grad_clip > 0:
            gf = _sliced(mul, gf, clip_scale)
        m32 = _fused(m.float(), b1, _sliced(mul, gf, 1 - b1))
        v32 = _fused(v.float(), b2,
                     _sliced(mul, _sliced(mul, gf, gf), 1 - b2))
        # XLA rewrites mhat / (sqrt(vhat) + eps), mhat = m32 / c1, into
        # one division by a product (the compiled step's HLO:
        # divide(m32, multiply(1 - b1^t, sqrt(v32 / c2) + eps))). The
        # divisor's ops need no flush: v32 is zero or at least tiny and
        # c2 <= 1, so nothing there lands below tiny
        denom = c1 * (_sqrt(v32 / c2) + cfg.eps)
        ratio = _sliced(div, m32, denom)
        step_dir = _fused(cfg.weight_decay, p.float(), ratio)
        m.copy_(m32)
        v.copy_(v32)
        if p.dtype == torch.float32:
            # no cast between the update and its add: XLA fuses -lr * dir
            # into it (into y = delta + c of the Kahan step)
            if cfg.kahan:
                y = _fused(-lr, step_dir, c)
                t = add(p, y)
                c.copy_(sub(y, sub(t, p)))
                p.copy_(t)
            else:
                p.copy_(_fused(-lr, step_dir, p))
            continue
        delta = _sliced(mul, -lr, step_dir)
        if cfg.kahan:
            # compensated p += delta in the PARAM dtype (bf16-safe)
            kahan_step_(p, c, delta.to(p.dtype))
        else:
            p.copy_(_sliced(add, p.float(), delta).to(p.dtype))
    if is_dtensor(state.step):
        state.step.to_local().copy_(step)
        step = state.step
    new_state = OptState(step=step, m=state.m, v=state.v,
                         comp=state.comp if cfg.kahan else None)
    lr_out = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    metrics = {"grad_norm": gnorm, "lr": lr_out}
    return params, new_state, metrics
