"""Mixture-of-Experts layer with group-local sort-based dispatch, in
PyTorch (counterpart of ``repro/models/moe.py``).

Tokens are reshaped to ``[G, T/G, D]`` (``n_groups``); each group routes
its tokens to the top-k of ``E`` experts, sorts the (token, expert)
entries by expert, and scatters them into a ``[G, E, C, D]`` buffer of
``C`` rows an expert (the capacity). Entries past an expert's capacity
are DROPPED, deterministically: the sort is stable, so the earliest
tokens keep their rows. The expert FFN runs on the whole buffer, every
expert included, as the reference's einsum does; the outputs are gathered
back, weighted by the gates and folded into each token.

Where the reference's jnp primitives leave an order or a bound to XLA,
the port pins it to the same answer:

* top-k: ``torch.sort(stable=True)`` of the probabilities, so that among
  equal probabilities the lower expert comes first, as ``lax.top_k``
  puts it;
* segment ranks: a stable argsort and a running maximum of the segment
  starts (``_positions_in_segment``);
* capacity: the reference's expression with Python's ``round`` (half to
  even); dropless at ``S == 1``;
* a dropped entry's row is ``C``: its scatter lands in one spare row that
  is cut off, its gather reads row ``C - 1`` (JAX clamps) times a zero
  weight;
* combine: each token's contributions are added from zero in the sorted
  order, ascending expert id, as XLA's sequential scatter-add applies
  them, with no atomics, so a token's sum is the same on every run and
  whatever else is in the batch;
* the backward in the same fixed order: the dispatch's token gather
  (``_TokenGather``) and the expert-output pick (``_ExpertPick``) are
  Functions whose backward adds a token's ``k`` gradient rows by
  ``combine`` and writes each kept entry's row once, where autograd's
  own would scatter-add with atomics on CUDA (a different order every
  run, so a step and a resumed run would not repeat). On the CPU they
  give the bits of autograd's scatter-adds, which add in that order.

Router logits, probabilities and the load-balance statistics are float32;
the buffer, the expert FFN and the combine run in the compute dtype. The
shared experts are an MLP of width ``n_shared * d_ff_shared`` on every
token, on the compensated matmul under ``kahan_matmul``; the router and
the expert contractions stay plain, as the reference computes them with
``jnp.einsum`` outside any kernel.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, on_local_experts
from repro_torch.models.layers import (Leaf, dtype_of, mlp_apply, mlp_spec,
                                      project)

Params = Dict[str, Any]
Tensor = torch.Tensor


def moe_spec(cfg) -> Params:
    """The ``Leaf``s of one MoE layer, scaled as the reference's
    ``moe_init``: the router ``[d, E]`` in float32, gate/up ``[E, d, f]``,
    down ``[E, f, d]`` and the shared experts' MLP."""
    mo, d = cfg.moe, cfg.d_model
    f = mo.d_ff_expert
    deep = (2 * cfg.n_layers) ** 0.5
    e = mo.n_experts
    spec = {"router": {"w": Leaf((d, e), d ** -0.5, ("embed", None),
                                 "float32")},
            "gate": Leaf((e, d, f), d ** -0.5, ("expert", "embed", "mlp")),
            "up": Leaf((e, d, f), d ** -0.5, ("expert", "embed", "mlp")),
            "down": Leaf((e, f, d), f ** -0.5 / deep,
                         ("expert", "mlp", "embed"))}
    if mo.n_shared:
        spec["shared"] = mlp_spec(cfg, mo.n_shared * (mo.d_ff_shared or f))
    return spec


def _positions_in_segment(sorted_ids: Tensor) -> Tensor:
    """Rank of each entry within its run of equal ids (last axis)."""
    n = sorted_ids.shape[-1]
    idx = torch.arange(n, device=sorted_ids.device).expand_as(sorted_ids)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    seg_start = torch.where(is_start, idx, 0)
    return idx - torch.cummax(seg_start, dim=-1).values


def n_groups(tokens: int, batch: int) -> int:
    """Routing groups: 32 halved until it divides the batch and the
    tokens (the reference's ``_n_groups``)."""
    g = 32
    while g > 1 and (batch % g or tokens % g):
        g //= 2
    return max(g, 1)


def capacity(cfg, tk: int, s: int) -> int:
    """Rows an expert takes in a group of ``tk`` (token, expert) entries:
    all of them at decode (``s == 1``, dropless), else ``tk / E`` times
    the capacity factor rounded half to even, at least 1."""
    if s == 1:
        return tk
    mo = cfg.moe
    return int(max(1, round(tk / mo.n_experts * mo.capacity_factor)))


class Routing(NamedTuple):
    """One call's routing: ``probs`` [G,Tg,E], ``gates`` and
    ``expert_idx`` [G,Tg,k] (highest probability first), and the
    dispatch in sorted order, [G,Tg*k] each: ``order`` (the sort of the
    token-major entries), ``expert`` and ``token`` ids, ``gate``, the
    rank in the expert's segment ``pos`` and ``keep = pos < capacity``."""

    probs: Tensor
    gates: Tensor
    expert_idx: Tensor
    order: Tensor
    expert: Tensor
    token: Tensor
    gate: Tensor
    pos: Tensor
    keep: Tensor
    capacity: int


def route(p: Params, cfg, xg: Tensor, s: int) -> Routing:
    """Route the groups ``xg`` [G,Tg,D] of a call over ``s`` positions."""
    mo = cfg.moe
    g, tg, _ = xg.shape
    k = mo.top_k
    logits = project(xg.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = top[..., :k], idx[..., :k]
    if k > 1:
        # contract: allow-no-uncompensated-reduction(gate renormalizer; top_k<=8 fp32 terms, as the reference's moe.py:106)
        gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    tk = tg * k
    e_flat = expert_idx.reshape(g, tk)
    t_flat = torch.arange(tg, device=xg.device).repeat_interleave(k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    expert = torch.gather(e_flat, -1, order)
    pos = _positions_in_segment(expert)
    cap = capacity(cfg, tk, s)
    return Routing(probs, gates, expert_idx, order, expert,
                   t_flat[order], torch.gather(gates.reshape(g, tk), -1,
                                               order),
                   pos, pos < cap, cap)


def combine(contrib: Tensor, order: Tensor, k: int) -> Tensor:
    """Each token's ``k`` contributions ``contrib`` [G, Tg*k, D] (in the
    sorted order ``order``) added from zero in that order, ascending
    expert id, as the reference's ``zeros.at[token].add`` applies them on
    the CPU: [G, Tg, D], without atomics."""
    g, tk, d = contrib.shape
    at = torch.sort(torch.argsort(order, dim=-1).reshape(g, tk // k, k),
                    dim=-1).values.reshape(g, tk)
    contrib = torch.gather(contrib, 1, at[..., None].expand(-1, -1, d))
    contrib = contrib.reshape(g, tk // k, k, d)
    y = torch.zeros_like(contrib[:, :, 0])
    for j in range(k):
        y = y + contrib[:, :, j]
    return y


class _TokenGather(torch.autograd.Function):
    """``xg`` [G, Tg, D] gathered at the sorted entries' tokens ``token``
    [G, Tg*k] -> [G, Tg*k, D]. Backward: each token's ``k`` gradient
    rows added from zero in the sorted order (``combine``, in float32 for
    a bf16 gradient and rounded once, as the CPU's scatter-add adds), with
    no atomics."""

    @staticmethod
    def forward(ctx, xg: Tensor, token: Tensor, order: Tensor, k: int):
        ctx.save_for_backward(order)
        ctx.k = k
        return torch.gather(xg, 1, token[..., None].expand(-1, -1,
                                                            xg.shape[-1]))

    @staticmethod
    def backward(ctx, g: Tensor):
        (order,) = ctx.saved_tensors
        acc = torch.promote_types(g.dtype, torch.float32)
        return combine(g.to(acc), order, ctx.k).to(g.dtype), None, None, None


class _ExpertPick(torch.autograd.Function):
    """The expert outputs ``out`` [G, E, C, D] at each sorted entry's
    (expert, row): a dropped entry (row ``C``) reads row ``C - 1``, which
    its zero gate cancels. Backward: each kept entry's gradient row
    written to its own (expert, row), the dropped entries' to a spare row
    ``C`` that is cut off; no two kept entries share a row, so nothing is
    added in an order that can change. A dropped entry's gradient is its
    zero gate times the token's (``moe_apply``), so indexing's backward,
    which adds it to row ``C - 1``, gives the same bits."""

    @staticmethod
    def forward(ctx, out: Tensor, gi: Tensor, expert: Tensor, rows: Tensor):
        ctx.save_for_backward(gi, expert, rows)
        ctx.shape = out.shape
        return out[gi, expert, rows.clamp_max(out.shape[2] - 1)]

    @staticmethod
    def backward(ctx, g: Tensor):
        gi, expert, rows = ctx.saved_tensors
        grp, e, cap, d = ctx.shape
        grad = g.new_zeros((grp, e, cap + 1, d))
        grad.index_put_((gi, expert, rows), g, accumulate=True)
        return grad[:, :, :cap], None, None, None


def moe_apply(p: Params, cfg, x: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x [B,S,D] -> (y [B,S,D], {aux_loss, dropped_frac}) as the
    reference's ``moe_apply`` (``repro/models/moe.py:88-190``)."""
    mo = cfg.moe
    cd = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    t = b * s
    g = n_groups(t, b)
    tg = t // g
    xg = constrain(x.reshape(g, tg, d), "moe_group", None, None)
    r = route(p, cfg, xg, s)

    # load-balance auxiliary loss over the whole call: top-1 counts as a
    # one-hot sum (exact; unlike ``bincount`` it waits on no host sync)
    top1 = r.expert_idx[..., 0].reshape(-1, 1)
    experts = torch.arange(mo.n_experts, device=x.device)
    # contract: allow-no-uncompensated-reduction(expert counts of a {0,1} mask, exact in fp32; the reference's scatter-add counts beside its aux-statistic exemptions moe.py:112-113)
    counts = torch.sum((top1 == experts).float(), dim=0)
    # contract: allow-no-uncompensated-reduction(router load statistic; feeds the diagnostic aux loss only, as the reference's moe.py:112)
    frac_probs = torch.mean(r.probs, dim=(0, 1))
    # contract: allow-no-uncompensated-reduction(aux-loss statistic; n_experts fp32 terms, diagnostic only, as the reference's moe.py:113)
    aux = mo.n_experts * torch.sum(counts / t * frac_probs)

    # dispatch into [G, E, C + 1, D]: the spare row C takes the dropped
    # entries' zeros and is cut off
    cap = r.capacity
    rows = torch.where(r.keep, r.pos, cap)
    gi = torch.arange(g, device=x.device)[:, None].expand_as(rows)
    gathered = _TokenGather.apply(xg, r.token, r.order, mo.top_k)
    gathered = torch.where(r.keep[..., None], gathered, 0).to(cd)
    buf = x.new_zeros((g, mo.n_experts, cap + 1, d), dtype=cd)
    buf[gi, r.expert, rows] = gathered
    buf = buf[:, :, :cap]
    # two-stage resharding: the scatter stays group-local, then a local
    # slice to the expert-parallel layout (``moe.py:148-153``)
    buf = constrain(buf, "moe_group", None, None, None)
    buf = constrain(buf, "moe_group", "expert", None, None)

    # the expert FFN over every expert's rows
    def experts(buf, gate, up, down):
        # each weight cast at its use: one compute-dtype copy at a time
        # contract: allow-no-uncompensated-reduction(expert FFN contraction; cd accumulate, d_model terms, as the reference's moe.py:157)
        gt = torch.einsum("gecd,edf->gecf", buf, gate.to(cd))
        # contract: allow-no-uncompensated-reduction(expert FFN contraction; cd accumulate, d_model terms, as the reference's moe.py:158)
        up = torch.einsum("gecd,edf->gecf", buf, up.to(cd))
        h = F.silu(gt.float()).to(cd) * up
        # contract: allow-no-uncompensated-reduction(expert FFN down-projection; cd accumulate, d_ff terms, as the reference's moe.py:163)
        return torch.einsum("gecf,efd->gecd", h, down.to(cd))

    out = on_local_experts(experts, buf, p["gate"], p["up"], p["down"])
    out = constrain(out, "moe_group", "expert", None, None)
    # the expert outputs back to the group-local layout for the combine
    out = constrain(out, "moe_group", None, None, None)

    picked = _ExpertPick.apply(out, gi, r.expert, rows)          # [G,Tk,D]
    y = combine(picked * (r.gate * r.keep).to(cd)[..., None], r.order,
                mo.top_k)
    y = constrain(y, "moe_group", None, None)

    if mo.n_shared:
        y = y + mlp_apply(p["shared"], xg.to(cd), cd,
                          compensated=cfg.kahan_matmul)
    metrics = {"aux_loss": aux,
               # contract: allow-no-uncompensated-reduction(capacity-drop diagnostic; fraction of a {0,1} mask, as the reference's moe.py:182)
               "dropped_frac": 1.0 - torch.mean(r.keep.float())}
    return y.reshape(b, s, d), metrics
