"""Plain PyTorch pieces shared by the reference models: the weights made
from a seed, the norms, RoPE, causal attention, the cross-entropy, AdamW
with the warmup schedule, and the training steps that the benchmark
compares the program with.

Nothing here imports the program. Everything computes in float32, with
TF32 switched off while the reference runs (``Precision.scope``); the
parameters a forward pass reads are the float32 master values rounded to
the dtype the configuration states for them (``train_readings``). A
``Precision("fp8")`` rounds the operands of every matrix product, and the
gradients flowing back into them, through float8 with a per-tensor scale:
the control, one precision below the bfloat16 the configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

#: largest finite values of the float8 formats
_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round8(x: Tensor, fmt: torch.dtype) -> Tensor:
    """``x`` rounded through ``fmt`` under a per-tensor scale that maps
    its largest magnitude to the format's largest value."""
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = _FP8_MAX[fmt] / amax
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """e4m3 in the forward pass, e5m2 for the gradient: the usual float8
    training recipe."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


class Precision:
    """How the reference's matrix products compute: ``None`` in float32,
    ``"fp8"`` with float8 operands and gradients (the control)."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"precision {kind!r}: None or 'fp8'")
        self.kind = kind

    def op(self, x: Tensor) -> Tensor:
        return x if self.kind is None else _Fp8.apply(x)

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(self.op(a), self.op(b))

    def ein(self, eq: str, a: Tensor, b: Tensor) -> Tensor:
        return torch.einsum(eq, self.op(a), self.op(b))

    @staticmethod
    @contextlib.contextmanager
    def scope():
        """float32 products in float32, not TF32, while the reference
        runs; the caller's settings come back after."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32,
               torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old[0]
            torch.backends.cudnn.allow_tf32 = old[1]
            torch.set_float32_matmul_precision(old[2])


def check_runs(c: Dict, runs: Dict) -> None:
    """Refuse a configuration file that states, for a key of ``runs``,
    another value than the one the family's reference (and the program)
    runs."""
    other = {k: c[k] for k, v in runs.items() if k in c and c[k] != v}
    if other:
        raise ValueError(f"the reference runs {runs}; the file states "
                         f"{other}")


# ---------------------------------------------------------------------------
# Weights from a seed
# ---------------------------------------------------------------------------

def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index``: each leaf has its own, so any
    one leaf can be drawn again alone."""
    return (int(seed) * 1_000_003 + 7_919 * (index + 1)) % (2 ** 63)


def draw_leaf(spec: Tuple, seed: int, index: int, device) -> Tensor:
    """One leaf of a layout: ``spec`` is ``(shape, init, dtype)``, init a
    float scale of N(0, 1) or "ones" / "zeros". A drawn leaf is made on
    ``device`` in float32 by one call and cast once."""
    shape, init, dtype = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(init).to(dtype)


def make_weights(layout: Dict[str, Tuple], seed: int, device) -> Dict:
    """A nested dict of every leaf of ``layout`` (path "a/b/c" -> spec, or
    None for an empty node), drawn from ``seed`` on ``device``."""
    out: Dict = {}
    for i, (path, spec) in enumerate(layout.items()):
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = {} if spec is None else draw_leaf(spec, seed, i, device)
    return out


def layout_paths(layout: Dict[str, Tuple]) -> List[str]:
    """The paths of a layout's leaves in ``leaf_paths``' order."""
    tree: Dict = {}
    for path, spec in layout.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = {} if spec is None else 0
    return leaf_paths(tree)


def get_path(tree: Dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def layernorm_np(x: Tensor, eps: float = 1e-5) -> Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: Tensor, theta: float) -> Tensor:
    """x [B, S, H, d] at positions 0..S-1: the rotation of the first half
    of the last axis against the second, frequency theta^(-i / (d/2))."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * freqs
    cos = torch.cos(ang).to(x.device, torch.float32)[:, None, :]
    sin = torch.sin(ang).to(x.device, torch.float32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(pr: Precision, q: Tensor, k: Tensor, v: Tensor,
                     scale: float) -> Tensor:
    """q, k [B, S, H, dk], v [B, S, H, dv] -> [B, S, H, dv]: softmax over
    the keys at or before each query."""
    s = q.shape[1]
    scores = pr.ein("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return pr.ein("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def swiglu(pr: Precision, x: Tensor, gate: Tensor, up: Tensor,
           down: Tensor) -> Tensor:
    return pr.mm(F.silu(pr.mm(x, gate)) * pr.mm(x, up), down)


def cross_entropy(pr: Precision, x: Tensor, head: Tensor, labels: Tensor,
                  mask: Tensor, vocab: int) -> Tensor:
    """Mean masked next-token cross-entropy over the real vocabulary:
    ``head`` [D, V_pad], its padded columns left out."""
    logits = pr.mm(x, head[:, :vocab])
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None]).squeeze(-1)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# Training: the microbatch fold, the clip, the schedule and AdamW
# ---------------------------------------------------------------------------

def warmup_cosine(step: int, warmup: int, total: int,
                  min_frac: float = 0.1) -> float:
    """The learning-rate scale at ``step`` completed steps: linear warmup,
    then a cosine decay to ``min_frac``."""
    warm = min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(
        math.pi * prog)))


def leaf_paths(tree: Dict, prefix: str = "") -> List[str]:
    """Paths of a nested dict's tensors, keys in sorted order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(leaf_paths(v, path + "/"))
        else:
            out.append(path)
    return out


def _with_leaves(tree: Dict, paths: List[str], leaves: List[Tensor]) -> Dict:
    """A copy of the nested dict ``tree`` holding ``leaves`` at ``paths``
    (empty nodes kept)."""
    out = {k: _with_leaves(v, [], []) if isinstance(v, dict) else v
           for k, v in tree.items()}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node[p]
        node[name] = leaf
    return out


def train_readings(model, weights: Dict, batches: List[Dict], opt: Dict,
                   schedule: Dict, microbatches: int,
                   drop_half: bool = False) -> Dict:
    """Three (or ``len(batches)``) AdamW steps of ``model`` from
    ``weights`` (the drawn tree, each leaf in the dtype the configuration
    states), and what the benchmark compares: each step's loss, each
    leaf's norm of the first step's gradient after the clip (as AdamW
    takes it), and each leaf's norm of the change of the parameters over
    all the steps. ``drop_half`` leaves out the second half of every
    batch and averages over the rest (a fault for the tests of the
    comparison).

    The parameters are float64 master values, updated by AdamW from its
    float32 moments;
    each forward and backward pass reads them rounded to the dtype the
    configuration states for them (a bfloat16 parameter is a bfloat16
    value; KahanAdamW's parameter plus its compensation is the master
    value), and computes in float32. ``model.loss(params, batch)`` is the
    mean loss of one microbatch; a model with ``rows_at_once`` takes a
    microbatch in blocks of that many rows, each block's mean weighted by
    its share of the microbatch's counted tokens, so that a float32 pass
    over the cell's rows fits beside the reference's state."""
    paths = leaf_paths(weights)
    start = [get_path(weights, p) for p in paths]
    dtypes = [x.dtype for x in start]
    # float64 masters: at the warmup's first rates a step moves a weight
    # by a few float32 spacings, which KahanAdamW's parameter plus its
    # compensation holds and a float32 master would round
    master = [x.to(torch.float64, copy=True) for x in start]
    m = [torch.zeros_like(x, dtype=torch.float32) for x in master]
    v = [torch.zeros_like(x, dtype=torch.float32) for x in master]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first_grad, raw_first = [], None, None
    for step, batch in enumerate(batches):
        rows = batch["tokens"].shape[0]
        n = microbatches
        if drop_half:
            rows //= 2
            n = max(1, n // 2)
        per = rows // n
        used = [x.to(dt).to(torch.float32, copy=True).requires_grad_(True)
                for x, dt in zip(master, dtypes)]
        params = _with_leaves(weights, paths, used)
        loss_sum = 0.0
        block = getattr(model, "rows_at_once", None) or per
        for i in range(n):
            mb = {k: t[i * per:(i + 1) * per] for k, t in batch.items()}
            total = mb["loss_mask"].sum()
            for j in range(0, per, block):
                part = {k: t[j:j + block] for k, t in mb.items()}
                share = part["loss_mask"].sum() / total.clamp_min(1.0)
                loss = model.loss(params, part) * share
                loss.backward()
                loss_sum += float(loss.detach())
                del loss
        grads = [x.grad for x in used]
        del params, used
        losses.append(loss_sum / n)
        for g in grads:
            g.div_(n)
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                             for g in grads))
        clip = min(1.0, opt["grad_clip"] / (norm + 1e-12)) \
            if opt["grad_clip"] > 0 else 1.0
        lr = opt["lr"] * warmup_cosine(step, schedule["warmup"],
                                       schedule["total"])
        t = step + 1
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for x, g, mi, vi in zip(master, grads, m, v):
                g.mul_(clip)
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).add_(g * g, alpha=1 - b2)
                direction = (mi / c1) / (torch.sqrt(vi / c2) + eps) + wd * x
                x.sub_(lr * direction)
        if step == 0:
            first_grad = [float(torch.linalg.vector_norm(g.double()))
                          for g in grads]
            raw_first = [f / clip for f in first_grad]
        del grads
    change = [float(torch.linalg.vector_norm((x - x0).double()))
              for x, x0 in zip(master, start)]
    return {"paths": paths, "loss": losses,
            "grad": first_grad, "raw_grad": raw_first, "change": change}
