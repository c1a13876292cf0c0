"""The plain reference of the dense decoder family (OLMo-1B): pre-norm
blocks of causal multi-head attention with RoPE and a SwiGLU MLP, a
final norm and the (tied) vocabulary head, in float32.

A configuration file of this family holds its Hugging Face ``config.json``
keys and a ``port`` section (the program's arch name and the fields it is
run with beside the published sizes). This module turns it into the
program's fields (``port_fields``), the tree of parameters the program
takes (``layout``), the reference model (``Model``), and the shapes of
its matrix products (``active_weights``, ``attention_flops``,
``projections``). It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.common import (Precision, causal_attention,
                                        check_runs, cross_entropy,
                                        layernorm_np, rmsnorm, rope, swiglu)


#: the published keys whose values this reference (and the program) run
RUNS = {"rope_scaling": None, "attention_bias": False, "clip_qkv": None}


def dims(c: Dict) -> Dict:
    """The sizes the family is built from, read from the file."""
    check_runs(c, RUNS)
    d, h = c["hidden_size"], c["num_attention_heads"]
    return {"layers": c["num_hidden_layers"], "d": d, "heads": h,
            "kv_heads": c.get("num_key_value_heads", h),
            "head_dim": c.get("head_dim") or d // h,
            "ff": c["intermediate_size"], "vocab": c["vocab_size"],
            "padded_vocab": -(-c["vocab_size"] // 2048) * 2048,
            "tied": c["tie_word_embeddings"], "theta": c["rope_theta"],
            "norm": c["port"]["fields"]["norm"]}


def port_fields(c: Dict) -> Dict:
    """The program's configuration fields: the published sizes, then the
    fields the file's ``port`` section states."""
    z = dims(c)
    out = {"n_layers": z["layers"], "d_model": z["d"], "n_heads": z["heads"],
           "n_kv_heads": z["kv_heads"], "d_ff": z["ff"],
           "vocab_size": z["vocab"], "tie_embeddings": z["tied"],
           "rope_theta": float(z["theta"])}
    out.update(c["port"]["fields"])
    return out


def _dtype(c: Dict) -> torch.dtype:
    return getattr(torch, c["port"]["fields"]["param_dtype"])


def _norm_leaves(out: Dict, path: str, z: Dict, dt, lead=()) -> None:
    if z["norm"] == "layernorm_np":
        out[path] = None
    else:
        out[f"{path}/scale"] = ((*lead, z["d"]), "ones", dt)


def layout(c: Dict) -> Dict[str, Tuple]:
    """Every parameter as ``path -> (shape, init, dtype)`` in the program's
    tree (``None``: an empty node, the parameter-free norm). The init
    scales are the usual ones: 0.02 for the embedding and the head,
    fan-in^-1/2 for the projections, and the output projections divided
    by sqrt(2 L)."""
    z = dims(c)
    dt = _dtype(c)
    L, d, h, kv, dh, ff = (z["layers"], z["d"], z["heads"], z["kv_heads"],
                           z["head_dim"], z["ff"])
    deep = (2 * L) ** 0.5
    out: Dict[str, Tuple] = {
        "embed/table": ((z["padded_vocab"], d), 0.02, dt)}
    _norm_leaves(out, "final_norm", z, dt)
    if not z["tied"]:
        out["head/w"] = ((d, z["padded_vocab"]), 0.02, dt)
    _norm_leaves(out, "blocks/ln1", z, dt, (L,))
    _norm_leaves(out, "blocks/ln2", z, dt, (L,))
    out["blocks/attn/q/w"] = ((L, d, h, dh), d ** -0.5, dt)
    out["blocks/attn/k/w"] = ((L, d, kv, dh), d ** -0.5, dt)
    out["blocks/attn/v/w"] = ((L, d, kv, dh), d ** -0.5, dt)
    out["blocks/attn/o/w"] = ((L, h * dh, d), (h * dh) ** -0.5 / deep, dt)
    out["blocks/ffn/gate/w"] = ((L, d, ff), d ** -0.5, dt)
    out["blocks/ffn/up/w"] = ((L, d, ff), d ** -0.5, dt)
    out["blocks/ffn/down/w"] = ((L, ff, d), ff ** -0.5 / deep, dt)
    return out


class Model:
    """The reference forward pass and loss over float32 parameters in the
    program's tree."""

    #: rows a float32 pass takes at once (its mean loss is per token, so
    #: blocks of rows add up to the microbatch's)
    rows_at_once = 2

    def __init__(self, c: Dict, precision: Precision):
        self.z = dims(c)
        self.pr = precision

    def _norm(self, p, x, i=None):
        if self.z["norm"] == "layernorm_np":
            return layernorm_np(x)
        scale = p["scale"] if i is None else p["scale"][i]
        return rmsnorm(x, scale)

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        z, pr = self.z, self.pr
        b, s = batch["tokens"].shape
        h, kv, dh = z["heads"], z["kv_heads"], z["head_dim"]
        x = params["embed"]["table"][batch["tokens"]]
        blk = params["blocks"]
        at, ff = blk["attn"], blk["ffn"]
        for i in range(z["layers"]):
            a = self._norm(blk["ln1"], x, i)
            q = pr.mm(a, at["q"]["w"][i].reshape(z["d"], -1))
            k = pr.mm(a, at["k"]["w"][i].reshape(z["d"], -1))
            v = pr.mm(a, at["v"]["w"][i].reshape(z["d"], -1))
            q = rope(q.reshape(b, s, h, dh), z["theta"])
            k = rope(k.reshape(b, s, kv, dh), z["theta"])
            v = v.reshape(b, s, kv, dh)
            if kv != h:
                k = k.repeat_interleave(h // kv, dim=2)
                v = v.repeat_interleave(h // kv, dim=2)
            o = causal_attention(pr, q, k, v, dh ** -0.5)
            x = x + pr.mm(o.reshape(b, s, h * dh), at["o"]["w"][i])
            m = self._norm(blk["ln2"], x, i)
            x = x + swiglu(pr, m, ff["gate"]["w"][i], ff["up"]["w"][i],
                           ff["down"]["w"][i])
        x = self._norm(params["final_norm"], x)
        head = (params["embed"]["table"].T if z["tied"]
                else params["head"]["w"])
        return cross_entropy(pr, x, head, batch["labels"],
                             batch["loss_mask"], z["vocab"])


def projections(c: Dict) -> List[Tuple[int, int, int]]:
    """``(K, N, count)`` of the dense projections (q, k, v, o and the MLP)
    each token-row goes through, ``count`` of them in the model."""
    z = dims(c)
    d, h, kv, dh, ff, L = (z["d"], z["heads"], z["kv_heads"],
                           z["head_dim"], z["ff"], z["layers"])
    return [(d, h * dh, L), (d, kv * dh, 2 * L), (h * dh, d, L),
            (d, ff, 2 * L), (ff, d, L)]


def active_weights(c: Dict) -> int:
    """Weights a token multiplies by in the forward pass: every
    projection and the head over the real vocabulary (the embedding is a
    lookup)."""
    z = dims(c)
    return (sum(k * n * cnt for k, n, cnt in projections(c))
            + z["d"] * z["vocab"])


def attention_flops(c: Dict, seq: int) -> int:
    """FLOPs of one sequence's causal attention products in the forward
    pass: q k^T and p v over the S (S + 1) / 2 pairs the mask keeps."""
    z = dims(c)
    pairs = seq * (seq + 1) // 2
    return 2 * pairs * z["heads"] * 2 * z["head_dim"] * z["layers"]
