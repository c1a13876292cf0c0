"""The plain reference of the DeepSeek-V2 family (DeepSeek-V2-Lite):
multi-head latent attention (MLA), a leading dense layer, then layers of
routed and shared experts, RMSNorm, an untied head, in float32.

MLA as DeepSeek-V2 describes it without query compression: the keys and
values are expanded from a normed latent of ``kv_lora_rank``, and one
rotary key of ``qk_rope_head_dim`` is shared by the heads, with plain
RoPE (``rope_scaling`` null). A token's top-k gates are renormalised to
sum to 1 (``norm_topk_prob`` true). The load-balance loss is taken over
each microbatch's tokens, not a sequence's (``seq_aux`` false), with the
coefficient ``aux_loss_alpha``. The experts follow the program's
routing, which the file's ``port`` section states: the tokens of a
microbatch route in groups (32 halved until it divides the rows and the
tokens); each expert takes ``round(tokens * k / E * capacity_factor)``
entries of a group, in token order, and drops the rest; the loss adds
``router_aux_coef`` times the layers' mean load-balance loss.

A configuration file of this family holds the published ``config.json``
keys and a ``port`` section. This module imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import (Precision, causal_attention,
                                        check_runs, cross_entropy, rmsnorm,
                                        rope, swiglu)


#: the published keys whose values this reference (and the program) run
RUNS = {"norm_topk_prob": True, "rope_scaling": None, "q_lora_rank": None,
        "scoring_func": "softmax", "topk_method": "greedy", "n_group": 1,
        "topk_group": 1, "routed_scaling_factor": 1, "moe_layer_freq": 1,
        "seq_aux": False}


def dims(c: Dict) -> Dict:
    p = c["port"]["fields"]
    # the load-balance loss runs over a whole microbatch (not a sequence),
    # weighted by the ``port`` section's coefficient
    check_runs(c, {**RUNS, "aux_loss_alpha": p["router_aux_coef"]})
    return {"layers": c["num_hidden_layers"], "d": c["hidden_size"],
            "heads": c["num_attention_heads"], "ff": c["intermediate_size"],
            "vocab": c["vocab_size"],
            "padded_vocab": -(-c["vocab_size"] // 2048) * 2048,
            "theta": c["rope_theta"], "rank": c["kv_lora_rank"],
            "rope": c["qk_rope_head_dim"], "nope": c["qk_nope_head_dim"],
            "v": c["v_head_dim"], "experts": c["n_routed_experts"],
            "top_k": c["num_experts_per_tok"],
            "ff_expert": c["moe_intermediate_size"],
            "shared": c["n_shared_experts"],
            "dense_layers": c["first_k_dense_replace"],
            "capacity_factor": p["capacity_factor"],
            "aux_coef": p["router_aux_coef"], "eps": c["rms_norm_eps"]}


def port_fields(c: Dict) -> Dict:
    """The program's configuration fields: the published sizes, then the
    fields the file's ``port`` section states (capacity and aux
    coefficient go to the MoE sub-configuration)."""
    z = dims(c)
    fields = dict(c["port"]["fields"])
    moe = {"n_experts": z["experts"], "top_k": z["top_k"],
           "d_ff_expert": z["ff_expert"], "n_shared": z["shared"],
           "d_ff_shared": z["ff_expert"], "interleave": 1,
           "first_k_dense": z["dense_layers"],
           "capacity_factor": fields.pop("capacity_factor"),
           "router_aux_coef": fields.pop("router_aux_coef")}
    mla = {"kv_lora_rank": z["rank"], "qk_rope_dim": z["rope"],
           "qk_nope_dim": z["nope"], "v_head_dim": z["v"]}
    out = {"n_layers": z["layers"], "d_model": z["d"], "n_heads": z["heads"],
           "n_kv_heads": c["num_key_value_heads"], "d_ff": z["ff"],
           "vocab_size": z["vocab"], "d_head": z["nope"] + z["rope"],
           "tie_embeddings": c["tie_word_embeddings"],
           "rope_theta": float(z["theta"]), "moe": moe, "mla": mla}
    out.update(fields)
    return out


def _mla_layout(out, pre, z, L, dt, deep):
    lead = () if L is None else (L,)
    d, h, r = z["d"], z["heads"], z["rank"]
    out[f"{pre}/attn/q/w"] = ((*lead, d, h, z["nope"] + z["rope"]),
                              d ** -0.5, dt)
    out[f"{pre}/attn/dkv/w"] = ((*lead, d, r), d ** -0.5, dt)
    out[f"{pre}/attn/kr/w"] = ((*lead, d, z["rope"]), d ** -0.5, dt)
    out[f"{pre}/attn/uk/w"] = ((*lead, r, h, z["nope"]), r ** -0.5, dt)
    out[f"{pre}/attn/uv/w"] = ((*lead, r, h, z["v"]), r ** -0.5, dt)
    out[f"{pre}/attn/o/w"] = ((*lead, h * z["v"], d),
                              (h * z["v"]) ** -0.5 / deep, dt)
    out[f"{pre}/attn/kv_norm/scale"] = ((*lead, r), "ones", dt)
    out[f"{pre}/ln1/scale"] = ((*lead, d), "ones", dt)
    out[f"{pre}/ln2/scale"] = ((*lead, d), "ones", dt)


def _mlp_layout(out, pre, d, f, lead, dt, deep):
    out[f"{pre}/gate/w"] = ((*lead, d, f), d ** -0.5, dt)
    out[f"{pre}/up/w"] = ((*lead, d, f), d ** -0.5, dt)
    out[f"{pre}/down/w"] = ((*lead, f, d), f ** -0.5 / deep, dt)


def layout(c: Dict) -> Dict[str, Tuple]:
    """Every parameter as ``path -> (shape, init, dtype)`` in the program's
    tree: ``dense_prefix`` (the leading dense layer, unstacked), then
    ``moe_blocks`` stacked over the remaining layers; the router in
    float32."""
    z = dims(c)
    dt = getattr(torch, c["port"]["fields"]["param_dtype"])
    if z["dense_layers"] != 1:
        raise ValueError("the family's program holds one leading dense "
                         "layer")
    d, e, f = z["d"], z["experts"], z["ff_expert"]
    deep = (2 * z["layers"]) ** 0.5
    n_moe = z["layers"] - 1
    out: Dict[str, Tuple] = {
        "embed/table": ((z["padded_vocab"], d), 0.02, dt),
        "final_norm/scale": ((d,), "ones", dt),
        "head/w": ((d, z["padded_vocab"]), 0.02, dt)}
    _mla_layout(out, "dense_prefix", z, None, dt, deep)
    _mlp_layout(out, "dense_prefix/ffn", d, z["ff"], (), dt, deep)
    _mla_layout(out, "moe_blocks", z, n_moe, dt, deep)
    out["moe_blocks/ffn/router/w"] = ((n_moe, d, e), d ** -0.5,
                                      torch.float32)
    out["moe_blocks/ffn/gate"] = ((n_moe, e, d, f), d ** -0.5, dt)
    out["moe_blocks/ffn/up"] = ((n_moe, e, d, f), d ** -0.5, dt)
    out["moe_blocks/ffn/down"] = ((n_moe, e, f, d), f ** -0.5 / deep, dt)
    _mlp_layout(out, "moe_blocks/ffn/shared", d, z["shared"] * f, (n_moe,),
                dt, deep)
    return out


def n_groups(tokens: int, rows: int) -> int:
    g = 32
    while g > 1 and (rows % g or tokens % g):
        g //= 2
    return g


def _at(tree, i):
    """Layer ``i`` of a stacked subtree (``i`` None: unstacked)."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree if i is None else tree[i]


class Model:
    """The reference forward pass and loss over float32 parameters in the
    program's tree."""

    def __init__(self, c: Dict, precision: Precision):
        self.z = dims(c)
        self.pr = precision

    def _mla(self, p, x):
        z, pr = self.z, self.pr
        b, s, d = x.shape
        h, nope, dr = z["heads"], z["nope"], z["rope"]
        q = pr.mm(x, p["q"]["w"].reshape(d, -1)).reshape(b, s, h, -1)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], z["theta"])], -1)
        lat = rmsnorm(pr.mm(x, p["dkv"]["w"]), p["kv_norm"]["scale"],
                      z["eps"])
        kr = rope(pr.mm(x, p["kr"]["w"])[:, :, None, :], z["theta"])
        k = torch.cat([pr.ein("bsr,rhn->bshn", lat, p["uk"]["w"]),
                       kr.expand(b, s, h, dr)], -1)
        v = pr.ein("bsr,rhv->bshv", lat, p["uv"]["w"])
        o = causal_attention(pr, q, k, v, (nope + dr) ** -0.5)
        return pr.mm(o.reshape(b, s, -1), p["o"]["w"])

    def _moe(self, p, x):
        """(routed and shared experts' output, load-balance loss)."""
        z, pr = self.z, self.pr
        b, s, d = x.shape
        t, e, k = b * s, z["experts"], z["top_k"]
        g = n_groups(t, b)
        xf = x.reshape(t, d)
        probs = torch.softmax(xf @ p["router"]["w"], -1)        # float32
        gates, idx = torch.topk(probs, k, -1)
        gates = gates / gates.sum(-1, keepdim=True)
        tg = t // g
        cap = max(1, round(tg * k / e * z["capacity_factor"]))
        chosen = idx.reshape(g, tg * k)                  # token-major
        onehot = F.one_hot(chosen, e)
        rank = (onehot.cumsum(1) * onehot).sum(-1) - 1
        keep = (rank < cap).reshape(t, k)
        counts = torch.bincount(idx[:, 0], minlength=e).float()
        aux = e * torch.sum(counts / t * probs.mean(0))
        y = torch.zeros_like(xf)
        weight = gates * keep
        for j in range(e):
            tok, slot = torch.nonzero((idx == j) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            out = swiglu(pr, xf[tok], p["gate"][j], p["up"][j], p["down"][j])
            y = y.index_add(0, tok, out * weight[tok, slot, None])
        sh = p["shared"]
        y = y + swiglu(pr, xf, sh["gate"]["w"], sh["up"]["w"], sh["down"]["w"])
        return y.reshape(b, s, d), aux

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        z = self.z
        x = params["embed"]["table"][batch["tokens"]]
        aux = 0.0
        layers = [(params["dense_prefix"], None)] + [
            (params["moe_blocks"], i) for i in range(z["layers"] - 1)]
        for tree, i in layers:
            p = _at(tree, i)
            x = x + self._mla(p["attn"], rmsnorm(x, p["ln1"]["scale"],
                                                 z["eps"]))
            m = rmsnorm(x, p["ln2"]["scale"], z["eps"])
            if i is None:
                f = p["ffn"]
                x = x + swiglu(self.pr, m, f["gate"]["w"], f["up"]["w"],
                               f["down"]["w"])
            else:
                y, a = self._moe(p["ffn"], m)
                x, aux = x + y, aux + a
        x = rmsnorm(x, params["final_norm"]["scale"], z["eps"])
        ce = cross_entropy(self.pr, x, params["head"]["w"], batch["labels"],
                           batch["loss_mask"], z["vocab"])
        return ce + z["aux_coef"] * aux / (z["layers"] - 1)


def _mla_projections(z) -> List[Tuple[int, int]]:
    """(K, N) of MLA's weight products a token goes through: q, the
    latent, the rotary key, the key and value expansions, o."""
    d, h, r = z["d"], z["heads"], z["rank"]
    return [(d, h * (z["nope"] + z["rope"])), (d, r), (d, z["rope"]),
            (r, h * z["nope"]), (r, h * z["v"]), (h * z["v"], d)]


def projections(c: Dict) -> List[Tuple[int, int, int]]:
    """``(K, N, count)`` of the dense projections of the model that run
    through the program's dense-projection path (MLA's q, latent,
    rotary-key and o projections; the dense and shared MLPs)."""
    z = dims(c)
    d, L = z["d"], z["layers"]
    sf = z["shared"] * z["ff_expert"]
    mla = _mla_projections(z)
    return ([(k, n, L) for k, n in (mla[0], mla[1], mla[2], mla[5])]
            + [(d, z["ff"], 2), (z["ff"], d, 1),
               (d, sf, 2 * (L - 1)), (sf, d, L - 1)])


def active_weights(c: Dict) -> int:
    """Weights a token multiplies by in the forward pass: MLA's products,
    the dense MLP, in each MoE layer the router, its top-k experts and
    the shared experts, and the head over the real vocabulary."""
    z = dims(c)
    d, L, f = z["d"], z["layers"], z["ff_expert"]
    mla = sum(k * n for k, n in _mla_projections(z))
    moe = d * z["experts"] + (z["top_k"] + z["shared"]) * 3 * d * f
    return L * mla + 3 * d * z["ff"] + (L - 1) * moe + d * z["vocab"]


def attention_flops(c: Dict, seq: int) -> int:
    """FLOPs of one sequence's causal attention products in the forward
    pass: q k^T over nope + rope dims and p v over the value dims, over
    the S (S + 1) / 2 pairs the mask keeps."""
    z = dims(c)
    pairs = seq * (seq + 1) // 2
    return (2 * pairs * z["heads"] * (z["nope"] + z["rope"] + z["v"])
            * z["layers"])
