#!/usr/bin/env python3
"""How far the port's training gradients lie from the JAX reference's on
the smoke configs, in float32 and in float64 compute, over several
weight and batch seeds (CPU; needs jax and the JAX package).

    PYTHONPATH=src python3 scripts/moe_grad_parity.py [--seeds 6] [--out FILE]

For each config and seed: the reference's weights (``init`` at
``key(seed)``, norm and bias leaves perturbed as
``tests/test_torch_configs.py`` does) carried over by the bridge, one
synthetic batch (seq 16, batch 2, data seed 1234 + ``seed``; seed 0 is
the test's own case), and the largest
difference between the two sides' gradient leaves, each over its leaf's
largest magnitude: the measure ``test_loss_and_grads_within_tolerance``
holds below 2e-6. Then the same with float64 params and compute on
both sides (jax's x64 mode; each side still casts to float32 where its
code says so). Prints one JSON line per (config, seed, dtype), and
writes them to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-7b", "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b")


def perturb(tree, rng):
    """Norm scales and biases drawn near 1 and 0 (numpy leaves)."""
    import numpy as np

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] in ("b", "bias", "scale"):
            base = 1.0 if path[-1] == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(np.shape(node))).astype(
                np.asarray(node).dtype)
        return np.asarray(node)

    return walk(tree, ())


def max_grad_diff(name: str, seed: int, dtype: str) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_smoke as jax_smoke
    from repro.data import DataConfig, SyntheticLM
    from repro.models import build_model as jax_build
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.models import build_model
    from repro_torch.train.trainer import batch_to_device

    cpu = torch.device("cpu")
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    with jax.enable_x64(dtype == "float64"):
        jmodel = jax_build(jax_smoke(name).replace(**kw))
        jparams, _ = jmodel.init(jax.random.key(seed))
        np_params = perturb(jax.tree.map(np.asarray, jparams),
                            np.random.default_rng(7 + seed))
        cfg = get_smoke(name).replace(**kw)
        batch = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
            d_model=cfg.d_model, seed=1234 + seed)).batch_at(0)
        _, jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, batch))
        want = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    params = T.tree_map(lambda p: p.requires_grad_(),
                        params_from_jax(np_params, cfg, cpu))
    loss, _ = build_model(cfg, cpu).loss(params, batch_to_device(batch, cpu))
    got = torch.autograd.grad(loss, T.leaves(params))
    return max(float(np.abs(g.numpy() - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    lines = []
    for name in ARCHS:
        for seed in range(args.seeds):
            for dtype in ("float32", "float64"):
                row = {"arch": name, "seed": seed, "dtype": dtype,
                       "max_rel_grad_diff": max_grad_diff(name, seed, dtype)}
                print(json.dumps(row), flush=True)
                lines.append(json.dumps(row))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
