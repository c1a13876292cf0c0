#!/usr/bin/env python3
"""How far the port's training gradients lie from the JAX reference's on
hymba-1.5b's smoke config, over several weight and batch seeds (CPU;
needs jax and the JAX package).

    PYTHONPATH=src python3 scripts/hybrid_grad_parity.py [--seeds 6] [--out FILE]

For each seed: the reference's weights (``init`` at ``key(seed)``, norm
scales, ``D`` and the biases perturbed as ``tests/test_torch_hybrid.py``
does, from ``default_rng(7 + seed)``) carried over by the bridge, one
synthetic batch (seq 40, batch 2, data seed ``seed``; seed 0 is the
test's own case), and the largest difference between the two sides'
gradient leaves, each over its leaf's largest magnitude: the measure the
test holds below 2e-6. Three settings: float32 params and compute;
float64 params and compute (jax's x64 mode), each side still casting to
float32 where its code says so (norms, attention scores and softmax, the
SSM, the loss), the test's setting; and float64 with those casts
widened to float64 on both sides as well (the reference's model modules
see ``jnp.float32`` as float64, the port's ``Tensor.float`` returns
float64), which shows how much of the gap those casts' rounding makes.
Prints one JSON line per (seed, setting), and writes them to ``--out``
when given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = "hymba-1.5b"
SETTINGS = ("float32", "float64", "float64-widened")


def perturb(tree, rng):
    """Norm scales and ``D`` near 1, the biases shifted (numpy leaves)."""
    import numpy as np

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        node = np.asarray(node)
        noise = 0.1 * rng.standard_normal(node.shape)
        if path[-1] in ("scale", "D"):
            return (1.0 + noise).astype(node.dtype)
        if path[-1] in ("b", "conv_b"):
            return (node + noise).astype(node.dtype)
        return node

    return walk(tree, ())


@contextlib.contextmanager
def widened():
    """Both sides' float32 casts in the model compute float64 while
    active."""
    import jax.numpy as jnp
    import torch

    from repro.models import common, hybrid, layers, ssm

    class Wide:
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    modules = (common, hybrid, layers, ssm)
    saved = [m.jnp for m in modules], torch.Tensor.float
    for m in modules:
        m.jnp = Wide()
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        for m, j in zip(modules, saved[0]):
            m.jnp = j
        torch.Tensor.float = saved[1]


def max_grad_diff(seed: int, setting: str):
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

    dt = "float32" if setting == "float32" else "float64"
    kw = dict(param_dtype=dt, compute_dtype=dt)
    cfg = get_smoke(NAME).replace(**kw)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=40,
                                   global_batch=2, seed=seed)).batch_at(0)
    wide = widened() if setting.endswith("widened") else (
        contextlib.nullcontext())
    with jax.enable_x64(dt == "float64"):
        jmodel = jax_build(jax_smoke(NAME).replace(**kw))
        jparams, _ = jmodel.init(jax.random.key(seed))
        np_params = perturb(jax.tree.map(np.asarray, jparams),
                            np.random.default_rng(7 + seed))
    with jax.enable_x64(dt == "float64"), wide:
        _, jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(jnp.asarray, batch))
        jgrads = jax.tree_util.tree_leaves_with_path(jgrads)
        params = T.tree_map(lambda p: p.requires_grad_(),
                            params_from_jax(np_params, cfg, "cpu"))
        loss, _ = build_model(cfg, "cpu").loss(params,
                                               batch_to_device(batch, "cpu"))
        grads = torch.autograd.grad(loss, T.leaves(params))
    worst, where = 0.0, ""
    for (path, want), got in zip(jgrads, grads):
        want = np.asarray(want)
        d = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        if d > worst:
            worst, where = d, jax.tree_util.keystr(path)
    return worst, where


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    rows = []
    for seed in range(args.seeds):
        for setting in SETTINGS:
            worst, where = max_grad_diff(seed, setting)
            row = {"arch": NAME, "seed": seed, "setting": setting,
                   "max_grad_diff_over_leaf_max": worst, "leaf": where}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
