"""Abstract inputs of the dry run's cells (counterpart of
``repro/launch/specs.py``).

Everything here is built under a ``FakeTensorMode`` (the counterpart of
``jax.eval_shape``): parameters, optimizer state, caches and batches are
fake tensors that carry shapes, dtypes and a device and allocate nothing,
so a 400B config costs no memory. The logical spec trees come from the
models' ``param_specs()`` / ``cache_specs()`` and ``opt_state_specs``.
Each function builds under the ambient fake mode, or a new one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import tree as _tree
from repro_torch.distributed import sharding as shd
from repro_torch.models import build_model
from repro_torch.models.common import leaf_dtype
from repro_torch.optim import AdamWConfig, opt_state_specs
from repro_torch.optim import init as opt_init
from repro_torch.train.serve import make_decode_step, make_prefill_step
from repro_torch.train.trainer import TrainConfig, make_train_step


def fake_mode(*trees):
    """The active ``FakeTensorMode``, or that of the fake tensors in
    ``trees``, or a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    leaves = [t for tree in trees for t in _tree.leaves(tree)
              if isinstance(t, torch.Tensor)]
    return detect_fake_mode(leaves) or FakeTensorMode()


def abstract_params(model) -> Tuple[Any, Any]:
    """(params as fake tensors in ``init``'s structure, logical specs)."""
    cfg = model.cfg

    def leaf(node):
        if isinstance(node, dict):
            return {k: leaf(v) for k, v in node.items()}
        return torch.empty(node.shape, dtype=leaf_dtype(node, cfg),
                           device=model.device)

    with fake_mode():
        params = leaf(model.param_spec())
    return params, model.param_specs()


def abstract_cache(model, batch_size: int, max_len: int) -> Tuple[Any, Any]:
    """(``init_cache(batch_size, max_len)`` as fake tensors, its specs)."""
    with fake_mode():
        cache = model.init_cache(batch_size, max_len)
    return cache, model.cache_specs()


def abstract_opt_state(opt_cfg: AdamWConfig, params: Any,
                       params_specs: Any) -> Tuple[Any, Any]:
    with fake_mode(params):
        state = opt_init(opt_cfg, params)
    return state, opt_state_specs(params_specs, opt_cfg)


def batch_struct(cfg: ArchConfig, shape: ShapeSpec,
                 device="cpu") -> Dict[str, Any]:
    """One global batch of ``shape`` as fake tensors (token ids int64, as
    the port's trainer feeds them)."""
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        batch = {
            "tokens": torch.zeros((b, s), dtype=torch.long, device=device),
            "labels": torch.zeros((b, s), dtype=torch.long, device=device),
            "loss_mask": torch.ones((b, s), dtype=torch.float32,
                                    device=device),
        }
        if cfg.vision is not None:
            batch["vision_embeds"] = torch.zeros(
                (b, cfg.vision.n_patches, cfg.d_model), device=device)
        if cfg.encoder is not None:
            batch["frames"] = torch.zeros(
                (b, cfg.encoder.n_frames, cfg.d_model), device=device)
    return batch


@dataclasses.dataclass
class Cell:
    """Everything needed to run one (arch x shape) cell."""

    step_fn: Any                 # the step to run
    args: Tuple[Any, ...]        # abstract args (fake-tensor trees)
    arg_specs: Tuple[Any, ...]   # logical spec trees (None = replicated)
    out_specs: Optional[Tuple[Any, ...]]
    model_flops: float           # useful-FLOPs accounting for the cell


def build_cell(cfg: ArchConfig, shape: ShapeSpec,
               tc: Optional[TrainConfig] = None, *, model=None,
               device="cpu") -> Cell:
    """The cell's step and abstract arguments. The abstract trees come
    from a model built on ``device`` under the fake mode; the step runs
    ``model`` when one is given (a real model, for a run on real
    tensors), else that fake-built model. A decode cell's position is the
    last of the cache (``seq_len - 1``)."""
    with fake_mode():
        return _build_cell(cfg, shape, tc, model, device)


def _build_cell(cfg, shape, tc, model, device) -> Cell:
    abstract_model = build_model(cfg, device)
    model = abstract_model if model is None else model
    params_sh, params_specs = abstract_params(abstract_model)
    n = cfg.param_counts()
    tokens = shape.global_batch * shape.seq_len

    if shape.kind == "train":
        tc = tc or TrainConfig(microbatches=1)
        opt_sh, opt_specs = abstract_opt_state(tc.opt, params_sh,
                                               params_specs)
        return Cell(step_fn=make_train_step(model, cfg, tc),
                    args=(params_sh, opt_sh, batch_struct(cfg, shape,
                                                          device)),
                    arg_specs=(params_specs, opt_specs, "batch"),
                    out_specs=(params_specs, opt_specs, None),
                    model_flops=6.0 * n["active"] * tokens)

    cache_sh, cache_specs = abstract_cache(abstract_model, shape.global_batch,
                                           shape.seq_len)
    if shape.kind == "prefill":
        return Cell(step_fn=make_prefill_step(model),
                    args=(params_sh, batch_struct(cfg, shape, device),
                          cache_sh),
                    arg_specs=(params_specs, "batch", cache_specs),
                    out_specs=(None, cache_specs),
                    model_flops=2.0 * n["active"] * tokens)

    # decode: one new token against a cache of seq_len
    tok = torch.zeros((shape.global_batch,), dtype=torch.long, device=device)
    return Cell(step_fn=make_decode_step(model),
                args=(params_sh, cache_sh, tok, shape.seq_len - 1),
                arg_specs=(params_specs, cache_specs, "tokens1d", None),
                out_specs=(None, cache_specs),
                model_flops=2.0 * n["active"] * shape.global_batch)


def _map_specs(mesh, rules, spec_entry, tree):
    """One Cell arg distributed by its spec entry (the reference's
    ``_map_specs``): "batch" by ``BATCH_LOGICAL``, "tokens1d" over the
    batch axes, a tree by its logical specs (None: replicated); a Python
    int (a decode position) as it is."""
    if not isinstance(tree, (torch.Tensor, dict, tuple)):
        return tree
    if spec_entry == "batch":
        return shd.distribute_batch(mesh, rules, tree)
    if spec_entry == "tokens1d":
        return shd.distribute(mesh, rules, ("batch",), tree)
    return shd.distribute_tree(mesh, rules, spec_entry, tree)


def distribute_args(mesh, rules: shd.Rules, cell: Cell, args=None) -> tuple:
    """The cell's arguments (its abstract ones, or real trees of the same
    structure: every rank's full copy) laid out by its arg specs; a train
    cell's params then track gradients."""
    args = cell.args if args is None else args
    out = tuple(_map_specs(mesh, rules, spec, a)
                for spec, a in zip(cell.arg_specs, args))
    if cell.out_specs is not None and cell.out_specs[0] is not None:
        for p in _tree.leaves(out[0]):          # a train cell
            p.requires_grad_()
    return out


def run_sharded(cell: Cell, mesh, rules: shd.Rules, args: tuple):
    """The cell's step on distributed ``args`` under ``activation_rules``
    (plain tensors the step makes count as replicated)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with shd.activation_rules(mesh, rules), implicit_replication():
        return cell.step_fn(*args)
