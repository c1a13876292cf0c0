"""The system under test: the port's train step, built as a user of its
trainer builds it (``repro_torch.train.trainer.make_train_step`` over
``repro_torch.models.build_model``), and the readings of its state that
the comparison takes. The only module of the benchmark that imports the
program."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from portbench.reference.common import draw_leaf, get_path, leaf_paths


class Program:
    """The port's training step for configuration file ``cfg`` of family
    ``fam``, traffic ``traffic`` and the cell's ``program`` options
    (``arch``: the program's configuration fields, ``optimizer``: its
    AdamW fields)."""

    def __init__(self, cfg: Dict, fam, traffic: Dict, options: Dict,
                 device: torch.device):
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.optim import AdamWConfig
        from repro_torch.train.trainer import TrainConfig, make_train_step

        base = get_config(cfg["port"]["arch"])
        fields = fam.port_fields(cfg)
        fields.update(options.get("arch", {}))
        for key, value in list(fields.items()):
            sub = getattr(base, key)
            if isinstance(value, dict) and dataclasses.is_dataclass(sub):
                fields[key] = dataclasses.replace(sub, **value)
        self.arch = base.replace(**fields)
        self.opt = AdamWConfig(**{**traffic["optimizer"],
                                  **options.get("optimizer", {})})
        tc = TrainConfig(steps=traffic["schedule"]["total"],
                         microbatches=traffic["microbatches"],
                         warmup=traffic["schedule"]["warmup"], opt=self.opt)
        self.model = build_model(self.arch, device)
        self.step = make_train_step(self.model, self.arch, tc)
        self.moe_layers = getattr(self.model, "moe_layers", 0)

    @staticmethod
    def load_kernels(names: List[str]) -> None:
        """The port's kernel libraries ``names``, loaded from the
        checkout's cache, or built there by nvcc on its first run."""
        from repro_torch.kernels import _build

        for name in names:
            _build.library(name)

    def init(self, params: Dict):
        """The optimizer state of ``params`` (leaves made trainable)."""
        from repro_torch.optim import init

        for p in leaves(params):
            p.requires_grad_(True)
        return init(self.opt, params)

    def update_alone(self, params: Dict, state):
        """One optimizer update on the step's parameters and state, with a
        float32 gradient of the parameters' shapes (a copy of the first
        moments): what the optimizer does in a step, run by itself."""
        from repro_torch.core import tree
        from repro_torch.optim import apply_update

        grads = tree.tree_map(torch.clone, state.m)
        return lambda: apply_update(self.opt, params, grads, state)


def leaves(tree: Dict) -> List[torch.Tensor]:
    return [get_path(tree, p) for p in leaf_paths(tree)]


@torch.no_grad()
def first_gradient_norms(program: Program, state,
                         paths: List[str]) -> torch.Tensor:
    """Each leaf's norm of the first step's gradient as AdamW took it
    (after the clip), worked out from the state after one step: the first
    moment is then (1 - b1) times it."""
    return torch.stack([
        torch.linalg.vector_norm(get_path(state.m, p).double())
        for p in paths]) / (1.0 - program.opt.b1)


@torch.no_grad()
def change_norms(params: Dict, state, layout: Dict, seed: int,
                 paths: List[str]) -> torch.Tensor:
    """Each leaf's norm of the change of the parameters since they were
    made: the value the state carries into the next step (a parameter
    plus its Kahan compensation) less the starting leaf, drawn again from
    the seed one leaf at a time."""
    index = {path: i for i, path in enumerate(layout)}
    out = []
    for p in paths:
        now = get_path(params, p).double()
        if state.comp is not None:
            now = now + get_path(state.comp, p).double()
        start = draw_leaf(layout[p], seed, index[p], now.device).double()
        out.append(torch.linalg.vector_norm(now - start))
        del now, start
    return torch.stack(out)
