"""Training loop: microbatched train step with Kahan gradient
accumulation, checkpointing, auto-resume and a failure hook (counterpart
of ``repro/train/trainer.py``).

``make_train_step`` builds the step

    (params, opt_state, batch) -> (params, opt_state, metrics)

Microbatching: the global batch [B, S] splits into ``microbatches``
slices run one after another; their gradients fold into a
``KahanAccumulator`` in ``accum_dtype`` (bf16-safe: the compensation
recovers the bits bf16 drops when a small microbatch gradient lands on a
large partial sum), their losses by ``kahan_step``. The optimizer runs
once per global step. The accumulator and the optimizer update their
tensors in place (the reference's jitted step donates them).

A ``mesh`` (a ``DeviceMesh`` from ``launch.mesh.make_local_mesh``) with
more than one rank on its "data" axis folds the loss metric through
``distributed.collectives.sharded_asum``, as the reference does; the
gradient path is the same on every rank (every rank computes the whole
step: data parallelism of the batch is ROADMAP A8's).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as _tree
from repro_torch.core.kahan import KahanAccumulator, kahan_step
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import collectives
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, apply_update
from repro_torch.optim import init as opt_init
from repro_torch.optim import schedule as schedules

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    accum_dtype: str = "float32"      # bf16 viable thanks to Kahan accum
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    warmup: int = 20
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def make_train_step(model, cfg: ArchConfig, tc: TrainConfig,
                    mesh=None) -> Callable:
    """Build the train step (``repro/train/trainer.py:49-147``).

    ``mesh``: an optional ``DeviceMesh``. When its "data" axis has more
    than one rank (and microbatching is on), the ``[microbatches]`` loss
    vector folds through ``collectives.sharded_asum``: each rank's block
    through the compensated sum kernel, the (s, c) grids gathered in rank
    order, one two-sum tree; the loss is the same bits on every rank and
    run to run. ``tc.microbatches`` must then divide by the axis size
    (checked here: no silent fallback to the local fold)."""
    n_data = collectives.axis_size(mesh, "data")
    if n_data > 1 and tc.microbatches > 1 and tc.microbatches % n_data:
        raise ValueError(
            f"microbatches ({tc.microbatches}) must divide by the mesh "
            f"data-axis size ({n_data}) for the sharded loss-metric fold "
            "— refusing to silently fall back to the local fold")

    def grads_of(params, batch):
        leaves = _tree.leaves(params)
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, _tree.unflatten(params, list(grads))

    def train_step(params, opt_state, batch):
        adt = getattr(torch, tc.accum_dtype)
        if tc.microbatches <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            n = tc.microbatches

            def split(x, i):
                b = x.shape[0]
                assert b % n == 0, f"batch {b} % microbatches {n}"
                return x[i * (b // n):(i + 1) * (b // n)]

            acc = KahanAccumulator.zeros_like(_tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=adt, device=p.device),
                params))
            loss_s = torch.zeros((), dtype=torch.float32,
                                 device=_tree.leaves(params)[0].device)
            loss_c = torch.zeros_like(loss_s)
            losses = []
            for i in range(n):
                mb = {k: split(v, i) for k, v in batch.items()}
                loss, metrics, grads = grads_of(params, mb)
                # rebinding frees the autograd dtype's gradients before
                # the fold's temporaries are made
                grads = _tree.tree_map(lambda g: g.to(adt), grads)
                acc.add_(grads)
                del grads
                loss_s, loss_c = kahan_step(loss_s, loss_c, loss)
                losses.append(loss.float())
            grads = acc.scale_total_(1.0 / n)
            del acc
            if n_data > 1:
                loss = collectives.sharded_asum(mesh, torch.stack(losses)) / n
            else:
                loss = (loss_s + loss_c) / n

        lr_scale = schedules.warmup_cosine(opt_state.step, warmup=tc.warmup,
                                           total=max(tc.steps, 1))
        params, opt_state, opt_metrics = apply_update(
            tc.opt, params, grads, opt_state, lr_scale=lr_scale)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def batch_to_device(batch: Dict, device: torch.device) -> Dict:
    """numpy batch -> tensors on ``device`` (integer arrays as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


class Trainer:
    """Single-device training driver with checkpoint / auto-resume
    (``repro/train/trainer.py:150-217``). ``failure_hook(step)`` is
    called before each step; the fault-tolerance tests inject simulated
    crashes through it. Parameters come from ``model.init`` on a
    generator seeded with ``seed``, or from the latest checkpoint in
    ``tc.ckpt_dir``. Runs on the card unless ``device`` says otherwise."""

    def __init__(self, cfg: ArchConfig, tc: TrainConfig, data: SyntheticLM,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 seed: int = 0, mesh=None, device: DeviceSpec = None):
        self.cfg = cfg
        self.tc = tc
        self.data = data
        self.failure_hook = failure_hook
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.step_fn = make_train_step(self.model, cfg, tc, mesh=mesh)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = _tree.tree_map(lambda p: p.requires_grad_(),
                                     self.model.init(gen))
        self.opt_state = opt_init(tc.opt, self.params)
        self.step = 0
        self.metrics_history: list = []
        self._maybe_resume()

    # ----------------------------------------------------------- checkpoint
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def _maybe_resume(self):
        tc = self.tc
        if not tc.ckpt_dir or ckpt.latest_step(tc.ckpt_dir) is None:
            return
        tree, step, extras = ckpt.restore(tc.ckpt_dir, self._state_tree())
        self.params = _tree.tree_map(lambda p: p.requires_grad_(),
                                     tree["params"])
        self.opt_state = tree["opt"]
        self.step = step
        self.data.load_state_dict(extras.get("data", {"step": step}))
        log.info("resumed from step %d", step)

    def _save(self):
        if not self.tc.ckpt_dir:
            return
        ckpt.save(self.tc.ckpt_dir, self.step, self._state_tree(),
                  extras={"data": self.data.state_dict()},
                  keep=self.tc.ckpt_keep)

    # ------------------------------------------------------------------ run
    def run(self) -> Dict[str, float]:
        tc = self.tc
        t0 = time.time()
        while self.step < tc.steps:
            if self.failure_hook is not None:
                self.failure_hook(self.step)
            batch = batch_to_device(self.data.batch_at(self.step),
                                    self.device)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            self.data.load_state_dict({"step": self.step})
            if self.step % tc.log_every == 0 or self.step == tc.steps:
                m = {k: float(v) for k, v in metrics.items()
                     if torch.as_tensor(v).dim() == 0}
                m["step"] = self.step
                m["wall_s"] = round(time.time() - t0, 2)
                self.metrics_history.append(m)
                log.info("step %d: %s", self.step,
                         {k: round(v, 4) if isinstance(v, float) else v
                          for k, v in m.items()})
            if self.step % tc.ckpt_every == 0 or self.step == tc.steps:
                self._save()
        return self.metrics_history[-1] if self.metrics_history else {}
