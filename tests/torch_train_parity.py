"""Shared body of the per-family train-step parity tests
(``tests/test_torch_train_<family>.py``): the port's ``make_train_step``
against the reference's ``repro.train.make_train_step`` on a family's
smoke config, two steps at microbatches 2, with and without
``kahan_matmul``, the same weights (the reference's init, its biases and
norm scales drawn at random as ``tests/test_torch_configs.py`` draws
them) and the same synthetic batches on both sides.

Parity tier 3 (ROADMAP's training tolerances): each step's loss, ce loss
and grad norm within rtol 1e-6, every parameter after the two steps
within 2e-6 absolute. The first update runs at rate 0 (warmup 1), so the
second is where the two sides' gradients move the weights.

Where a family's gradient test holds its gradients in float64 (the MoE
family: both sides' params and compute in float64 under ``jax.enable_x64``)
or with every float32 cast of the model widened as well (hymba, xLSTM),
the step runs the same way here, with the optimizer, the accumulator and
the norm left as they are: the widening reaches the model's modules
only, on both sides (the reference's through their ``jnp``, the port's
through ``Tensor.float`` while its model's loss and gradients are taken,
and its RoPE frequencies, which the model computes once at build time).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jax_smoke
from repro.data import DataConfig as JaxDataConfig
from repro.kernels import use_policy as jax_policy
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init as jax_opt_init
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import tree as T
from repro_torch.kernels import use_policy
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, init
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.trainer import batch_to_device
from torch_widen import WidenedModel

CPU = torch.device("cpu")
#: the steps' data: 2 microbatches of 2 sequences
SEQ, BATCH, MICRO, STEPS = 16, 4, 2, 2
LR = 1e-3
RTOL, PARAM_ATOL = 1e-6, 2e-6


def perturb(tree, rng):
    """Random q/k/v biases and norm scales/biases (numpy leaves), so the
    parity sees them (``tests/test_torch_configs.py::_perturb``)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] in ("b", "bias", "scale"):
            base = 1.0 if path[-1] == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(np.shape(node))).astype(
                np.asarray(node).dtype)
        return np.asarray(node)

    return walk(tree, ())


class _Wide:
    """A reference module's ``jnp`` with ``float32`` read as float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _wide_freqs(d_head, theta, device):
    """``layers.rope_freqs`` in float64: the widened reference computes
    its RoPE frequencies in float64 at every call."""
    half = d_head // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float64))
    return torch.exp(-log_theta * torch.arange(half, dtype=torch.float64)
                     / half).to(device)


class _NarrowLoss:
    """The reference's model with its (widened) loss and metrics returned
    in float32, as its train step's scan carries them."""

    def __init__(self, model):
        self.model = model

    def loss(self, params, batch):
        loss, metrics = self.model.loss(params, batch)
        return loss.astype(jnp.float32), jax.tree.map(
            lambda m: m.astype(jnp.float32), metrics)


def _data(cfg):
    return JaxSyntheticLM(JaxDataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        vision_patches=cfg.vision.n_patches if cfg.vision else 0,
        d_model=cfg.d_model,
        n_frames=cfg.encoder.n_frames if cfg.encoder else 0))


def train_step_parity(*args, **kw):
    """``_parity`` on one intra-op thread: the smoke step's tensors are a
    few KB, and test files running side by side on every core otherwise
    spend most of their time waiting on each other's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _parity(*args, **kw)
    finally:
        torch.set_num_threads(threads)


def _parity(name, kahan_matmul, monkeypatch=None, x64=False, widen=(),
            bridge=True):
    """Two train steps of ``name``'s smoke config on both sides; asserts
    the tier-3 tolerances and returns the largest parameter gap.

    ``x64``: params, compute, the compensated kernels' compute dtype
    (the Policy) and the microbatch accumulator in float64 on both sides (a float32 accumulator rounds each microbatch's
    gradient, and where two microbatches' terms cancel to a small
    component the rounding of the larger terms is what remains); ``widen``: the
    reference's model modules whose ``jnp.float32`` reads as float64 (and
    the port's ``Tensor.float`` as ``double`` in its model); ``bridge``:
    the port's params through ``params_from_jax`` (else every numpy leaf
    in float64 on both sides, as they are: the bridge holds xLSTM's gate
    leaves to float32)."""
    kw = dict(kahan_matmul=kahan_matmul)
    if x64:
        kw.update(param_dtype="float64", compute_dtype="float64")
    jcfg = jax_smoke(name).replace(**kw)
    cfg = get_smoke(name).replace(**kw)
    step_kw = dict(steps=STEPS + 1, microbatches=MICRO, warmup=1,
                   accum_dtype="float64" if x64 else "float32")
    jtc = JaxTrainConfig(opt=JaxAdamWConfig(lr=LR), **step_kw)
    tc = TrainConfig(opt=AdamWConfig(lr=LR), **step_kw)
    data = _data(cfg)
    policy = dict(compute_dtype="float64") if x64 else {}
    with jax.enable_x64(x64):
        jmodel = jax_build(jcfg)
        # one program: the eager init compiles each of its ops
        jparams = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.key(0))
        np_params = perturb(jax.tree.map(np.asarray, jparams),
                            np.random.default_rng(7))
        if bridge:
            params = params_from_jax(np_params, cfg, CPU)
        else:
            np_params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                                     np_params)
            params = T.tree_map(lambda x: torch.from_numpy(x.copy()),
                                np_params)
        params = T.tree_map(lambda p: p.requires_grad_(), params)
        if widen:
            from repro_torch.models import encdec, hybrid, transformer

            for module in (encdec, hybrid, transformer):
                monkeypatch.setattr(module, "rope_freqs", _wide_freqs)
            for module in widen:
                monkeypatch.setattr(module, "jnp", _Wide())
            model = WidenedModel(build_model(cfg, CPU))
        else:
            model = build_model(cfg, CPU)
        jstep = jax.jit(jax_make_train_step(
            _NarrowLoss(jmodel) if widen else jmodel, jcfg, jtc))
        step = make_train_step(model, cfg, tc)
        jp = jax.tree.map(jnp.asarray, np_params)
        jo = jax_opt_init(jtc.opt, jp)
        opt = init(tc.opt, params)
        for i in range(STEPS):
            batch = data.batch_at(i)
            with jax_policy(**policy), use_policy(**policy):
                jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, batch))
                params, opt, m = step(params, opt,
                                      batch_to_device(batch, CPU))
            for k in ("loss", "ce_loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=RTOL, err_msg=f"{k} {i}")
            if "dropped_frac" in jm:
                assert float(m["dropped_frac"]) == float(jm["dropped_frac"])
        jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    if widen:
        monkeypatch.undo()
    gaps = []
    for want, got in zip(jleaves, T.leaves(params)):
        got = got.detach().numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL)
        gaps.append(float(np.abs(got.astype(np.float64) - want).max()))
    assert int(opt.step) == int(jo.step) == STEPS
    return max(gaps)
