"""The port's checkpoint manager (``repro_torch.checkpoint``): exact round
trips in the reference's on-disk format, keep-N, the commit marker, shape
checks, and checkpoints exchanged with the JAX package bit for bit
(parity tier 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.configs import get_smoke as jax_smoke
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init as jax_opt_init
from repro_torch import checkpoint as ckpt
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import tree as T
from repro_torch.optim import AdamWConfig, init

CPU = torch.device("cpu")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g),
            "b": torch.randn(5, generator=g).bfloat16(),
            "n": {"i": torch.arange(6, dtype=torch.int32),
                  "d": torch.randn(2, 2, generator=g).double()}}


def _equal(a, b) -> bool:
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip_exact(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree, extras={"data": {"step": 7}})
    target = T.tree_map(torch.zeros_like, tree)
    got, step, extras = ckpt.restore(str(tmp_path), target)
    assert step == 7 and extras == {"data": {"step": 7}}
    assert _equal(got, tree)


def test_keep_n_prunes(tmp_path):
    for s in range(5):
        ckpt.save(str(tmp_path), s, _tree(s), keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_incomplete_checkpoint_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    ckpt.save(str(tmp_path), 2, _tree(1))
    (tmp_path / "step_00000002" / ".complete").unlink()
    (tmp_path / "step_00000003.tmp").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 1
    got, step, _ = ckpt.restore(str(tmp_path),
                                T.tree_map(torch.zeros_like, _tree()))
    assert step == 1 and _equal(got, _tree())


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    target = _tree()
    target["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), target)
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), {"missing": torch.zeros(1)})


def _jax_state(param_dtype):
    cfg = jax_smoke("olmo-1b").replace(param_dtype=param_dtype)
    params, _ = jax_build(cfg).init(jax.random.key(3))
    opt = jax_opt_init(JaxAdamWConfig(), params)
    rng = np.random.default_rng(0)
    opt = opt._replace(
        step=jnp.int32(5),
        m=jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape), jnp.float32), opt.m),
        comp=jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape) * 1e-3, x.dtype), opt.comp))
    return cfg, params, opt


def _port_target(param_dtype):
    cfg = get_smoke("olmo-1b").replace(param_dtype=param_dtype)
    from repro_torch.models import build_model

    params = build_model(cfg, CPU).init(torch.Generator().manual_seed(1))
    return cfg, {"params": params, "opt": init(AdamWConfig(), params)}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, param_dtype):
    """A trainer state saved by ``repro.checkpoint`` restores into the
    port's tree, every leaf bit for bit (bf16 params and comp too)."""
    jcfg, params, opt = _jax_state(param_dtype)
    jax_ckpt.save(str(tmp_path), 5, {"params": params, "opt": opt},
                  extras={"data": {"step": 5}})
    cfg, target = _port_target(param_dtype)
    got, step, extras = ckpt.restore(str(tmp_path), target)
    assert step == 5 and extras == {"data": {"step": 5}}
    want = {"params": params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      CPU)}
    assert _equal(got["params"], want["params"])
    assert int(got["opt"].step) == 5 and got["opt"].step.dtype == torch.int32
    for j, t in zip(jax.tree.leaves((opt.m, opt.v, opt.comp)),
                    T.leaves((got["opt"].m, got["opt"].v, got["opt"].comp))):
        j = np.asarray(j)
        if j.dtype.name == "bfloat16":
            j = j.view(np.uint16)
            t = t.view(torch.int16).numpy().view(np.uint16)
        else:
            t = t.numpy()
        assert j.dtype == t.dtype and np.array_equal(j, t)


def test_port_checkpoint_restores_into_jax(tmp_path):
    """And the other way: the port's save restores into the reference."""
    cfg, state = _port_target("bfloat16")
    ckpt.save(str(tmp_path), 2, state)
    jcfg, params, opt = _jax_state("bfloat16")
    tree, step, _ = jax_ckpt.restore(str(tmp_path),
                                     {"params": params, "opt": opt})
    assert step == 2
    for j, t in zip(jax.tree.leaves(tree), T.leaves(state)):
        j = np.asarray(j)
        if j.dtype.name == "bfloat16":
            assert np.array_equal(j.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(j, t.numpy())
