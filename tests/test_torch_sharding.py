"""The port's sharding layer vs the JAX reference, on the CPU:
``distributed/sharding.py`` (``physical_spec``, ``placements``,
``constrain``), and the sharded train and serve steps that ``build_cell``
and the rules make, on two gloo ranks.

Parity tiers:

* tier 1 (equal): ``physical_spec`` against the reference's on its six
  cases of ``tests/test_distributed.py``, and on every leaf of every
  config's parameter tree at published width under every rule table and
  the meshes {data 16, model 16}, {pod 2, data 16, model 16}, {data 2,
  model 1} and {data 1, model 2}; ``constrain`` is the identity outside
  ``activation_rules`` and lays a DTensor out by ``physical_spec`` inside
  (a fake world of 256 ranks, set up and torn down in the test).
* tier 2 (bitwise within the port): the sharded global norm is the same
  bits on both ranks and run to run, under the column scan and under B3;
  both ranks' logits are the same bits.
* tier 3: the sharded train step on a (data 2, model 1) mesh against the
  reference's unsharded ``make_train_step``: loss and grad norm within
  1e-5 relative; prefill (``kahan_attention``: B7's plain version on each
  rank's heads) and four decode steps on a (data 1, model 2) mesh, the
  KV cache sharded on its positions, against the reference's steps:
  logits within 1e-5 relative L2, the same argmax. A smoke config with
  16 heads (so that "heads" shards), float32 compute, bridged weights.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
DATA = dict(seq_len=32, global_batch=4)
PROMPT, MAX_LEN, DECODE = 32, 64, 4
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 1}, {"data": 1, "model": 2}]
TABLES = ["train", "train_nosp", "serve"]


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


# ---------------------------------------------------------------------------
# physical_spec (tier 1)
# ---------------------------------------------------------------------------

REFERENCE_CASES = {
    # tests/test_distributed.py, case for case
    "basic": ({"data": 1, "model": 1}, "train", ("embed", "mlp"), (128, 256)),
    "divisibility_degrades": ({"model": 1}, {"heads": "model"}, ("heads",),
                              (5,)),
    "absent_axis_dropped": ({"data": 1, "model": 1}, "train",
                            ("batch", None), (8, 16)),
    "no_axis_reuse": ({"model": 2}, {"a": "model", "b": "model"},
                      ("a", "b"), (4, 4)),
    "heads_25_on_16": ({"model": 16}, {"heads": "model", "kv_seq": "model"},
                       ("heads",), (25,)),
    "kv_seq_on_16": ({"model": 16}, {"heads": "model", "kv_seq": "model"},
                     (None, "kv_seq"), (4, 32768)),
}


def _rules(table):
    if isinstance(table, dict):
        return shd.Rules("t", table), jshd.Rules("t", table)
    return shd.RULES[table], {"train": jshd.TRAIN_RULES,
                              "train_nosp": jshd.TRAIN_NOSP_RULES,
                              "serve": jshd.SERVE_RULES}[table]


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_physical_spec_reference_cases(case):
    """The reference's six sharding cases: the port's answer is the
    reference's, dim for dim."""
    shape_of_mesh, table, logical, shape = REFERENCE_CASES[case]
    port_rules, ref_rules = _rules(table)
    mesh = _mesh(shape_of_mesh)
    want = jshd.physical_spec(mesh, ref_rules, P(*logical), shape)
    assert shd.physical_spec(mesh, port_rules, logical, shape) == tuple(want)


def _leaves_with_specs(specs, shapes):
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _leaves_with_specs(specs[k], shapes[k])
    else:
        yield specs, shapes


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", list(list_archs()))
def test_physical_spec_every_param_leaf(arch, table):
    """Every leaf of the published config's parameter tree (the port's
    specs and shapes; the reference's through ``jax.eval_shape``) on every
    mesh: the same physical spec."""
    port_rules, ref_rules = _rules(table)
    model = build_model(get_config(arch), torch.device("cpu"))
    ref_shapes, ref_specs = jspecs.abstract_params(jax_build(jax_config(arch)))
    port = list(_leaves_with_specs(model.param_specs(), model.param_spec()))
    ref = list(_leaves_with_specs(ref_specs, ref_shapes))
    assert len(port) == len(ref)
    for shape in MESHES:
        mesh = _mesh(shape)
        for (spec, leaf), (rspec, rleaf) in zip(port, ref):
            assert tuple(leaf.shape) == tuple(rleaf.shape)
            want = jshd.physical_spec(mesh, ref_rules, rspec, rleaf.shape)
            got = shd.physical_spec(mesh, port_rules, spec, leaf.shape)
            assert got == tuple(want), (shape, spec, leaf.shape)


def test_constrain_is_identity_outside_a_context():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "batch", None) is x
    with shd.activation_rules(_mesh({"data": 2}), shd.TRAIN_RULES):
        assert shd.constrain(x, "batch", None) is x      # a plain tensor


@pytest.fixture
def fake_world():
    """A fake process group of 256 ranks in this process, torn down after
    the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_constrain_places_by_physical_spec(fake_world):
    """On a fake 16 x 16 mesh, under TRAIN_RULES, ``constrain`` lays a
    replicated activation out by ``physical_spec``: batch on data, seq on
    model; ("pod", "data") shards one dimension over two mesh dims."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device_type="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 4096, 2048), mesh,
                              [Replicate(), Replicate()])
        with shd.activation_rules(mesh, shd.TRAIN_RULES):
            y = shd.constrain(x, "batch", "seq", None)
            z = shd.constrain(y, "batch", "seq", None)
    spec = shd.physical_spec(mesh, shd.TRAIN_RULES, ("batch", "seq", None),
                             (256, 4096, 2048))
    assert spec == ("data", "model")
    assert tuple(y.placements) == shd.placements(mesh, spec) == (Shard(0),
                                                                 Shard(1))
    assert z is y
    assert shd.placements(types.SimpleNamespace(
        mesh_dim_names=("pod", "data", "model")),
        (("pod", "data"), None, "model")) == (Shard(0), Shard(0), Shard(2))


def test_make_production_mesh_needs_its_world(fake_world):
    from repro_torch.launch.mesh import make_production_mesh

    assert make_production_mesh(device_type="cpu").shape == (16, 16)
    with pytest.raises(ValueError, match="world size is 256"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_a_dtensor_never_reaches_a_kernel_entry(fake_world):
    """A DTensor handed to a kernel entry raises TypeError naming it:
    sharded callers pass their local shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels.engine import CompensatedReduction
    from repro_torch.kernels.kahan_columns import column_sq_accumulators
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device_type="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 1024), mesh,
                              [Shard(0), Shard(1)])
        with pytest.raises(TypeError, match="column_sq_accumulators"):
            column_sq_accumulators(x)
        with pytest.raises(TypeError, match="sum_accumulators"):
            CompensatedReduction().asum(x)


# ---------------------------------------------------------------------------
# The sharded steps on two gloo ranks (tiers 2 and 3)
# ---------------------------------------------------------------------------

def _smoke(get_smoke):
    """OLMo's smoke config with 16 heads (the production TP=16 divides
    them, so "heads" shards) and float32 compute."""
    return get_smoke("olmo-1b").replace(
        n_heads=16, n_kv_heads=16, d_model=128, d_ff=256, loss_chunk=16)


def _prompt(vocab):
    return np.random.default_rng(7).integers(0, vocab, size=(2, PROMPT))


def _reference(out: str) -> dict:
    from repro.configs import get_smoke
    from repro.data import DataConfig, SyntheticLM
    from repro.optim import AdamWConfig
    from repro.optim import init as opt_init
    from repro.train import TrainConfig, make_train_step
    from repro.train.serve import make_decode_step, make_prefill_step

    cfg = _smoke(get_smoke)
    model = jax_build(cfg)
    params, _ = model.init(jax.random.key(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    batch = jax.tree.map(jnp.asarray, data.batch_at(0))
    res = {}
    for kn in (True, False):
        tc = TrainConfig(steps=3, warmup=1,
                         opt=AdamWConfig(lr=1e-3, kahan_norm=kn))
        step = jax.jit(make_train_step(model, cfg, tc))
        _, _, m = step(params, opt_init(tc.opt, params), batch)
        res[f"loss_{kn}"], res[f"norm_{kn}"] = m["loss"], m["grad_norm"]
    smodel = jax_build(cfg.replace(kahan_attention=True))
    cache, _ = smodel.init_cache(2, MAX_LEN)
    toks = jnp.asarray(_prompt(cfg.vocab_size), jnp.int32)
    logits, cache = make_prefill_step(smodel)(params, {"tokens": toks}, cache)
    res["prefill"] = logits
    decode = jax.jit(make_decode_step(smodel))
    for i in range(DECODE):
        tok = jnp.argmax(logits[:, :cfg.vocab_size], -1).astype(jnp.int32)
        logits, cache = decode(params, cache, tok, jnp.int32(PROMPT + i))
        res[f"decode_{i}"] = logits
    with open(out, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return {k: np.asarray(v) for k, v in res.items()}


def _port(rank: int, store: str, params_pkl: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.specs import (build_cell, distribute_args,
                                          run_sharded)
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import init as opt_init
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import batch_to_device

    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    cpu = torch.device("cpu")
    cfg = _smoke(get_smoke)
    with open(params_pkl, "rb") as f:
        jparams = pickle.load(f)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    batch = batch_to_device(data.batch_at(0), cpu)
    res = {}
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    model = build_model(cfg, cpu)
    shape = ShapeSpec("train", "train", DATA["seq_len"],
                      DATA["global_batch"])
    for kn in (True, False):
        for run in range(2):
            tc = TrainConfig(steps=3, warmup=1,
                             opt=AdamWConfig(lr=1e-3, kahan_norm=kn))
            cell = build_cell(cfg, shape, tc, model=model)
            params = params_from_jax(jparams, cfg, cpu)
            args = distribute_args(mesh, shd.TRAIN_RULES, cell,
                                   (params, opt_init(tc.opt, params), batch))
            _, _, m = run_sharded(cell, mesh, shd.TRAIN_RULES, args)
            res[f"loss_{kn}_{run}"] = m["loss"].full_tensor()
            res[f"norm_{kn}_{run}"] = m["grad_norm"]
    smesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    scfg = cfg.replace(kahan_attention=True)
    smodel = build_model(scfg, cpu)
    rules = shd.SERVE_RULES
    pcell = build_cell(scfg, ShapeSpec("p", "prefill", MAX_LEN, 2),
                       model=smodel)
    dcell = build_cell(scfg, ShapeSpec("d", "decode", MAX_LEN, 2),
                       model=smodel)
    toks = torch.from_numpy(_prompt(cfg.vocab_size)).long()
    params, batch, cache = distribute_args(
        smesh, rules, pcell, (params_from_jax(jparams, scfg, cpu),
                              {"tokens": toks}, smodel.init_cache(2, MAX_LEN)))
    res["cache_placements"] = np.array(
        str(cache["blocks"][0].placements))
    logits, cache = run_sharded(pcell, smesh, rules, (params, batch, cache))
    res["prefill"] = logits.full_tensor()
    for i in range(DECODE):
        tok = torch.argmax(logits.full_tensor()[:, :cfg.vocab_size], -1)
        tok = distribute_args(smesh, rules, dcell,
                              (None, None, tok, None))[2]
        logits, cache = run_sharded(dcell, smesh, rules,
                                    (params, cache, tok, PROMPT + i))
        res[f"decode_{i}"] = logits.full_tensor()
    dist.barrier()
    dist.destroy_process_group()
    np.savez(out, **{k: v.detach().numpy() if isinstance(v, torch.Tensor)
                     else v for k, v in res.items()})


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    ref = _reference(str(tmp / "params.pkl"))
    ranks = [subprocess.Popen(
        [sys.executable, __file__, "port", str(r), str(tmp / "store"),
         str(tmp / "params.pkl"), str(tmp / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=_env()) for r in range(WORLD)]
    for r, p in enumerate(ranks):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    return ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("kahan_norm", [True, False])
def test_sharded_train_step_within_tolerance(steps, kahan_norm):
    """Tier 3: the data-parallel step's loss and grad norm (the norm over
    each rank's shards, gathered and folded) within 1e-5 relative of the
    reference's unsharded step."""
    ref, ranks = steps
    for got in ranks:
        for q in ("loss", "norm"):
            want = float(ref[f"{q}_{kahan_norm}"])
            assert abs(float(got[f"{q}_{kahan_norm}_0"]) - want) \
                <= 1e-5 * abs(want), q


@pytest.mark.parametrize("kahan_norm", [True, False])
def test_sharded_norm_bitwise_between_ranks_and_runs(steps, kahan_norm):
    """Tier 2: the grad norm and loss are the same bits on both ranks and
    in two runs."""
    _, ranks = steps
    for q in ("loss", "norm"):
        want = ranks[0][f"{q}_{kahan_norm}_0"]
        for got in ranks:
            for run in range(2):
                assert np.array_equal(got[f"{q}_{kahan_norm}_{run}"], want)


@pytest.mark.parametrize("step", ["prefill"] + [f"decode_{i}"
                                                for i in range(DECODE)])
def test_sharded_serve_steps_within_tolerance(steps, step):
    """Tier 3: prefill (B7's plain version on each rank's 8 heads) and
    decode against the position-sharded cache: logits within 1e-5
    relative L2 of the reference's and the same argmax; both ranks the
    same bits."""
    ref, ranks = steps
    vocab = 512
    want = ref[step][:, :vocab].astype(np.float64)
    for got in ranks:
        assert "Shard(dim=2)" in str(got["cache_placements"])
        g = got[step][:, :vocab]
        assert np.linalg.norm(g - want) <= 1e-5 * np.linalg.norm(want)
        assert (g.argmax(-1) == want.argmax(-1)).all()
        assert np.array_equal(got[step], ranks[0][step])


if __name__ == "__main__":
    if sys.argv[1] == "port":
        _port(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
