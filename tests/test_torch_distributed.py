"""The port's distributed slice vs the JAX reference, on the CPU.

The port runs in two processes, one rank each, over gloo (a ``FileStore``
in ``tmp_path``: no TCP port); the reference runs once in a subprocess
with two forced host devices (the flag must not leak into this process),
its Pallas kernels in interpret mode. Both take the same numpy inputs
(``_inputs``) and write what they compute to ``.npz`` files that the tests
below compare. Parity tiers:

* tier 1 (bitwise against the reference): ``sharded_asum`` and
  ``sharded_dot`` for every built-in scheme at U = 2, ``sharded_matmul``
  on K-blocks of one product a row (the fold checked, not XLA's order
  within a block), ``deterministic_mean``, ``compressed_psum``,
  ``compensated_psum_scalar``, ``activation_sq_norm(mesh=...)``, a
  scheme registered at runtime through ``sharded_asum``; in this
  process, ``quantize`` / ``dequantize``, ``ef_step`` and the lane
  reductions.
* tier 2 (bitwise within the port): both ranks hold the same bits;
  ``merge_sharded_accumulators`` on the gathered grids equals
  ``merge_accumulators`` on the same grids stacked on one rank; the
  trainer's loss is the same bits run to run.
* tier 3: ``sharded_matmul`` on a dense K within 1e-6 of ``|a| @ |b|``
  (``tests/test_torch_matmul.py``'s tolerance); the trainer's sharded
  loss within rtol 1e-6 of the reference's 2-device trainer (the
  train-step tolerance of ``tests/test_torch_train.py``).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SCHEMES = ["naive", "kahan", "pairwise", "dot2"]
WORLD = 2
DATA = dict(seq_len=32, global_batch=4)
TRAIN_STEPS = 2
MATMUL_BLOCK_K = 128


def _inputs():
    """The numpy inputs of every sharded case (seeded)."""
    rng = np.random.default_rng(2026)

    def wide(*shape):
        e = rng.integers(-8, 8, size=shape)
        return (rng.standard_normal(shape) * np.exp2(e)).astype(np.float32)

    # one nonzero a row in each 128-column K-block of each rank's slice:
    # every block product is one rounded product, in any order, so the
    # sharded fold is checked bit for bit (XLA's dot orders a dense block
    # its own way: tier 3, ``matmul_dense``)
    k_rank = 300
    sparse = np.zeros((5, WORLD * k_rank), np.float32)
    for r in range(WORLD):
        for lo in range(0, k_rank, MATMUL_BLOCK_K):
            hi = min(lo + MATMUL_BLOCK_K, k_rank)
            cols = r * k_rank + rng.integers(lo, hi, size=5)
            sparse[np.arange(5), cols] = wide(5)
    return {
        "sparse": sparse,
        "x": wide(WORLD * 3001),
        "y": wide(WORLD * 3001),
        "a": wide(5, WORLD * 300),
        "b": wide(WORLD * 300, 130),
        "values": np.array([1.25, -3.5e-3], np.float32),
        "leaves": wide(WORLD, 64, 33),
        "pairs": np.array([[3.0, 1e-7], [-1.5, 2.5e-8]], np.float32),
        "act": wide(4, 57),
    }


def _toy_update(two_sum):
    """A scheme no kernel has: TwoSum accumulation (as
    ``tests/test_schemes.py``'s toy), given each package's ``two_sum``."""
    def update(s, c, x, step):
        s, e = two_sum(s, x)
        return s, c + e
    return update


# ---------------------------------------------------------------------------
# The reference (a subprocess with two host devices)
# ---------------------------------------------------------------------------

def _reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke
    from repro.core import compat
    from repro.core import kahan as JK
    from repro.data import DataConfig, SyntheticLM
    from repro.distributed import collectives as coll
    from repro.distributed.compression import compressed_psum
    from repro.kernels import schemes
    from repro.models import build_model
    from repro.models.layers import activation_sq_norm
    from repro.optim import AdamWConfig
    from repro.optim import init as opt_init
    from repro.train import TrainConfig, make_train_step

    assert len(jax.devices()) == WORLD
    mesh = jax.make_mesh((WORLD,), ("data",))
    toy = schemes.CompensationScheme(
        name="toy-sum2", update=_toy_update(JK.two_sum),
        instruction_mix=schemes.InstructionMix(adds=7, muls=1),
        error_bound=schemes.NAIVE.error_bound)
    schemes.register(toy)

    def cases(d):
        # one jit over every case: the eager shard_map path compiles each
        # call on its own (seconds each in interpret mode)
        res = {}
        for name in SCHEMES:
            res[f"asum_{name}"] = coll.sharded_asum(mesh, d["x"],
                                                    scheme=name, unroll=2)
            res[f"dot_{name}"] = coll.sharded_dot(mesh, d["x"], d["y"],
                                                  scheme=name, unroll=2)
        res["matmul"] = coll.sharded_matmul(mesh, d["sparse"], d["b"],
                                            block_k=MATMUL_BLOCK_K)
        res["matmul_dense"] = coll.sharded_matmul(mesh, d["a"], d["b"])
        res["mean"] = coll.deterministic_mean(mesh, d["values"])
        res["compressed"] = compat.shard_map(
            lambda v: compressed_psum(v[0], "data"), mesh=mesh,
            in_specs=P("data"), out_specs=P(), check_vma=False)(d["leaves"])
        res["psum_s"], res["psum_c"] = compat.shard_map(
            lambda p: JK.compensated_psum_scalar(p[0, 0], p[0, 1], "data"),
            mesh=mesh, in_specs=P("data"), out_specs=P(),
            check_vma=False)(d["pairs"])
        res["act"] = activation_sq_norm(d["act"], mesh=mesh)
        res["toy"] = coll.sharded_asum(mesh, d["x"], scheme="toy-sum2",
                                       unroll=2)
        return res

    res = jax.jit(cases)({k: jnp.asarray(v) for k, v in _inputs().items()})
    schemes.unregister("toy-sum2")

    cfg = get_smoke("olmo-1b").replace(loss_chunk=16)
    model = build_model(cfg)
    params, _ = model.init(jax.random.key(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    tc = TrainConfig(steps=3, microbatches=2, warmup=1,
                     opt=AdamWConfig(lr=1e-3))
    step = jax.jit(make_train_step(model, cfg, tc, mesh=mesh))
    p, o = params, opt_init(tc.opt, params)
    losses = []
    for i in range(TRAIN_STEPS):
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, data.batch_at(i)))
        losses.append(m["loss"])
    res["train_loss"] = jnp.stack(losses)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    with open(out + ".params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)


# ---------------------------------------------------------------------------
# The port (one process a rank)
# ---------------------------------------------------------------------------

def _port(rank: int, store: str, params_pkl: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_smoke
    from repro_torch.core import kahan as TK
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.kernels import schemes
    from repro_torch.kernels.engine import (CompensatedReduction,
                                            merge_accumulators)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import activation_sq_norm
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import init as opt_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import batch_to_device

    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    cpu = torch.device("cpu")
    mesh = make_local_mesh(device=cpu)
    group = mesh.get_group("data")
    d = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    res = {}
    for name in SCHEMES:
        res[f"asum_{name}"] = coll.sharded_asum(mesh, d["x"], scheme=name,
                                                unroll=2)
        res[f"dot_{name}"] = coll.sharded_dot(mesh, d["x"], d["y"],
                                              scheme=name, unroll=2)
    res["matmul"] = coll.sharded_matmul(mesh, d["sparse"], d["b"],
                                        block_k=MATMUL_BLOCK_K)
    res["matmul_dense"] = coll.sharded_matmul(mesh, d["a"], d["b"])
    res["mean"] = coll.deterministic_mean(mesh, d["values"])
    res["compressed"] = compressed_psum(d["leaves"][rank], group)
    res["psum_s"], res["psum_c"] = TK.compensated_psum_scalar(
        d["pairs"][rank, 0], d["pairs"][rank, 1], group)
    res["act"] = activation_sq_norm(d["act"], mesh=mesh)
    # the gathered fold against the single-device tree on the same grids
    eng = CompensatedReduction(scheme="kahan", unroll=2)
    shards = d["x"].reshape(WORLD, -1)
    grids = [eng.sum_accumulators(s) for s in shards]
    mine = grids[rank]
    res["merge_gathered"] = coll.merge_sharded_accumulators(
        TK.gather_ranks(mine.s, group), TK.gather_ranks(mine.c, group))
    res["merge_single"] = merge_accumulators(
        torch.stack([g.s for g in grids]), torch.stack([g.c for g in grids]))
    toy = schemes.CompensationScheme(
        name="toy-sum2", update=_toy_update(TK.two_sum),
        instruction_mix=schemes.InstructionMix(adds=7, muls=1),
        error_bound=schemes.NAIVE.error_bound)
    schemes.register(toy)
    res["toy"] = coll.sharded_asum(mesh, d["x"], scheme="toy-sum2", unroll=2)
    schemes.unregister("toy-sum2")

    cfg = get_smoke("olmo-1b").replace(loss_chunk=16)
    model = build_model(cfg, cpu)
    with open(params_pkl, "rb") as f:
        jparams = pickle.load(f)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    tc = TrainConfig(steps=3, microbatches=2, warmup=1,
                     opt=AdamWConfig(lr=1e-3))
    for run in range(2):
        step = make_train_step(model, cfg, tc, mesh=mesh)
        params = T.tree_map(lambda p: p.requires_grad_(),
                            params_from_jax(jparams, cfg, cpu))
        opt = opt_init(tc.opt, params)
        losses = []
        for i in range(TRAIN_STEPS):
            params, opt, m = step(params, opt,
                                  batch_to_device(data.batch_at(i), cpu))
            losses.append(m["loss"])
        res[f"train_loss_{run}"] = torch.stack(losses)
    try:
        make_train_step(model, cfg, TrainConfig(microbatches=3), mesh=mesh)
        res["indivisible"] = np.array("no error")
    except ValueError as e:
        res["indivisible"] = np.array(str(e))
    dist.barrier()
    dist.destroy_process_group()
    np.savez(out, **{k: v.detach().numpy() if isinstance(v, torch.Tensor)
                     else v for k, v in res.items()})


# ---------------------------------------------------------------------------
# Fixtures: one reference subprocess, one two-rank port run
# ---------------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2", **extra)
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    ref = str(tmp / "reference.npz")
    flags = (os.environ.get("XLA_FLAGS", "") +
             f" --xla_force_host_platform_device_count={WORLD}").strip()
    proc = subprocess.run(
        [sys.executable, __file__, "reference", ref], capture_output=True,
        text=True, timeout=600, cwd=ROOT, env=_env(XLA_FLAGS=flags))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = [subprocess.Popen(
        [sys.executable, __file__, "port", str(r), str(tmp / "store"),
         ref + ".params.pkl", str(tmp / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=_env()) for r in range(WORLD)]
    for r, p in enumerate(ranks):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    load = lambda f: dict(np.load(f))  # noqa: E731
    return load(ref), [load(tmp / f"rank{r}.npz") for r in range(WORLD)]


def _same(want, got) -> bool:
    want, got = np.atleast_1d(want), np.atleast_1d(got)
    return (want.dtype == got.dtype and want.shape == got.shape
            and np.array_equal(want.view(np.uint8), got.view(np.uint8)))


CASES = ([f"asum_{s}" for s in SCHEMES] + [f"dot_{s}" for s in SCHEMES]
         + ["matmul", "mean", "compressed", "psum_s", "psum_c", "toy"])


@pytest.mark.parametrize("case", CASES)
def test_sharded_bitwise(results, case):
    """Tier 1: each sharded result equals the reference's 2-device result
    bit for bit, on both ranks."""
    ref, ranks = results
    for r, got in enumerate(ranks):
        assert _same(ref[case], got[case]), (case, r, ref[case], got[case])


def test_sharded_matmul_dense_within_tolerance(results):
    """Tier 3 on a dense K: each block product is formed in its own
    order on each side (the port's ascending chain, XLA's ``dot``), so
    the products agree within 1e-6 of ``|a| @ |b|`` elementwise, the
    tolerance of ``tests/test_torch_matmul.py``."""
    ref, ranks = results
    d = _inputs()
    scale = np.abs(d["a"].astype(np.float64)) @ np.abs(d["b"])
    for got in ranks:
        assert _same(ranks[0]["matmul_dense"], got["matmul_dense"])
        err = np.abs(got["matmul_dense"].astype(np.float64)
                     - ref["matmul_dense"])
        assert (err <= 1e-6 * scale).all(), (err / scale).max()


def test_activation_sq_norm_per_rank(results):
    """Tier 1: each rank's norms are its block of the reference's
    batch-sharded result (one B4 launch a rank on the card)."""
    ref, ranks = results
    for r, got in enumerate(ranks):
        assert _same(ref["act"][2 * r:2 * r + 2], got["act"]), r


def test_merge_sharded_equals_single_device_tree(results):
    """Tier 2: the fold of the gathered grids equals the single-device
    tree on the same grids stacked, and the reference's sharded sum."""
    ref, ranks = results
    for got in ranks:
        assert _same(got["merge_single"], got["merge_gathered"])
        assert _same(ref["asum_kahan"], got["merge_gathered"])


def test_trainer_sharded_loss(results):
    """Tier 3 against the reference's 2-device trainer (rtol 1e-6);
    tier 2: the same bits on both ranks and run to run."""
    ref, ranks = results
    for got in ranks:
        assert _same(got["train_loss_0"], got["train_loss_1"])
        assert _same(ranks[0]["train_loss_0"], got["train_loss_0"])
        np.testing.assert_allclose(got["train_loss_0"], ref["train_loss"],
                                   rtol=1e-6)


def test_trainer_refuses_indivisible_microbatches(results):
    for got in results[1]:
        assert "must divide" in str(got["indivisible"])


# ---------------------------------------------------------------------------
# Local functions, in this process
# ---------------------------------------------------------------------------

def _wide(shape, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(-12, 12, size=shape)
    return (rng.standard_normal(shape) * np.exp2(e)).astype(np.float32)


def test_quantize_dequantize_bitwise():
    """Tier 1: int8 codes and their dequantized values."""
    import jax.numpy as jnp
    import torch

    from repro.distributed import compression as JC
    from repro_torch.distributed import compression as TC

    g = _wide((64, 33), seed=3)
    for scale in (np.float32(np.abs(g).max()), np.float32(0.0),
                  np.float32(1e-3)):
        jq = JC.quantize(jnp.asarray(g), jnp.asarray(scale))
        tq = TC.quantize(torch.from_numpy(g), torch.tensor(scale))
        assert _same(jq, tq.numpy())
        assert _same(JC.dequantize(jq, jnp.asarray(scale)),
                     TC.dequantize(tq, torch.tensor(scale)).numpy())


def test_ef_step_bitwise():
    """Tier 1: one error-feedback round over a small tree, then a second
    with the carried errors."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.distributed import compression as JC
    from repro_torch.distributed import compression as TC

    grads = {"w": _wide((16, 9), seed=4), "b": _wide((9,), seed=5)}
    errs = {k: np.zeros_like(v) for k, v in grads.items()}
    jg = jax.tree.map(jnp.asarray, grads)
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    je, te = jax.tree.map(jnp.asarray, errs), {
        k: torch.from_numpy(v) for k, v in errs.items()}
    for _ in range(2):
        jq, je = JC.ef_step(jg, je)
        tq, te = TC.ef_step(tg, te)
        for k in grads:
            assert _same(jq[k][0], tq[k][0].numpy())
            assert _same(jq[k][1], tq[k][1].numpy())
            assert _same(je[k], te[k].numpy())


@pytest.mark.parametrize("name", ["kahan_sum", "kahan_dot", "kahan_dot2",
                                  "naive_sum", "naive_dot"])
def test_lane_reductions_bitwise(name):
    """Tier 1: the paper's lane-parallel reductions (scan loops in the
    reference, so their products contract into fmas) at lengths below,
    at and off the lane count, and a lane count that is odd."""
    import jax.numpy as jnp
    import torch

    from repro.core import kahan as JK
    from repro_torch.core import kahan as TK

    for n, lanes in ((1, 128), (127, 128), (1000, 128), (3001, 128),
                     (1000, 7)):
        a, b = _wide((n,), seed=n), _wide((n,), seed=n + 1)
        args = (a,) if name.endswith("sum") else (a, b)
        kw = {} if name.startswith("naive") else {"lanes": lanes}
        want = getattr(JK, name)(*map(jnp.asarray, args), **kw)
        got = getattr(TK, name)(*map(torch.from_numpy, args), **kw)
        assert _same(want, got.numpy()), (name, n, lanes)


@pytest.mark.parametrize("lanes", [1, 5, 128])
def test_lane_partials_and_merge_bitwise(lanes):
    """Tier 1: the lane partials and the lane merge, an odd lane count
    folding its last lane first."""
    import jax.numpy as jnp
    import torch

    from repro.core import kahan as JK
    from repro_torch.core import kahan as TK

    x = _wide((2 * 1024 + 3,), seed=lanes)
    js, jc = JK._lane_partials_sum(jnp.asarray(x), lanes)
    ts, tc = TK._lane_partials_sum(torch.from_numpy(x), lanes)
    assert _same(js, ts.numpy()) and _same(jc, tc.numpy())
    jm, tm = JK._merge_lanes(js, jc), TK._merge_lanes(ts, tc)
    assert _same(jm[0], tm[0].numpy()) and _same(jm[1], tm[1].numpy())


def test_sharded_length_must_divide():
    """A length that does not divide by the axis size raises, as
    ``shard_map`` does (no process group needed to refuse)."""
    import torch

    from repro_torch.distributed import collectives as coll

    with pytest.raises(ValueError, match="divide"):
        coll._shard(torch.zeros(7), 0, 2, 0, "sharded_asum")
    assert coll.axis_size(None) == 1


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _port(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
