"""The port's dry run (``repro_torch.launch.dryrun``), its roofline
(``repro_torch.perf.roofline``) and the kernel entries on fake tensors,
on the CPU.

* The dry run in a subprocess: ``xlstm-1.3b x decode_32k`` on both
  production meshes (a fake world of 256, then 512 ranks) writes ``status:
  ok`` JSON, chips 256 and 512, positive FLOPs and memory term, a valid
  dominant term, with every key of the reference's ``CellReport`` and the
  H100 machine. ``olmo-1b x long_500k`` is skipped with the reference's
  reason; a failing cell makes the exit status 1.
* ``DeviceCounter`` counts one rank's own work below DTensor: a sharded
  matmul's local FLOPs and an all-gather's operand bytes (exact).
* Each kernel entry on a fake tensor returns its outputs' shapes, dtypes
  and device, records its own work (launches, FLOPs and bytes by PERF.md
  §2's formulas) and never calls its plain version (patched to raise).
* Importing the port's modules initialises no process group.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro_torch.kernels import abstract
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kahan_columns as kc
from repro_torch.kernels import kahan_dot as kd
from repro_torch.kernels import kahan_matmul as km
from repro_torch.kernels import kahan_sum as ks
from repro_torch.kernels.schemes import resolve_scheme
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


def _reference_keys():
    from repro.perf.roofline import CellReport

    return set(CellReport(arch="a", shape="s", mesh="m", chips=1,
                          flops_per_device=1.0, bytes_per_device=1.0,
                          collective_bytes_per_device=1.0,
                          collective_breakdown={}, peak_memory_bytes=None,
                          model_flops=1.0).to_json())


@pytest.fixture(scope="module")
def xlstm_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-1.3b", "--shape", "decode_32k", "--both-meshes", "--out",
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return {m: json.load(open(out / f"xlstm-1.3b__decode_32k__{m}.json"))
            for m in ("16x16", "2x16x16")}


@pytest.mark.parametrize("mesh,chips", [("16x16", 256), ("2x16x16", 512)])
def test_serve_cell_runs(xlstm_cells, mesh, chips):
    out = xlstm_cells[mesh]
    assert out["status"] == "ok"
    assert out["chips"] == chips and out["mesh"] == mesh
    assert out["flops_per_device"] > 0 and out["bytes_per_device"] > 0
    assert out["memory_s"] > 0
    assert out["dominant"] in ("compute", "memory", "collective")
    assert out["peak_memory_bytes"] > 0
    assert out["machine"] == "H100 SXM5 80GB"


def test_cell_json_holds_the_reference_keys(xlstm_cells):
    assert _reference_keys() <= set(xlstm_cells["16x16"])


def test_full_attention_long_cell_is_skipped():
    out = dryrun.run_cell("olmo-1b", "long_500k")
    assert out["status"] == "skipped"
    assert "full-attention" in out["reason"]


def test_a_failed_cell_exits_1(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "run_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.load(open(tmp_path / "olmo-1b__train_4k__16x16.json"))
    assert rec["status"] == "error" and "boom" in rec["error"]


def test_overrides_are_the_references():
    from repro.launch import dryrun as jdry

    assert set(dryrun.OVERRIDES) == set(jdry.OVERRIDES)
    assert dryrun.RULE_OVERRIDES == jdry.RULE_OVERRIDES
    opt = dryrun.OVERRIDES[("llama4-maverick-400b-a17b", "train_4k")]["opt"]
    assert (opt.kahan, opt.moment_dtype) == (True, "bfloat16")


def test_device_counter_counts_local_work():
    """A 2 x 2 fake world: x [64, 32] sharded on rows over "data" times a
    replicated w [32, 16] is one local [32, 32] x [32, 16] product; x
    gathered over "data" is an all-gather of its [32, 32] float32 shard."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.perf.roofline import DeviceCounter

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        counter = DeviceCounter()
        with counter:
            x = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(32, 16), mesh,
                                  [Replicate(), Replicate()])
            with counter.counting():
                y = x @ w
                flops = counter.flops
                x.redistribute(mesh, [Replicate(), Replicate()])
        assert y.to_local().shape == (32, 16)
        assert flops == 2 * 32 * 32 * 16
        assert counter.coll["all-gather"] == 32 * 32 * 4
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Kernel entries on fake tensors
# ---------------------------------------------------------------------------

KAHAN = resolve_scheme("kahan")


def _plain_raises(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a fake tensor")

    for mod, name in ((kd, "dot_plain"), (ks, "sum_plain"),
                      (fa, "flash_plain"), (km, "matmul_plain"),
                      (kc, "column_sq_plain")):
        monkeypatch.setattr(mod, name, refuse)


def _call(entry):
    """(outputs, want shapes, want dtype, want FLOPs) of one entry."""
    f32 = torch.float32
    if entry == "dot_accumulators":
        a = torch.empty(8 * 8 * 128 * 3)
        return (kd.dot_accumulators(a, a, scheme=KAHAN), [(64, 128)] * 2,
                f32, 2 * a.numel())
    if entry == "dot_accumulators_batched":
        a = torch.empty(4, 8 * 8 * 128)
        return (kd.dot_accumulators_batched(a, a, scheme=KAHAN),
                [(4, 64, 128)] * 2, f32, 2 * a.numel())
    if entry == "sum_accumulators":
        x = torch.empty(8 * 8 * 128 * 2, dtype=torch.float64)
        return (ks.sum_accumulators(x, scheme=KAHAN), [(64, 128)] * 2,
                torch.float64, x.numel())
    if entry == "sum_accumulators_batched":
        x = torch.empty(3, 8 * 8 * 128)
        return (ks.sum_accumulators_batched(x, scheme=KAHAN),
                [(3, 64, 128)] * 2, f32, x.numel())
    if entry == "flash_accumulators":
        q, k = torch.empty(8, 256, 64), torch.empty(4, 256, 64)
        out = fa.flash_accumulators(q, k, k, block_q=128, block_k=128,
                                    scheme=KAHAN, causal=True, kv_len=200,
                                    q_groups=2)
        pairs = sum(min(i + 1, 200) for i in range(256))
        return (out, [(8, 256, 1)] * 2 + [(8, 256, 64)] * 2, f32,
                4 * 8 * 64 * pairs)
    if entry == "flash_chunk_accumulators":
        q, k = torch.empty(4, 64, 64), torch.empty(4, 256, 64)
        out = fa.flash_chunk_accumulators(q, k, k, 100, block_q=64,
                                          block_k=128, scheme=KAHAN,
                                          kv_len=164)
        pairs = sum(min(100 + i + 1, 164) for i in range(64))
        return (out, [(4, 64, 1)] * 2 + [(4, 64, 64)] * 2, f32,
                4 * 4 * 64 * pairs)
    if entry == "matmul_accumulators":
        a = torch.empty(5, 512, dtype=torch.bfloat16)
        b = torch.empty(512, 256, dtype=torch.bfloat16)
        return (km.matmul_accumulators(a, b, scheme=KAHAN, block_n=256,
                                       block_k=512),
                [(5, 256)] * 2, f32, 2 * 5 * 256 * 512)
    if entry == "matmul_accumulators_batched":
        a, b = torch.empty(2, 9, 512), torch.empty(2, 512, 256)
        return (km.matmul_accumulators_batched(a, b, scheme=KAHAN,
                                               block_n=256, block_k=512),
                [(2, 9, 256)] * 2, f32, 2 * 2 * 9 * 256 * 512)
    x = torch.empty(100, 7, 3, dtype=torch.bfloat16)
    return kc.column_sq_accumulators(x), [(7, 3)] * 2, f32, 2 * x.numel()


ENTRIES = ["dot_accumulators", "dot_accumulators_batched",
           "sum_accumulators", "sum_accumulators_batched",
           "flash_accumulators", "flash_chunk_accumulators",
           "matmul_accumulators", "matmul_accumulators_batched",
           "column_sq_accumulators"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_entry_on_fake_tensors(entry, monkeypatch):
    """Outputs of the right shapes, dtype and device; the kernel's own
    work recorded once; no plain version run."""
    _plain_raises(monkeypatch)
    work: dict = {}
    with FakeTensorMode(), abstract.recording(work):
        out, shapes, dtype, flops = _call(entry)
    assert [tuple(t.shape) for t in out] == shapes
    assert all(isinstance(t, FakeTensor) and t.dtype == dtype
               and t.device.type == "cpu" for t in out)
    assert list(work) == [entry]
    assert work[entry]["launches"] == 1
    assert work[entry]["flops"] == flops
    assert work[entry]["bytes"] > sum(
        t.numel() * t.element_size() for t in out)


def test_engine_on_fake_tensors_reaches_no_plain_version(monkeypatch):
    """The engine's entries (promotion, padding, the merge) on fake
    tensors: shapes only, the kernels' work recorded."""
    from repro_torch.kernels.engine import CompensatedReduction

    _plain_raises(monkeypatch)
    work: dict = {}
    eng = CompensatedReduction()
    with FakeTensorMode(), abstract.recording(work):
        total = eng.asum(torch.empty(5000))
        o = eng.flash_attention(torch.empty(4, 100, 64),
                                torch.empty(4, 100, 64),
                                torch.empty(4, 100, 64), causal=True)
        m = eng.matmul(torch.empty(3, 300), torch.empty(300, 70))
    assert total.shape == () and o.shape == (4, 100, 64)
    assert m.shape == (3, 70)
    assert {k: w["launches"] for k, w in work.items()} == {
        "sum_accumulators": 1, "flash_accumulators": 1,
        "matmul_accumulators": 1}


def test_importing_the_port_initialises_no_process_group():
    import importlib

    import torch.distributed as dist

    for mod in ("repro_torch.launch.dryrun", "repro_torch.launch.specs",
                "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
                "repro_torch.perf.roofline", "repro_torch.train.serve"):
        importlib.import_module(mod)
    assert not dist.is_initialized()
