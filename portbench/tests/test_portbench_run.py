"""A run of each cell at a size a CPU test can hold: the port against the
plain reference, the result line's keys, the faults that ``correct``
must catch, the control one precision below, and nothing of JAX or the
JAX package loaded. One test needs the card and runs the control at the
cell's own size there."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench_smoke import MOE_CELL, ROOT, smoke_tree

from portbench.harness import check
from portbench.harness.cell import Cell, run_cell
from portbench.harness.files import Files

CPU = torch.device("cpu")
#: the benchmark's cells, and a MoE cell for the tests alone
CELLS = ("olmo-1b.train", "olmo-1b.train-kahan-matmul")
TESTED = CELLS + (MOE_CELL,)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return smoke_tree(tmp_path_factory.mktemp("f32"))


@pytest.mark.parametrize("cell", TESTED)
def test_port_agrees_with_the_reference(files, cell):
    """In float32 the port and the reference part by rounding alone."""
    out = run_cell(files, cell, 2 ** 31 + 11, 0.2, False, CPU, 0.0)
    assert out["correct"], out["checks"]
    assert all(c["value"] < 1e-4 for c in out["checks"].values())


@pytest.mark.parametrize("trace", (0, 1))
def test_the_result_line(files, trace):
    out = run_cell(files, MOE_CELL, 3, 0.2, bool(trace), CPU, 0.0)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"loss", "grad", "update"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: only the host's readings remain
        assert set(out["metrics"]) == {"enqueue_ms", "moe_dropped_share"}
    else:
        assert set(out["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                       "setup_s"}


def _state_unchanged(step):
    """A step that returns its parameters and state as it found them."""
    def broken(params, state, batch):
        import copy

        keep = copy.deepcopy((params, state))
        _, _, met = step(params, state, batch)
        return keep[0], keep[1], met
    return broken


def _half_batch(step):
    """Half of every batch left out, the mean taken over the rest."""
    def broken(params, state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(params, state, {k: v[:rows] for k, v in batch.items()})
    return broken


@pytest.mark.parametrize("fault", (_state_unchanged, _half_batch))
@pytest.mark.parametrize("cell", TESTED)
def test_faults_under_the_timed_path_are_not_correct(files, cell, fault):
    out = run_cell(files, cell, 5, 0.1, False, CPU, 0.0, wrap_step=fault)
    assert not out["correct"], out["checks"]


def test_loss_compares_every_checked_step(files):
    """``loss`` is the largest relative gap over all the checked steps,
    the last (the first forward pass after an update) included."""
    cell = Cell(files, "olmo-1b.train", CPU)
    assert len(cell.reference(1, cell.batches(1))["loss"]) == 3
    ref = {"loss": [10.0, 10.0, 10.0], "grad": [1.0, 2.0],
           "raw_grad": [1.0, 2.0], "change": [1.0, 1.0]}
    prog = {"loss": [10.0, 10.001, 10.002], "grad": [1.0, 2.0],
            "change": [1.0, 1.0]}
    assert check.numbers(prog, ref)["loss"] == pytest.approx(2e-4)


def test_the_control_separates_from_the_port(tmp_path):
    """In bfloat16, as the cells state it, the control (the reference with
    float8 products in the program's place) reads at least three times
    what the port reads, on some number of every seed."""
    files = smoke_tree(tmp_path, "bfloat16")
    for name in ("olmo-1b.train", MOE_CELL):
        cell = Cell(files, name, CPU)
        prog = cell.program()
        for seed in (1, 2):
            pool = cell.batches(seed)
            _, _, got = cell.checked_steps(prog, seed, pool, prog.step)
            ref = cell.reference(seed, pool)
            port = check.numbers(got, ref)
            ctl = check.numbers(cell.reference(seed, pool, "fp8"), ref)
            assert max(ctl[k] / port[k] for k in port) >= 3, (port, ctl)


def test_no_module_of_jax_after_a_run(tmp_path):
    """A whole run in a fresh process loads no module whose top-level
    name is jax, jaxlib, flax, repro or benchmarks (repro_torch is not
    repro)."""
    code = f"""
import sys, torch
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
from portbench_smoke import smoke_tree
from portbench.harness.cell import run_cell
sys.path.insert(0, {str(ROOT / 'portbench')!r})
from run import banned_modules
files = smoke_tree({str(tmp_path)!r})
run_cell(files, "olmo-1b.train", 1, 0.1, True, torch.device("cpu"), 0.0)
assert "repro_torch" in sys.modules
print(banned_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refused_without_the_devices_a_cell_needs():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a host without one")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", "olmo-1b.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cell_on_the_card(cell):
    """At the cell's own size on the card, the control fails one of the
    cell's limits on each of three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = Cell(Files(), cell, torch.device("cuda", 0))
    for seed in (101, 102, 103):
        pool = c.batches(seed)
        ctl = check.numbers(c.reference(seed, pool, "fp8"),
                            c.reference(seed, pool))
        assert not check.verdict(ctl, c.spec["limits"])[0], ctl
