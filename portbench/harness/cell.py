"""One run of one cell: set-up, the measured window, the trace's readers
and the comparison with the reference.

Set-up makes the weights on the device from the seed, the traffic's pool
of batches, the program's step and optimizer state, and drives that one
step object through the checked steps (the first three), reading from
its state what the comparison needs. The window then calls the same
step on the pool's next batches, one after another, each ended by a
synchronise, until the next step would end past ``seconds``. After the
window the program's state is freed and the plain reference follows the
checked steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench.harness import check, yardstick
from portbench.harness.files import Files
from portbench.harness.program import (Program, change_norms,
                                       first_gradient_norms)
from portbench.harness.trace import DeviceTrace
from portbench.reference.common import (Precision, layout_paths,
                                        make_weights, train_readings)
from portbench.traffic.synthetic_lm import SyntheticLM


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Seconds of each stage of set-up, each ended by a synchronise."""

    def __init__(self, device: torch.device, start: float = None):
        self.device = device
        self.last = time.perf_counter() if start is None else start
        self.stages: List = []

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.stages.append((name, now - self.last))
        self.last = now

    def line(self) -> str:
        return "setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in self.stages)


class Cell:
    """A cell's files: its configuration, family, traffic and options."""

    def __init__(self, files: Files, name: str, device: torch.device):
        self.device = device
        self.spec = files.workload(name)
        self.cfg = files.config(self.spec["config"])
        self.traffic = files.traffic(self.spec["traffic"])
        self.fam = files.family(self.cfg["family"])
        self.layout = self.fam.layout(self.cfg)
        self.paths = layout_paths(self.layout)
        t = self.traffic
        self.tokens_per_step = t["global_batch"] * t["seq_len"]

    def batches(self, seed: int) -> List[Dict[str, torch.Tensor]]:
        """The pool of batches the steps cycle through, on the device."""
        t = self.traffic
        gen = SyntheticLM(self.cfg["vocab_size"], t["seq_len"],
                          t["global_batch"], seed, t["n_bigram_states"])
        out = []
        for i in range(t["pool"]):
            b = gen.batch_at(i)
            out.append({"tokens": torch.from_numpy(b["tokens"]).long(),
                        "labels": torch.from_numpy(b["labels"]).long(),
                        "loss_mask": torch.from_numpy(b["loss_mask"])})
        return [{k: v.to(self.device) for k, v in b.items()} for b in out]

    def program(self) -> Program:
        return Program(self.cfg, self.fam, self.traffic,
                       self.spec.get("program", {}), self.device)

    def checked_steps(self, prog: Program, seed: int, pool, step: Callable,
                      marks: Optional[Marks] = None):
        """Weights from ``seed``, the optimizer state, and the checked
        steps through ``step``: (params, state, the program's readings).
        ``marks`` times each stage."""
        marks = marks or Marks(self.device)
        params = make_weights(self.layout, seed, self.device)
        state = prog.init(params)
        marks("weights and optimizer state")
        losses, grad = [], None
        for i in range(self.traffic["checked_steps"]):
            params, state, met = step(params, state, pool[i])
            losses.append(met["loss"].detach())
            if i == 0:
                grad = first_gradient_norms(prog, state, self.paths)
                marks("first step (CUDA and cuBLAS load lazily)")
        marks("the other checked steps")
        change = change_norms(params, state, self.layout, seed, self.paths)
        marks("readings")
        readings = {"loss": [float(x) for x in losses],
                    "grad": grad.tolist(), "change": change.tolist()}
        return params, state, readings

    def reference(self, seed: int, pool, precision: Optional[str] = None,
                  drop_half: bool = False) -> Dict:
        """The plain reference's readings over the checked steps, from the
        weights drawn again from ``seed``, in float32 (or ``precision``)."""
        params = make_weights(self.layout, seed, self.device)
        model = self.fam.Model(self.cfg, Precision(precision))
        n = self.traffic["checked_steps"]
        with Precision.scope():
            out = train_readings(model, params, pool[:n],
                                 self.traffic["optimizer"],
                                 self.traffic["schedule"],
                                 self.traffic["microbatches"], drop_half)
        if out["paths"] != self.paths:
            raise RuntimeError("the reference's leaves differ from the "
                               "layout's")
        return out


class TraceRun:
    """What the per-layer metrics read from a traced run: the cell, its
    window (steps, host seconds of each call and of the window), the
    device's operations in it, those of one optimizer update alone, and
    the steps' own returned metrics."""

    def __init__(self, cell: Cell, prog: Program, ends: List[float],
                 enqueue: List[float], events, optimizer_events,
                 step_metrics: List[Dict[str, float]]):
        self.cell, self.cfg, self.fam = cell, cell.cfg, cell.fam
        self.traffic, self.layout = cell.traffic, cell.layout
        self.steps = len(ends)
        self.window_s = ends[-1]
        self.enqueue_s = enqueue
        self.events = events
        self.optimizer_events = optimizer_events
        self.step_metrics = step_metrics
        self.moe_layers = prog.moe_layers
        self.compute_dtype = str(prog.arch.compute_dtype)

    def busy_s(self, names=None) -> float:
        """Device seconds in the window in which an operation (whose name
        holds one of ``names``, if given) ran, overlaps counted once."""
        return yardstick.union_ns(
            (s, d) for s, d, n in self.events
            if names is None or any(x in n for x in names)) / 1e9


def run_cell(files: Files, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, start: float,
             wrap_step: Optional[Callable] = None) -> Dict:
    """One run: the result line's fields, ``checks`` last. ``wrap_step``
    (tests only) wraps the program's step to plant a fault under the
    timed path."""
    marks = Marks(device, start)
    marks("imports")
    cell = Cell(files, name, device)
    prog = cell.program()
    step = prog.step if wrap_step is None else wrap_step(prog.step)
    marks("the model and its step")
    if device.type == "cuda":
        prog.load_kernels(cell.spec.get("kernels", []))
        marks("kernels (nvcc builds them on a checkout's first run)")
    pool = cell.batches(seed)
    marks("the batches")
    params, state, readings = cell.checked_steps(prog, seed, pool, step,
                                                 marks)
    sync(device)
    setup_s = time.perf_counter() - start

    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ends, enqueue, mets = [], [], []
    i = cell.traffic["checked_steps"]
    with DeviceTrace(device, on=trace) as tr:
        sync(device)
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            params, state, met = step(params, state, pool[i % len(pool)])
            enqueue.append(time.perf_counter() - a)
            sync(device)
            ends.append(time.perf_counter() - t0)
            mets.append(met)
            i += 1
            last = ends[-1] - (ends[-2] if len(ends) > 1 else 0.0)
            if ends[-1] + last > seconds:
                break
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    step_metrics = [{k: float(v) for k, v in m.items()
                     if torch.as_tensor(v).dim() == 0} for m in mets]

    result = {"correct": False, "attempted": len(ends), "failed": 0,
              "metrics": {}, "device": _device(device, window_peak,
                                               setup_peak)}
    if trace:
        update = prog.update_alone(params, state)
        sync(device)
        with DeviceTrace(device) as opt_tr:
            update()
            sync(device)
        run = TraceRun(cell, prog, ends, enqueue, tr.events, opt_tr.events,
                       step_metrics)
        for m in files.per_layer(name):
            value = files.metric(m["name"]).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = run.busy_s()
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = {"device_ops": yardstick.by_name(tr.events),
                               "idle_gaps": yardstick.gaps(tr.events)}
        del update
    else:
        rate = cell.tokens_per_step * len(ends) / ends[-1]
        e2e = {"train_tokens_per_s": rate,
               "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s}
        for m in files.end_to_end(name):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}

    del params, state, prog, step, mets
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = cell.reference(seed, pool)
    got = check.numbers(readings, ref)
    correct, checks = check.verdict(got, cell.spec["limits"])
    result["correct"] = correct
    result["setup"] = marks.line()
    result["checks"] = checks
    return result


def _device(device: torch.device, window_peak: int, setup_peak: int):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": max(window_peak, setup_peak)}
