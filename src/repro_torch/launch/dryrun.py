"""Dry run on the production meshes: every (arch x shape) cell's step
runs once on fake tensors over a fake world of 256 or 512 ranks, and
its per-device roofline terms are written as JSON (counterpart of
``repro/launch/dryrun.py``).

One process holds the whole world: a fake process group
(``torch.testing``'s ``FakeStore``, rank 0 of 256 or 512), a "cpu"
``DeviceMesh`` from ``make_production_mesh`` and a ``FakeTensorMode``
(``perf.roofline.DeviceCounter``). Params, optimizer state, cache and
batch are distributed by the cell's logical specs under ``TRAIN_RULES``
or ``SERVE_RULES``; the step (forward, backward and update for a train
cell) then runs once inside ``activation_rules``, and the counter adds up
what rank 0's own ops do. Nothing runs on any device, and no kernel's
plain version runs: a kernel entry on a fake tensor records its own work.

Usage:
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
import traceback
from typing import Iterator

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import abstract
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh
from repro_torch.launch.specs import build_cell, distribute_args, run_sharded
from repro_torch.optim import AdamWConfig
from repro_torch.perf import roofline
from repro_torch.train.trainer import TrainConfig

# Per-cell configuration overrides (the reference's): 400B params with
# bf16 moments and Kahan compensation instead of float32 master state
OVERRIDES = {
    ("llama4-maverick-400b-a17b", "train_4k"): dict(
        opt=AdamWConfig(kahan=True, moment_dtype="bfloat16")),
}

# Per-cell sharding-rule overrides: xLSTM loses the seq sharding at every
# chunk reshape; batch-only activation sharding avoids the gathers
RULE_OVERRIDES = {
    ("xlstm-1.3b", "train_4k"): "train_nosp",
}


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION_MESHES[bool(multi_pod)][0]))


@contextlib.contextmanager
def fake_world(multi_pod: bool) -> Iterator[int]:
    """A fake process group of the production mesh's size in this
    process (rank 0), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = PRODUCTION_MESHES[bool(multi_pod)][0]
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield n
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (a DTensor's
    ``to_local()``)."""
    from repro_torch.core import tree as _tree

    total = 0
    for t in _tree.leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if shd.is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             tc: TrainConfig = None, verbose: bool = True) -> dict:
    """One cell in a fake world of its own: its JSON record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    name = mesh_name(multi_pod)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "skipped", "reason": reason}
    rules = shd.TRAIN_RULES if shape.kind == "train" else shd.SERVE_RULES
    if RULE_OVERRIDES.get((arch, shape_name)) == "train_nosp":
        rules = shd.TRAIN_NOSP_RULES
    if tc is None:
        over = OVERRIDES.get((arch, shape_name), {})
        tc = TrainConfig(**over) if over else TrainConfig()

    with fake_world(multi_pod) as chips:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        counter = roofline.DeviceCounter()
        work: dict = {}
        t0 = time.time()
        with counter:
            cell = build_cell(cfg, shape, tc=tc)
            args = distribute_args(mesh, rules, cell)
            peak = float(local_bytes(args))
            t_setup = time.time() - t0
            with counter.counting(), abstract.recording(work):
                run_sharded(cell, mesh, rules, args)
            t_step = time.time() - t0 - t_setup
        report = roofline.analyze(
            counter, work, arch=arch, shape=shape_name, mesh_name=name,
            chips=chips, model_flops=cell.model_flops,
            peak_memory_bytes=peak)
    out = report.to_json()
    out.update({"status": "ok", "setup_s": round(t_setup, 1),
                "step_s": round(t_step, 1)})
    if verbose:
        t = report.terms()
        print(f"[{arch} x {shape_name} x {name}] "
              f"compute={t.compute_s * 1e3:.2f}ms "
              f"memory={t.memory_s * 1e3:.2f}ms "
              f"collective={t.collective_s * 1e3:.2f}ms "
              f"dominant={t.dominant} "
              f"roofline_frac={out['roofline_fraction']:.3f} "
              f"(setup {t_setup:.0f}s step {t_step:.0f}s)", flush=True)
    del cell, args
    gc.collect()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in list_archs():
            for shape_name in SHAPES:
                cells.append((arch, shape_name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{mesh_name(mp)}"
            try:
                result = run_cell(arch, shape_name, multi_pod=mp)
            except Exception as e:  # a failed cell is a bug: record it
                traceback.print_exc()
                result = {"arch": arch, "shape": shape_name,
                          "mesh": mesh_name(mp), "status": "error",
                          "error": repr(e)}
                failures += 1
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(result, f, indent=2)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
