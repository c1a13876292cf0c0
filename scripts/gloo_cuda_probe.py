#!/usr/bin/env python3
"""Which gloo collectives work on CUDA tensors, two ranks sharing one
card (the layout of ``chip_smoke.py`` phases 8 and 15: NCCL refuses two
ranks on one device).

    python3 scripts/gloo_cuda_probe.py

Each case runs in its own pair of processes (a crash ends only that
case) and prints the two ranks' exit codes and last lines. Needs one
CUDA card. On an NVIDIA H100 80GB HBM3 with torch 2.11.0+cu128, the
functional all-gather (``_functional_collectives.all_gather_tensor``,
which DTensor's Shard -> Replicate calls) crashed both ranks with
SIGSEGV in float32 and bfloat16, and so did a DTensor redistribution to
Replicate; c10d's ``all_gather_into_tensor``, ``reduce_scatter_tensor``
and ``all_reduce`` and the functional reduce-scatter and all-reduce
worked. ``chip_smoke.py``'s phase 15 therefore routes DTensor's
all-gathers through c10d's (``gloo_cuda_all_gather``).
"""

import os
import subprocess
import sys
import tempfile

CASES = ("funcol_ag_f32", "funcol_ag_bf16", "c10d_ag_bf16", "funcol_rs_f32",
         "funcol_rs_bf16", "c10d_rs_f32", "funcol_ar_f32", "funcol_ar_bf16",
         "c10d_ar_bf16", "dtensor_rep_f32", "dtensor_rep_bf16")

RANK = r'''
import sys, torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
case, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
dt = torch.bfloat16 if "bf16" in case else torch.float32
x = torch.arange(8, device="cuda", dtype=torch.float32).to(dt) + rank
g = dist.group.WORLD
if case.startswith("funcol_ag"):
    y = fc.wait_tensor(fc.all_gather_tensor(x, 0, g))
elif case.startswith("funcol_rs"):
    y = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, g))
elif case.startswith("funcol_ar"):
    y = fc.wait_tensor(fc.all_reduce(x, "sum", g))
elif case.startswith("c10d_ag"):
    y = x.new_empty(16)
    dist.all_gather_into_tensor(y, x)
elif case.startswith("c10d_rs"):
    y = x.new_empty(4)
    dist.reduce_scatter_tensor(y, x)
elif case.startswith("c10d_ar"):
    y = x.clone()
    dist.all_reduce(y)
else:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = init_device_mesh("cuda", (2,))
    d = distribute_tensor(torch.ones(8, 4, device="cuda", dtype=dt), mesh,
                          [Shard(0)])
    y = d.redistribute(mesh, [Replicate()]).to_local()
torch.cuda.synchronize()
print(case, rank, "OK", y.float().sum().item(), flush=True)
dist.barrier()
dist.destroy_process_group()
'''


def main() -> None:
    import torch

    print(f"torch {torch.__version__}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for case in CASES:
            store = os.path.join(tmp, f"store_{case}")
            procs = [subprocess.Popen(
                [sys.executable, "-c", RANK, case, str(r), store],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
            outs = []
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = "timeout"
                outs.append((p.returncode, (out or "").strip()
                             .splitlines()[-1:]))
            print(case, outs, flush=True)


if __name__ == "__main__":
    main()
