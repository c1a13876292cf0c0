#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA
port) once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by its name (``portbench/workloads/<cell>.json``
and what it names). The last line of standard output is the result as
one JSON object; the numbers compared with the reference, each with its
limit, are the last lines of standard error. With ``--trace 0`` the
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics. Exits with a code other than 0, and prints no result,
without the CUDA devices the cell needs, or when a module of JAX or of
the JAX package was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules no run may load: JAX, the JAX package, the old
#: benchmarks of the JAX package
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    port and the benchmark importable from it."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def banned_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from portbench.harness import check
    from portbench.harness.cell import run_cell
    from portbench.harness.files import Files

    files = Files()
    chips = files.cell_entry(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s), found {found}", file=sys.stderr)
        return 3
    result = run_cell(files, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), START)
    bad = banned_modules()
    if bad:
        print(f"portbench: loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    print(result.pop("setup"), file=sys.stderr)
    for line in check.lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
