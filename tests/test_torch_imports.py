"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), ",".join(bad))
"""


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_port_imports_no_jax_and_no_reference():
    count, _, bad = _run(_PROBE).partition(" ")
    assert int(count) >= 15, f"only {count} submodules found"
    assert bad == "", f"repro_torch pulled in: {bad}"


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "repro" not in roots, sorted(roots)
    out = _run("import sys; import chip_smoke; "
               "print(sorted(m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'repro')))")
    assert out == "[]"


def test_distributed_modules_import_without_a_process_group():
    """The distributed slice's modules are in the package and importing
    them (or building a train step with no mesh) touches no process
    group: ``make_local_mesh`` is a function, as the reference's is."""
    out = _run(
        "import torch.distributed as dist\n"
        "import repro_torch.distributed as d\n"
        "from repro_torch.distributed import collectives, compression\n"
        "from repro_torch.launch import mesh\n"
        "from repro_torch.core import kahan\n"
        "names = ['sharded_asum', 'sharded_dot', 'sharded_matmul',\n"
        "         'merge_sharded_accumulators', 'deterministic_mean',\n"
        "         'expected_grad_spec']\n"
        "assert all(hasattr(collectives, n) for n in names)\n"
        "assert all(hasattr(compression, n) for n in ('quantize',\n"
        "    'dequantize', 'ef_step', 'compressed_psum'))\n"
        "assert all(hasattr(kahan, n) for n in ('compensated_psum_scalar',\n"
        "    'kahan_sum', 'kahan_dot', 'kahan_dot2', 'naive_sum',\n"
        "    'naive_dot'))\n"
        "assert callable(mesh.make_local_mesh)\n"
        "assert callable(mesh.make_production_mesh)\n"
        "print(dist.is_initialized())")
    assert out == "False"

