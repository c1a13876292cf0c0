"""Where the benchmark's pieces live, found by the names in
``BENCHMARK.json``: a cell's file ``workloads/<cell>.json`` names its
configuration ``configs/<config>.json`` and its traffic
``traffic/<traffic>.json``; a configuration names its family's reference
``reference/<family>.py``; a per-layer metric is read by
``metrics/<metric>.py``. A new cell, configuration or metric is a new
file; no file here lists them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

#: the benchmark's folder and the checkout's root
BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Files:
    """The benchmark's files under ``bench`` (the folder this module
    lives in, unless a test gives another), ``BENCHMARK.json`` beside
    it."""

    def __init__(self, bench: Path = BENCH):
        self.bench = Path(bench)

    def _json(self, kind: str, name: str) -> Dict:
        path = self.bench / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> Dict:
        return self._json("workloads", name)

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self.bench / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} module {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def family(self, name: str) -> ModuleType:
        return self._module("reference", name)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def benchmark(self) -> Dict:
        return json.loads((self.bench.parent / "BENCHMARK.json").read_text())

    def cell_entry(self, name: str) -> Dict:
        for w in self.benchmark()["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"cell {name!r} is not in BENCHMARK.json")

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics reported in ``cell``: those listing it,
        and those with no list whose end-to-end metric the cell reports."""
        bench = self.benchmark()
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        out = []
        for m in bench["per_layer"]:
            cells: Optional[List[str]] = m.get("workloads")
            if cells is None:
                moved = e2e.get(m["moves"], {})
                cells = moved.get("workloads")
                if cells is None or cell in cells:
                    out.append(m)
            elif cell in cells:
                out.append(m)
        return out

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.benchmark()["end_to_end"]
                if cell in m.get("workloads", [cell])]
