"""CLI: ``python -m repro_torch.analysis [paths...] [options]``
(counterpart of ``python -m repro.analysis``: the same flags and exit
codes, plus ``--sass``).

Three audit levels share one report schema and one exit-code contract
(0 clean, 1 findings, 2 bad invocation):

* **AST mode** (default) lints source text: ``python -m
  repro_torch.analysis --strict --budget N src/repro_torch`` exits 0 only
  when the tree has zero unannotated violations, every pragma parses
  with a non-empty reason and the annotated exemptions number at most N
  (the ratchet pinned in tests/test_torch_analysis.py).
* **Trace mode** (``--trace``) audits what the port actually runs: the
  registered entry points in :mod:`repro_torch.analysis.targets` are run
  once, eagerly, on CPU tensors at tiny shapes under an op recorder, and
  their op logs are checked against :mod:`repro_torch.analysis.trace`.
  ``--target ID`` restricts the audit (repeatable).
* **Cost mode** (``--cost``) audits what the kernels COST: each
  scheme's update is counted op for op on the CPU, the kernel entries'
  bytes are read from their abstract records, and both are held against
  the ECM model (:mod:`repro_torch.analysis.costmodel`). ``--cost
  --sass`` adds the compiled level: a probe of every scheme's device
  update is built with nvcc and disassembled, and the shipping kernels'
  SASS is counted (needs the CUDA toolkit; a missing ``nvcc`` or
  disassembler is a finding, never a silent skip).

``--sarif`` renders any level's findings as a SARIF 2.1.0 report for CI
annotations (``--json`` stays the stable machine-readable schema).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import report as _report
from repro_torch.analysis.core import lint_paths
from repro_torch.analysis.rules import names


def _default_target() -> Path:
    """The installed repro_torch package itself (lint ourselves when no
    path is given)."""
    return Path(__file__).resolve().parents[1]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="engine-contract auditor of the PyTorch port: AST "
                    "rules over source text, trace rules over recorded op "
                    "logs, cost rules over counted instruction mixes and "
                    "kernel traffic (and, with --sass, over the compiled "
                    "kernels' SASS)")
    p.add_argument("paths", nargs="*", type=Path,
                   help="files or directories to lint "
                        "(default: the repro_torch package; AST mode only)")
    p.add_argument("--strict", action="store_true",
                   help="also fail on pragma errors (empty reasons, "
                        "unknown rule ids) — the gate mode")
    p.add_argument("--rule", action="append", dest="rules", metavar="ID",
                   help="run only this rule (repeatable)")
    p.add_argument("--trace", action="store_true",
                   help="audit the recorded op logs of the registered "
                        "targets instead of source text")
    p.add_argument("--cost", action="store_true",
                   help="audit the counted kernel cost (instruction mix, "
                        "memory traffic) against the ECM model")
    p.add_argument("--sass", action="store_true",
                   help="with --cost: also build the scheme probes with "
                        "nvcc and audit their SASS and the shipping "
                        "kernels' (needs the CUDA toolkit)")
    p.add_argument("--target", action="append", dest="targets",
                   metavar="ID",
                   help="audit only this target (repeatable; implies "
                        "--trace unless --cost is given)")
    p.add_argument("--budget", type=int, metavar="N",
                   help="fail when the annotated-exemption count "
                        "exceeds N (the ratchet)")
    fmt = p.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true",
                     help="emit the machine-readable JSON report")
    fmt.add_argument("--sarif", action="store_true",
                     help="emit the SARIF 2.1.0 report (CI annotations)")
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules (and, with --trace/--cost, "
                        "targets) and exit")
    p.add_argument("--show-exemptions", action="store_true",
                   help="also print every annotated exemption (the audit "
                        "view)")
    return p


def _path_problems(paths: List[Path]) -> List[str]:
    """Validate EVERY path up front — one run reports them all."""
    problems: List[str] = []
    for p in paths:
        if not p.exists():
            problems.append(f"no such path: {p}")
        elif p.is_dir():
            if not os.access(p, os.R_OK | os.X_OK):
                problems.append(f"directory not readable: {p}")
        elif not os.access(p, os.R_OK):
            problems.append(f"file not readable: {p}")
    return problems


def _report_problems(problems: List[str]) -> int:
    for msg in problems:
        print(f"error: {msg}", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.trace and args.cost:
        print("error: choose one of --trace / --cost per run",
              file=sys.stderr)
        return 2
    if args.sass and not args.cost:
        print("error: --sass is a cost-level option (use --cost --sass)",
              file=sys.stderr)
        return 2
    if args.targets and not args.cost:
        args.trace = True

    if args.cost:
        # imported lazily, like trace mode: cost mode pulls in torch.
        from repro_torch.analysis import costmodel as _cost
        from repro_torch.analysis import targets as _targets
        if args.sass:
            _cost.register_sass()
        _cost.register_cost_targets()
        if args.list_rules:
            print(_report.render_cost_list(
                _cost.registered().values(),
                [t for t in _targets.registered().values()
                 if "cost" in t.tags]))
            return 0
        problems = [f"unknown cost rule: {r} (registered: "
                    f"{sorted(_cost.names())})"
                    for r in (args.rules or []) if r not in _cost.names()]
        problems += [f"unknown cost target: {t} (registered: "
                     f"{sorted(n for n in _targets.names() if n.startswith(('cost.', 'sass.')))})"
                     for t in (args.targets or [])
                     if t not in _targets.names()]
        if args.paths:
            problems.append(
                "--cost audits the registered cost targets, not paths "
                f"(got: {[str(p) for p in args.paths]})")
        if problems:
            return _report_problems(problems)
        report = _cost.audit(target_ids=args.targets, rule_ids=args.rules)
        rules = _cost.select(args.rules)
    elif args.trace:
        # imported lazily: trace mode pulls in torch; plain AST lints stay
        # dependency-light and fast.
        from repro_torch.analysis import targets as _targets
        from repro_torch.analysis import trace as _trace
        if args.list_rules:
            print(_report.render_trace_list(
                _trace.registered().values(),
                [t for t in _targets.registered().values()
                 if "cost" not in t.tags]))
            return 0
        problems = [f"unknown trace rule: {r} (registered: "
                    f"{sorted(_trace.names())})"
                    for r in (args.rules or []) if r not in _trace.names()]
        problems += [f"unknown trace target: {t} (registered: "
                     f"{sorted(_targets.names())})"
                     for t in (args.targets or [])
                     if t not in _targets.names()]
        if args.paths:
            problems.append(
                "--trace audits the registered targets, not paths "
                f"(got: {[str(p) for p in args.paths]})")
        if problems:
            return _report_problems(problems)
        report = _trace.audit(target_ids=args.targets, rule_ids=args.rules)
        rules = _trace.select(args.rules)
    else:
        if args.list_rules:
            print(_report.render_rule_list())
            return 0
        problems = [f"unknown rule: {r} (registered: {sorted(names())})"
                    for r in (args.rules or []) if r not in names()]
        paths = args.paths or [_default_target()]
        problems += _path_problems(paths)
        if problems:
            return _report_problems(problems)
        report = lint_paths(paths, rule_ids=args.rules)
        rules = None  # render_json/render_sarif default to the AST registry

    if args.sarif:
        print(_report.render_sarif(report, rules=rules))
    elif args.json:
        print(_report.render_json(report, budget=args.budget, rules=rules))
    else:
        print(_report.render_text(report, strict=args.strict,
                                  show_exemptions=args.show_exemptions,
                                  budget=args.budget))
    rc = report.exit_code(strict=args.strict)
    if rc == 0 and not _report.budget_ok(report, args.budget):
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
