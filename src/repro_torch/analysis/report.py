"""Text, JSON and SARIF reporters for lint results (counterpart of
``repro/analysis/report.py``; the same schema, only the tool name is
``repro_torch.analysis``).

Text output is grep/editor-friendly ``file:line:col: rule: message``
lines; JSON is the machine-readable artifact (stable keys — the schema
is pinned by tests/test_torch_analysis.py) consumed by CI tooling and the
exemption audit.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional

from repro_torch.analysis.core import LintReport
from repro_torch.analysis.rules import registered


def budget_ok(report: LintReport, budget: Optional[int]) -> bool:
    """True when the annotated-exemption count fits the ratchet budget
    (or no budget was requested)."""
    return budget is None or len(report.exemptions) <= budget


def render_text(report: LintReport, *, strict: bool = False,
                show_exemptions: bool = False,
                budget: Optional[int] = None) -> str:
    out: List[str] = []
    for v in report.violations:
        out.append(v.format())
    for e in report.pragma_errors:
        prefix = "error" if strict else "warning"
        out.append(f"{prefix}: {e}")
    unused = [p for p in report.exemptions if not p.used]
    for p in unused:
        out.append(
            f"warning: {p.path}:{p.comment_line}: pragma "
            f"allow-{p.rule} suppresses nothing (stale exemption?)")
    if show_exemptions:
        for p in report.exemptions:
            out.append(f"exempt: {p.path}:{p.line}: {p.rule}: {p.reason}")
    n_ex = len(report.exemptions)
    if budget is not None:
        if n_ex > budget:
            out.append(
                f"error: {n_ex} annotated exemption(s) exceed the budget "
                f"of {budget} — remove a pragma (or raise the ratchet "
                f"deliberately in tests/test_torch_analysis.py)")
        else:
            out.append(f"exemption budget: {n_ex}/{budget}")
    out.append(
        f"{report.files} file(s), {len(report.violations)} violation(s), "
        f"{n_ex} annotated exemption(s)"
        + (f", {len(report.pragma_errors)} pragma error(s)"
           if report.pragma_errors else ""))
    return "\n".join(out)


def _rule_entry(r) -> dict:
    # AST rules carry ``scope`` (path globs); trace rules carry ``tags``
    # (target-tag selectors). Both render under the "scope" key.
    scope = getattr(r, "scope", None)
    if scope is None:
        scope = getattr(r, "tags", ())
    return {"id": r.id, "doc": r.doc, "scope": list(scope),
            "fix_hint": r.fix_hint}


def render_json(report: LintReport, *, budget: Optional[int] = None,
                rules: Optional[Iterable] = None) -> str:
    rule_objs = list(rules) if rules is not None else \
        list(registered().values())
    payload = {
        "files": report.files,
        "violations": [dataclasses.asdict(v) for v in report.violations],
        "exemptions": [
            {"rule": p.rule, "reason": p.reason, "path": p.path,
             "line": p.line, "comment_line": p.comment_line,
             "used": p.used}
            for p in report.exemptions
        ],
        "pragma_errors": list(report.pragma_errors),
        "rules": [_rule_entry(r) for r in rule_objs],
        "budget": {
            "limit": budget,
            "exemptions": len(report.exemptions),
            "ok": budget_ok(report, budget),
        },
    }
    return json.dumps(payload, indent=2, sort_keys=True)


def render_rule_list() -> str:
    out = ["registered contract rules:"]
    for r in registered().values():
        out.append(f"  {r.id}")
        out.append(f"      {r.doc}")
        out.append(f"      scope: {', '.join(r.scope)}"
                   + (f"  (excluding {', '.join(r.exclude)})"
                      if r.exclude else ""))
        out.append(f"      fix: {r.fix_hint}")
    out.append("")
    out.append("pragma escape: # contract: allow-<rule>(<non-empty reason>)")
    return "\n".join(out)


def _render_target_level_list(level: str, rules: Iterable,
                              targets: Iterable) -> str:
    out = [f"registered {level} rules:"]
    for r in rules:
        out.append(f"  {r.id}")
        out.append(f"      {r.doc}")
        out.append(f"      applies to tags: {', '.join(r.tags)}")
        out.append(f"      fix: {r.fix_hint}")
    out.append("")
    out.append(f"registered {level} targets:")
    for t in targets:
        out.append(f"  {t.id}  [{', '.join(t.tags)}]")
        out.append(f"      {t.doc}")
        for rule_id, reason in sorted(t.exempt.items()):
            out.append(f"      exempt {rule_id}: {reason}")
    out.append("")
    out.append("exemption escape: Target(..., exempt={'<rule>': '<reason>'})")
    return "\n".join(out)


def render_trace_list(rules: Iterable, targets: Iterable) -> str:
    """``--trace --list-rules`` view: trace rules plus the target registry."""
    return _render_target_level_list("trace", rules, targets)


def render_cost_list(rules: Iterable, targets: Iterable) -> str:
    """``--cost --list-rules`` view: cost rules plus the cost targets."""
    return _render_target_level_list("cost", rules, targets)


#: pinned SARIF version/schema — tests/test_torch_analysis.py asserts these so
#: CI annotation consumers can rely on the exact dialect.
#: the SARIF tool name (the reference reports "repro.analysis")
TOOL_NAME = "repro_torch.analysis"
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def render_sarif(report: LintReport, *,
                 rules: Optional[Iterable] = None) -> str:
    """SARIF 2.1.0 report — the CI-annotation dialect every level shares.

    Violations map to error-level results anchored at their
    ``path:line:col`` (trace/cost findings carry line 0, clamped to the
    SARIF minimum of 1); pragma errors surface as warning-level
    ``pragma-error`` results so a malformed exemption is visible in the
    same annotation stream it tried to silence.
    """
    rule_objs = list(rules) if rules is not None else \
        list(registered().values())

    def _result(rule_id: str, level: str, message: str, path: str,
                line: int, col: int) -> dict:
        return {
            "ruleId": rule_id,
            "level": level,
            "message": {"text": message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": path},
                    "region": {"startLine": max(line, 1),
                               "startColumn": max(col + 1, 1)},
                },
            }],
        }

    results = [
        _result(v.rule, "error",
                v.message + (f" [fix: {v.fix_hint}]" if v.fix_hint else ""),
                v.path, v.line, v.col)
        for v in report.violations
    ]
    results += [
        _result("pragma-error", "warning", e, "", 1, 0)
        for e in report.pragma_errors
    ]
    payload = {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": TOOL_NAME,
                    "rules": [{
                        "id": r.id,
                        "shortDescription": {"text": r.doc},
                        "help": {"text": r.fix_hint},
                    } for r in rule_objs],
                },
            },
            "results": results,
        }],
    }
    return json.dumps(payload, indent=2, sort_keys=True)
