"""Linter core: annotated ASTs, pragma parsing, and the lint entry points
(counterpart of ``repro/analysis/core.py``, with the same pragma grammar
and report types; only the package root it resolves paths against is
``repro_torch``).

Design notes
------------

* **Annotated AST** (``FileContext``): a plain ``ast.parse`` tree plus
  the three indexes every rule wants — resolved import aliases (so
  ``F.linear`` and ``torch.nn.functional.linear`` are the same dotted
  name), parent
  links (so a node knows its enclosing functions), and the set of nodes
  that sit in default-argument position (so ``compute_dtype=torch.float32``
  as a *parameter default* is distinguishable from a hard-coded dtype in
  a kernel body).
* **Pragmas** are comments, invisible to ``ast``; they are lexed with
  ``tokenize`` from the same source, so strings containing pragma-shaped
  text never count. A trailing pragma covers its own physical line; a
  standalone comment covers the next code line (violations anchor at the
  ``ast`` node's ``lineno``, which for a multi-line call is the line the
  callee starts on).
* ``lint_source`` matches violations against pragmas per ``(line, rule)``,
  marks used pragmas, and reports pragma *errors* (empty reason, unknown
  rule id) separately — ``--strict`` promotes those to failures so every
  exemption in the tree stays auditable.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

PRAGMA_MARKER = "contract:"
_PRAGMA_RE = re.compile(r"allow-([A-Za-z0-9][A-Za-z0-9-]*)\(([^)]*)\)")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: a contract rule fired at ``file:line``."""

    rule: str
    path: str            # package-relative posix path (e.g. "models/moe.py")
    line: int
    col: int
    message: str
    fix_hint: str = ""

    def format(self) -> str:
        hint = f" [fix: {self.fix_hint}]" if self.fix_hint else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}{hint}"


@dataclasses.dataclass
class Pragma:
    """One ``# contract: allow-<rule>(<reason>)`` exemption."""

    rule: str
    reason: str
    path: str
    line: int            # line the pragma COVERS (not the comment line)
    comment_line: int
    used: bool = False


@dataclasses.dataclass
class LintReport:
    """Everything one lint run produced, pre-formatting."""

    violations: List[Violation] = dataclasses.field(default_factory=list)
    exemptions: List[Pragma] = dataclasses.field(default_factory=list)
    pragma_errors: List[str] = dataclasses.field(default_factory=list)
    files: int = 0

    def extend(self, other: "LintReport") -> None:
        self.violations.extend(other.violations)
        self.exemptions.extend(other.exemptions)
        self.pragma_errors.extend(other.pragma_errors)
        self.files += other.files

    def exit_code(self, strict: bool = False) -> int:
        if self.violations:
            return 1
        if strict and self.pragma_errors:
            return 1
        return 0


# ---------------------------------------------------------------------------
# Annotated AST
# ---------------------------------------------------------------------------

class FileContext:
    """One file's annotated AST — the object every rule checker receives.

    relpath   package-relative posix path ("models/moe.py"), the string
              rule scope globs match against
    tree      the parsed module
    aliases   import-alias map: local name -> absolute dotted module/attr
              (``F`` -> ``torch.nn.functional``)
    """

    def __init__(self, source: str, relpath: str, display_path: str = ""):
        self.relpath = relpath
        self.display_path = display_path or relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=self.display_path)
        self.aliases: Dict[str, str] = {}
        self._parents: Dict[ast.AST, ast.AST] = {}
        self._default_nodes: set = set()
        self._annotate()

    # -- construction -------------------------------------------------------
    def _annotate(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                args = node.args
                for d in (*args.defaults, *args.kw_defaults):
                    if d is not None:
                        self._default_nodes.update(ast.walk(d))

    # -- navigation ---------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_functions(self, node: ast.AST) -> Tuple[str, ...]:
        """Names of enclosing function defs, innermost first."""
        out = []
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur.name)
            cur = self._parents.get(cur)
        return tuple(out)

    def in_function_body(self, node: ast.AST) -> bool:
        """True when node sits inside some function def (module-level
        constants like ``COMPUTE_DTYPE = torch.float32`` stay allowed)."""
        return bool(self.enclosing_functions(node))

    def in_default_arg(self, node: ast.AST) -> bool:
        """True when node is (part of) a parameter's default value."""
        return node in self._default_nodes

    # -- name resolution ----------------------------------------------------
    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted absolute name for a Name/Attribute chain, resolving
        import aliases (``F.linear`` -> ``torch.nn.functional.linear``);
        None when the chain bottoms out in anything but a Name (e.g. a
        call result)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    # -- iteration helpers --------------------------------------------------
    def walk(self) -> Iterator[ast.AST]:
        return ast.walk(self.tree)

    def calls(self) -> Iterator[ast.Call]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                yield node

    def functions(self) -> Iterator[ast.FunctionDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    # -- violation factory --------------------------------------------------
    def violation(self, node: ast.AST, rule: str, message: str,
                  fix_hint: str = "") -> Violation:
        return Violation(rule=rule, path=self.display_path,
                         line=getattr(node, "lineno", 0),
                         col=getattr(node, "col_offset", 0) + 1,
                         message=message, fix_hint=fix_hint)


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------

def parse_pragmas(source: str, display_path: str,
                  ) -> Tuple[List[Pragma], List[str]]:
    """Lex ``# contract: allow-<rule>(<reason>)`` pragmas out of comments.

    Returns (pragmas, errors). A trailing pragma covers its own line; a
    standalone comment line covers the next non-blank, non-comment line.
    Empty reasons are errors (exemptions must say WHY); a ``contract:``
    marker with no parseable ``allow-...(...)`` is an error too (a typo'd
    pragma silently not applying would be worse).
    """
    pragmas: List[Pragma] = []
    errors: List[str] = []
    lines = source.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenError:
        return pragmas, errors
    for tok in tokens:
        if tok.type != tokenize.COMMENT or PRAGMA_MARKER not in tok.string:
            continue
        comment_line = tok.start[0]
        body = tok.string.split(PRAGMA_MARKER, 1)[1]
        matches = list(_PRAGMA_RE.finditer(body))
        if not matches:
            errors.append(
                f"{display_path}:{comment_line}: malformed contract pragma "
                f"(expected 'allow-<rule>(<reason>)'): {tok.string.strip()}")
            continue
        standalone = lines[comment_line - 1][:tok.start[1]].strip() == ""
        covers = comment_line
        if standalone:
            covers = _next_code_line(lines, comment_line)
        for m in matches:
            rule_id, reason = m.group(1), m.group(2).strip()
            if not reason:
                errors.append(
                    f"{display_path}:{comment_line}: pragma allow-{rule_id} "
                    f"has an empty reason — exemptions must say why")
                continue
            pragmas.append(Pragma(rule=rule_id, reason=reason,
                                  path=display_path, line=covers,
                                  comment_line=comment_line))
    return pragmas, errors


def _next_code_line(lines: List[str], after: int) -> int:
    """First line after ``after`` (1-based) that holds code."""
    for i in range(after, len(lines)):
        stripped = lines[i].strip()
        if stripped and not stripped.startswith("#"):
            return i + 1
    return after


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, relpath: str, display_path: str = "",
                rule_ids: Optional[Iterable[str]] = None) -> LintReport:
    """Lint one source string as package-relative path ``relpath``.

    The unit every entry point funnels into (and the one tests drive
    directly with fixture snippets). Scope globs match ``relpath``;
    diagnostics print ``display_path`` (defaults to relpath).
    """
    from repro_torch.analysis import rules as _rules

    report = LintReport(files=1)
    display_path = display_path or relpath
    try:
        ctx = FileContext(source, relpath, display_path)
    except SyntaxError as e:
        report.pragma_errors.append(f"{display_path}: not parseable: {e}")
        return report

    pragmas, errors = parse_pragmas(source, display_path)
    report.pragma_errors.extend(errors)
    known = set(_rules.names())
    for p in pragmas:
        if p.rule not in known:
            report.pragma_errors.append(
                f"{p.path}:{p.comment_line}: pragma names unknown rule "
                f"{p.rule!r} (registered: {sorted(known)})")
    by_line: Dict[Tuple[int, str], Pragma] = {
        (p.line, p.rule): p for p in pragmas}

    active = _rules.select(rule_ids)
    for rule in active:
        if not rule.applies_to(relpath):
            continue
        for v in rule.checker(ctx):
            pragma = by_line.get((v.line, v.rule))
            if pragma is not None:
                pragma.used = True
                continue
            report.violations.append(
                dataclasses.replace(v, fix_hint=v.fix_hint or rule.fix_hint))
    report.exemptions.extend(pragmas)
    report.violations.sort(key=lambda v: (v.path, v.line, v.col))
    return report


#: the package root directory scope globs are relative to
PACKAGE = "repro_torch"


def package_relpath(path: Path) -> str:
    """Path relative to the ``repro_torch`` package root, posix-style.

    ``src/repro_torch/models/moe.py`` -> ``models/moe.py``. Files outside
    a ``repro_torch`` directory fall back to their own name (scope globs
    then match against that), so the linter still runs on loose files.
    """
    parts = path.resolve().parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i + 1:])
    return path.name


def lint_file(path: Path, rule_ids: Optional[Iterable[str]] = None,
              root: Optional[Path] = None) -> LintReport:
    path = Path(path)
    try:
        source = path.read_text()
    except OSError as e:
        report = LintReport(files=1)
        report.pragma_errors.append(f"{path}: unreadable: {e}")
        return report
    display = str(path)
    if root is not None:
        try:
            display = str(path.relative_to(root))
        except ValueError:
            pass
    return lint_source(source, package_relpath(path), display,
                       rule_ids=rule_ids)


def lint_paths(paths: Iterable[Path],
               rule_ids: Optional[Iterable[str]] = None) -> LintReport:
    """Lint files and/or directory trees (``*.py``, sorted, recursive)."""
    report = LintReport()
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                report.extend(lint_file(f, rule_ids, root=Path.cwd()))
        else:
            report.extend(lint_file(p, rule_ids, root=Path.cwd()))
    return report
