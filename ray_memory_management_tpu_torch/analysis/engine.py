"""rmtcheck engine: file discovery, pragma handling, checker registry.

The runtime grew a set of CONVENTION-based invariants — ``# guarded-by``
lock discipline, the canonical ``rmt_*`` metric registry, the named
fault-site plane, additive-only wire protocol v2, ContextVar trace
propagation — that nothing machine-checked (Ray itself lints exactly
this class of invariant in CI). Each convention gets one AST checker
here; the suite runs as ``python -m ray_memory_management_tpu_torch.analysis``
(CLI ``rmt check``) and as the tier-1 test
``tests/test_static_analysis.py`` asserting zero violations on the tree.

Suppression grammar (audited exceptions only — every pragma carries its
reason in the trailing comment text)::

    some_code()  # rmtcheck: disable=<rule>[,<rule>] — <reason>

A pragma suppresses its own line and, when it sits alone on a line, the
line below. ``# rmtcheck: disable-file=<rule>`` within the first 20
lines suppresses a rule for the whole file. ``# rmtcheck: holds=<lock>``
on a ``def`` line asserts the function runs with ``self.<lock>`` held by
its caller (the lock checkers treat the body as a held-lock region).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

PRAGMA_RE = re.compile(r"#\s*rmtcheck:\s*disable=([\w,\-]+)")
FILE_PRAGMA_RE = re.compile(r"#\s*rmtcheck:\s*disable-file=([\w,\-]+)")
HOLDS_RE = re.compile(r"#\s*rmtcheck:\s*holds=([\w,]+)")
GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([\w.]+)")


class Violation:
    """One invariant breach at a file:line."""

    __slots__ = ("rule", "path", "line", "message")

    def __init__(self, rule: str, path: str, line: int, message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Violation({self.format()})"


class SourceFile:
    """One parsed module: text, per-line pragmas, AST (None on syntax
    error — reported as its own violation by run_checks)."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.syntax_error: Optional[str] = None
        try:
            self.tree = ast.parse(text, filename=rel)
        except SyntaxError as e:  # pragma: no cover - tree always parses
            self.syntax_error = f"syntax error: {e.msg} (line {e.lineno})"
        # line -> set(rules) disabled there
        self._disabled: Dict[int, set] = {}
        self._file_disabled: set = set()
        for i, line in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(line)
            if m:
                rules = set(m.group(1).split(","))
                self._disabled.setdefault(i, set()).update(rules)
                # a standalone pragma line covers the statement below it
                if line.strip().startswith("#"):
                    self._disabled.setdefault(i + 1, set()).update(rules)
            if i <= 20:
                fm = FILE_PRAGMA_RE.search(line)
                if fm:
                    self._file_disabled.update(fm.group(1).split(","))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        if rule in self._file_disabled:
            return True
        return rule in self._disabled.get(lineno, ())

    def holds_annotation(self, node: ast.AST) -> List[str]:
        """Locks asserted held for a function via ``# rmtcheck: holds=``
        on (or directly above) its ``def`` line."""
        locks: List[str] = []
        for lineno in (getattr(node, "lineno", 0),
                       getattr(node, "lineno", 0) - 1):
            m = HOLDS_RE.search(self.line_text(lineno))
            if m:
                locks.extend(m.group(1).split(","))
        return locks


class Project:
    """The file sets the checkers see: the package tree (checked) and
    the test tree (scanned only for references, never checked)."""

    def __init__(self, package_root: str, test_root: Optional[str] = None,
                 repo_root: Optional[str] = None, test_prefix: str = ""):
        self.package_root = package_root
        self.test_root = test_root
        self.repo_root = repo_root or os.path.dirname(package_root)
        self.files: List[SourceFile] = self._load(package_root)
        # the repo's tests/ also holds the JAX package's tests: the port
        # counts only its own (``test_prefix="test_torch_"``)
        self.test_files: List[SourceFile] = [
            sf for sf in (
                self._load(test_root, skip_dirs=("analysis_fixtures",))
                if test_root and os.path.isdir(test_root) else [])
            if os.path.basename(sf.path).startswith(test_prefix)]

    def _load(self, root: str, skip_dirs: Tuple[str, ...] = ()
              ) -> List[SourceFile]:
        out: List[SourceFile] = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",) + skip_dirs)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, self.repo_root)
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        out.append(SourceFile(path, rel, f.read()))
                except OSError:  # pragma: no cover - unreadable file
                    continue
        return out

    def get(self, rel_suffix: str) -> Optional[SourceFile]:
        for sf in self.files:
            if sf.rel.endswith(rel_suffix):
                return sf
        return None


# rule name -> checker(project, options) -> [Violation]
CheckerFn = Callable[[Project, dict], List[Violation]]
_REGISTRY: Dict[str, CheckerFn] = {}


def register(rule: str) -> Callable[[CheckerFn], CheckerFn]:
    def deco(fn: CheckerFn) -> CheckerFn:
        _REGISTRY[rule] = fn
        return fn
    return deco


def all_rules() -> List[str]:
    return sorted(_REGISTRY)


def run_checks(package_root: str, test_root: Optional[str] = None,
               rules: Optional[List[str]] = None,
               options: Optional[dict] = None) -> List[Violation]:
    """Run the (selected) checkers over the tree; returns unsuppressed
    violations sorted by path:line. ``options``: ``frozen`` (bool) makes
    protocol-additivity treat NEW wire keys as violations instead of
    auto-registering them (the CI mode); ``test_prefix`` (str) keeps
    only the test files whose name starts with it."""
    # import the checker modules so they register (lazy: the analysis
    # package must stay importable without running anything)
    from . import (  # noqa: F401
        check_faults, check_health, check_locks, check_logs,
        check_metrics, check_protocol, check_trace,
    )

    opts = dict(options or {})
    project = Project(package_root, test_root,
                      test_prefix=opts.get("test_prefix", ""))
    out: List[Violation] = []
    for sf in project.files:
        if sf.syntax_error:
            out.append(Violation("parse", sf.rel, 1, sf.syntax_error))
    for rule in (rules or all_rules()):
        fn = _REGISTRY.get(rule)
        if fn is None:
            raise ValueError(f"unknown rule {rule!r} (want {all_rules()})")
        for v in fn(project, opts):
            sf = next((f for f in project.files if f.rel == v.path), None)
            if sf is not None and sf.suppressed(v.rule, v.line):
                continue
            out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


# --------------------------------------------------------------- AST helpers
def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - very old ast shapes
        return "<expr>"


def dict_literal_keys(node: ast.Dict) -> List[str]:
    """String keys of a dict literal (non-literal keys skipped)."""
    keys = []
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.append(k.value)
    return keys


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def self_attr(node: ast.AST) -> Optional[str]:
    """'x' for ``self.x``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None
