"""``log-discipline`` — package code uses the structured log plane.

The runtime has a cluster log plane (utils/structlog.py): a
record emitted through the package logger carries node/role/task/trace
identity and lands in the head LogStore; a bare ``print()`` yields an
anonymous line on some process's stderr that no query surface can find.
Two conventions keep the plane authoritative:

- no bare ``print()`` in library code. CLI entry points (``scripts/``,
  any ``__main__.py``), bench/microbench modules and the top-level
  ``setup``-style scripts are console programs whose stdout IS the
  interface — they are exempt. Audited exceptions (e.g. a user-facing
  ``Dataset.show()``) carry a pragma with a reason.

- log calls format lazily: ``log.warning("x %s", v)``, never
  ``log.warning(f"x {v}")``. Eager formatting pays string-build cost
  even when the level is filtered, and it destroys the constant message
  template that makes records aggregatable.
"""

from __future__ import annotations

import ast
from typing import List

from .engine import Project, Violation, register

_LOG_METHODS = {"debug", "info", "warning", "error", "exception",
                "critical"}
# receivers that are conventionally loggers; plus any name assigned from
# a get_logger()/getLogger() call in the same file (collected per file)
_LOGGER_NAMES = {"log", "logger", "_log", "_logger", "LOG"}
_LOGGER_FACTORIES = {"get_logger", "getLogger"}


def _is_exempt(rel: str) -> bool:
    base = rel.rsplit("/", 1)[-1]
    return ("/scripts/" in rel
            or base == "__main__.py"
            or base.endswith("_bench.py")
            or base == "microbenchmark.py")


def _logger_vars(tree: ast.AST) -> set:
    names = set(_LOGGER_NAMES)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr in _LOGGER_FACTORIES):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
            elif isinstance(tgt, ast.Attribute):
                names.add(tgt.attr)
    return names


def _receiver_name(func: ast.Attribute) -> str:
    base = func.value
    if isinstance(base, ast.Name):
        return base.id
    if isinstance(base, ast.Attribute):
        return base.attr
    return ""


def _eager_reason(arg: ast.AST) -> str:
    """Why the first log argument formats eagerly, or '' if it's fine."""
    if isinstance(arg, ast.JoinedStr):
        return "an f-string"
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Mod):
        return "%-interpolation"
    if isinstance(arg, ast.Call) and \
            isinstance(arg.func, ast.Attribute) and \
            arg.func.attr == "format":
        return "str.format()"
    return ""


@register("log-discipline")
def check_log_discipline(project: Project, options: dict
                         ) -> List[Violation]:
    out: List[Violation] = []
    for sf in project.files:
        if sf.tree is None or _is_exempt(sf.rel):
            continue
        loggers = _logger_vars(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name) and func.id == "print":
                out.append(Violation(
                    "log-discipline", sf.rel, node.lineno,
                    "bare print() in package code — use the package "
                    "logger (utils/structlog.get_logger) so the line "
                    "carries node/task/trace identity and reaches the "
                    "head LogStore; scripts/, __main__.py and bench "
                    "modules are exempt"))
                continue
            if isinstance(func, ast.Attribute) and \
                    func.attr in _LOG_METHODS and \
                    _receiver_name(func) in loggers and node.args:
                reason = _eager_reason(node.args[0])
                if reason:
                    out.append(Violation(
                        "log-discipline", sf.rel, node.lineno,
                        f"log call formats its message eagerly with "
                        f"{reason} — pass a %s template and args "
                        f"(log.{func.attr}(\"x %s\", v)) so formatting "
                        f"is skipped when the level is filtered and "
                        f"the template stays aggregatable"))
    return out
