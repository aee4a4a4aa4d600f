"""Lock-discipline checkers.

``lock-discipline`` — a field annotated ``# guarded-by: <lock>`` at its
``__init__`` assignment may only be MUTATED (assigned, subscript-stored,
or hit with a mutating method like ``.append``/``.pop``/``.update``)
inside a lexical ``with self.<lock>:`` block of the same class, or in a
function carrying ``# rmtcheck: holds=<lock>`` (caller-held contract).
``__init__`` itself is construction-before-threads and exempt. Reads are
not checked (too many benign racy reads are by design: monotonic
counters, snapshot loops); aliased mutation (``x = self.f; x.pop()``)
is out of scope — annotate the hot path, not every alias.

``blocking-under-lock`` — inside any held lock-like region (a ``with``
whose subject's last name segment looks like a lock: ``*lock``, ``*mu``,
``*mutex``, ``*cond``, ``*sem``), flag calls that can block the thread:
``time.sleep``/``.sleep()``, ``subprocess.*``, ``os.system``,
``socket.create_connection``, ``select.select``, ``.accept()``,
``.recv*()``, and ``.wait()``/``.wait_for()`` on anything OTHER than the
held subject itself (``cond.wait()`` under ``with cond:`` is the
condition-variable protocol and legal). This is the transfer/metrics race
class: a sleep or socket read under a hot lock turns every other thread
into a convoy.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .engine import (
    GUARDED_BY_RE, Project, SourceFile, Violation, register, self_attr,
    unparse,
)

MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "clear", "update", "add", "discard", "setdefault",
    "__setitem__", "popitem",
}

_LOCKISH_RE = re.compile(r"(lock|mutex|cond|sem)$|(^|_)mu$")

BLOCKING_SIMPLE = {
    "time.sleep", "os.system", "socket.create_connection",
    "select.select", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "subprocess.Popen",
}
BLOCKING_METHOD_ATTRS = {
    "sleep", "accept", "recv", "recv_bytes", "recv_bytes_into",
}
WAIT_ATTRS = {"wait", "wait_for"}


def _lockish(expr: ast.AST) -> bool:
    """Does a with-subject look like a lock/condition/semaphore?"""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Subscript):
        # self._conn_send_locks[conn] — a lock table entry
        return _lockish(expr.value)
    elif isinstance(expr, ast.Call):
        return False  # ``with self._applied(...)`` etc: not a lock
    else:
        return False
    return bool(_LOCKISH_RE.search(name.lower()))


def _guarded_fields(sf: SourceFile, cls: ast.ClassDef) -> Dict[str, Tuple[str, int]]:
    """{field: (lock_attr, annotation_line)} from ``# guarded-by:``
    comments on ``self.<field> =`` lines inside the class body."""
    out: Dict[str, Tuple[str, int]] = {}
    end = max(getattr(cls, "end_lineno", cls.lineno), cls.lineno)
    assign_re = re.compile(r"^\s*self\.(\w+)\s*[:=]")
    for lineno in range(cls.lineno, end + 1):
        line = sf.line_text(lineno)
        m = GUARDED_BY_RE.search(line)
        if not m:
            continue
        am = assign_re.match(line)
        if am:
            lock = m.group(1)
            if lock.startswith("self."):
                lock = lock[len("self."):]
            out[am.group(1)] = (lock, lineno)
    return out


def _with_held_attrs(node: ast.With) -> Set[str]:
    """self.<attr> lock attributes acquired by a with statement."""
    out: Set[str] = set()
    for item in node.items:
        attr = self_attr(item.context_expr)
        if attr is not None:
            out.add(attr)
    return out


def _mutated_field(stmt: ast.AST) -> List[Tuple[str, int]]:
    """(field, lineno) for every self.<field> mutation in ONE statement
    node (non-recursive over child statements)."""
    found: List[Tuple[str, int]] = []

    def target_fields(t: ast.AST) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                target_fields(e)
            return
        a = self_attr(t)
        if a is not None:
            found.append((a, t.lineno))
            return
        if isinstance(t, ast.Subscript):
            a = self_attr(t.value)
            if a is not None:
                found.append((a, t.lineno))
        if isinstance(t, ast.Starred):
            target_fields(t.value)

    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) else \
            [stmt.target]
        for t in targets:
            target_fields(t)
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            target_fields(t)
    elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        call = stmt.value
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in MUTATOR_METHODS:
            a = self_attr(call.func.value)
            if a is not None:
                found.append((a, call.lineno))
    return found


@register("lock-discipline")
def check_lock_discipline(project: Project, options: dict
                          ) -> List[Violation]:
    out: List[Violation] = []
    for sf in project.files:
        if sf.tree is None:
            continue
        for cls in [n for n in ast.walk(sf.tree)
                    if isinstance(n, ast.ClassDef)]:
            guarded = _guarded_fields(sf, cls)
            if not guarded:
                continue
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__":
                    continue
                held0 = set(sf.holds_annotation(fn))
                _walk_guarded(sf, fn.body, held0, guarded, out, sf.rel)
    return out


def _walk_guarded(sf: SourceFile, body: List[ast.stmt], held: Set[str],
                  guarded: Dict[str, Tuple[str, int]],
                  out: List[Violation], rel: str) -> None:
    for stmt in body:
        for field, lineno in _mutated_field(stmt):
            info = guarded.get(field)
            if info is None:
                continue
            lock, _ = info
            if lock not in held:
                out.append(Violation(
                    "lock-discipline", rel, lineno,
                    f"self.{field} is guarded-by {lock} but mutated "
                    f"without holding it (held: "
                    f"{sorted(held) if held else 'nothing'})"))
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            _walk_guarded(sf, stmt.body, held | _with_held_attrs(stmt),
                          guarded, out, rel)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs LATER (thread target, callback): only its
            # own holds= contract applies
            _walk_guarded(sf, stmt.body, set(sf.holds_annotation(stmt)),
                          guarded, out, rel)
        else:
            for child in _child_bodies(stmt):
                _walk_guarded(sf, child, held, guarded, out, rel)


def _child_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
    bodies = []
    for name in ("body", "orelse", "finalbody"):
        b = getattr(stmt, name, None)
        if b:
            bodies.append(b)
    for h in getattr(stmt, "handlers", ()) or ():
        bodies.append(h.body)
    return bodies


# ------------------------------------------------------- blocking-under-lock
def _blocking_call(call: ast.Call, held_exprs: Set[str]
                   ) -> Optional[str]:
    """A human-readable description when ``call`` can block, else None.
    ``held_exprs``: unparsed with-subjects currently held (so waiting on
    the held condition itself is allowed)."""
    func = call.func
    dotted = unparse(func)
    if dotted in BLOCKING_SIMPLE:
        return dotted
    if isinstance(func, ast.Attribute):
        if func.attr in BLOCKING_METHOD_ATTRS:
            return f"{dotted}()"
        if func.attr in WAIT_ATTRS:
            subject = unparse(func.value)
            if subject not in held_exprs:
                return f"{dotted}() (not the held condition)"
    return None


@register("blocking-under-lock")
def check_blocking_under_lock(project: Project, options: dict
                              ) -> List[Violation]:
    out: List[Violation] = []
    for sf in project.files:
        if sf.tree is None:
            continue
        _walk_blocking(sf, sf.tree.body, frozenset(), out)
    return out


def _stmt_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expression fields that execute as part of THIS statement
    (child statement lists are walked separately so lock regions nest
    correctly)."""
    exprs: List[ast.AST] = []
    for name in ("test", "value", "iter", "exc", "cause", "msg"):
        e = getattr(stmt, name, None)
        if isinstance(e, ast.AST):
            exprs.append(e)
    if isinstance(stmt, ast.Assign):
        exprs.extend(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        exprs.append(stmt.target)
    elif isinstance(stmt, ast.Delete):
        exprs.extend(stmt.targets)
    elif isinstance(stmt, ast.Return) and stmt.value is None:
        pass
    return exprs


def _calls_in(expr: ast.AST):
    """Call nodes in an expression, NOT descending into lambdas (their
    bodies run later, outside the current lock region)."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _walk_blocking(sf: SourceFile, body: List[ast.stmt],
                   held_exprs: frozenset, out: List[Violation]) -> None:
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested/top-level def starts a fresh region (plus any
            # caller-held contract from its holds= annotation, which for
            # blocking purposes names self.<lock> subjects)
            held0 = frozenset(f"self.{a}"
                              for a in sf.holds_annotation(stmt))
            _walk_blocking(sf, stmt.body, held0, out)
            continue
        if held_exprs:
            for expr in _stmt_exprs(stmt):
                for call in _calls_in(expr):
                    desc = _blocking_call(call, set(held_exprs))
                    if desc:
                        out.append(Violation(
                            "blocking-under-lock", sf.rel, call.lineno,
                            f"blocking call {desc} while holding "
                            f"{sorted(held_exprs)}"))
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_exprs = set(held_exprs)
            for item in stmt.items:
                if held_exprs:
                    for call in _calls_in(item.context_expr):
                        desc = _blocking_call(call, set(held_exprs))
                        if desc:
                            out.append(Violation(
                                "blocking-under-lock", sf.rel,
                                call.lineno,
                                f"blocking call {desc} while holding "
                                f"{sorted(held_exprs)}"))
                if _lockish(item.context_expr):
                    new_exprs.add(unparse(item.context_expr))
            _walk_blocking(sf, stmt.body, frozenset(new_exprs), out)
        elif isinstance(stmt, ast.ClassDef):
            _walk_blocking(sf, stmt.body, frozenset(), out)
        else:
            for child in _child_bodies(stmt):
                _walk_blocking(sf, child, held_exprs, out)
