"""``trace-propagation`` — every function that serializes a
dispatch/done/transfer frame must carry the trace context.

The tracing plane makes spans causal by threading ``trace_ctx`` through
every hop: dispatch frames (``{"type": "exec"|"exec_actor"}`` built in
core/runtime.py), done frames (``{"type": "done"}`` in core/worker.py),
and transfer request headers (dicts carrying both ``"oid"`` and
``"proto"`` in core/transfer.py). A new frame constructor that forgets
the trace field doesn't fail anything — the span tree just silently
loses its parent edge. So: any function containing one of those frame
literals must mention a trace identifier (``trace_ctx``, ``trace``,
``_trace...``) somewhere in its body.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .engine import Project, Violation, dict_literal_keys, register

_FRAME_TYPES = {"exec", "exec_actor", "done"}
_FRAME_FILES = ("core/runtime.py", "core/worker.py",
                "core/node_agent.py", "core/remote_node.py")
_TRANSFER_SUFFIX = "core/transfer.py"


def _is_frame_dict(node: ast.Dict, in_transfer: bool) -> bool:
    keys = dict_literal_keys(node)
    if in_transfer:
        return "oid" in keys and "proto" in keys
    if "type" not in keys:
        return False
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and k.value == "type" and \
                isinstance(v, ast.Constant) and v.value in _FRAME_TYPES:
            return True
    return False


def _mentions_trace(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and "trace" in node.id.lower():
            return True
        if isinstance(node, ast.Attribute) and \
                "trace" in node.attr.lower():
            return True
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and "trace" in node.value:
            return True
    return False


def _enclosing_function(tree: ast.AST, target: ast.AST
                        ) -> Optional[ast.AST]:
    """Innermost function whose body contains ``target`` (by identity)."""
    def visit(node: ast.AST, current: Optional[ast.AST]
              ) -> Optional[ast.AST]:
        if node is target:
            return current
        nxt = node if isinstance(node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) else current
        for child in ast.iter_child_nodes(node):
            hit = visit(child, nxt)
            if hit is not None:
                return hit
        return None

    return visit(tree, None)


@register("trace-propagation")
def check_trace_propagation(project: Project, options: dict
                            ) -> List[Violation]:
    out: List[Violation] = []
    for sf in project.files:
        if sf.tree is None:
            continue
        in_transfer = sf.rel.endswith(_TRANSFER_SUFFIX)
        if not in_transfer and not any(sf.rel.endswith(s)
                                       for s in _FRAME_FILES):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Dict) or \
                    not _is_frame_dict(node, in_transfer):
                continue
            fn = _enclosing_function(sf.tree, node)
            if fn is None:
                # module-level frame literal (e.g. a constant template):
                # nothing to propagate from — skip
                continue
            if not _mentions_trace(fn):
                kind = "transfer request" if in_transfer else "frame"
                out.append(Violation(
                    "trace-propagation", sf.rel, node.lineno,
                    f"{getattr(fn, 'name', '<fn>')}() serializes a "
                    f"{kind} dict but never touches a trace field — "
                    f"the span tree loses its parent edge here "
                    f"(thread trace_ctx through, see core/trace.py)"))
    return out
