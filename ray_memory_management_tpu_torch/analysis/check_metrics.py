"""``metric-registry`` — the canonical ``rmt_*`` instrument set
(``core/metrics_defs.py``) and its call sites must agree.

Three sub-invariants, all from the DEFS dict parsed out of
metrics_defs.py (pure data, so the checker reads the same source of
truth the runtime does):

  * every emit site names a DECLARED series: ``mdefs.<accessor>()``
    must name a real accessor, ``get("rmt_...")`` /
    ``Counter("rmt_...")``-style constructions must name a declared
    metric;
  * literal ``tags={...}`` dicts at ``.inc()/.observe()/.set()`` call
    sites (on a direct ``mdefs.<accessor>()`` chain or a variable
    assigned from one) only use the series' DECLARED tag keys — an
    undeclared key raises at runtime, but only when that branch runs,
    which is exactly how earlier counter races hid;
  * every declared series has at least one call site somewhere in the
    package (a declared-but-never-emitted series is registry drift:
    wire it or remove it).

Indirection through accessor-name strings (``_count("transfer_pool_hits")``
in core/transfer.py) counts as a reference — string literals equal to an
accessor name are tracked.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .engine import Project, Violation, const_str, register

_METRICS_DEFS_SUFFIX = "core/metrics_defs.py"
# module-level names of metrics_defs that are legal attribute accesses
_MODULE_PUBLIC = {"get", "DEFS", "LATENCY_BOUNDARIES", "BYTES_BOUNDARIES"}
_EMIT_METHODS = {"inc", "observe", "set"}
_METRIC_CLASSES = {"Counter", "Gauge", "Histogram"}


def parse_registry(project: Project
                   ) -> Tuple[Dict[str, Tuple[str, Tuple[str, ...]]],
                              Dict[str, str]]:
    """(metrics, accessors): ``metrics[name] = (cls, tag_keys)`` from the
    DEFS literal; ``accessors[fn_name] = metric_name`` from the
    ``def x(): return get("...")`` accessor bodies."""
    sf = project.get(_METRICS_DEFS_SUFFIX)
    metrics: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
    accessors: Dict[str, str] = {}
    if sf is None or sf.tree is None:
        return metrics, accessors
    for node in ast.walk(sf.tree):
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        if targets and \
                any(isinstance(t, ast.Name) and t.id == "DEFS"
                    for t in targets) and \
                isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                name = const_str(k)
                if name is None or not isinstance(v, ast.Tuple) or \
                        len(v.elts) != 2:
                    continue
                cls = v.elts[0].id if isinstance(v.elts[0], ast.Name) \
                    else "?"
                tag_keys: Tuple[str, ...] = ()
                kwargs = v.elts[1]
                if isinstance(kwargs, ast.Call):
                    for kw in kwargs.keywords:
                        if kw.arg == "tag_keys" and \
                                isinstance(kw.value, ast.Tuple):
                            tag_keys = tuple(
                                s for s in (const_str(e)
                                            for e in kw.value.elts)
                                if s is not None)
                metrics[name] = (cls, tag_keys)
        if isinstance(node, ast.FunctionDef) and node.name != "get":
            for stmt in node.body:
                if isinstance(stmt, ast.Return) and \
                        isinstance(stmt.value, ast.Call) and \
                        isinstance(stmt.value.func, ast.Name) and \
                        stmt.value.func.id == "get" and stmt.value.args:
                    mname = const_str(stmt.value.args[0])
                    if mname:
                        accessors[node.name] = mname
    return metrics, accessors


def _mdefs_aliases(tree: ast.AST) -> Tuple[Set[str], Dict[str, str]]:
    """(module_aliases, imported_accessors): names this module binds to
    the metrics_defs module itself, and accessor names imported from it
    (``from .metrics_defs import scheduler_placements as _sp`` maps
    ``_sp -> scheduler_placements``)."""
    aliases: Set[str] = set()
    imported: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""   # "" for ``from . import x``
            if mod.split(".")[-1] == "metrics_defs":
                for a in node.names:
                    if a.name != "*":
                        imported[a.asname or a.name] = a.name
            else:
                for a in node.names:
                    if a.name == "metrics_defs":
                        aliases.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] == "metrics_defs":
                    aliases.add(a.asname or a.name)
    return aliases, imported


def _accessor_of_call(call: ast.AST, aliases: Set[str],
                      imported: Dict[str, str],
                      accessors: Dict[str, str]) -> Optional[str]:
    """Accessor name when ``call`` is ``mdefs.<acc>()`` or an imported
    ``<acc>()``."""
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in aliases and f.attr in accessors:
        return f.attr
    if isinstance(f, ast.Name) and f.id in imported and \
            imported[f.id] in accessors:
        return imported[f.id]
    return None


@register("metric-registry")
def check_metric_registry(project: Project, options: dict
                          ) -> List[Violation]:
    metrics, accessors = parse_registry(project)
    defs_sf = project.get(_METRICS_DEFS_SUFFIX)
    defs_rel = defs_sf.rel if defs_sf else _METRICS_DEFS_SUFFIX
    out: List[Violation] = []
    if not metrics:
        out.append(Violation(
            "metric-registry", defs_rel, 1,
            "could not parse the DEFS registry out of metrics_defs.py"))
        return out
    accessor_names = set(accessors)
    referenced: Set[str] = set()   # metric names with >= 1 call site

    for sf in project.files:
        if sf.tree is None or sf.rel.endswith(_METRICS_DEFS_SUFFIX):
            continue
        aliases, imported = _mdefs_aliases(sf.tree)
        # variables assigned from an accessor call anywhere in the file:
        # ``self._m_submitted = mdefs.tasks_submitted()`` or
        # ``hist = task_stage_seconds()`` — tracked so tags checks reach
        # the hoisted hot-path instruments
        var_metric: Dict[str, str] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                acc = _accessor_of_call(node.value, aliases, imported,
                                        accessors)
                if acc:
                    t = node.targets[0]
                    key = None
                    if isinstance(t, ast.Name):
                        key = t.id
                    elif isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        key = f"self.{t.attr}"
                    if key:
                        var_metric[key] = accessors[acc]

        for node in ast.walk(sf.tree):
            # unknown accessor: mdefs.<not-an-accessor>
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in aliases:
                if node.attr in accessor_names:
                    referenced.add(accessors[node.attr])
                elif node.attr not in _MODULE_PUBLIC and \
                        not node.attr.startswith("__"):
                    out.append(Violation(
                        "metric-registry", sf.rel, node.lineno,
                        f"metrics_defs.{node.attr} is not a declared "
                        f"accessor (typo? declare the series in DEFS)"))
            if isinstance(node, ast.Name) and node.id in imported and \
                    imported[node.id] in accessor_names:
                referenced.add(accessors[imported[node.id]])
            # string-literal references: get("rmt_x"), Counter("rmt_x"),
            # and accessor-name strings (the _count("...") indirection)
            if isinstance(node, ast.Call):
                fname = None
                if isinstance(node.func, ast.Name):
                    fname = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    fname = node.func.attr
                if fname in _METRIC_CLASSES | {"get"} and node.args:
                    lit = const_str(node.args[0])
                    if lit and lit.startswith("rmt_"):
                        if lit in metrics:
                            referenced.add(lit)
                        else:
                            out.append(Violation(
                                "metric-registry", sf.rel, node.lineno,
                                f"metric {lit!r} is not declared in "
                                f"metrics_defs.DEFS"))
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value in accessor_names:
                referenced.add(accessors[node.value])
            # tags= literal keys at emit sites
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _EMIT_METHODS:
                base = node.func.value
                mname = None
                acc = _accessor_of_call(base, aliases, imported, accessors)
                if acc:
                    mname = accessors[acc]
                elif isinstance(base, ast.Name):
                    mname = var_metric.get(base.id)
                elif isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id == "self":
                    mname = var_metric.get(f"self.{base.attr}")
                if mname is None or mname not in metrics:
                    continue
                referenced.add(mname)
                declared = set(metrics[mname][1])
                for kw in node.keywords:
                    if kw.arg != "tags" or not isinstance(kw.value,
                                                          ast.Dict):
                        continue
                    for k in kw.value.keys:
                        key = const_str(k)
                        if key is not None and key not in declared:
                            out.append(Violation(
                                "metric-registry", sf.rel, node.lineno,
                                f"tag key {key!r} is not declared for "
                                f"{mname} (declared: "
                                f"{sorted(declared) or 'none'})"))

    for name in sorted(metrics):
        if name not in referenced:
            out.append(Violation(
                "metric-registry", defs_rel, 1,
                f"declared series {name} has no call site anywhere in "
                f"the package (registry drift: wire it or remove it)"))
    return out
