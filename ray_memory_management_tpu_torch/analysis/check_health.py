"""``alert-rule-registry`` — the shipped health rule pack
(``core/health.py``) and the metric registry must agree.

A health rule references its series by name inside a plain data tuple
(``("rate", "rmt_tasks_failed_total", 30.0)``), which is invisible to
``metric-registry`` (that rule only tracks ``get()``/constructor args
and accessor-name strings). So rule-pack drift — a rule watching a
series that was renamed or removed from ``metrics_defs.DEFS`` — would
silently evaluate to no-data forever: the alert can never fire, which
is the worst possible failure mode for an alerting system.

This rule closes the gap: every ``rmt_*`` string constant in a
``core/health.py`` module must name a series declared in DEFS. The
probe functions live in the same module and reference series the same
way, so they are covered too.
"""

from __future__ import annotations

import ast
from typing import List

from .check_metrics import parse_registry
from .engine import Project, Violation, register

_HEALTH_SUFFIX = "core/health.py"


@register("alert-rule-registry")
def check_alert_rule_registry(project: Project, options: dict
                              ) -> List[Violation]:
    sf = project.get(_HEALTH_SUFFIX)
    if sf is None or sf.tree is None:
        return []  # no health module in this tree: nothing to drift
    metrics, _accessors = parse_registry(project)
    out: List[Violation] = []
    if not metrics:
        out.append(Violation(
            "alert-rule-registry", sf.rel, 1,
            "could not parse the DEFS registry out of metrics_defs.py "
            "(rule-pack series cannot be validated)"))
        return out
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value.startswith("rmt_")):
            continue
        if node.value not in metrics:
            out.append(Violation(
                "alert-rule-registry", sf.rel, node.lineno,
                f"health rule references series {node.value!r} which is "
                "not declared in metrics_defs.DEFS — the rule can never "
                "fire (rename it or declare the series)"))
    return out
