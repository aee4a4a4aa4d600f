"""``fault-site`` — the string-keyed fault plane (``utils/faults.py``)
and its fire points must agree.

  * every ``faults.fire("<site>")`` / ``fire("<site>")`` literal in the
    package names a site registered in ``SITES`` (a typo'd site silently
    never fires — the injection test passes while injecting nothing);
  * every registered site has >= 1 fire point in the package (a
    registered-but-never-fired site is drift: chaos plans list it, but
    no fault can ever materialize there);
  * every registered site is referenced by >= 1 test (substring match in
    the test tree) so the chaos suite actually exercises it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .engine import Project, Violation, const_str, register

_FAULTS_SUFFIX = "utils/faults.py"


def parse_sites(project: Project) -> Tuple[str, ...]:
    sf = project.get(_FAULTS_SUFFIX)
    if sf is None or sf.tree is None:
        return ()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and \
                any(isinstance(t, ast.Name) and t.id == "SITES"
                    for t in node.targets) and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            return tuple(s for s in (const_str(e)
                                     for e in node.value.elts)
                         if s is not None)
    return ()


def _fire_literals(project: Project) -> List[Tuple[str, str, int]]:
    """(site, rel, lineno) for every ``fire("<lit>")`` /
    ``faults.fire("<lit>")`` call in the package, excluding faults.py
    itself (its own fire() definition and docstrings are not call
    sites)."""
    out: List[Tuple[str, str, int]] = []
    for sf in project.files:
        if sf.tree is None or sf.rel.endswith(_FAULTS_SUFFIX):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if name != "fire":
                continue
            lit = const_str(node.args[0])
            if lit is not None:
                out.append((lit, sf.rel, node.lineno))
    return out


@register("fault-site")
def check_fault_sites(project: Project, options: dict) -> List[Violation]:
    sites = parse_sites(project)
    faults_sf = project.get(_FAULTS_SUFFIX)
    faults_rel = faults_sf.rel if faults_sf else _FAULTS_SUFFIX
    out: List[Violation] = []
    if not sites:
        out.append(Violation(
            "fault-site", faults_rel, 1,
            "could not parse the SITES tuple out of utils/faults.py"))
        return out
    site_set: Set[str] = set(sites)
    fired: Dict[str, int] = {}
    for lit, rel, lineno in _fire_literals(project):
        if lit in site_set:
            fired[lit] = fired.get(lit, 0) + 1
        else:
            out.append(Violation(
                "fault-site", rel, lineno,
                f"fire({lit!r}) names an unregistered fault site "
                f"(registered: {', '.join(sites)})"))

    tested: Set[str] = set()
    for tf in project.test_files:
        for site in sites:
            if site in tf.text:
                tested.add(site)

    for site in sites:
        if site not in fired:
            out.append(Violation(
                "fault-site", faults_rel, 1,
                f"registered site {site!r} has no fire() point in the "
                f"package (drift: wire it or remove it)"))
        if site not in tested and project.test_files:
            out.append(Violation(
                "fault-site", faults_rel, 1,
                f"registered site {site!r} is never referenced by any "
                f"test (chaos coverage gap)"))
    return out
