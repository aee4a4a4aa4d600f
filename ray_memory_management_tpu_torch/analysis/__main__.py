"""CLI for the rmtcheck static-analysis suite.

``python -m ray_memory_management_tpu_torch.analysis [--json] [--frozen]
[--rule RULE ...] [--root DIR]`` — exits non-zero when any violation is
found, printing ``file:line: rule: message`` lines (or a machine-
readable JSON report with ``--json``). ``rmt check`` delegates here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .engine import all_rules, run_checks

REPORT_VERSION = 1


def build_report(violations, rules: List[str], files_scanned: int,
                 frozen: bool) -> dict:
    counts: dict = {}
    for v in violations:
        counts[v.rule] = counts.get(v.rule, 0) + 1
    return {
        "version": REPORT_VERSION,
        "frozen": frozen,
        "rules": rules,
        "files_scanned": files_scanned,
        "violation_count": len(violations),
        "counts_by_rule": counts,
        "violations": [v.as_dict() for v in violations],
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="rmt check",
        description="rmtcheck: static analysis for the runtime's "
                    "concurrency and registry conventions")
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable JSON report")
    ap.add_argument("--frozen", action="store_true",
                    help="treat new wire-protocol keys as violations "
                         "instead of auto-registering (CI mode)")
    ap.add_argument("--rule", action="append", dest="rules",
                    metavar="RULE",
                    help="run only this rule (repeatable); default all")
    ap.add_argument("--root", default=None,
                    help="repo root to analyze (default: the installed "
                         "package's own tree)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the registered rules and exit")
    args = ap.parse_args(argv)

    # importing the checkers registers the rules
    from . import (  # noqa: F401
        check_faults, check_locks, check_logs, check_metrics,
        check_protocol, check_trace,
    )
    if args.list_rules:
        for r in all_rules():
            print(r)
        return 0

    from . import TEST_PREFIX

    prefix = TEST_PREFIX
    if args.root:
        repo = os.path.abspath(args.root)
        pkg = os.path.join(repo, "ray_memory_management_tpu_torch")
        if not os.path.isdir(pkg):
            pkg = repo  # analyze an arbitrary tree (fixtures)
            prefix = ""
    else:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        repo = os.path.dirname(pkg)
    tests = os.path.join(repo, "tests")

    options = {"frozen": args.frozen, "test_prefix": prefix}
    violations = run_checks(pkg, tests if os.path.isdir(tests) else None,
                            rules=args.rules, options=options)

    rules = args.rules or all_rules()
    from .engine import Project
    files_scanned = len(Project(pkg, None).files)

    try:
        if args.json:
            print(json.dumps(build_report(violations, rules,
                                          files_scanned,
                                          args.frozen), indent=2))
        else:
            for v in violations:
                print(v.format())
            for line in options.get("schema_diff", ()):
                print(f"protocol_schema.py updated: {line}",
                      file=sys.stderr)
            if violations:
                print(f"\nrmt check: {len(violations)} violation(s) "
                      f"across {files_scanned} files", file=sys.stderr)
            else:
                print(f"rmt check: clean ({files_scanned} files, "
                      f"{len(rules)} rules)", file=sys.stderr)
    except BrokenPipeError:
        # downstream closed the pipe (e.g. `rmt check --json | head`):
        # swap stdout for devnull so the interpreter's exit flush
        # doesn't raise again, and keep the violation exit code
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
