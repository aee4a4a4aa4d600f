"""rmtcheck: AST static analysis + runtime race/deadlock detection for
the port's concurrency and registry conventions.

Static suite: ``python -m ray_memory_management_tpu_torch.analysis`` or
``rmt-torch check`` — see ``engine.run_checks`` and
``analysis/README.md``; it runs over this package and the port's tests.
Runtime detector: ``lockwatch`` (opt-in via ``RMT_LOCK_CHECK=1``),
installed by the package ``__init__``.
"""

from .engine import Violation, all_rules, run_checks  # noqa: F401

__all__ = ["Violation", "all_rules", "run_checks", "run_default"]

# the port's own test files in the shared tests/ directory
TEST_PREFIX = "test_torch_"


def run_default(frozen: bool = False, rules=None):
    """Run the suite against the in-tree port package + the port's tests
    (the paths the CLI and tier-1 test use)."""
    import os

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo = os.path.dirname(pkg)
    tests = os.path.join(repo, "tests")
    return run_checks(pkg, tests, rules=rules,
                      options={"frozen": frozen, "test_prefix": TEST_PREFIX})
