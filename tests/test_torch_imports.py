"""The PyTorch port stands alone: no file of it, and not chip_smoke.py,
imports JAX or the JAX package.

The check is static (an AST walk over the sources), because the test
process itself imports JAX and the JAX package, so ``sys.modules`` says
nothing about what the port needs.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_memory_management_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ray_memory_management_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return out


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_forbidden_names_are_told_apart():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("ray_memory_management_tpu.ops")
    assert not _forbidden("ray_memory_management_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")


def test_walk_covers_the_port():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("ray_memory_management_tpu_torch", "serve",
                        "llm.py") in names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [f"{os.path.relpath(path, REPO)}:{line}: {mod}"
           for line, mod in _imported_modules(tree) if _forbidden(mod)]
    assert not bad, "the port imports JAX or the JAX package:\n" + \
        "\n".join(bad)
