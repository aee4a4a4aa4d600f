"""The PyTorch port stands alone: no file of it, and not chip_smoke.py,
imports JAX or the JAX package, or names a JAX package module in a
string (``python -m ray_memory_management_tpu.core.worker_main`` in a
copied spawn command would quietly start the reference's worker).

The check is static (an AST walk over the sources), because the test
process itself imports JAX and the JAX package, so ``sys.modules`` says
nothing about what the port needs.
"""

import ast
import os
import re
import subprocess
import sys

import pytest
from _port_fixtures import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_memory_management_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ray_memory_management_tpu")
JAX_PACKAGE = "ray_memory_management_tpu"
# a dotted module path under the JAX package; "ray_memory_management_tpu_"
# (the port's own name) never matches, and neither does a file path
_JAX_MODULE_PATH = re.compile(re.escape(JAX_PACKAGE) + r"\.")


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


def _names_jax_module(text: str) -> bool:
    """A string that names a JAX package module: a dotted path under it,
    or the bare package name (used as a module-name prefix)."""
    return text == JAX_PACKAGE or bool(_JAX_MODULE_PATH.search(text))


def _string_constants(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value


def test_forbidden_names_are_told_apart():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("ray_memory_management_tpu.ops")
    assert not _forbidden("ray_memory_management_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")
    assert _names_jax_module("ray_memory_management_tpu.core.worker_main")
    assert _names_jax_module("-m ray_memory_management_tpu.core.zygote")
    assert _names_jax_module("ray_memory_management_tpu")
    assert not _names_jax_module(
        "ray_memory_management_tpu_torch.core.worker_main")
    assert not _names_jax_module("ray_memory_management_tpu_torch")
    assert not _names_jax_module(
        "ray_memory_management_tpu/ops/flash_attention.py:74")


def test_walk_covers_the_port():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    for parts in (("serve", "llm.py"), ("api.py",), ("core", "runtime.py"),
                  ("core", "worker_main.py"), ("core", "zygote.py"),
                  ("native", "shm_client.py"), ("native", "build.py"),
                  ("analysis", "lockwatch.py"), ("utils", "structlog.py"),
                  ("utils", "runtime_smoke.py"), ("core", "node_agent.py"),
                  ("core", "remote_node.py"), ("client", "client.py"),
                  ("client", "server.py"), ("utils", "sim_agent.py"),
                  ("utils", "chaos.py"), ("usage_stats.py",),
                  ("collective", "collective.py"),
                  ("collective", "coordinator.py"),
                  ("collective", "mesh_group.py"),
                  ("collective", "types.py"), ("parallel", "mesh.py"),
                  ("parallel", "sharding.py"), ("train", "trainer.py"),
                  ("train", "backend_executor.py"),
                  ("train", "checkpoint.py"), ("train", "session.py"),
                  ("utils", "local_world.py"), ("parallel", "pipeline.py"),
                  ("models", "layers.py"), ("models", "resnet.py"),
                  ("models", "vit.py"), ("rllib", "__init__.py"),
                  ("rllib", "env.py"), ("rllib", "sample_batch.py"),
                  ("rllib", "replay.py"), ("rllib", "connectors.py"),
                  ("rllib", "models.py"), ("rllib", "rollout_worker.py"),
                  ("rllib", "collector.py"), ("rllib", "multi_agent.py"),
                  ("rllib", "algorithm.py"), ("rllib", "pg.py"),
                  ("rllib", "ppo.py"), ("rllib", "impala.py"),
                  ("rllib", "appo.py"), ("rllib", "dqn.py"),
                  ("rllib", "recurrent.py")):
        assert os.path.join("ray_memory_management_tpu_torch",
                            *parts) in names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [f"{os.path.relpath(path, REPO)}:{line}: {mod}"
           for line, mod in _imported_modules(tree) if _forbidden(mod)]
    assert not bad, "the port imports JAX or the JAX package:\n" + \
        "\n".join(bad)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_names_no_jax_module_in_strings(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [f"{os.path.relpath(path, REPO)}:{line}: {text[:80]!r}"
           for line, text in _string_constants(tree)
           if _names_jax_module(text)]
    assert not bad, "the port names a JAX package module:\n" + \
        "\n".join(bad)


@pytest.mark.parametrize("package", ["collective", "parallel", "train",
                                     "rllib"])
def test_subpackage_imports_without_jax(package):
    """The collective, parallel, train and rllib subpackages import in a
    fresh interpreter without JAX or the JAX package ever loading."""
    code = (
        "import sys\n"
        f"import ray_memory_management_tpu_torch.{package}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ray_memory_management_tpu' "
        "or m.startswith('ray_memory_management_tpu.'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
