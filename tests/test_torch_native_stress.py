"""Native store stress test (the C++-side race/lifecycle coverage), plain
and under ThreadSanitizer and AddressSanitizer+UBSan.

The PyTorch port's copy of ``tests/test_native_stress.py``: the same
three runs of ``native/stress_shmstore.cpp`` over the port's
``native/shmstore.cpp``, built by ``native/build.py`` into the package's
``_build/`` (the reference runs ``make`` in its source directory). Each
case also holds that the build wrote nothing into the source tree.
"""

import os
import subprocess
import sys

import pytest

from ray_memory_management_tpu_torch.native import build
from _port_fixtures import one_intra_op_thread  # noqa: F401

NATIVE_DIR = os.path.dirname(os.path.abspath(build.__file__))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source_tree():
    return {os.path.join(d, f) for d, _, files in os.walk(NATIVE_DIR)
            for f in files if "__pycache__" not in d}


@pytest.mark.parametrize("target, env", [
    ("stress", {}),
    # race detection for the multi-threaded allocator (the reference's
    # --config=tsan bazel run, .bazelrc:92-106): any data race fails the
    # run (halt_on_error)
    ("stress_tsan", {"TSAN_OPTIONS": "halt_on_error=1"}),
    # heap/UB coverage
    ("stress_asan", {}),
], ids=["plain", "tsan", "asan"])
def test_native_stress(target, env):
    before = _source_tree()
    binary = build.program_path(target)
    assert os.path.dirname(binary) == str(build.BUILD_DIR)
    out = subprocess.run([binary], capture_output=True, text=True,
                         timeout=600, env={**os.environ, **env})
    both = out.stdout + out.stderr
    assert out.returncode == 0, both
    assert "STRESS OK" in out.stdout
    assert "failures=0" in out.stderr
    assert "WARNING: ThreadSanitizer" not in both
    assert "ERROR: AddressSanitizer" not in both
    assert _source_tree() == before


def test_failed_compile_raises_with_compiler_stderr(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses fails the build with g++'s own
    message, and leaves no output or temporary file behind."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    broken = tmp_path / "broken.cpp"
    broken.write_text("int main() { return undeclared_name; }\n")
    monkeypatch.setitem(build._PROGRAMS, "broken",
                        ([str(broken)], build.CLIENT_FLAGS, False))
    with pytest.raises(build.BuildError, match="undeclared_name"):
        build.program_path("broken")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["broken.cpp"]


# one builder process: the C++ demo into the build directory argv[1]
_BUILD_DEMO = """
import sys
from pathlib import Path
from ray_memory_management_tpu_torch.native import build
build.BUILD_DIR = Path(sys.argv[1])
print(build.program_path("rmt_demo"))
"""


def test_concurrent_builders_never_expose_a_partial_output(tmp_path):
    """Two processes (as two pytest workers) build the client library
    and the demo into one empty directory at once: both get the same
    finished program, it runs, and no temporary file is left."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_DEMO,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    run = subprocess.run([paths.pop()], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode == 2 and "usage" in run.stderr
    assert not [p.name for p in tmp_path.iterdir() if ".tmp." in p.name]
