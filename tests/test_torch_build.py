"""The port's kernel build (``ops/_build.py``) on the CPU: which library a
source maps to. No ``nvcc`` runs here; the cases point ``CSRC_DIR`` at a
temporary copy of ``csrc/`` and read only ``library_path``."""

import shutil

import pytest

from ray_memory_management_tpu_torch.ops import _build

SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_every_source_includes_only_headers_the_digest_covers(csrc):
    headers = {p.name for p in csrc.glob("*.cuh")}
    assert headers, "the kernels share a header"
    for name in SOURCES:
        text = (csrc / f"{name}.cu").read_text()
        quoted = {line.split('"')[1] for line in text.splitlines()
                  if line.startswith("#include \"")}
        assert quoted <= headers, name


@pytest.mark.parametrize("name", SOURCES)
def test_editing_a_header_rebuilds_every_library(csrc, name):
    before = _build.library_path(name)
    assert before == _build.library_path(name)  # the same tree, one name
    header = csrc / "hopper_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"lib{name}-")


@pytest.mark.parametrize("name", SOURCES)
def test_editing_a_source_rebuilds_only_its_library(csrc, name):
    paths = {n: _build.library_path(n) for n in SOURCES}
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    for other in SOURCES:
        assert (_build.library_path(other) == paths[other]) == (other != name)


def test_profile_summary_names_every_kernel_of_csrc():
    # utils/profile_serve.py sums each kernel's device time by its
    # __global__ name: a kernel missing from its table reads as 0 ms
    import re

    from ray_memory_management_tpu_torch.utils.profile_serve import (
        PORT_KERNELS)

    names = set()
    for src in _build.CSRC_DIR.glob("*.cu"):
        text = src.read_text()
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\("
            r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(", text))
    assert names == set(PORT_KERNELS)
    assert not any(a != b and a in b for a in names for b in names)
