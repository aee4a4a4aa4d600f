"""Lazy build of the native pieces: the shared-memory store library, its
stress test, and the C++ thin client with its two programs.

Each output compiles with ``g++`` at first use into the package's
``_build/`` directory (git ignores it), named by a digest of its sources
and flags, the way ``ops/_build.py`` builds the CUDA kernels with
``nvcc``: an edited source rebuilds, an unchanged one is reused, and
nothing is ever written next to a source. Every output is written under
a per-process temporary name and moved into place with ``os.replace``,
so a process that finds it finds it whole, whichever process built it.
A failed compile raises :class:`BuildError` with the compiler's stderr.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O2", "-g", "-fPIC", "-shared", "-std=c++17", "-Wall",
             "-Werror")
LINK_FLAGS = ("-lpthread", "-lrt")
# the stress test, plain and under each sanitizer
STRESS_FLAGS = {
    "stress": ("-O2", "-g", "-std=c++17", "-Wall", "-Werror"),
    "stress_tsan": ("-O1", "-g", "-std=c++17", "-fsanitize=thread"),
    "stress_asan": ("-O1", "-g", "-std=c++17",
                    "-fsanitize=address,undefined"),
}
CLIENT_FLAGS = ("-O2", "-g", "-std=c++17", "-Wall", "-Werror", "-fPIC")
_LOCK = threading.Lock()

_LIBS = {
    "shmstore": ["shmstore.cpp"],
}
_CLIENT_LIB = ["client/rmt_client.cpp", "client/rmt_client.hpp"]
# program -> (its sources, its flags, whether it links librmtclient.a)
_PROGRAMS = {
    **{name: (["shmstore.cpp", "stress_shmstore.cpp"], flags, False)
       for name, flags in STRESS_FLAGS.items()},
    "rmt_demo": (["client/demo.cpp"], CLIENT_FLAGS, True),
    "rmt_executor_demo": (["client/executor_demo.cpp"], CLIENT_FLAGS, True),
}


class BuildError(RuntimeError):
    """g++ or ar failed; the message holds the command and its stderr."""


def _digest(sources: Sequence[Path], *extra: str) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(extra).encode())
    return h.hexdigest()[:16]


def _run(cmd) -> None:
    r = subprocess.run([str(c) for c in cmd], capture_output=True,
                       text=True)
    if r.returncode:
        raise BuildError(f"{' '.join(map(str, cmd))} exited "
                         f"{r.returncode}:\n{r.stderr}")


def _built(out: Path, make) -> str:
    """``out``, made by ``make(tmp)`` into a per-process temporary path
    and moved into place, unless it already exists."""
    with _LOCK:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        tmp.unlink(missing_ok=True)
        try:
            # _LOCK exists to serialize the compile itself; concurrent
            # callers waiting for the finished output is the intended
            # behavior
            # rmtcheck: disable=blocking-under-lock
            make(tmp)
            os.replace(tmp, out)  # atomic wrt concurrent builders
        finally:
            tmp.unlink(missing_ok=True)
    return str(out)


def lib_path(name: str = "shmstore") -> str:
    """Return the path to the built .so, compiling it if it is missing."""
    sources = [_HERE / s for s in _LIBS[name]]
    out = BUILD_DIR / (f"lib{name}-"
                       f"{_digest(sources, *CXX_FLAGS, *LINK_FLAGS)}.so")
    return _built(out, lambda tmp: _run(
        ["g++", *CXX_FLAGS, *sources, "-o", tmp, *LINK_FLAGS]))


def _client_lib_path() -> str:
    """The C++ thin client's static library (``librmtclient.a``) that
    its programs link, compiled if it is missing."""
    sources = [_HERE / s for s in _CLIENT_LIB]
    out = BUILD_DIR / f"librmtclient-{_digest(sources, *CLIENT_FLAGS)}.a"

    def make(tmp: Path) -> None:
        obj = tmp.with_name(tmp.name + ".o")
        try:
            _run(["g++", *CLIENT_FLAGS, "-c", sources[0], "-o", obj])
            _run(["ar", "rcs", tmp, obj])
        finally:
            obj.unlink(missing_ok=True)

    return _built(out, make)


def program_path(name: str) -> str:
    """Return the path to the built program ``name``, compiling it if it
    is missing: ``stress``, ``stress_tsan`` or ``stress_asan`` (the shm
    store's stress test, plain and under ThreadSanitizer or
    AddressSanitizer with UBSan), or ``rmt_demo`` or
    ``rmt_executor_demo`` (the C++ thin client's driver and executor
    programs)."""
    srcs, flags, client = _PROGRAMS[name]
    sources = [_HERE / s for s in srcs]
    archive = [_client_lib_path()] if client else []
    link = LINK_FLAGS if not client else ()
    digest = _digest(sources, *flags, *link, *(Path(a).name for a in archive))
    out = BUILD_DIR / f"{name}-{digest}"
    return _built(out, lambda tmp: _run(
        ["g++", *flags, *sources, *archive, "-o", tmp, *link]))
