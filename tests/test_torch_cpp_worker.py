"""Worker-side C++ API: tasks implemented IN C++ and served by a native
executor process (native/client Executor) — the counterpart of the
reference's C++ worker runtime executing RAY_REMOTE-registered functions
(cpp/include/ray/api.h ray::Task(fn).Remote(); task_executor.cc). Python
callers use rmt.cpp_function(name).remote(...) and ordinary ObjectRefs;
args/results cross the boundary as opaque bytes (the XLANG convention).

The PyTorch port's copy of ``tests/test_cpp_worker.py``: the same three
cases against the port, with the executor built by ``native/build.py``
into the package's ``_build/``, plus a C++ task's result fed as an
ObjectRef to a task that computes on it (``runtime_smoke.flip_on_card``,
on the CPU here). Every cluster wait and subprocess has a deadline.
"""

import subprocess
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.exceptions import TaskError
from ray_memory_management_tpu_torch.native import build
from ray_memory_management_tpu_torch.utils import runtime_smoke
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def executor_binary():
    return build.program_path("rmt_executor_demo")


def _wait_registered(name: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if name in rmt.cpp_functions():
            return
        time.sleep(0.05)
    raise TimeoutError(f"C++ executor never registered {name!r}")


def _start_executor(binary, server):
    host, port = server.address
    return subprocess.Popen([binary, host, str(port)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _stop(proc):
    if proc is not None and proc.poll() is None:
        proc.kill()
    if proc is not None:
        proc.communicate(timeout=10)


class TestCppWorker:
    def test_cpp_tasks_end_to_end(self, executor_binary):
        """An executor registers C++ functions; Python dispatches tasks to
        them and gets results (and C++ exceptions) through ObjectRefs."""
        from ray_memory_management_tpu_torch.client.server import (
            ClusterServer)

        rmt.init(num_cpus=2)
        server = None
        proc = None
        try:
            server = ClusterServer()
            proc = _start_executor(executor_binary, server)
            _wait_registered("add_i64")
            assert set(rmt.cpp_functions()) >= {"add_i64", "rev", "boom"}

            add = rmt.cpp_function("add_i64")
            assert rmt.get(add.remote(b"2", b"40"), timeout=60) == b"42"
            # several in flight at once: completion order via promises
            refs = [add.remote(str(i).encode(), b"100")
                    for i in range(8)]
            assert rmt.get(refs, timeout=60) == [
                str(100 + i).encode() for i in range(8)]

            assert rmt.get(rmt.cpp_function("rev").remote(b"abcdef"),
                           timeout=60) == b"fedcba"

            # a throwing C++ function fails the task with the what() text
            with pytest.raises(TaskError, match="kaboom"):
                rmt.get(rmt.cpp_function("boom").remote(), timeout=60)

            # results interop with the rest of the object plane
            r = add.remote(b"1", b"2")
            ready, not_ready = rmt.wait([r], timeout=60)
            assert ready and not not_ready
        finally:
            _stop(proc)
            if server is not None:
                server.close()
            rmt.shutdown()

    def test_freed_promise_drops_late_resolution(self):
        """A promise freed before resolution (its caller disconnected or
        dropped the ref) must purge its pending future and DROP a late
        result instead of storing an ownerless object forever."""
        rmt.init(num_cpus=1)
        try:
            from ray_memory_management_tpu_torch import _worker_context

            rt = _worker_context.get_runtime()
            oid = rt.create_promise()
            assert oid in rt.futures and oid in rt._promises
            rt.free_objects([oid])
            assert oid not in rt.futures and oid not in rt._promises
            rt.resolve_promise(oid, value=b"late")  # must be dropped
            assert oid not in rt.memory_store
            assert oid not in rt.futures

            # and a live promise resolves normally
            oid2 = rt.create_promise()
            rt.resolve_promise(oid2, value=b"ontime")
            assert rt.get_objects([oid2], timeout=10) == [b"ontime"]
        finally:
            rmt.shutdown()

    def test_executor_death_fails_tasks_and_deregisters(
            self, executor_binary):
        """Killing the executor fails its undelivered tasks loudly and
        removes its functions from the registry (no silent hangs)."""
        from ray_memory_management_tpu_torch.client.server import (
            ClusterServer)

        rmt.init(num_cpus=2)
        server = None
        proc = None
        try:
            server = ClusterServer()
            proc = _start_executor(executor_binary, server)
            _wait_registered("add_i64")
            # park a task the executor CANNOT finish before the kill (a
            # fast add could complete first and no error would surface):
            # it sleeps executor-side; kill lands mid-task — or before
            # pickup — and either way the promise must fail, not hang
            ref = rmt.cpp_function("sleep_ms").remote(b"30000")
            proc.kill()
            proc.wait(timeout=10)
            with pytest.raises(TaskError, match="disconnected"):
                rmt.get(ref, timeout=90)
            deadline = time.monotonic() + 30
            while rmt.cpp_functions() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert rmt.cpp_functions() == []
            with pytest.raises(RuntimeError, match="no C\\+\\+ executor"):
                rmt.cpp_function("add_i64").remote(b"1")
        finally:
            _stop(proc)
            if server is not None:
                server.close()
            rmt.shutdown()


def test_cpp_result_feeds_a_task_by_ref(executor_binary):
    """A C++ task's ObjectRef is an ordinary task argument: ``rev``'s
    result reaches ``flip_on_card`` (which runs on the card in
    ``chip_smoke.py``; here on the CPU) as the bytes the executor
    returned, and the task's answer is computed from them. A task
    submitted before its C++ argument resolved waits for it and then
    runs (the resolution wakes it), and one whose C++ argument failed
    fails instead of waiting forever."""
    from ray_memory_management_tpu_torch.client.server import ClusterServer

    rmt.init(num_cpus=2)
    server = None
    proc = None
    try:
        server = ClusterServer()
        proc = _start_executor(executor_binary, server)
        _wait_registered("rev")
        flip = rmt.remote(runtime_smoke.flip_on_card)
        rev = rmt.cpp_function("rev").remote(b"abcdef")
        got = rmt.get(flip.remote(rev, device="cpu"), timeout=120)
        assert got["value"] == b"abcdef"
        assert got["sum"] == sum(b"abcdef")
        assert got["device"] == "cpu"

        slept = rmt.cpp_function("sleep_ms").remote(b"500")
        late = flip.remote(slept, device="cpu")  # slept is unresolved
        assert rmt.get(late, timeout=60)["value"] == b"tpels"

        failed = flip.remote(rmt.cpp_function("boom").remote(),
                             device="cpu")
        with pytest.raises(TaskError):
            rmt.get(failed, timeout=60)
    finally:
        _stop(proc)
        if server is not None:
            server.close()
        rmt.shutdown()
