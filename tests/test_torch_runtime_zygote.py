"""Worker fork-server (zygote) tests: ms-class spawns, fallback paths,
and the startup-token (bootstrap) delivery contract.

The reference keeps worker processes warm via WorkerPool prestart/startup
tokens (src/ray/raylet/worker_pool.h:104,349,427,446); here the analog is
fork-from-a-preloaded-zygote, so the properties under test are: forked
workers are real, isolated processes; the zygote is an accelerator and
never a single point of failure (cold spawn always works); and the
dedicated-actor token rides the spawn.

The PyTorch port's copy of ``tests/test_zygote.py``: the same cases run
against ``ray_memory_management_tpu_torch``, with CUDA in the places of
the JAX platform. A worker the zygote forks starts with
``CUDA_VISIBLE_DEVICES=""`` (the reference's ``JAX_PLATFORMS=cpu``); a
worker whose environment names cards cold-spawns; a class preload that
leaves CUDA initialized in the zygote retires it (the reference's live
jax backend). ``test_actor_burst_is_fast`` is not copied: its 10 s bound
fails in the reference's own runs too (ROADMAP C).
"""

import os
import subprocess
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import zygote
from ray_memory_management_tpu_torch.core.node_manager import (
    package_env,
    spawn_worker_process,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401


def test_forked_workers_run_tasks_and_actors():
    rmt.init(num_cpus=4)
    try:
        @rmt.remote
        def f(x):
            return os.getpid(), x * 2

        pid_a, va = rmt.get(f.remote(3))
        assert va == 6 and pid_a != os.getpid()

        @rmt.remote(num_cpus=0)
        class Counter:
            def __init__(self, start):
                self.n = start

            def add(self, k):
                self.n += k
                return self.n

        c = Counter.remote(10)
        assert rmt.get(c.add.remote(5)) == 15
        assert rmt.get(c.add.remote(1)) == 16
    finally:
        rmt.shutdown()


def test_spawn_falls_back_to_cold_popen_without_zygote():
    cfg = Config()
    env = dict(package_env())
    env.update({
        "RMT_WORKER_ID": "00" * 16, "RMT_NODE_ID": "00" * 16,
        "RMT_STORE_NAME": "/none", "RMT_SOCKET": "/tmp/none.sock",
        "RMT_AUTHKEY": "", "RMT_INLINE_LIMIT": "1",
        "RMT_LOG_TO_DRIVER": "0",
        # a worker that names cards => must cold-spawn (the zygote only
        # forks workers that start without cards)
        "CUDA_VISIBLE_DEVICES": "0",
    })
    called = []
    proc = spawn_worker_process(env, cfg, bootstrap={"type": "noop"},
                                on_cold_bootstrap=lambda: called.append(1))
    try:
        assert isinstance(proc, subprocess.Popen)
        assert called == [1]  # cold path must hand the token back
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_forked_proc_liveness_and_kill():
    z = zygote.get_global()
    if z is None:
        pytest.skip("fork server unavailable")
    env = dict(package_env())
    env.update({
        "RMT_WORKER_ID": "00" * 16, "RMT_NODE_ID": "00" * 16,
        "RMT_STORE_NAME": "/none", "RMT_SOCKET": "/tmp/rmt_noexist.sock",
        "RMT_AUTHKEY": "", "RMT_INLINE_LIMIT": "1",
        "RMT_LOG_TO_DRIVER": "0", "CUDA_VISIBLE_DEVICES": "",
    })
    proc = z.spawn(env)
    assert proc is not None and proc.pid > 0
    # the worker exits on its own (no socket to dial); poll must flip
    deadline = time.monotonic() + 30
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert proc.poll() is not None

    proc2 = z.spawn(env)
    assert proc2 is not None
    proc2.kill()
    deadline = time.monotonic() + 10
    while proc2.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert proc2.poll() is not None


def test_forked_worker_env_fidelity():
    """A forked worker's environment must be EXACTLY what
    build_worker_env produced — the delta protocol resets the child to
    the client's baseline, not the zygote's own (drifted) environ. The
    regression this pins: the zygote pins its own CUDA_VISIBLE_DEVICES
    at start, and a child reset to the zygote's environ would see the
    zygote's value rather than the one build_worker_env set."""
    rmt.init(num_cpus=2)
    try:
        @rmt.remote
        def probe_env():
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    os.environ.get("RMT_ZYGOTE_AUTHKEY"),
                    os.environ.get("RMT_WORKER_ID") is not None)

        visible, authkey, has_wid = rmt.get(probe_env.remote(),
                                            timeout=120)
        assert visible == ""            # build_worker_env's value
        assert authkey is None          # the zygote secret never leaks
        assert has_wid                  # per-worker delta vars applied
    finally:
        rmt.shutdown()


def test_preload_taint_retires_zygote():
    """A class blob whose unpickling initializes CUDA must not be
    preloaded pre-fork (every later child would inherit a fork-broken
    CUDA context): the zygote retires itself, the class is blacklisted,
    and a fresh zygote serves it with the load deferred to the child.
    Without a card, the blob marks CUDA initialized inside the zygote
    (``torch.cuda.is_initialized`` replaced there), which is what
    ``zygote.cuda_live`` reads."""
    import cloudpickle

    z = zygote.get_global()
    if z is None:
        pytest.skip("fork server unavailable")

    def _touch_backend():
        import torch

        torch.cuda.is_initialized = lambda: True
        return int

    class _Trigger:
        def __reduce__(self):
            return (_touch_backend, ())

    blob = cloudpickle.dumps(_Trigger())
    env = dict(package_env())
    env["CUDA_VISIBLE_DEVICES"] = ""
    cls_id = b"taint-test-cls"
    boot = {"type": "create_actor", "cls_id": cls_id, "cls_blob": blob}
    assert z.spawn(env, bootstrap=dict(boot)) is None  # retired, no fork
    assert cls_id in zygote._taint_classes
    deadline = time.monotonic() + 10
    while z._proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert z._proc.poll() is not None  # the tainted zygote exited

    z2 = zygote.get_global()  # fresh replacement
    assert z2 is not None and z2 is not z
    proc = z2.spawn(env, bootstrap=dict(boot))  # no_preload: forks fine
    assert proc is not None and proc.pid > 0
    assert z2._proc.poll() is None  # replacement survived the spawn
    proc.kill()
    zygote._taint_classes.discard(cls_id)
    zygote.shutdown_global()


def test_zygote_death_is_survivable():
    """Killing the fork server must not break worker spawning — the next
    get_global() replaces it, and spawn falls back to cold Popen in the
    interim."""
    z = zygote.get_global()
    if z is None:
        pytest.skip("fork server unavailable")
    z._proc.kill()
    z._proc.wait(timeout=10)
    assert z.spawn({"CUDA_VISIBLE_DEVICES": ""}) is None  # dead server: None
    z2 = zygote.get_global()  # replaced
    assert z2 is not None and z2 is not z
    zygote.shutdown_global()
