"""Thin-client mode, runtime envs, dashboard (reference coverage shape:
test_client.py, test_runtime_env*.py, dashboard tests)."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.client import ClusterServer


_shared = []  # the runtime of the cases that take rmt_start_regular


@pytest.fixture
def rmt_start_regular():
    """One runtime for every case of this module that takes this fixture
    (the conftest's fixture starts one per case): made at the first such
    case and kept for the next; ``_own_runtime`` shuts it down before a
    case that starts its own, and ``_end_shared`` at the module's end."""
    from ray_memory_management_tpu_torch import _worker_context

    if not _shared or _worker_context.get_runtime() is not _shared[0]:
        rmt.shutdown()
        _shared[:] = [rmt.init(num_cpus=4)]
    return _shared[0]


@pytest.fixture(autouse=True)
def _own_runtime(request):
    if _shared and "rmt_start_regular" not in request.fixturenames:
        rmt.shutdown()
        _shared.clear()


@pytest.fixture
def rmt_fresh_runtime():
    """A runtime of the case's own: the job-table cases count every job
    the runtime has seen."""
    rt = rmt.init(num_cpus=4)
    yield rt
    rmt.shutdown()


@pytest.fixture(autouse=True, scope="module")
def _end_shared():
    yield
    rmt.shutdown()
    _shared.clear()


class TestRuntimeEnv:
    def test_env_vars(self, rmt_start_regular):
        @rmt.remote(runtime_env={"env_vars": {"RMT_TEST_VAR": "tpu!"}})
        def read_env():
            return os.environ.get("RMT_TEST_VAR")

        assert rmt.get(read_env.remote()) == "tpu!"

        @rmt.remote
        def read_plain():
            return os.environ.get("RMT_TEST_VAR")

        assert rmt.get(read_plain.remote()) is None  # restored after

    def test_working_dir(self, rmt_start_regular, tmp_path):
        src = tmp_path / "proj"
        src.mkdir()
        (src / "data.txt").write_text("payload")

        @rmt.remote(runtime_env={"working_dir": str(src)})
        def read_file():
            return open("data.txt").read()

        assert rmt.get(read_file.remote()) == "payload"

    def test_py_modules(self, rmt_start_regular, tmp_path):
        mod = tmp_path / "extra_mod.py"
        mod.write_text("MAGIC = 77\n")

        @rmt.remote(runtime_env={"py_modules": [str(tmp_path)]})
        def use_module():
            import extra_mod

            return extra_mod.MAGIC

        assert rmt.get(use_module.remote()) == 77

    def test_actor_runtime_env(self, rmt_start_regular):
        @rmt.remote(runtime_env={"env_vars": {"ACTOR_ENV": "on"}})
        class EnvActor:
            def __init__(self):
                self.at_init = os.environ.get("ACTOR_ENV")

            def probe(self):
                return self.at_init, os.environ.get("ACTOR_ENV")

        a = EnvActor.remote()
        assert rmt.get(a.probe.remote()) == ("on", "on")
        rmt.kill(a)

    def test_unsupported_keys_rejected(self, rmt_start_regular):
        # conda is now supported (dedicated env workers); container and
        # unknown keys still refuse loudly
        @rmt.remote(runtime_env={"container": {"image": "x"}})
        def nope():
            return 1

        with pytest.raises(ValueError):
            nope.remote()

        @rmt.remote(runtime_env={"no_such_key": 1})
        def nope2():
            return 1

        with pytest.raises(ValueError):
            nope2.remote()

    def test_pip_env_installs_local_package(self, rmt_start_regular,
                                            tmp_path):
        """A task's pip runtime_env installs a package the driver lacks
        (from a local source tree — this image has no network), and the
        install is URI-cached so a second task reuses it."""
        src = tmp_path / "pkgsrc"
        (src / "rmt_pip_e2e").mkdir(parents=True)
        (src / "setup.py").write_text(
            "from setuptools import setup\n"
            "setup(name='rmt-pip-e2e', version='0.1',"
            " packages=['rmt_pip_e2e'])\n")
        (src / "rmt_pip_e2e" / "__init__.py").write_text("ANSWER = 42\n")

        with pytest.raises(ImportError):
            import rmt_pip_e2e  # noqa: F401 — driver must lack it

        env = {"pip": {"packages": [str(src)],
                       "extra_args": ["--no-index",
                                      "--no-build-isolation"]}}

        @rmt.remote(runtime_env=env, max_retries=0)
        def probe():
            import rmt_pip_e2e

            return rmt_pip_e2e.ANSWER

        assert rmt.get(probe.remote(), timeout=300) == 42
        # cached: second call must not rebuild (same content key)
        assert rmt.get(probe.remote(), timeout=60) == 42

        @rmt.remote(max_retries=0)
        def still_absent():
            try:
                import rmt_pip_e2e  # noqa: F401
            except ImportError:
                return "clean"
            return "leaked"

        assert rmt.get(still_absent.remote(), timeout=60) == "clean"


class TestCondaRuntimeEnv:
    """Conda runtime envs run in DEDICATED cold workers whose process is
    the env's python (the reference's dedicated-worker pattern for
    conda envs, worker_pool.h:446 + _private/runtime_env/conda.py). The
    conda CLI is faked via RMT_CONDA_EXE: creation materializes a prefix
    whose bin/python is a wrapper stamping RMT_FAKE_CONDA_ENV before
    exec'ing the real interpreter."""

    @pytest.fixture
    def fake_conda(self, tmp_path, monkeypatch):
        log = tmp_path / "conda_calls.log"
        fake = tmp_path / "conda"
        fake.write_text(f"""#!/bin/sh
echo "$@" >> {log}
case "$1 $2" in
  "env list") echo '{{"envs": []}}' ;;
  "env create")
    prefix=""
    prev=""
    for a in "$@"; do
      if [ "$prev" = "-p" ]; then prefix="$a"; fi
      prev="$a"
    done
    mkdir -p "$prefix/bin"
    cat > "$prefix/bin/python" <<EOF
#!/bin/sh
export RMT_FAKE_CONDA_ENV="$prefix"
exec {sys.executable} "\\$@"
EOF
    chmod +x "$prefix/bin/python"
    ;;
esac
exit 0
""")
        fake.chmod(0o755)
        monkeypatch.setenv("RMT_CONDA_EXE", str(fake))
        # private content-keyed cache per test run
        import ray_memory_management_tpu_torch.runtime_env as re_mod

        monkeypatch.setattr(re_mod, "_CONDA_CACHE",
                            str(tmp_path / "conda_cache"))
        return log

    def test_conda_task_runs_in_env_worker(self, rmt_start_regular,
                                           fake_conda):
        spec = {"name": "e2e", "dependencies": ["python"]}

        @rmt.remote(runtime_env={"conda": spec}, max_retries=0)
        def where():
            import os as _os

            return _os.environ.get("RMT_FAKE_CONDA_ENV")

        @rmt.remote(max_retries=0)
        def plain():
            import os as _os

            return _os.environ.get("RMT_FAKE_CONDA_ENV")

        env_prefix = rmt.get(where.remote(), timeout=120)
        assert env_prefix and "conda_cache" in env_prefix
        # pooled workers are untouched by the env
        assert rmt.get(plain.remote(), timeout=60) is None
        # offline cache: a second task reuses the created env — exactly
        # one `env create` ever runs, and the warm dedicated worker
        # serves the task without a new spawn
        assert rmt.get(where.remote(), timeout=60) == env_prefix
        creates = [ln for ln in
                   fake_conda.read_text().splitlines()
                   if ln.startswith("env create")]
        assert len(creates) == 1

    def test_conda_actor_runs_in_env_worker(self, rmt_start_regular,
                                            fake_conda):
        @rmt.remote(runtime_env={"conda": {"name": "act",
                                           "dependencies": []}},
                    max_restarts=0)
        class Probe:
            def env(self):
                import os as _os

                return _os.environ.get("RMT_FAKE_CONDA_ENV")

        a = Probe.remote()
        prefix = rmt.get(a.env.remote(), timeout=120)
        assert prefix and "conda_cache" in prefix
        rmt.kill(a)

    def test_conda_prefix_path_used_directly(self, rmt_start_regular,
                                             fake_conda, tmp_path):
        # a prefix dir with bin/python skips the CLI entirely
        prefix = tmp_path / "preexisting"
        (prefix / "bin").mkdir(parents=True)
        py = prefix / "bin" / "python"
        py.write_text(f"""#!/bin/sh
export RMT_FAKE_CONDA_ENV="{prefix}"
exec {sys.executable} "$@"
""")
        py.chmod(0o755)

        @rmt.remote(runtime_env={"conda": str(prefix)}, max_retries=0)
        def where():
            import os as _os

            return _os.environ.get("RMT_FAKE_CONDA_ENV")

        assert rmt.get(where.remote(), timeout=120) == str(prefix)
        assert "env create" not in fake_conda.read_text() \
            if fake_conda.exists() else True

    def test_container_still_rejected(self, rmt_start_regular):
        with pytest.raises(ValueError, match="container"):
            @rmt.remote(runtime_env={"container": {"image": "x"}})
            def f():
                return 1

            f.remote()


class TestClientMode:
    def test_client_roundtrip_subprocess(self, rmt_start_regular):
        """A separate process connects as a thin client and drives the
        cluster (the reference's ray://-init e2e shape)."""
        server = ClusterServer(port=0)
        script = f"""
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.client import connect, disconnect
connect("127.0.0.1:{server.port}")

@rmt.remote
def double(x):
    return 2 * x

refs = [double.remote(i) for i in range(5)]
assert rmt.get(refs) == [0, 2, 4, 6, 8]

@rmt.remote
class Counter:
    def __init__(self):
        self.n = 0
    def add(self, k):
        self.n += k
        return self.n

c = Counter.remote()
assert rmt.get(c.add.remote(3)) == 3
assert rmt.get(c.add.remote(4)) == 7

ref = rmt.put({{"big": list(range(1000))}})
assert rmt.get(ref)["big"][-1] == 999
ready, pending = rmt.wait([double.remote(1)], num_returns=1, timeout=30)
assert len(ready) == 1
rmt.kill(c)
disconnect()
print("CLIENT OK")
"""
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=240)
        assert "CLIENT OK" in out.stdout, out.stderr
        server.close()

    def test_unversioned_requests_refused_before_ping(
            self, rmt_start_regular):
        """Every verb before the versioned ping handshake is refused — a
        frontend cannot skip the ping and speak unversioned (ADVICE r4:
        the check previously lived only in the ping handler)."""
        from multiprocessing.connection import Client as MpClient

        server = ClusterServer(port=0)
        try:
            conn = MpClient(("127.0.0.1", server.port), family="AF_INET",
                            authkey=b"rmt-client")
            try:
                conn.send({"type": "put_bytes", "data": b"x",
                           "req_id": 1})
                reply = conn.recv()
                assert reply["error"] is not None
                from ray_memory_management_tpu_torch import serialization as ser

                exc = ser.loads(reply["error"])
                assert "handshake" in str(exc)
                # after a good ping the same verb works
                from ray_memory_management_tpu_torch.config import (
                    WIRE_PROTOCOL_VERSION,
                )

                conn.send({"type": "ping",
                           "proto": WIRE_PROTOCOL_VERSION, "req_id": 2})
                assert conn.recv()["error"] is None
                conn.send({"type": "put_bytes", "data": b"x",
                           "req_id": 3})
                reply = conn.recv()
                assert reply["error"] is None and reply["object_id"]
            finally:
                conn.close()
        finally:
            server.close()

    def test_named_actor_via_client(self, rmt_start_regular):
        @rmt.remote
        class Registry:
            def ping(self):
                return "reg"

        Registry.options(name="shared_reg", lifetime="detached").remote()
        server = ClusterServer(port=0)
        script = f"""
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.client import connect
connect("127.0.0.1:{server.port}")
h = rmt.get_actor("shared_reg")
assert rmt.get(h.ping.remote()) == "reg"
print("NAMED OK")
"""
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=240)
        assert "NAMED OK" in out.stdout, out.stderr
        server.close()


class TestDashboard:
    def test_routes(self, rmt_start_regular):
        from ray_memory_management_tpu_torch.dashboard import (
            start_dashboard, stop_dashboard,
        )

        @rmt.remote
        def touch():
            return 1

        rmt.get(touch.remote())
        dash = start_dashboard(port=0)
        try:
            def fetch(path):
                try:
                    with urllib.request.urlopen(dash.url + path,
                                                timeout=30) as r:
                        return r.status, r.read()
                except urllib.error.HTTPError as e:
                    return e.code, e.read()

            status, body = fetch("/api/cluster")
            assert status == 200
            assert json.loads(body)["nodes"] == 1
            status, body = fetch("/api/tasks")
            assert any(t["name"] == "touch" for t in json.loads(body))
            status, body = fetch("/api/nodes")
            assert json.loads(body)[0]["state"] == "ALIVE"
            status, body = fetch("/")
            assert b"rmt cluster" in body
            status, body = fetch("/metrics")
            assert status == 200
            status, body = fetch("/api/drivers")
            rows = json.loads(body)
            assert status == 200 and rows and \
                rows[0]["state"] == "RUNNING"
            status, _ = fetch("/api/bogus")
            assert status == 404
        finally:
            stop_dashboard()


class TestJobs:
    """Job table + per-client resource isolation (GcsJobManager analog,
    gcs_job_manager.h:28): every client connection is a job; disconnect
    reclaims its non-detached actors, PGs, and put objects."""

    def test_driver_job_registered(self, rmt_fresh_runtime):
        from ray_memory_management_tpu_torch import state

        jobs = state.list_jobs()
        assert len(jobs) == 1
        assert jobs[0]["state"] == "RUNNING"
        assert jobs[0]["type"] == "driver"

    def test_client_job_lifecycle_and_reclaim(self, rmt_fresh_runtime):
        import subprocess
        import sys
        import time

        from ray_memory_management_tpu_torch import state
        from ray_memory_management_tpu_torch.core.runtime import ACTOR_DEAD

        rt = rmt_fresh_runtime
        server = ClusterServer(port=0)
        try:
            script = f"""
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.client import connect
connect("127.0.0.1:{server.port}")

@rmt.remote
class JobCounter:
    def __init__(self): self.n = 0
    def inc(self):
        self.n += 1
        return self.n

a = JobCounter.options(name="job_actor").remote()
assert rmt.get(a.inc.remote()) == 1
r = rmt.put({{"who": "client"}})
print("OID", r.hex(), flush=True)
print("CLIENT OK", flush=True)
import os
os._exit(0)  # vanish without cleanup: the server must reclaim
"""
            out = subprocess.run([sys.executable, "-c", script],
                                 capture_output=True, text=True,
                                 timeout=240)
            assert "CLIENT OK" in out.stdout, out.stderr
            oid = bytes.fromhex(
                [ln for ln in out.stdout.splitlines()
                 if ln.startswith("OID ")][0].split()[1])

            # disconnect reclaims: actor killed, job row FINISHED
            deadline = time.monotonic() + 30
            rec = None
            jobs = []
            while time.monotonic() < deadline:
                jobs = state.list_jobs(filters=[("type", "=", "client")])
                recs = [r for r in rt.gcs.actors.values()
                        if r.state == ACTOR_DEAD]
                if (jobs and jobs[0]["state"] == "FINISHED" and recs):
                    rec = recs[0]
                    break
                time.sleep(0.1)
            assert jobs and jobs[0]["state"] == "FINISHED", jobs
            assert rec is not None, "client actor was not reclaimed"
            # the reclaimed actor is gone from the living set
            assert rt.gcs.get_named_actor("job_actor") is None
            # the client's put object was freed with the job
            with rt._lock:
                assert oid not in rt.memory_store
        finally:
            server.close()


