"""Ops-layer tests: state API, autoscaler, job submission, CLI
(reference coverage shape: test_state_api.py, test_autoscaler.py,
dashboard job tests, CLI smoke tests)."""

import subprocess
import sys
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.autoscaler import (
    Monitor, StandardAutoscaler, VirtualNodeProvider,
)
from ray_memory_management_tpu_torch.job_submission import JobSubmissionClient


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


@pytest.fixture(autouse=True, scope="module")
def _end_shared():
    yield
    rmt.shutdown()
    _shared.clear()


@pytest.fixture
def rmt_start_cluster():
    """3-node virtual cluster, 4 CPUs each."""
    rt = rmt.init(num_cpus=4, num_nodes=3)
    yield rt
    rmt.shutdown()


class TestStateAPI:
    def test_list_nodes(self, rmt_start_cluster):
        nodes = state.list_nodes()
        assert len(nodes) == 3
        assert all(n["state"] == "ALIVE" for n in nodes)
        assert all("CPU" in n["resources_total"] for n in nodes)

    def test_list_tasks_and_summary(self, rmt_start_regular):
        @rmt.remote
        def job(x):
            return x

        rmt.get([job.remote(i) for i in range(5)])
        tasks = state.list_tasks()
        assert len(tasks) >= 5
        finished = state.list_tasks(filters=[("state", "=", "FINISHED")])
        assert len(finished) >= 5
        summary = state.summarize_tasks()
        assert summary["total"] >= 5
        assert summary["by_state"].get("FINISHED", 0) >= 5

    def test_list_actors(self, rmt_start_regular):
        @rmt.remote
        class A:
            def ping(self):
                return 1

        a = A.remote()
        rmt.get(a.ping.remote())
        actors = state.list_actors()
        assert any(r["class_name"] == "A" and r["state"] == "ALIVE"
                   for r in actors)
        rmt.kill(a)

    def test_list_objects(self, rmt_start_regular):
        import numpy as np

        small = rmt.put(42)
        big = rmt.put(np.zeros(1 << 18))
        objs = state.list_objects()
        ids = {o["object_id"] for o in objs}
        assert small.binary().hex() in ids
        assert big.binary().hex() in ids
        big_row = next(o for o in objs
                       if o["object_id"] == big.binary().hex())
        assert big_row["size_bytes"] > (1 << 20)
        assert state.summarize_objects()["count"] >= 2

    def test_list_workers(self, rmt_start_regular):
        @rmt.remote
        def noop():
            return 1

        rmt.get(noop.remote())
        workers = state.list_workers()
        assert len(workers) >= 1
        assert all(w["pid"] for w in workers)


class TestAutoscaler:
    def test_scale_up_on_demand(self, rmt_start_regular):
        rt = rmt_start_regular
        provider = VirtualNodeProvider(rt)
        autoscaler = StandardAutoscaler(
            provider, node_config={"num_cpus": 4}, min_workers=0,
            max_workers=3, idle_timeout_s=3600, runtime=rt)

        @rmt.remote(num_cpus=4)
        def hog(t):
            time.sleep(t)
            return 1

        # saturate: more 4-cpu tasks than the single 4-cpu node can hold
        refs = [hog.remote(2.0) for _ in range(4)]
        time.sleep(0.3)
        assert autoscaler.pending_demand() > 0
        autoscaler.update()
        assert autoscaler.num_launches >= 1
        assert len(provider.non_terminated_nodes()) >= 1
        # added capacity lets the backlog drain
        assert rmt.get(refs, timeout=60) == [1] * 4

    def test_scale_down_when_idle(self, rmt_start_regular):
        rt = rmt_start_regular
        provider = VirtualNodeProvider(rt)
        autoscaler = StandardAutoscaler(
            provider, node_config={"num_cpus": 2}, min_workers=0,
            max_workers=2, idle_timeout_s=0.2, runtime=rt)
        provider.create_node({"num_cpus": 2})
        assert len(provider.non_terminated_nodes()) == 1
        time.sleep(0.1)
        autoscaler.update()  # records idle_since
        time.sleep(0.3)
        autoscaler.update()  # past timeout: terminate
        assert len(provider.non_terminated_nodes()) == 0
        assert autoscaler.num_terminations == 1

    def test_process_provider_scales_real_agents(self, rmt_start_regular):
        """ProcessNodeProvider: the autoscaler grows/shrinks with node-agent
        PROCESSES over the multi-host plane, not in-process virtual nodes."""
        from ray_memory_management_tpu_torch.autoscaler import ProcessNodeProvider

        rt = rmt_start_regular
        provider = ProcessNodeProvider(rt)
        autoscaler = StandardAutoscaler(
            provider, node_config={"num_cpus": 4}, min_workers=0,
            max_workers=1, idle_timeout_s=0.2, runtime=rt)

        @rmt.remote(num_cpus=4)
        def hog(t):
            time.sleep(t)
            return 1

        refs = [hog.remote(2.0) for _ in range(3)]
        time.sleep(0.3)
        assert autoscaler.pending_demand() > 0
        autoscaler.update()  # launches one agent process
        assert autoscaler.num_launches == 1
        (node_id,) = provider.non_terminated_nodes()
        assert rt._agent_proc_by_node[node_id].poll() is None
        assert rmt.get(refs, timeout=120) == [1] * 3
        # drain, then idle-terminate the agent
        deadline = time.time() + 30
        while time.time() < deadline:
            autoscaler.update()
            if not provider.non_terminated_nodes():
                break
            time.sleep(0.2)
        assert not provider.non_terminated_nodes()
        assert autoscaler.num_terminations == 1
        assert not rt.nodes[node_id].alive

    def test_min_workers_maintained(self, rmt_start_regular):
        rt = rmt_start_regular
        provider = VirtualNodeProvider(rt)
        autoscaler = StandardAutoscaler(
            provider, min_workers=2, max_workers=4, runtime=rt)
        autoscaler.update()
        assert len(provider.non_terminated_nodes()) == 2

    def test_monitor_loop(self, rmt_start_regular):
        rt = rmt_start_regular
        provider = VirtualNodeProvider(rt)
        autoscaler = StandardAutoscaler(
            provider, min_workers=1, max_workers=2, runtime=rt)
        monitor = Monitor(autoscaler, update_interval_s=0.1)
        monitor.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            if provider.non_terminated_nodes():
                break
            time.sleep(0.05)
        monitor.stop()
        assert len(provider.non_terminated_nodes()) >= 1


class TestJobSubmission:
    def test_submit_and_succeed(self, tmp_path):
        client = JobSubmissionClient(str(tmp_path))
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c \"print('job ran ok')\"")
        deadline = time.time() + 30
        while time.time() < deadline:
            if client.get_job_status(job_id) != "RUNNING":
                break
            time.sleep(0.1)
        assert client.get_job_status(job_id) == "SUCCEEDED"
        assert "job ran ok" in client.get_job_logs(job_id)

    def test_failed_job(self, tmp_path):
        client = JobSubmissionClient(str(tmp_path))
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
        deadline = time.time() + 30
        while client.get_job_status(job_id) == "RUNNING" and \
                time.time() < deadline:
            time.sleep(0.1)
        info = client.get_job_info(job_id)
        assert info["status"] == "FAILED"
        assert info["returncode"] == 3

    def test_stop_job(self, tmp_path):
        client = JobSubmissionClient(str(tmp_path))
        job_id = client.submit_job(
            entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
        assert client.get_job_status(job_id) == "RUNNING"
        assert client.stop_job(job_id)
        assert client.get_job_status(job_id) == "STOPPED"

    def test_list_jobs_cross_client(self, tmp_path):
        c1 = JobSubmissionClient(str(tmp_path))
        job_id = c1.submit_job(entrypoint="true", submission_id="jobA")
        time.sleep(0.5)
        c2 = JobSubmissionClient(str(tmp_path))
        jobs = c2.list_jobs()
        assert any(j["job_id"] == "jobA" for j in jobs)


class TestCLI:
    def _run(self, *argv, timeout=240):
        return subprocess.run(
            [sys.executable, "-m",
             "ray_memory_management_tpu_torch.scripts.cli", *argv],
            capture_output=True, text=True, timeout=timeout)

    def test_job_cli_roundtrip(self, tmp_path):
        out = self._run("job", "submit", "--job-dir", str(tmp_path),
                        "--submission-id", "cli1", "--",
                        "echo", "hello-cli")
        assert out.returncode == 0, out.stderr
        time.sleep(1.0)
        out = self._run("job", "list", "--job-dir", str(tmp_path))
        assert "cli1" in out.stdout
        out = self._run("job", "logs", "--job-dir", str(tmp_path), "cli1")
        assert "hello-cli" in out.stdout

    def test_workflow_cli(self, tmp_path, monkeypatch, rmt_start_regular):
        from ray_memory_management_tpu_torch import workflow

        old = workflow.get_storage()
        workflow.set_storage(str(tmp_path / "wf"))
        try:
            @workflow.step
            def one():
                return 1

            workflow.run(one.step(), workflow_id="cliwf")
            monkeypatch.setenv("RMT_WORKFLOW_STORAGE", str(tmp_path / "wf"))
            out = self._run("workflow", "list")
            assert "cliwf" in out.stdout and "SUCCESS" in out.stdout
        finally:
            workflow.set_storage(old)

    def test_status_cli(self):
        out = self._run("status")
        assert out.returncode == 0, out.stderr
        assert "Cluster status" in out.stdout
        assert "CPU" in out.stdout
