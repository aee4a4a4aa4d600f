"""The port's surfaces beyond the JAX package's: what lets a process
outside the head read and drive a running cluster.

- ``rmt-torch status --address`` and ``list objects --address`` read a
  running cluster through its client port (``client.ClusterServer``):
  the CLI process asks the head's state API;
- a driver submitted with ``JobSubmissionClient(address=...)`` joins the
  head with ``init(address="auto")``; the head's job row carries its
  submission id, and ``list_tasks(job_id=...)`` lists its tasks;
- with an autoscaler attached, a task that no node can hold yet waits as
  the autoscaler's demand and runs on the node it adds (the reference's
  infeasible queue); the JAX package fails it at once.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import ray_memory_management_tpu as jrmt
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.client import ClusterServer
from _port_fixtures import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def served_cluster():
    """A two-node cluster (the second holds a custom resource) with a
    thin-client port; yields (runtime, second node, client address)."""
    rt = rmt.init(num_cpus=2)
    server = ClusterServer(port=0)
    try:
        second = rt.add_node({"num_cpus": 2, "resources": {"widget": 3}})
        yield rt, second, f"127.0.0.1:{server.port}"
    finally:
        server.close()
        rmt.shutdown()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "ray_memory_management_tpu_torch.scripts.cli",
         *args], capture_output=True, text=True, timeout=120, env=env)


def test_cli_reads_a_running_cluster_through_its_client_port(
        served_cluster):
    _rt, second, address = served_cluster
    ref = rmt.put(np.arange(1 << 16, dtype=np.float64))  # shm, 512 KiB
    status = _cli("status", "--address", address)
    assert status.returncode == 0, status.stderr
    assert "Nodes: 2" in status.stdout
    (line,) = [ln for ln in status.stdout.splitlines()
               if second.hex() in ln]
    assert "ALIVE" in line and "widget 3.0" in line
    assert "  4.0 CPU" in status.stdout and "  3.0 widget" in status.stdout

    listed = _cli("list", "objects", "--address", address)
    assert listed.returncode == 0, listed.stderr
    rows = [r for r in json.loads(listed.stdout)
            if r["object_id"] == ref.hex()]
    assert rows == state.list_objects(
        filters=[("object_id", "=", ref.hex())])
    assert rows[0]["where"] == "store"

    nodes = _cli("list", "nodes", "--address", address)
    assert sorted(r["node_id"] for r in json.loads(nodes.stdout)) == sorted(
        r["node_id"] for r in state.list_nodes())


def test_cli_list_without_a_cluster_says_so():
    out = _cli("list", "objects")
    assert out.returncode == 1
    assert "no cluster is running" in out.stderr


def test_submitted_driver_joins_the_head_under_its_submission_id(
        served_cluster, tmp_path):
    from ray_memory_management_tpu_torch.job_submission import (
        JobSubmissionClient,
    )

    _rt, _second, address = served_cluster
    driver = tmp_path / "driver.py"
    driver.write_text(textwrap.dedent("""
        import ray_memory_management_tpu_torch as rmt

        rmt.init(address="auto")

        @rmt.remote(resources={"widget": 1})
        def triple(x):
            return 3 * x

        print("RESULT", rmt.get(triple.remote(14), timeout=120))
        rmt.shutdown()
    """))
    client = JobSubmissionClient(str(tmp_path / "jobs"), address=address)
    job = client.submit_job(entrypoint=f"{sys.executable} {driver}",
                            runtime_env={"env_vars": {"PYTHONPATH": REPO}})
    deadline = time.monotonic() + 120
    while (client.get_job_status(job) == "RUNNING"
           and time.monotonic() < deadline):
        time.sleep(0.1)
    logs = client.get_job_logs(job)
    assert client.get_job_status(job) == "SUCCEEDED", logs
    assert "RESULT 42" in logs
    assert client.get_job_info(job)["address"] == address
    (row,) = [r for r in state.list_jobs() if r.get("submission_id") == job]
    assert row["type"] == "client"
    tasks = state.list_tasks(job_id=row["job_id"])
    assert [(t["name"], t["state"]) for t in tasks] == [
        ("triple", "FINISHED")]


def test_init_auto_needs_an_address(monkeypatch):
    monkeypatch.delenv("RMT_CLIENT_ADDRESS", raising=False)
    with pytest.raises(Exception, match="RMT_CLIENT_ADDRESS"):
        rmt.init(address="auto")


@pytest.mark.parametrize("pkg", [rmt, jrmt], ids=["port", "jax"])
def test_a_task_no_node_holds_waits_for_the_autoscaler(pkg):
    from importlib import import_module

    autoscaler = import_module(f"{pkg.__name__}.autoscaler")
    rt = pkg.init(num_cpus=2)
    try:
        provider = autoscaler.VirtualNodeProvider(rt)
        scaler = autoscaler.StandardAutoscaler(
            provider, node_config={"num_cpus": 1,
                                   "resources": {"widget": 1}},
            max_workers=1, idle_timeout_s=3600, runtime=rt)

        @pkg.remote(resources={"widget": 1})
        def where():
            import os as _os

            return _os.environ["RMT_NODE_ID"]

        ref = where.remote()
        if pkg is jrmt:
            # the JAX package fails it before the autoscaler can help
            with pytest.raises(Exception, match="infeasible"):
                pkg.get(ref, timeout=60)
            return
        deadline = time.monotonic() + 30
        while scaler.pending_demand() == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert scaler.pending_demand() == 1
        scaler.update()
        (node,) = provider.non_terminated_nodes()
        assert pkg.get(ref, timeout=60) == node.hex()
        assert scaler.pending_demand() == 0
    finally:
        pkg.shutdown()
