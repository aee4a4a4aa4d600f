"""Cluster launcher: ``rmt up / exec / down`` lifecycle (the reference's
``ray up/down/exec`` launcher, scripts.py:1165-1623, with the subprocess
provider standing in for cloud hosts the way fake_multi_node does)."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from ray_memory_management_tpu_torch import launcher
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def cluster_yaml(tmp_path, monkeypatch):
    monkeypatch.setattr(launcher, "STATE_DIR", str(tmp_path / "state"))
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text(textwrap.dedent("""
        cluster_name: launchtest
        provider:
          type: subprocess
        head:
          num_cpus: 2
        workers:
          - num_cpus: 2
          - num_cpus: 2
    """))
    return str(cfg)


def test_up_exec_down(cluster_yaml):
    state = launcher.up(cluster_yaml, wait_s=120)
    try:
        assert launcher._pid_alive(state["head_pid"])
        assert len(state["workers"]) == 2

        # a client script drives the cluster through RMT_CLIENT_ADDRESS,
        # and its tasks spread across the agent nodes
        script = textwrap.dedent("""
            import os
            import ray_memory_management_tpu_torch as rmt
            from ray_memory_management_tpu_torch.client import connect, disconnect

            connect(os.environ["RMT_CLIENT_ADDRESS"])

            @rmt.remote(scheduling_strategy="SPREAD")
            def whoami(i):
                import os
                return os.environ["RMT_NODE_ID"]

            homes = set(rmt.get([whoami.remote(i) for i in range(12)],
                                timeout=120))
            assert len(homes) >= 2, homes
            print("HOMES", len(homes))
            disconnect()
        """)
        path = os.path.join(os.path.dirname(cluster_yaml), "client.py")
        with open(path, "w") as f:
            f.write(script)
        rc = launcher.exec_script(cluster_yaml, [sys.executable, path])
        assert rc == 0
    finally:
        assert launcher.down(cluster_yaml)
    assert not launcher._pid_alive(state["head_pid"])
    assert launcher.load_state("launchtest") is None


def test_double_up_refused(cluster_yaml):
    state = launcher.up(cluster_yaml, wait_s=120)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            launcher.up(cluster_yaml)
    finally:
        launcher.down(cluster_yaml)


def test_ssh_provider_command_shape(tmp_path, monkeypatch):
    """The ssh provider launches agents through the configured ssh binary;
    a shim records the command instead of dialing a host."""
    monkeypatch.setattr(launcher, "STATE_DIR", str(tmp_path / "state"))
    shim = tmp_path / "fake_ssh.sh"
    log = tmp_path / "ssh.log"
    shim.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\nsleep 600\n")
    shim.chmod(0o755)
    provider = launcher.SSHProvider({
        "type": "ssh", "ssh_command": str(shim), "ssh_user": "gpu",
        "ssh_options": [],
    })
    rec = provider.launch_worker({"host": "pod-worker-7", "num_cpus": 8,
                                  "num_gpus": 4},
                                 "10.0.0.1:7777", "abcd")
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not log.exists():
            time.sleep(0.05)
        line = log.read_text().strip()
        assert "gpu@pod-worker-7" in line
        assert "--address 10.0.0.1:7777" in line
        assert "--num-cpus 8" in line and "--num-gpus 4" in line
        assert "node_agent" in line
    finally:
        provider.terminate_worker(rec)


def test_gce_gpu_provider_command_shape(tmp_path, monkeypatch):
    """The GCE provider drives gcloud compute instances create (with an
    attached GPU), ssh and delete; a shim records every invocation
    instead of touching GCP."""
    monkeypatch.setattr(launcher, "STATE_DIR", str(tmp_path / "state"))
    shim = tmp_path / "fake_gcloud.sh"
    log = tmp_path / "gcloud.log"
    shim.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "case \"$*\" in *\" ssh \"*) sleep 600;; esac\n")
    shim.chmod(0o755)
    provider = launcher.GCEGPUProvider({
        "type": "gce-gpu", "gcloud_command": str(shim),
        "project": "my-proj", "zone": "us-central1-a",
        "bootstrap": "pip install rmt",
    })
    rec = provider.launch_worker(
        {"name": "podnode", "accelerator_type": "nvidia-h100-80gb",
         "num_cpus": 8, "num_gpus": 8},
        "10.0.0.1:7777", "abcd")
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                not log.exists() or log.read_text().count("\n") < 2):
            time.sleep(0.05)
        lines = log.read_text().strip().splitlines()
        create = next(ln for ln in lines if " create " in ln)
        assert "compute instances create podnode" in create
        assert "--project my-proj" in create
        assert "--accelerator type=nvidia-h100-80gb,count=8" in create
        ssh = next(ln for ln in lines if " ssh " in ln)
        assert "compute ssh podnode" in ssh
        assert "--num-gpus 8" in ssh
        assert "pip install rmt &&" in ssh
        assert "--address 10.0.0.1:7777" in ssh
        assert "node_agent" in ssh
    finally:
        provider.terminate_worker(rec)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            "delete" not in log.read_text():
        time.sleep(0.05)
    assert any("delete podnode" in ln and "--quiet" in ln
               for ln in log.read_text().splitlines())


def test_gce_gpu_create_retries_transient_failures(tmp_path):
    """A capacity stockout on create retries with backoff and succeeds;
    a non-transient error fails fast into record['error']."""
    import time as _time

    count_file = tmp_path / "count"
    count_file.write_text("0")
    log = tmp_path / "gcloud.log"
    shim = tmp_path / "gcloud"
    shim.write_text(f"""#!/bin/sh
echo "$@" >> {log}
case "$*" in
  *create*)
    n=$(cat {count_file})
    echo $((n + 1)) > {count_file}
    if [ "$n" -lt 2 ]; then
      echo "ERROR: ZONE_RESOURCE_POOL_EXHAUSTED: no capacity" >&2
      exit 1
    fi
    ;;
esac
exit 0
""")
    shim.chmod(0o755)
    from ray_memory_management_tpu_torch import launcher

    provider = launcher.GCEGPUProvider({
        "type": "gce-gpu", "gcloud_command": str(shim),
        "project": "p", "zone": "z",
        "create_retries": 3, "create_retry_wait_s": 0.05,
    })
    rec = provider.launch_worker({"name": "stocked"}, "h:1", "ab")
    deadline = _time.monotonic() + 20
    while _time.monotonic() < deadline:
        if log.exists() and any(" ssh " in ln
                                for ln in log.read_text().splitlines()):
            break
        _time.sleep(0.05)
    assert rec["error"] is None
    assert count_file.read_text().strip() == "3"  # 2 failures + 1 success
    assert any(" ssh " in ln for ln in log.read_text().splitlines())
    provider.terminate_worker(rec)

    # non-transient error: no retries, error recorded
    bad_log = tmp_path / "bad.log"
    bad = tmp_path / "gcloud_bad"
    bad.write_text(f"""#!/bin/sh
echo "$@" >> {bad_log}
case "$*" in *create*) echo "ERROR: PERMISSION_DENIED" >&2; exit 1;; esac
exit 0
""")
    bad.chmod(0o755)
    provider2 = launcher.GCEGPUProvider({
        "type": "gce-gpu", "gcloud_command": str(bad),
        "create_retries": 3, "create_retry_wait_s": 0.05,
    })
    rec2 = provider2.launch_worker({"name": "denied"}, "h:1", "ab")
    deadline = _time.monotonic() + 20
    while _time.monotonic() < deadline and rec2["error"] is None:
        _time.sleep(0.05)
    assert rec2["error"] and "PERMISSION_DENIED" in rec2["error"]
    assert bad_log.read_text().count("create") == 1  # no retry
