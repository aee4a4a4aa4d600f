"""Cluster launcher: ``rmt up / down / exec / submit`` over a cluster YAML.

The reference's launcher (python/ray/autoscaler/_private/commands.py behind
``ray up/down/attach/exec``, scripts.py:1165-1623) provisions cloud nodes,
then boots a head and workers over SSH. Here the same lifecycle targets a
fleet of GPU hosts:

  - the HEAD is a detached ``rmt head`` process: an rmt runtime + thin-client
    server (client/server.py) + the node-agent TCP listener;
  - WORKERS are node agents (core/node_agent.py) joined to the head, one per
    host, launched through a NodeProvider;
  - providers: ``subprocess`` (this host — the fake_multi_node analog used
    by tests and single-host clusters), ``ssh`` (one agent per remote host,
    the reference's command-runner path; exercised in tests by overriding
    the ssh binary) and ``gce-gpu`` (GCE VMs with attached GPUs through
    ``gcloud``).

Cluster state (head pid, ports, worker pids) persists in
``~/.rmt/clusters/<name>.json`` so ``down``/``exec`` find the cluster the
way the reference keeps cluster state under ``~/.ray``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

STATE_DIR = os.path.expanduser("~/.rmt/clusters")

# the package's parent dir: launched daemons and exec'd client scripts must
# import this package regardless of their cwd/script dir (the reference gets
# this for free from pip-installed ray; here the checkout is the install)
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with_pkg_path(env: Dict[str, str]) -> Dict[str, str]:
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if _PKG_PARENT not in parts:
        env["PYTHONPATH"] = os.pathsep.join([_PKG_PARENT] + parts)
    return env


# ------------------------------------------------------------------ config
def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg.setdefault("cluster_name", "default")
    cfg.setdefault("provider", {"type": "subprocess"})
    cfg.setdefault("head", {})
    cfg.setdefault("workers", [])
    return cfg


def _state_path(name: str) -> str:
    os.makedirs(STATE_DIR, exist_ok=True)
    return os.path.join(STATE_DIR, f"{name}.json")


def load_state(name: str) -> Optional[Dict[str, Any]]:
    try:
        with open(_state_path(name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def save_state(name: str, state: Dict[str, Any]) -> None:
    """Persist cluster state. Worker records are live objects that
    provider threads mutate and may carry runtime-only fields (the GCE
    provider's "_mu" lock, which json.dump would crash on): persist a
    snapshot of the JSON-safe public fields only — ``down`` needs
    name/kind/pid, and terminate_worker treats a missing "_mu" as
    "loaded from disk"."""

    def _public(rec: Dict[str, Any]) -> Dict[str, Any]:
        mu = rec.get("_mu")
        if mu is not None:
            with mu:
                items = list(rec.items())
        else:
            items = list(rec.items())
        return {k: v for k, v in items
                if not k.startswith("_")
                and isinstance(v, (str, int, float, bool, type(None)))}

    snapshot = dict(state)
    if isinstance(snapshot.get("workers"), list):
        snapshot["workers"] = [
            _public(w) if isinstance(w, dict) else w
            for w in snapshot["workers"]]
    with open(_state_path(name), "w") as f:
        json.dump(snapshot, f, indent=2)


# ---------------------------------------------------------------- providers
class NodeProvider:
    """Launches one node agent per worker entry (the reference's
    NodeProvider + command-runner pair, autoscaler/_private/*)."""

    def launch_worker(self, spec: Dict[str, Any], head_addr: str,
                      authkey_hex: str) -> Dict[str, Any]:
        raise NotImplementedError

    def terminate_worker(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError


class SubprocessProvider(NodeProvider):
    """Workers as local agent processes — the fake_multi_node analog
    (autoscaler/_private/fake_multi_node) and the single-host-pod case."""

    def __init__(self, log_dir: str = ""):
        self.log_dir = log_dir
        self._count = 0

    def launch_worker(self, spec, head_addr, authkey_hex):
        self._count += 1
        log = _daemon_log(self.log_dir, f"worker-{self._count}")
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "ray_memory_management_tpu_torch.core.node_agent",
             "--address", head_addr, "--authkey", authkey_hex,
             "--num-cpus", str(spec.get("num_cpus", 4)),
             "--num-gpus", str(spec.get("num_gpus", 0))],
            env=_with_pkg_path(dict(os.environ)), close_fds=True, **log,
        )
        return {"kind": "subprocess", "pid": proc.pid}

    def terminate_worker(self, record):
        try:
            os.kill(record["pid"], signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass


class SSHProvider(NodeProvider):
    """One agent per remote host over ssh (the command-runner path,
    autoscaler/_private/command_runner.py). The ssh binary is
    configurable so tests can substitute a local shim."""

    def __init__(self, provider_cfg: Dict[str, Any], log_dir: str = ""):
        self.ssh = provider_cfg.get("ssh_command", "ssh")
        self.user = provider_cfg.get("ssh_user", "")
        self.opts = provider_cfg.get("ssh_options",
                                     ["-o", "StrictHostKeyChecking=no"])
        self.python = provider_cfg.get("remote_python", "python3")
        self.log_dir = log_dir

    def launch_worker(self, spec, head_addr, authkey_hex):
        host = spec["host"]
        target = f"{self.user}@{host}" if self.user else host
        remote_cmd = (
            f"{self.python} -m ray_memory_management_tpu_torch.core.node_agent "
            f"--address {head_addr} --authkey {authkey_hex} "
            f"--num-cpus {spec.get('num_cpus', 4)} "
            f"--num-gpus {spec.get('num_gpus', 0)}"
        )
        proc = subprocess.Popen([self.ssh, *self.opts, target, remote_cmd],
                                close_fds=True,
                                **_daemon_log(self.log_dir, f"ssh-{host}"))
        return {"kind": "ssh", "pid": proc.pid, "host": host}

    def terminate_worker(self, record):
        # killing the local ssh client drops the channel; the agent exits
        # on channel EOF (its run loop returns when the head/pipe is gone)
        try:
            os.kill(record["pid"], signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass


class GCEGPUProvider(NodeProvider):
    """GCE VMs with attached GPUs through the ``gcloud`` CLI (the
    reference's GCP node provider, autoscaler/_private/gcp/
    node_provider.py: ``gcloud compute instances create/delete`` with
    ``--accelerator``, the agent started by ``gcloud compute ssh``).

    Worker spec fields: ``name`` (instance name; generated if absent),
    ``machine_type`` (default a3-highgpu-1g), ``accelerator_type``
    (default nvidia-h100-80gb; ``num_gpus`` of them, at least one),
    optional ``image_family``/``image_project`` (the boot image; else
    gcloud's default), plus the usual num_cpus/num_gpus. Provider
    config: ``project``,
    ``zone``, optional ``gcloud_command`` (tests substitute a recording
    shim), ``remote_python``, ``bootstrap`` (shell prefix run before
    the agent, e.g. a pip install of this package), ``create_retries``
    (default 3) and ``create_retry_wait_s`` (default 30, doubled per
    attempt) for transient create failures. Each VM joins the head as
    its own node (one agent per host, the model the multi-host plane
    expects)."""

    # stderr markers of transient gcloud failures worth retrying: capacity
    # stockouts, quota/rate limiting, and service-side flakiness. Anything
    # else (auth, bad flags, permission) fails fast into record["error"].
    # Phrases, not bare substrings: operation ids / request URLs embed
    # arbitrary digits, so bare "429"/"503" would misclassify permanent
    # errors (HTTP codes are matched word-bounded in _retryable).
    _RETRYABLE = ("RESOURCE_EXHAUSTED", "ZONE_RESOURCE_POOL_EXHAUSTED",
                  "QUOTA EXCEEDED", "QUOTA_EXCEEDED", "RATE_LIMIT",
                  "RATE LIMIT", "UNAVAILABLE", "INTERNAL ERROR",
                  "DEADLINE_EXCEEDED", "TRY AGAIN")

    def __init__(self, provider_cfg: Dict[str, Any], log_dir: str = ""):
        import itertools

        self.gcloud = provider_cfg.get("gcloud_command", "gcloud")
        self.project = provider_cfg.get("project", "")
        self.zone = provider_cfg.get("zone", "")
        self.python = provider_cfg.get("remote_python", "python3")
        self.bootstrap = provider_cfg.get("bootstrap", "")
        self.create_retries = int(provider_cfg.get("create_retries", 3))
        self.create_retry_wait_s = float(
            provider_cfg.get("create_retry_wait_s", 30.0))
        self.log_dir = log_dir
        self._counter = itertools.count(1)  # thread-safe (CPython atomic)

    @classmethod
    def _retryable(cls, stderr: str) -> bool:
        import re

        up = stderr.upper()
        if any(marker in up for marker in cls._RETRYABLE):
            return True
        return re.search(r"\b(429|503)\b", up) is not None

    def _scope(self) -> List[str]:
        out = []
        if self.project:
            out += ["--project", self.project]
        if self.zone:
            out += ["--zone", self.zone]
        return out

    def _wait_ready(self, name: str, record,
                    timeout_s: float = 900.0) -> str:
        """Poll ``describe`` until the VM reports RUNNING (used when a
        create was adopted via ALREADY_EXISTS and the server-side
        operation may still be provisioning). Returns "ready",
        "cancelled" (terminate_worker ran — the caller must fall through
        to its cancelled-cleanup delete, not bail out before it), or
        "failed" (record["error"] set)."""
        deadline = time.monotonic() + timeout_s
        describe = [self.gcloud, "compute", "instances", "describe",
                    name, *self._scope(), "--format", "value(status)"]
        consecutive_failures = 0
        while time.monotonic() < deadline:
            with record["_mu"]:
                if record["cancelled"]:
                    return "cancelled"
            try:
                rc = subprocess.run(describe, capture_output=True,
                                    text=True, timeout=120)
            except Exception:  # noqa: BLE001 - transient describe flake
                consecutive_failures += 1
                if consecutive_failures >= 6:
                    record["error"] = (f"describe {name} kept "
                                       "failing/hanging")
                    return "failed"
                time.sleep(10)
                continue
            if rc.returncode != 0:
                err = rc.stderr.strip()
                up = err.upper()
                # a gone VM or dead credentials will never turn READY:
                # fail fast instead of burning the full timeout
                if "NOT_FOUND" in up or "PERMISSION" in up or \
                        "UNAUTHENTICATED" in up:
                    record["error"] = (f"describe {name} failed: "
                                       + err[-400:])
                    return "failed"
                consecutive_failures += 1
                if consecutive_failures >= 6:
                    record["error"] = (f"describe {name} kept failing: "
                                       + err[-400:])
                    return "failed"
                time.sleep(10)
                continue
            consecutive_failures = 0
            state = rc.stdout.strip().upper()
            if state == "RUNNING":
                return "ready"
            if state in ("TERMINATED", "STOPPING", "SUSPENDED"):
                record["error"] = f"vm {name} entered state {state}"
                return "failed"
            time.sleep(10)
        record["error"] = (f"vm {name} not RUNNING after {timeout_s:.0f}s "
                           "(adopted via ALREADY_EXISTS)")
        return "failed"

    def launch_worker(self, spec, head_addr, authkey_hex):
        import threading

        name = spec.get("name", f"rmt-worker-{next(self._counter)}")
        accel = spec.get("accelerator_type", "nvidia-h100-80gb")
        create = [
            self.gcloud, "compute", "instances", "create", name,
            *self._scope(),
            "--machine-type", spec.get("machine_type", "a3-highgpu-1g"),
            "--accelerator",
            f"type={accel},count={max(int(spec.get('num_gpus', 1)), 1)}",
            "--maintenance-policy", "TERMINATE",  # GPU VMs cannot migrate
        ]
        for key in ("image_family", "image_project"):
            if spec.get(key):
                create += ["--" + key.replace("_", "-"), spec[key]]
        agent_cmd = (
            f"{self.python} -m ray_memory_management_tpu_torch.core.node_agent "
            f"--address {head_addr} --authkey {authkey_hex} "
            f"--num-cpus {spec.get('num_cpus', 4)} "
            f"--num-gpus {spec.get('num_gpus', 0)}"
        )
        if self.bootstrap:
            agent_cmd = f"{self.bootstrap} && {agent_cmd}"
        ssh = [
            self.gcloud, "compute", "ssh", name,
            *self._scope(), "--command", agent_cmd,
        ]
        # _mu makes terminate-vs-provision atomic: the delete can run while
        # the up-to-30-minute create is still in flight, and without the
        # cancelled check the late-finishing provision would spawn the ssh
        # agent anyway (pid was None at kill time), leaving an orphan agent
        # dialing the head against a deleted VM
        record = {"kind": "gce-gpu", "pid": None, "name": name,
                  "error": None, "cancelled": False,
                  "_mu": threading.Lock()}

        def provision():
            # create takes MINUTES per GPU VM: run it off the caller so a
            # multi-worker `up` provisions the whole fleet concurrently
            # (nodes join the head as their agents come up). Transient
            # failures — capacity stockouts, quota/rate limits, service
            # flakiness, hung creates — retry with exponential backoff;
            # everything else fails fast into record["error"].
            for attempt in range(self.create_retries + 1):
                with record["_mu"]:
                    if record["cancelled"]:
                        return  # terminated before we created anything
                try:
                    rc = subprocess.run(create, capture_output=True,
                                        text=True, timeout=1800)
                except subprocess.TimeoutExpired:
                    # a hung create is the same transient condition as a
                    # server-reported timeout: retry it
                    if attempt < self.create_retries:
                        time.sleep(
                            self.create_retry_wait_s * (2 ** attempt))
                        continue
                    record["error"] = "create timed out after retries"
                    return
                except Exception as e:  # noqa: BLE001
                    record["error"] = f"create failed: {e!r}"
                    return
                if rc.returncode == 0:
                    break
                err = rc.stderr.strip()
                if attempt > 0 and "ALREADY_EXISTS" in err.upper():
                    # an earlier "failed" attempt actually landed server-
                    # side (the classic ambiguous 503-after-accept): the
                    # VM exists, so proceed to ssh — failing here would
                    # leave a billed VM running that nothing tracks or
                    # deletes. The server-side create may still be
                    # mid-provision (the timed-out attempt's operation
                    # keeps running), and ssh is one-shot: wait for READY
                    # first or the agent launch fails with no retry.
                    status = self._wait_ready(name, record)
                    if status == "failed":
                        # error recorded; the VM stays in cluster state so
                        # `rmt down` still deletes it
                        return
                    # "ready" falls through to ssh; "cancelled" falls
                    # through to the post-loop cancelled check, which
                    # skips ssh and runs the cleanup delete
                    break
                if attempt < self.create_retries and self._retryable(err):
                    time.sleep(self.create_retry_wait_s * (2 ** attempt))
                    continue
                record["error"] = err[-500:]
                return
            with record["_mu"]:
                cancelled = record["cancelled"]
                if not cancelled:
                    proc = subprocess.Popen(
                        ssh, close_fds=True,
                        **_daemon_log(self.log_dir, f"gce-{name}"))
                    record["pid"] = proc.pid
            if cancelled:
                # terminate_worker already ran — its delete hit a VM that
                # didn't exist yet, so the create we just finished made a
                # fresh (billed) VM nobody else will clean up: delete it
                # here, outside the lock, and RECORD any failure (a billed
                # VM silently leaking is the worst outcome)
                try:
                    rc = subprocess.run(
                        [self.gcloud, "compute", "instances",
                         "delete", name, *self._scope(), "--quiet"],
                        capture_output=True, text=True, timeout=1800)
                    # terminate_worker may have won the race and deleted
                    # the VM itself — a not-found delete is a success, not
                    # a leak
                    if rc.returncode != 0 and "not found" not in \
                            rc.stderr.lower():
                        record["error"] = ("cleanup delete failed — VM "
                                           f"{name} may be leaked: "
                                           + rc.stderr.strip()[-400:])
                except Exception as e:  # noqa: BLE001
                    record["error"] = ("cleanup delete failed — VM "
                                       f"{name} may be leaked: {e!r}")

        threading.Thread(target=provision, daemon=True,
                         name=f"gce-up-{name}").start()
        return record

    def terminate_worker(self, record):
        mu = record.get("_mu")
        if mu is not None:
            with mu:
                record["cancelled"] = True
                pid = record.get("pid")
        else:
            pid = record.get("pid")
        if pid:
            try:
                os.kill(pid, signal.SIGTERM)  # drop the ssh channel
            except (ProcessLookupError, PermissionError):
                pass
        subprocess.run(
            [self.gcloud, "compute", "instances", "delete",
             record["name"], *self._scope(), "--quiet"],
            capture_output=True, text=True, timeout=1800)


def _daemon_log(log_dir: str, tag: str) -> Dict[str, Any]:
    """Popen kwargs detaching a daemon's stdio from the caller: inheriting
    the CLI's pipes would keep e.g. ``subprocess.run(capture_output=True)``
    callers blocked on pipe EOF for as long as the daemon lives. Output
    goes to a log file when a log_dir is known (the reference keeps head /
    raylet logs under the session dir), else /dev/null."""
    if not log_dir:
        return {"stdin": subprocess.DEVNULL, "stdout": subprocess.DEVNULL,
                "stderr": subprocess.DEVNULL}
    os.makedirs(log_dir, exist_ok=True)
    f = open(os.path.join(log_dir, f"{tag}.log"), "ab")
    return {"stdin": subprocess.DEVNULL, "stdout": f, "stderr": f}


def make_provider(provider_cfg: Dict[str, Any],
                  log_dir: str = "") -> NodeProvider:
    kind = provider_cfg.get("type", "subprocess")
    if kind == "subprocess":
        return SubprocessProvider(log_dir)
    if kind == "ssh":
        return SSHProvider(provider_cfg, log_dir)
    if kind in ("gce", "gce-gpu"):
        return GCEGPUProvider(provider_cfg, log_dir)
    raise ValueError(f"unknown provider type: {kind}")


# --------------------------------------------------------------- lifecycle
def up(config_path: str, wait_s: float = 60.0) -> Dict[str, Any]:
    """Boot the head process and all workers; returns the cluster state."""
    cfg = load_cluster_config(config_path)
    name = cfg["cluster_name"]
    existing = load_state(name)
    if existing and _pid_alive(existing.get("head_pid")):
        raise RuntimeError(f"cluster '{name}' is already up "
                           f"(head pid {existing['head_pid']})")

    info_path = _state_path(name) + ".head"
    try:
        os.unlink(info_path)
    except OSError:
        pass
    head_cfg = cfg["head"]
    env = dict(os.environ)
    env["RMT_HEAD_INFO_PATH"] = info_path
    env["RMT_HEAD_NUM_CPUS"] = str(head_cfg.get("num_cpus", 4))
    env["RMT_HEAD_NUM_GPUS"] = str(head_cfg.get("num_gpus", 0))
    env["RMT_HEAD_CLIENT_PORT"] = str(head_cfg.get("client_port", 0))
    log_dir = os.path.join(STATE_DIR, f"{name}.logs")
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_memory_management_tpu_torch.launcher"],
        env=_with_pkg_path(env), close_fds=True,
        **_daemon_log(log_dir, "head"),
    )
    deadline = time.monotonic() + wait_s
    info = None
    while time.monotonic() < deadline:
        if head.poll() is not None:
            raise RuntimeError(f"head exited rc={head.returncode}")
        try:
            with open(info_path) as f:
                info = json.load(f)
            break
        except (OSError, ValueError):
            time.sleep(0.2)
    if info is None:
        head.kill()
        raise TimeoutError("head did not come up in time")

    provider = make_provider(cfg["provider"], log_dir)
    workers = [provider.launch_worker(spec, info["node_listener"],
                                      info["authkey"])
               for spec in cfg["workers"]]
    # state is saved BEFORE the readiness wait so a slow/unreachable worker
    # leaves a cluster `rmt down` can still find and clean up
    state = {
        "cluster_name": name,
        "config_path": os.path.abspath(config_path),
        "head_pid": head.pid,
        "client_address": info["client_address"],
        "node_listener": info["node_listener"],
        "workers": workers,
        "provider": cfg["provider"],
    }
    save_state(name, state)
    # ray-up waits until workers are usable; here that means the agents
    # registered and the cluster's aggregate CPU covers every node
    want_cpus = (head_cfg.get("num_cpus", 4)
                 + sum(w.get("num_cpus", 4) for w in cfg["workers"]))
    _wait_for_cpus(info["client_address"], want_cpus,
                   deadline - time.monotonic() + wait_s)
    return state


def down(config_or_name: str) -> bool:
    """Tear the cluster down (``ray down`` analog)."""
    name = config_or_name
    if os.path.exists(config_or_name):
        name = load_cluster_config(config_or_name)["cluster_name"]
    state = load_state(name)
    if state is None:
        return False
    provider = make_provider(state.get("provider", {}))
    for rec in state.get("workers", []):
        provider.terminate_worker(rec)
    head_pid = state.get("head_pid")
    if _pid_alive(head_pid):
        _kill_quietly(head_pid, signal.SIGTERM)
        for attempt in range(100):
            _reap(head_pid)
            if not _pid_alive(head_pid):
                break
            if attempt == 50:  # graceful shutdown is taking too long
                _kill_quietly(head_pid, signal.SIGKILL)
            time.sleep(0.1)
    try:
        os.unlink(_state_path(name))
    except OSError:
        pass
    return True


def client_address(config_or_name: str) -> str:
    name = config_or_name
    if os.path.exists(config_or_name):
        name = load_cluster_config(config_or_name)["cluster_name"]
    state = load_state(name)
    if state is None:
        raise RuntimeError(f"cluster '{name}' is not up")
    return state["client_address"]


def exec_script(config_or_name: str, script: List[str]) -> int:
    """Run a command with RMT_CLIENT_ADDRESS pointing at the cluster
    (``ray exec``/``ray submit`` analog — the script connects via
    client.connect(os.environ['RMT_CLIENT_ADDRESS']))."""
    env = _with_pkg_path(dict(os.environ))
    env["RMT_CLIENT_ADDRESS"] = client_address(config_or_name)
    return subprocess.call(script, env=env)


def _wait_for_cpus(client_address: str, want_cpus: float,
                   timeout: float) -> None:
    """Poll the head's cluster_resources through the thin-client port
    until every launched node has registered its CPUs."""
    from multiprocessing.connection import Client as _Client

    from .config import WIRE_PROTOCOL_VERSION

    host, port = client_address.rsplit(":", 1)
    deadline = time.monotonic() + max(5.0, timeout)
    while time.monotonic() < deadline:
        try:
            conn = _Client((host, int(port)), authkey=b"rmt-client")
            try:
                # every verb is refused until the versioned ping lands
                # (the wire-protocol gate all frontends pass through)
                conn.send({"type": "ping", "req_id": 0,
                           "proto": WIRE_PROTOCOL_VERSION})
                conn.recv()
                conn.send({"type": "cluster_resources", "req_id": 1})
                reply = conn.recv()
            finally:
                conn.close()
            if reply.get("resources", {}).get("CPU", 0) >= want_cpus:
                return
        except (OSError, EOFError, ValueError):
            pass
        time.sleep(0.25)
    raise TimeoutError(
        f"workers did not register {want_cpus} CPUs in time")


def _kill_quietly(pid, sig) -> None:
    try:
        os.kill(pid, sig)
    except (ProcessLookupError, PermissionError):
        pass  # exited on its own between the liveness check and the kill


def _reap(pid) -> None:
    """Collect the exit status if ``pid`` is our zombie child (a SIGKILLed
    child stays kill-0-visible until waited, which would make _pid_alive
    lie forever)."""
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass  # not our child (down() from another process) — init reaps it


def _pid_alive(pid) -> bool:
    if not pid:
        return False
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False
    except OSError:
        return False


# ------------------------------------------------------------- head process
def _head_main() -> int:
    """Entry point of the detached head process (``rmt up`` spawns this):
    an rmt runtime serving thin clients + node agents until SIGTERM."""
    import threading

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.client import ClusterServer

    rt = rmt.init(
        num_cpus=int(os.environ.get("RMT_HEAD_NUM_CPUS", "4")),
        num_gpus=int(os.environ.get("RMT_HEAD_NUM_GPUS", "0")),
    )
    server = ClusterServer(port=int(os.environ.get("RMT_HEAD_CLIENT_PORT",
                                                   "0")))
    host, port = rt.node_listener_address
    info = {
        "client_address": f"127.0.0.1:{server.port}",
        "node_listener": f"{host}:{port}",
        "authkey": rt._authkey.hex(),
        "pid": os.getpid(),
    }
    info_path = os.environ["RMT_HEAD_INFO_PATH"]
    with open(info_path + ".tmp", "w") as f:
        json.dump(info, f)
    os.replace(info_path + ".tmp", info_path)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    rmt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_head_main())
