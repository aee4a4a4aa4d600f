"""The surfaces against the JAX package: the same program through both
packages on the CPU gives the same state rows, rules, autoscaler
decisions, job results and launcher commands.

- state: one program of tasks, an actor and puts; ``summarize_tasks``
  and ``summarize_objects`` agree, and every ``list_*`` row carries the
  same keys;
- ``rmt check``: the same rules are registered;
- autoscaler: one demand sequence over a fake provider and a fake
  runtime gives the same launch and terminate decisions;
- job submission: one entrypoint ends in the same status with the same
  log text;
- launcher: the providers' command lines agree word for word, but for
  the device: ``--num-gpus`` where the JAX package passes ``--num-tpus``,
  the port's agent module, and ``gcloud compute instances`` with
  ``--accelerator`` (``gcloud compute ssh``) where the JAX package
  drives ``gcloud compute tpus tpu-vm`` with ``--accelerator-type``.
"""

import sys
import threading
import time

import numpy as np
import pytest

import ray_memory_management_tpu as jrmt
import ray_memory_management_tpu_torch as rmt
from _port_fixtures import one_intra_op_thread  # noqa: F401


def _state_program(pkg):
    """Tasks (one failing), an actor and two puts; returns the summaries
    and each list's row keys."""
    from importlib import import_module

    state = import_module(f"{pkg.__name__}.state")
    pkg.init(num_cpus=2)
    try:
        @pkg.remote
        def square(x):
            return x * x

        @pkg.remote
        def boom():
            raise ValueError("boom")

        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        assert pkg.get([square.remote(i) for i in range(5)],
                       timeout=120) == [i * i for i in range(5)]
        with pytest.raises(Exception):
            pkg.get(boom.remote(), timeout=120)
        counter = pkg.remote(Counter).remote()
        assert pkg.get(counter.add.remote(3), timeout=120) == 3
        keep = [pkg.put(np.arange(1 << 15, dtype=np.float64)),  # shm
                pkg.put(b"small")]                              # inline
        tasks = state.summarize_tasks()
        summary = {
            "tasks": {"total": tasks["total"],
                      "by_state": tasks["by_state"],
                      "by_name": tasks["by_name"]},
            "objects": state.summarize_objects(),
            "actors": state.summarize_actors(),
        }
        keys = {}
        for kind in ("nodes", "tasks", "objects", "actors", "workers",
                     "jobs"):
            rows = getattr(state, f"list_{kind}")()
            assert rows, kind
            keys[kind] = sorted({k for r in rows for k in r})
        del keep
        return summary, keys
    finally:
        pkg.shutdown()


def test_state_summaries_and_row_keys_match():
    j_summary, j_keys = _state_program(jrmt)
    p_summary, p_keys = _state_program(rmt)
    assert p_keys == j_keys
    assert p_summary == j_summary
    assert p_summary["tasks"]["total"] >= 7


CHECKERS = ("check_faults", "check_health", "check_locks", "check_logs",
            "check_metrics", "check_protocol", "check_trace")


def test_check_rules_match():
    # the rules register when their checker modules are imported (both
    # engines import them lazily, in run_checks), so import them on both
    # sides first: what an earlier case in this process ran must not
    # decide the comparison
    import importlib

    from ray_memory_management_tpu.analysis import all_rules as j_rules
    from ray_memory_management_tpu_torch.analysis import all_rules

    for pkg in ("ray_memory_management_tpu", "ray_memory_management_tpu_torch"):
        for name in CHECKERS:
            importlib.import_module(f"{pkg}.analysis.{name}")
    assert all_rules() == j_rules()
    assert len(all_rules()) >= 8


class _FakeNode:
    def __init__(self):
        self.alive = True
        self.queue = []
        self.workers = {}

    def backlog(self):
        return len(self.queue)


class _FakeRuntime:
    def __init__(self):
        self._lock = threading.Lock()
        self._pending_schedule = []
        self.nodes = {}


class _FakeProvider:
    def __init__(self, rt):
        self.rt = rt
        self.next = 0

    def create_node(self, node_config):
        self.next += 1
        self.rt.nodes[self.next] = _FakeNode()
        return self.next

    def terminate_node(self, node_id):
        self.rt.nodes.pop(node_id)

    def non_terminated_nodes(self):
        return sorted(self.rt.nodes)


def _autoscaler_decisions(module):
    """Feed one demand sequence (pending tasks, nodes kept busy) and
    record the managed nodes after every update."""
    rt = _FakeRuntime()
    provider = _FakeProvider(rt)
    sc = module.StandardAutoscaler(provider, node_config={"num_cpus": 2},
                                   min_workers=1, max_workers=3,
                                   idle_timeout_s=0.0, runtime=rt)
    seen = []
    for pending, busy in ((0, ()), (3, ()), (3, (1,)), (5, (1, 2)),
                          (5, (1, 2, 3)), (0, (2,)), (0, ()), (0, ())):
        rt._pending_schedule[:] = [object()] * pending
        for nid, node in rt.nodes.items():
            node.queue[:] = ["task"] if nid in busy else []
        sc.update()
        seen.append((provider.non_terminated_nodes(), sc.num_launches,
                     sc.num_terminations))
    return seen


def test_autoscaler_decisions_match():
    from ray_memory_management_tpu import autoscaler as j_autoscaler
    from ray_memory_management_tpu_torch import autoscaler

    got = _autoscaler_decisions(autoscaler)
    assert got == _autoscaler_decisions(j_autoscaler)
    assert got[-1][1] >= 3 and got[-1][2] >= 2  # it scaled both ways


@pytest.mark.parametrize("code,status", [
    ("print('hello from the job'); import sys; "
     "print('to stderr', file=sys.stderr)", "SUCCEEDED"),
    ("print('about to fail'); raise SystemExit(3)", "FAILED"),
], ids=["succeeds", "fails"])
def test_job_status_and_logs_match(tmp_path, code, status):
    from ray_memory_management_tpu import job_submission as j_jobs
    from ray_memory_management_tpu_torch import job_submission

    out = []
    for i, module in enumerate((j_jobs, job_submission)):
        client = module.JobSubmissionClient(str(tmp_path / f"jobs{i}"))
        job = client.submit_job(
            entrypoint=f"{sys.executable} -c \"{code}\"",
            submission_id="same-job")
        deadline = time.monotonic() + 60
        while (client.get_job_status(job) == module.RUNNING
               and time.monotonic() < deadline):
            time.sleep(0.05)
        out.append((client.get_job_status(job), client.get_job_logs(job),
                    [m["job_id"] for m in client.list_jobs()]))
    assert out[1] == out[0]
    assert out[1][0] == status


def _record(tmp_path, name, body=""):
    shim = tmp_path / name
    log = tmp_path / f"{name}.log"
    shim.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\n{body}")
    shim.chmod(0o755)
    return shim, log


def _lines(log, want, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if log.exists() and log.read_text().count("\n") >= want:
            break
        time.sleep(0.05)
    return log.read_text().strip().splitlines()


def _to_port_words(line):
    return (line.replace("--num-tpus", "--num-gpus")
            .replace("ray_memory_management_tpu.",
                     "ray_memory_management_tpu_torch."))


def test_launcher_command_shapes_match(tmp_path):
    from ray_memory_management_tpu import launcher as j_launcher
    from ray_memory_management_tpu_torch import launcher

    # ssh: the same command line, with the device flag and module renamed
    lines = []
    for i, (module, n_key) in enumerate(((j_launcher, "num_tpus"),
                                         (launcher, "num_gpus"))):
        shim, log = _record(tmp_path, f"ssh{i}", "sleep 600\n")
        provider = module.SSHProvider({"ssh_command": str(shim),
                                       "ssh_user": "me",
                                       "ssh_options": []})
        rec = provider.launch_worker({"host": "h7", "num_cpus": 8,
                                      n_key: 4}, "10.0.0.1:7777", "abcd")
        try:
            lines.append(_lines(log, 1))
        finally:
            provider.terminate_worker(rec)
        assert set(rec) == {"kind", "pid", "host"}
    assert lines[1] == [_to_port_words(ln) for ln in lines[0]]
    assert "--num-gpus 4" in lines[1][0]

    # gcloud: create, then ssh, then delete on terminate; the same scope,
    # bootstrap and agent command, the device words swapped
    cfg = {"project": "p", "zone": "z", "bootstrap": "setup-node"}
    got = []
    for i, (cls, spec) in enumerate((
            (j_launcher.GCETPUProvider, {"name": "n1", "num_tpus": 8,
                                         "num_cpus": 8}),
            (launcher.GCEGPUProvider, {"name": "n1", "num_gpus": 8,
                                       "num_cpus": 8}))):
        shim, log = _record(tmp_path, f"gcloud{i}",
                            "case \"$*\" in *\" ssh \"*) sleep 600;; "
                            "esac\n")
        provider = cls(dict(cfg, gcloud_command=str(shim)))
        rec = provider.launch_worker(spec, "10.0.0.1:7777", "abcd")
        try:
            _lines(log, 2)
        finally:
            provider.terminate_worker(rec)
        got.append((_lines(log, 3), sorted(rec)))
    (j_lines, j_keys), (p_lines, p_keys) = got
    assert p_keys == j_keys
    assert [ln.split()[:3] for ln in j_lines] == [
        ["compute", "tpus", "tpu-vm"]] * 3
    verbs = [ln.split()[3] for ln in j_lines]
    assert verbs == ["create", "ssh", "delete"]
    assert [ln.split()[:4] for ln in p_lines] == [
        ["compute", "instances", "create", "n1"],
        ["compute", "ssh", "n1", "--project"],
        ["compute", "instances", "delete", "n1"]]
    scope = "--project p --zone z"
    assert all(scope in ln for ln in j_lines + p_lines)
    assert "--accelerator-type" in j_lines[0]
    assert "--accelerator type=nvidia-h100-80gb,count=8" in p_lines[0]
    j_agent = j_lines[1].split("--command ", 1)[1]
    p_agent = p_lines[1].split("--command ", 1)[1]
    assert p_agent == _to_port_words(j_agent)
    assert p_agent.startswith("setup-node && ")
    assert j_lines[2].endswith("--quiet") and p_lines[2].endswith("--quiet")


def test_port_cli_lacks_only_check_perf():
    """``check --perf`` (with its ``--baseline`` and ``--current``) waits
    for the port's benchmark; every verb of the JAX package's CLI is
    there, ``microbenchmark`` included, and ``list`` is the port's own."""
    from ray_memory_management_tpu.scripts import cli as j_cli
    from ray_memory_management_tpu_torch.scripts import cli

    def verbs(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return sub.choices

    def options(parser):
        return {o for a in parser._actions for o in a.option_strings}

    j_verbs, p_verbs = verbs(j_cli.build_parser()), verbs(cli.build_parser())
    assert set(j_verbs) - set(p_verbs) == set()
    assert set(p_verbs) - set(j_verbs) == {"list"}
    assert options(j_verbs["check"]) - options(p_verbs["check"]) == {
        "--perf", "--baseline", "--current"}
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["check", "--perf"])
