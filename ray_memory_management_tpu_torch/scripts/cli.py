"""``rmt-torch`` CLI: the port's ``rmt``.

The reference's ``ray`` click CLI (python/ray/scripts/scripts.py:
status:1865, memory:1823, timeline:1758, ``ray list``, plus the job and
workflow CLIs). argparse-based (no extra deps); subcommands that need a
cluster spin up an ephemeral in-process one, or, given ``--address``,
join a running cluster's client port (``client.ClusterServer``) and ask
its head. ``check --perf`` belongs to the port's benchmark and is not
registered yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _ephemeral_runtime(num_nodes: int = 1):
    import ray_memory_management_tpu_torch as rmt

    return rmt.init(num_nodes=num_nodes, ignore_reinit_error=True)


def cmd_agent(args) -> int:
    from ray_memory_management_tpu_torch.core import node_agent

    return node_agent.main([
        "--address", args.address, "--authkey", args.authkey,
        "--num-cpus", str(args.num_cpus), "--num-gpus", str(args.num_gpus),
    ])


def cmd_up(args) -> int:
    from ray_memory_management_tpu_torch import launcher

    state = launcher.up(args.config)
    print(f"cluster '{state['cluster_name']}' is up")
    print(f"  head pid:       {state['head_pid']}")
    print(f"  client address: {state['client_address']}")
    print(f"  node listener:  {state['node_listener']}")
    print(f"  workers:        {len(state['workers'])}")
    print("connect with: from ray_memory_management_tpu_torch.client import "
          f"connect; connect(\"{state['client_address']}\")")
    return 0


def cmd_down(args) -> int:
    from ray_memory_management_tpu_torch import launcher

    if launcher.down(args.config):
        print("cluster stopped")
        return 0
    print("no such cluster (already down?)")
    return 1


def cmd_exec(args) -> int:
    from ray_memory_management_tpu_torch import launcher

    if not args.command:
        print("rmt exec: no command given "
              "(usage: rmt exec CONFIG -- CMD [ARGS...])", file=sys.stderr)
        return 2
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("rmt exec: no command given", file=sys.stderr)
        return 2
    return launcher.exec_script(args.config, command)


def cmd_status(args) -> int:
    import ray_memory_management_tpu_torch as rmt

    if args.address:
        return _status_of(args.address)
    _ephemeral_runtime(args.num_nodes)
    total = rmt.cluster_resources()
    avail = rmt.available_resources()
    print("======== Cluster status ========")
    print(f"Nodes: {len(rmt.nodes())}")
    print("Resources")
    print("---------------------------------")
    for key in sorted(total):
        print(f"  {avail.get(key, 0):.1f}/{total[key]:.1f} {key}")
    rmt.shutdown()
    return 0


def _status_of(address: str) -> int:
    """``status`` of a running cluster, read through its client port:
    every node with its resources, then the totals."""
    from ray_memory_management_tpu_torch import state
    from ray_memory_management_tpu_torch.client import connect, disconnect

    connect(address)
    try:
        nodes = state.list_nodes()
    finally:
        disconnect()
    total: dict = {}
    print("======== Cluster status ========")
    print(f"Nodes: {len(nodes)}")
    for row in nodes:
        res = row["resources_total"]
        print(f"  node {row['node_id']} {row['state']}: "
              + " ".join(f"{k} {res[k]:.1f}" for k in sorted(res)))
        if row["state"] == "ALIVE":
            for k, v in res.items():
                total[k] = total.get(k, 0.0) + v
    print("Resources")
    print("---------------------------------")
    for key in sorted(total):
        print(f"  {total[key]:.1f} {key}")
    return 0


def cmd_list(args) -> int:
    """``ray list`` analog: the state API's rows of one kind as JSON, from
    the runtime in this process or, with ``--address``, from a running
    cluster's head."""
    from ray_memory_management_tpu_torch import _worker_context, state

    fn = getattr(state, f"list_{args.kind}")
    if args.address:
        from ray_memory_management_tpu_torch.client import (
            connect, disconnect,
        )

        connect(args.address)
        try:
            rows = fn(limit=args.limit)
        finally:
            disconnect()
    elif _worker_context.get_runtime() is None:
        print("no cluster is running in this process (pass --address "
              "HOST:PORT of a cluster's client port)", file=sys.stderr)
        return 1
    else:
        rows = fn(limit=args.limit)
    print(json.dumps(rows, indent=2, default=str))
    return 0


def cmd_check(args) -> int:
    """Static-analysis suite (lock discipline, metric/fault registry
    consistency, wire-protocol additivity, trace propagation) over the
    port's tree and tests. Exits non-zero with ``file:line: rule:
    message`` output on violations."""
    from ray_memory_management_tpu_torch.analysis.__main__ import main as check

    argv = []
    if args.json:
        argv.append("--json")
    if args.frozen:
        argv.append("--frozen")
    for r in args.rules or ():
        argv.extend(["--rule", r])
    if args.root:
        argv.extend(["--root", args.root])
    return check(argv)


def cmd_memory(args) -> int:
    """Object summary of the runtime in THIS process (meaningful when
    main() is invoked programmatically inside a driver; the runtime is
    in-process, so a fresh CLI process has nothing to attach to)."""
    from ray_memory_management_tpu_torch import _worker_context, state

    if _worker_context.get_runtime() is None:
        print("no cluster is running in this process "
              "(call init() first, then rmt.scripts.cli.main(['memory']))",
              file=sys.stderr)
        return 1
    print(json.dumps(state.summarize_objects(), indent=2))
    return 0


def cmd_summary(args) -> int:
    """Task-state counts plus per-lifecycle-stage latency percentiles of
    the runtime in THIS process (the ``ray summary tasks`` analog). Like
    ``memory``, this reads the in-process runtime — call main(['summary'])
    from a driver."""
    from ray_memory_management_tpu_torch import _worker_context, state

    if _worker_context.get_runtime() is None:
        print("no cluster is running in this process "
              "(call init() first, then rmt.scripts.cli.main(['summary']))",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "tasks": state.summarize_tasks(),
        "latencies": state.summarize_task_latencies(),
    }, indent=2))
    return 0


def cmd_jobs(args) -> int:
    """Live job-plane view of the runtime in THIS process (like
    ``memory``/``summary``, reads the in-process runtime — call
    main(['jobs']) from a driver). One row per GCS job (driver + every
    thin-client connection) with its quota-ledger usage: bytes charged
    against object/device quotas, cpu slots in use vs parked, priority,
    and preemption/demotion counters."""
    from ray_memory_management_tpu_torch import _worker_context, state

    if _worker_context.get_runtime() is None:
        print("no cluster is running in this process "
              "(call init() first, then rmt.scripts.cli.main(['jobs']))",
              file=sys.stderr)
        return 1
    rows = state.list_jobs()
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0

    def _mb(n):
        return f"{(n or 0) / 1e6:8.1f}MB"

    print(f"{'job':16s} {'state':9s} {'prio':>4s} {'slots':>11s} "
          f"{'obj_bytes':>10s} {'dev_bytes':>10s} {'preempt':>7s}")
    for row in rows:
        u = row.get("usage") or {}
        q = u.get("quota") or {}
        slots = (f"{u.get('tasks_inflight', 0)}/"
                 f"{q.get('cpu_slots') or '∞'}"
                 + (f" (+{u['tasks_parked']}q)"
                    if u.get("tasks_parked") else ""))
        print(f"{row['job_id'][:16]:16s} {row.get('state', '?'):9s} "
              f"{u.get('priority', 1):>4d} {slots:>11s} "
              f"{_mb(u.get('object_bytes'))} {_mb(u.get('device_bytes'))} "
              f"{u.get('preempted', 0):>7d}")
    return 0


def cmd_trace(args) -> int:
    """Span tree + critical-path attribution for one trace of the
    runtime in THIS process (like ``summary``/``memory``, reads the
    in-process runtime — call main(['trace', ...]) from a driver). With
    no trace_id, lists the indexed trace ids newest-last."""
    from ray_memory_management_tpu_torch import _worker_context, state

    rt = _worker_context.get_runtime()
    if rt is None:
        print("no cluster is running in this process "
              "(call init() first, then rmt.scripts.cli.main(['trace']))",
              file=sys.stderr)
        return 1
    if not args.trace_id:
        with rt._lock:
            trace_ids = list(rt._traces)
        print(json.dumps({"traces": trace_ids}, indent=2))
        return 0
    data = {
        "trace": state.get_trace(args.trace_id),
        "critical_path": state.summarize_critical_path(args.trace_id),
    }
    if args.output:
        with open(args.output, "w") as f:
            json.dump(data, f, indent=2)
        print(f"trace written to {args.output}")
    else:
        print(json.dumps(data, indent=2))
    return 0


def cmd_logs(args) -> int:
    """Structured log records of the runtime in THIS process (like
    ``trace``/``summary``, reads the in-process runtime — call
    main(['logs', ...]) from a driver). ``--follow`` poll-tails the
    head store, printing new records as workers ship them — the
    driver-live-tail analog of Ray's worker-output streaming."""
    import time

    from ray_memory_management_tpu_torch import _worker_context, state
    from ray_memory_management_tpu_torch.utils import structlog

    rt = _worker_context.get_runtime()
    if rt is None:
        print("no cluster is running in this process "
              "(call init() first, then rmt.scripts.cli.main(['logs']))",
              file=sys.stderr)
        return 1

    def fetch(since_seq: int):
        recs = state.get_logs(task_id=args.task_id,
                              trace_id=args.trace_id,
                              node_id=args.node_id,
                              level=args.level,
                              limit=args.limit)
        return [r for r in recs if r.get("seq", 0) > since_seq]

    last_seq = 0
    deadline = (time.monotonic() + args.duration
                if args.duration is not None else None)
    try:
        while True:
            for rec in fetch(last_seq):
                print(structlog.format_record(rec))
                last_seq = max(last_seq, rec.get("seq", 0))
            if not args.follow:
                return 0
            if deadline is not None and time.monotonic() >= deadline:
                return 0
            time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        return 0


def cmd_profile(args) -> int:
    """Folded stack samples from the cluster profiling plane (like
    ``logs``/``trace``, reads the in-process runtime — call
    main(['profile', ...]) from a driver). ``--duration`` waits that
    long first so the continuous samplers accumulate more cluster-wide
    samples (and, with ``--hz``, additionally burst-samples THIS process
    at that rate while waiting). ``-o FILE`` writes collapsed-stack
    lines (``stack count``) ready for flamegraph.pl / Speedscope."""
    import time

    from ray_memory_management_tpu_torch import _worker_context, state
    from ray_memory_management_tpu_torch.utils import profiler

    rt = _worker_context.get_runtime()
    if rt is None:
        print("no cluster is running in this process "
              "(call init() first, then rmt.scripts.cli.main(['profile']))",
              file=sys.stderr)
        return 1
    if args.duration:
        if args.hz:
            profiler.burst(args.duration, args.hz)
        else:
            time.sleep(args.duration)
    folded = state.get_profile(node_id=args.node_id,
                               task_id=args.task_id,
                               trace_id=args.trace_id,
                               limit=args.limit, fold=True)
    lines = [f"{r['stack']} {r['count']}" for r in folded]
    if args.output:
        with open(args.output, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        print(f"{len(lines)} folded stacks written to {args.output}")
    else:
        for line in lines:
            print(line)
    return 0


def cmd_doctor(args) -> int:
    """Ranked cluster diagnosis from the health plane (like ``logs``/
    ``trace``, reads the in-process runtime — call main(['doctor'])
    from a driver): re-evaluates the SLO rule pack against the tsdb,
    runs the static probes (dead nodes, stuck leases, unsealed creates,
    degraded spill, quota-starved jobs), and prints firing alerts first
    — severity-ranked, each with its evidence window and (when
    attributable) the exemplar trace id to pivot into ``rmt trace``/
    ``rmt logs``/``rmt profile``."""
    from ray_memory_management_tpu_torch import _worker_context, state
    from ray_memory_management_tpu_torch.core import health as _health

    rt = _worker_context.get_runtime()
    if rt is None:
        print("no cluster is running in this process "
              "(call init() first, then rmt.scripts.cli.main(['doctor']))",
              file=sys.stderr)
        return 1
    engine = getattr(rt, "health", None)
    store = getattr(rt, "tsdb", None)
    if engine is None or store is None:
        print("health plane unavailable on this runtime", file=sys.stderr)
        return 1
    engine.evaluate()  # fresh pass so the diagnosis isn't one tick stale
    alerts = state.get_alerts()
    probes = _health.run_probes(rt, store)
    # rule-pack point-in-time values round out the diagnosis (a rule
    # under threshold still shows what it measured)
    rules = []
    for rule in engine.rules:
        try:
            value = engine.eval_expr(rule)
        except Exception:
            value = None
        rules.append({"rule": rule.name, "expr": rule.describe_expr(),
                      "value": value, "threshold": rule.threshold,
                      "severity": rule.severity})
    firing = [a for a in alerts if a["state"] == "firing"]
    healthy = not firing and not probes
    if args.json:
        print(json.dumps({"healthy": healthy, "alerts": alerts,
                          "probes": probes, "rules": rules}, indent=2))
        return 0 if healthy else 1

    def _fmt_val(v):
        return "n/a" if v is None else f"{v:g}"

    print("======== rmt doctor ========")
    if healthy:
        print("healthy: no firing alerts, no probe findings")
    for i, a in enumerate(firing, 1):
        print(f"{i}. [{a['severity']}] {a['rule']}: {a['expr']} = "
              f"{_fmt_val(a['value'])} (threshold {a['threshold']:g}, "
              f"held {a['for_duration_s']:g}s)")
        if a.get("description"):
            print(f"   {a['description']}")
        ev = a.get("evidence") or []
        if ev:
            pts = ", ".join(f"{v:g}" for _, v in ev)
            print(f"   evidence ({len(ev)} samples over "
                  f"{ev[-1][0] - ev[0][0]:.1f}s): {pts}")
        ex = a.get("exemplar") or {}
        if ex.get("trace_id"):
            print(f"   pivot: rmt trace {ex['trace_id']}"
                  + (f"  (task {ex['task_id']})" if ex.get("task_id")
                     else ""))
    for f in probes:
        print(f"-- [{f['severity']}] {f['probe']}: {f['summary']}")
    print("---- rule pack ----")
    for r in rules:
        print(f"   {r['rule']:20s} {r['expr']:45s} "
              f"{_fmt_val(r['value']):>12s} / {r['threshold']:g}")
    return 0 if healthy else 1


def cmd_microbenchmark(args) -> int:
    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.utils.microbenchmark import (
        run_microbenchmark,
    )

    _ephemeral_runtime()
    results = run_microbenchmark(scale=args.scale)
    for name, value in results.items():
        unit = "GB/s" if "gigabytes" in name else "ops/s"
        print(f"{name}: {value:,.1f} {unit}")
    rmt.shutdown()
    return 0


def cmd_timeline(args) -> int:
    import ray_memory_management_tpu_torch as rmt

    _ephemeral_runtime()
    path = rmt.timeline(args.output)
    print(f"trace written to {path}")
    rmt.shutdown()
    return 0


# ------------------------------------------------------------------- jobs
def cmd_job_submit(args) -> int:
    from ray_memory_management_tpu_torch.job_submission import JobSubmissionClient

    import shlex

    client = JobSubmissionClient(args.job_dir)
    entrypoint = list(args.entrypoint)
    if entrypoint and entrypoint[0] == "--":
        entrypoint = entrypoint[1:]
    if not entrypoint:
        print("error: no entrypoint command given", file=sys.stderr)
        return 2
    # shlex.join preserves each argv element's quoting through the
    # shell=True re-parse (plain ' '.join corrupts args with spaces)
    job_id = client.submit_job(
        entrypoint=shlex.join(entrypoint),
        submission_id=args.submission_id)
    print(job_id)
    if args.wait:
        for chunk in client.tail_job_logs(job_id, timeout_s=args.timeout):
            sys.stdout.write(chunk)
        status = client.get_job_status(job_id)
        print(f"\njob {job_id} finished: {status}")
        return 0 if status == "SUCCEEDED" else 1
    return 0


def cmd_job_list(args) -> int:
    from ray_memory_management_tpu_torch.job_submission import JobSubmissionClient

    for meta in JobSubmissionClient(args.job_dir).list_jobs():
        print(f"{meta['job_id']}  {meta['status']:10s}  "
              f"{meta['entrypoint']}")
    return 0


def cmd_job_status(args) -> int:
    from ray_memory_management_tpu_torch.job_submission import JobSubmissionClient

    print(JobSubmissionClient(args.job_dir).get_job_status(args.job_id))
    return 0


def cmd_job_logs(args) -> int:
    from ray_memory_management_tpu_torch.job_submission import JobSubmissionClient

    sys.stdout.write(
        JobSubmissionClient(args.job_dir).get_job_logs(args.job_id))
    return 0


def cmd_job_stop(args) -> int:
    from ray_memory_management_tpu_torch.job_submission import JobSubmissionClient

    ok = JobSubmissionClient(args.job_dir).stop_job(args.job_id)
    print("stopped" if ok else "not running")
    return 0


# --------------------------------------------------------------- workflow
def cmd_workflow_list(args) -> int:
    from ray_memory_management_tpu_torch import workflow

    for wid, status in workflow.list_all():
        print(f"{wid}  {status}")
    return 0


def cmd_workflow_status(args) -> int:
    from ray_memory_management_tpu_torch import workflow

    print(workflow.get_status(args.workflow_id))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rmt-torch",
        description="distributed runtime CLI (the PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("status", help="show cluster resources")
    s.add_argument("--num-nodes", type=int, default=1)
    s.add_argument("--address", default=None,
                   help="a running cluster's client port HOST:PORT")
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("list", help="state API rows of one kind as JSON "
                                    "('ray list' analog)")
    s.add_argument("kind", choices=("nodes", "objects", "tasks", "actors",
                                     "jobs", "workers",
                                     "placement_groups"))
    s.add_argument("--address", default=None,
                   help="a running cluster's client port HOST:PORT")
    s.add_argument("--limit", type=int, default=10000)
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser(
        "up",
        help="boot a cluster from a YAML config: a detached head serving "
             "thin clients plus one node agent per worker entry "
             "('ray up' analog)")
    s.add_argument("config", help="cluster YAML path")
    s.set_defaults(fn=cmd_up)

    s = sub.add_parser("down", help="tear a cluster down ('ray down')")
    s.add_argument("config", help="cluster YAML path or cluster name")
    s.set_defaults(fn=cmd_down)

    s = sub.add_parser(
        "exec",
        help="run a command against a running cluster: RMT_CLIENT_ADDRESS "
             "is set for the child ('ray exec'/'ray submit' analog)")
    s.add_argument("config", help="cluster YAML path or cluster name")
    s.add_argument("command", nargs=argparse.REMAINDER,
                   help="command (and args) to run")
    s.set_defaults(fn=cmd_exec)

    s = sub.add_parser(
        "agent",
        help="join this host to a head as a worker node (the reference's "
             "'ray start --address' analog; runs a node agent that tunnels "
             "workers + objects to the head over TCP)")
    s.add_argument("--address", required=True, help="head HOST:PORT")
    s.add_argument("--authkey", required=True, help="hex cluster authkey")
    s.add_argument("--num-cpus", type=int, default=4)
    s.add_argument("--num-gpus", type=int, default=0)
    s.set_defaults(fn=cmd_agent)

    s = sub.add_parser(
        "check",
        help="run the rmtcheck static-analysis suite (exit non-zero on "
             "violations)")
    s.add_argument("--json", action="store_true",
                   help="machine-readable JSON report")
    s.add_argument("--frozen", action="store_true",
                   help="fail on new wire-protocol keys instead of "
                        "auto-registering (CI mode)")
    s.add_argument("--rule", action="append", dest="rules", metavar="RULE",
                   help="run only this rule (repeatable)")
    s.add_argument("--root", default=None, help="repo root to analyze")
    s.set_defaults(fn=cmd_check)

    s = sub.add_parser("memory", help="object store summary")
    s.set_defaults(fn=cmd_memory)

    s = sub.add_parser(
        "summary",
        help="task-state counts + per-stage latency p50/p95/p99")
    s.set_defaults(fn=cmd_summary)

    s = sub.add_parser(
        "jobs",
        help="live jobs (driver + thin-client connections) with "
             "quota-ledger usage: bytes, slots, priority, preemptions")
    s.add_argument("--json", action="store_true",
                   help="machine-readable JSON rows")
    s.set_defaults(fn=cmd_jobs)

    s = sub.add_parser(
        "trace",
        help="span tree + critical-path breakdown for one trace "
             "(no trace_id: list known trace ids)")
    s.add_argument("trace_id", nargs="?", default=None)
    s.add_argument("--output", default=None,
                   help="write JSON here instead of stdout")
    s.set_defaults(fn=cmd_trace)

    s = sub.add_parser(
        "logs",
        help="query the cluster log plane (print/logging output of every "
             "worker, trace-correlated); --follow live-tails it")
    s.add_argument("--task", dest="task_id", default=None,
                   help="filter: task id (hex)")
    s.add_argument("--trace", dest="trace_id", default=None,
                   help="filter: trace id (hex)")
    s.add_argument("--node", dest="node_id", default=None,
                   help="filter: node id (hex)")
    s.add_argument("--level", default=None,
                   help="minimum severity (DEBUG/INFO/WARNING/ERROR/"
                        "CRITICAL)")
    s.add_argument("--limit", type=int, default=1000,
                   help="newest N records per poll (default 1000)")
    s.add_argument("--follow", action="store_true",
                   help="poll for new records until interrupted")
    s.add_argument("--duration", type=float, default=None,
                   help="with --follow: stop after this many seconds")
    s.add_argument("--poll-interval", type=float, default=0.5,
                   help="follow poll period in seconds (default 0.5)")
    s.set_defaults(fn=cmd_logs)

    s = sub.add_parser(
        "profile",
        help="query the cluster profiling plane (folded stack samples "
             "from every process, task/trace-correlated); -o writes "
             "flamegraph.pl-ready collapsed stacks")
    s.add_argument("--task", dest="task_id", default=None,
                   help="filter: task id (hex)")
    s.add_argument("--trace", dest="trace_id", default=None,
                   help="filter: trace id (hex)")
    s.add_argument("--node", dest="node_id", default=None,
                   help="filter: node id (hex)")
    s.add_argument("--duration", type=float, default=None,
                   help="accumulate samples for this many seconds "
                        "before querying")
    s.add_argument("--hz", type=float, default=None,
                   help="with --duration: burst-sample this process at "
                        "this rate while waiting")
    s.add_argument("--limit", type=int, default=10000,
                   help="newest N samples to merge (default 10000)")
    s.add_argument("-o", "--output", default=None,
                   help="write folded 'stack count' lines here instead "
                        "of stdout")
    s.set_defaults(fn=cmd_profile)

    s = sub.add_parser(
        "doctor",
        help="ranked cluster diagnosis: run the health rule pack + "
             "static probes and print firing alerts with evidence "
             "(exit 1 when anything fires)")
    s.add_argument("--json", action="store_true",
                   help="machine-readable JSON diagnosis")
    s.set_defaults(fn=cmd_doctor)

    s = sub.add_parser("microbenchmark",
                       help="run the core microbenchmark suite")
    s.add_argument("--scale", type=float, default=1.0)
    s.set_defaults(fn=cmd_microbenchmark)

    s = sub.add_parser("timeline", help="dump a chrome trace")
    s.add_argument("--output", default="timeline.json")
    s.set_defaults(fn=cmd_timeline)

    job = sub.add_parser("job", help="job submission")
    jsub = job.add_subparsers(dest="job_command", required=True)
    s = jsub.add_parser("submit")
    s.add_argument("--job-dir", default=None)
    s.add_argument("--submission-id", default=None)
    s.add_argument("--wait", action="store_true")
    s.add_argument("--timeout", type=float, default=3600.0)
    s.add_argument("entrypoint", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_job_submit)
    for name, fn, extra in (
        ("list", cmd_job_list, ()),
        ("status", cmd_job_status, ("job_id",)),
        ("logs", cmd_job_logs, ("job_id",)),
        ("stop", cmd_job_stop, ("job_id",)),
    ):
        s = jsub.add_parser(name)
        s.add_argument("--job-dir", default=None)
        for a in extra:
            s.add_argument(a)
        s.set_defaults(fn=fn)

    wf = sub.add_parser("workflow", help="workflow management")
    wsub = wf.add_subparsers(dest="workflow_command", required=True)
    s = wsub.add_parser("list")
    s.set_defaults(fn=cmd_workflow_list)
    s = wsub.add_parser("status")
    s.add_argument("workflow_id")
    s.set_defaults(fn=cmd_workflow_status)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
