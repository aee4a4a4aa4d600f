"""Pod-scale control-plane benchmark.

Drives 64-256 node memberships and ~10^6 live directory rows through
the GENUINE head code paths using the simulated agent plane
(:mod:`sim_agent`): every sim node speaks the real wire protocol over
the real authenticated channels, so the head's scheduler, lease-credit
accounting, delta-heartbeat ingress, and memory-bounded directory are
measured exactly as a real pod would exercise them — minus worker
processes and the p2p transfer plane, which is what lets one host
sustain 256 memberships.

Two phases:

* **membership curve** — for each node count: register N sim agents,
  burst leaf tasks through the lease plane (tasks/s), microbench the
  directory (add/locate/remove p50/p99 us), and sample head RSS.
* **row flood** (largest point only) — sim agents assert synthetic
  rows via pong deltas until the directory holds ``rows_target`` live
  rows against a small hot cap backed by a sqlite blob surface.  The
  headline claims are (a) head RSS stays bounded (hot cap + cold
  index, NOT ~1KB/row), and (b) ingress is O(changes): churn ships
  delta pongs whose size tracks the churn rate, not the row count.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict, List

from .sim_agent import close_sim_agents, spawn_sim_agents


def _note(msg: str) -> None:
    # rmtcheck: disable=log-discipline — bench progress, stderr like
    # bench.py's own suite chatter
    print(f"    pod: {msg}", file=sys.stderr, flush=True)


def _rss_mb() -> float:
    """Current RSS of the head process (MB) — /proc is authoritative and
    cheap; ru_maxrss is a high-water mark that never comes back down
    across the curve's points."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0))
    except (OSError, ValueError, IndexError):
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _pcts(durs_us: List[float]) -> Dict[str, float]:
    durs_us = sorted(durs_us)
    n = len(durs_us)
    return {"p50": durs_us[n // 2], "p99": durs_us[min(n - 1, (n * 99) // 100)]}


def _dir_microbench(gcs, node_id: bytes, n_ops: int = 2000) -> Dict[str, float]:
    """Directory-op latency under whatever concurrent pong-delta load the
    sim plane is applying: timed add -> locate -> remove over fresh oids."""
    oids = [b"podbench" + i.to_bytes(6, "big") + os.urandom(6)
            for i in range(n_ops)]
    add_us: List[float] = []
    loc_us: List[float] = []
    for oid in oids:
        t0 = time.perf_counter()
        gcs.add_object_location(oid, node_id, size=64)
        add_us.append((time.perf_counter() - t0) * 1e6)
    for oid in oids:
        t0 = time.perf_counter()
        gcs.locate_objects([oid])
        loc_us.append((time.perf_counter() - t0) * 1e6)
    for oid in oids:
        gcs.remove_object_location(oid, node_id)
    both = add_us + loc_us
    out = _pcts(both)
    out["locate_p99"] = _pcts(loc_us)["p99"]
    return out


def run_pod_curve(node_counts=(8, 64, 128, 256), tasks_per_point=1500,
                  rows_target=1_000_000, hot_max_rows=200_000,
                  rows_per_agent_chunk=1000):
    """Returns the ``pod_curve`` suite dict (see module docstring)."""
    import ray_memory_management_tpu_torch as rmt
    from ..config import Config
    from ..core import metrics_defs as mdefs

    counts = list(node_counts)
    tasks_pts: Dict[str, float] = {}
    dir_p50: Dict[str, float] = {}
    dir_p99: Dict[str, float] = {}
    rss_pts: Dict[str, float] = {}
    rows_detail: Dict[str, float] = {}
    tmp = tempfile.mkdtemp(prefix="rmt-podbench-")
    for n in counts:
        # every curve point runs the SAME config (in-memory tables, no
        # WAL) so tasks/s compares membership size and nothing else
        t_pt = time.perf_counter()
        rt = rmt.init(num_cpus=2, object_store_memory=1 << 28)
        agents = []
        try:
            agents = spawn_sim_agents(rt, n, num_cpus=2)
            _note(f"{n}n registered in "
                  f"{time.perf_counter() - t_pt:.1f}s")

            @rmt.remote(max_retries=0)
            def noop():
                return b"ok"

            # warm: one wave boots the lease plane + fn_blob caches
            rmt.get([noop.remote() for _ in range(2 * n)], timeout=300)
            t0 = time.perf_counter()
            rmt.get([noop.remote() for _ in range(tasks_per_point)],
                    timeout=600)
            tasks_pts[str(n)] = tasks_per_point / (time.perf_counter() - t0)

            mb = _dir_microbench(rt.gcs, agents[0].node_id)
            dir_p50[str(n)] = mb["p50"]
            dir_p99[str(n)] = mb["p99"]
            rss_pts[str(n)] = _rss_mb()
            _note(f"{n}n tasks {tasks_pts[str(n)]:.0f}/s, point done in "
                  f"{time.perf_counter() - t_pt:.1f}s")
        finally:
            close_sim_agents(agents)
            rmt.shutdown()
            _note(f"{n}n torn down at {time.perf_counter() - t_pt:.1f}s")
    if rows_target > 0:
        # row flood in a dedicated runtime at the largest membership:
        # small hot cap + sqlite blob surface so cold batches leave RAM
        cfg = Config(
            gcs_storage_path=os.path.join(tmp, "pod-rows.db"),
            gcs_directory_hot_max_rows=hot_max_rows,
        )
        t_fl = time.perf_counter()
        rt = rmt.init(num_cpus=2, object_store_memory=1 << 28, _config=cfg)
        agents = []
        try:
            agents = spawn_sim_agents(rt, counts[-1], num_cpus=2)
            _note(f"flood fleet up in {time.perf_counter() - t_fl:.1f}s")
            rows_detail = _row_flood(rt, agents, rows_target,
                                     rows_per_agent_chunk, mdefs)
            _note(f"flood converged {rows_detail['total']:.0f} rows at "
                  f"{time.perf_counter() - t_fl:.1f}s")
            # directory-op latency with the table at full row count and
            # the hot cap engaged (faults on the locate path)
            rows_detail["dir_p99_us_at_rows"] = \
                _dir_microbench(rt.gcs, agents[0].node_id)["p99"]
        finally:
            close_sim_agents(agents)
            rmt.shutdown()
    first, lastc = str(counts[0]), str(counts[-1])
    return {
        "nodes": counts,
        "tasks_per_s": tasks_pts,
        "dir_p50_us": dir_p50,
        "dir_p99_us": dir_p99,
        "head_rss_mb": rss_pts,
        "tasks_scaling_first_to_last":
            tasks_pts[lastc] / tasks_pts[first] if tasks_pts.get(first)
            else 0.0,
        "rows": rows_detail,
    }


def _row_flood(rt, agents, rows_target, chunk, mdefs) -> Dict[str, float]:
    """Assert rows_target synthetic rows across the sim fleet via pong
    deltas, then churn to show steady-state ingress is O(changes)."""
    per_agent = rows_target // len(agents) + 1
    added = 0
    while added < per_agent:
        step = min(chunk, per_agent - added)
        for a in agents:
            a.add_rows(step)
        added += step
        # pace the flood to the heartbeat so pong frames stay reasonable
        time.sleep(0.25)
    deadline = time.monotonic() + 180
    stats = rt.gcs.directory_stats()
    while time.monotonic() < deadline:
        stats = rt.gcs.directory_stats()
        if stats["hot"] + stats["cold"] >= rows_target:
            break
        time.sleep(0.5)
    rss_at_rows = _rss_mb()
    # steady-state churn: 1% of rows replaced; the delta plane must ship
    # ~2% of rows per cycle, NOT full state
    shipped_before = sum(a.rows_shipped for a in agents)
    for a in agents:
        a.churn_rows(max(1, a.row_count() // 100))
    time.sleep(3 * 0.5 + 0.5)  # a few heartbeat cycles
    shipped_churn = sum(a.rows_shipped for a in agents) - shipped_before
    out = {
        "target": float(rows_target),
        "total": float(stats["hot"] + stats["cold"]),
        "hot": float(stats["hot"]),
        "cold": float(stats["cold"]),
        "rss_mb_at_rows": rss_at_rows,
        "faults": float(mdefs.gcs_directory_faults().get()),
        "spills": float(mdefs.gcs_directory_spills().get()),
        "resyncs": float(mdefs.heartbeat_resyncs().get()),
        "full_pongs": float(sum(a.pongs_full for a in agents)),
        "delta_pongs": float(sum(a.pongs_delta for a in agents)),
        "churn_rows_shipped": float(shipped_churn),
    }
    return out
