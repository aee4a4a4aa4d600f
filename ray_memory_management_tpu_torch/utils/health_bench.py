"""Health-plane overhead bench: task fan-out with ``RMT_HEALTH`` on/off
plus a pod-scale store-footprint probe.

The health plane rides the heartbeat tick (registry sample into the
tsdb rings + rule-pack evaluation), so its cost to the task hot path
should be near zero — but "should" is what benches are for. Part one
mirrors utils/logging_bench.py: tasks/s on a plain fan-out with the
plane enabled vs disabled; the delta is the headline
``health.overhead_pct`` (ceiling: 5%).

Part two answers the boundedness question head-on: ingest a synthetic
pod-scale workload (``sim_nodes`` node-tagged series, rings filled past
capacity) into a standalone TSDB with ``n_rules`` rules evaluating over
it, and report the head RSS delta (MB) plus the per-tick rule-pack
evaluation time (ms). Fixed rings mean the RSS delta is a one-time
allocation, not a leak slope.
"""

from __future__ import annotations

import os
import time
from typing import Dict

HEALTH_DEFAULTS = dict(n_tasks=200, trials=3, sim_nodes=256, n_rules=10)


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return 0


def run_health_suite(n_tasks: int = 200, trials: int = 3,
                     sim_nodes: int = 256, n_rules: int = 10) -> Dict:
    import ray_memory_management_tpu_torch as rmt
    from ..core.health import HealthEngine, Rule
    from . import tsdb as _tsdb

    @rmt.remote
    def unit(i):
        return i

    def run_mode(enabled: bool) -> float:
        prev_env = os.environ.get("RMT_HEALTH")
        prev_local = _tsdb.is_enabled()
        os.environ["RMT_HEALTH"] = "1" if enabled else "0"
        _tsdb.set_enabled(enabled)
        rt = rmt.init(num_cpus=2)
        try:
            rt.add_node({"num_cpus": 2})
            # warm worker pools so no measured trial pays a spawn
            rmt.get([unit.remote(i) for i in range(8)])
            best = 0.0
            for _ in range(trials):
                t0 = time.perf_counter()
                rmt.get([unit.remote(i) for i in range(n_tasks)])
                dt = time.perf_counter() - t0
                best = max(best, n_tasks / dt)
            return best
        finally:
            rmt.shutdown()
            if prev_env is None:
                os.environ.pop("RMT_HEALTH", None)
            else:
                os.environ["RMT_HEALTH"] = prev_env
            _tsdb.set_enabled(prev_local)

    # off first: the on-run's leftover rings can't skew the baseline
    off = run_mode(False)
    on = run_mode(True)
    overhead_pct = (off - on) / off * 100.0 if off > 0 else 0.0

    # -- pod-scale footprint: sim_nodes tagged series, rings run full ----------
    rss0 = _rss_bytes()
    store = _tsdb.TSDB(max_series_per_name=sim_nodes + 1)
    base = time.time()
    tick_s = 0.5
    # fill the raw rings past capacity (default 600 points) so the
    # measured RSS is the steady-state ceiling, not a partial fill
    ticks = store._raw_points + 50
    snaps = {}
    for i in range(sim_nodes):
        key = (("node_id", f"sim{i:03d}"),)
        snaps[key] = 0.0
    for t in range(ticks):
        for key in snaps:
            snaps[key] += 1.0
        store.ingest("rmt_bench_health_total", "counter", dict(snaps),
                     base + t * tick_s)
    rss_delta_mb = max(0, _rss_bytes() - rss0) / (1024.0 * 1024.0)

    rules = [
        Rule(f"bench-rule-{i:02d}",
             ("rate", "rmt_bench_health_total", 30.0),
             threshold=1e18, for_duration_s=60.0, severity="WARNING",
             description="health bench synthetic rule")
        for i in range(n_rules)
    ]
    engine = HealthEngine(store, rules=rules)
    now = base + ticks * tick_s
    evals = 5
    t0 = time.perf_counter()
    for _ in range(evals):
        engine.evaluate(now=now)
    rule_eval_ms = (time.perf_counter() - t0) / evals * 1000.0

    return {
        "n_tasks": n_tasks,
        "trials": trials,
        "sim_nodes": sim_nodes,
        "n_rules": n_rules,
        "health_on_tasks_per_s": round(on, 1),
        "health_off_tasks_per_s": round(off, 1),
        # negative = noise (on-run happened to be faster); the contract
        # only promises it stays under the 5% ceiling
        "health_overhead_pct": round(overhead_pct, 2),
        "store_rss_delta_mb": round(rss_delta_mb, 2),
        "store_points": store.stats()["points"],
        "rule_eval_ms": round(rule_eval_ms, 3),
    }
