"""Job-plane bench: multi-tenant isolation overhead, sweep latency,
driver churn.

Three measurements, matching the multi-tenant job plane's acceptance
criteria:

  - **Isolation overhead** — tasks/s of one batch submitted by the root
    job alone (single-ledger fast path: no admission, no fair ordering)
    vs the same batch split across 4 quota'd jobs (per-job attribution,
    byte/slot admission, stride fair ordering in ``_pump``). The gap is
    the whole cost of multi-tenancy on the submit hot path.
  - **Sweep latency vs object count** — a client job puts K objects and
    dies; how long does :meth:`Runtime.sweep_job` take to cancel, free,
    and retire everything, and does the directory really end at zero
    rows for the job? (K = 100 and 1000 — the sweep walks only tagged
    rows, so it should scale with the JOB's footprint, not the
    cluster's.)
  - **Driver churn soak** — N driver threads cycle register → submit →
    (get results + clean sweep | abrupt mid-flight sweep, the SIGKILL
    analog) for several rounds. Reports aggregate completed tasks/s and
    the leak probes: directory rows still tagged to any dead job and
    device-tier bytes pinned above the pre-churn baseline (both must be
    zero).

Run directly:
``python -m ray_memory_management_tpu_torch.utils.job_plane_bench``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List


def _noop_fn():
    import ray_memory_management_tpu_torch as rmt

    @rmt.remote
    def _bench_noop(i):
        return i

    return _bench_noop


def _submit_as(rt, fn, job, i) -> List[bytes]:
    """Submit one task attributed to ``job`` (None = root), the way the
    cluster server stamps thin-client payloads."""
    from .. import api as _api

    payload = dict(fn._template())
    enc_args, enc_kwargs = _api._encode_call((i,), {})
    payload["args"] = enc_args
    payload["kwargs"] = enc_kwargs
    if job is not None:
        payload["job_id"] = job
    return rt.submit_task(payload)


def _drain(rt, rids, timeout: float = 120.0) -> int:
    done = 0
    for rid in rids:
        try:
            rt.get_objects([rid], timeout=timeout)
            done += 1
        except Exception:  # noqa: BLE001 — swept jobs fail their tasks
            pass
    return done


def _isolation_suite(rt, n_tasks: int) -> Dict:
    fn = _noop_fn()
    # warm: pool spin-up and fn-blob shipping are not the measurement
    _drain(rt, [r for i in range(8) for r in _submit_as(rt, fn, None, i)])

    t0 = time.perf_counter()
    rids = [r for i in range(n_tasks) for r in _submit_as(rt, fn, None, i)]
    _drain(rt, rids)
    single_s = time.perf_counter() - t0

    jobs = [os.urandom(16) for _ in range(4)]
    for j in jobs:
        rt.register_client_job(j, {"type": "bench"},
                               quota={"priority": 1})
    t0 = time.perf_counter()
    rids = [r for i in range(n_tasks)
            for r in _submit_as(rt, fn, jobs[i % 4], i)]
    done = _drain(rt, rids)
    multi_s = time.perf_counter() - t0
    for j in jobs:
        rt.sweep_job(j, trigger="disconnect")

    single_rate = n_tasks / single_s if single_s > 0 else 0.0
    multi_rate = done / multi_s if multi_s > 0 else 0.0
    overhead = ((single_rate / multi_rate - 1.0) * 100.0
                if multi_rate > 0 else float("inf"))
    return {
        "single_job_tasks_per_s": round(single_rate, 1),
        "multi_job_tasks_per_s": round(multi_rate, 1),
        "isolation_overhead_pct": round(overhead, 1),
    }


def _sweep_suite(rt, counts=(100, 1000)) -> Dict:
    out: Dict = {"sweep_leaked_rows": 0}
    for k in counts:
        job = os.urandom(16)
        rt.register_client_job(job, {"type": "bench"})
        for i in range(k):
            rt.put_object(b"x" * 256, job_id=job)
        t0 = time.perf_counter()
        ok = rt.sweep_job(job, trigger="disconnect")
        out[f"sweep_ms_{k}"] = round(
            (time.perf_counter() - t0) * 1e3, 2)
        leaked = rt.gcs.count_job_rows(job)
        out["sweep_leaked_rows"] += leaked if ok else leaked or 1
    return out


def _churn_suite(rt, drivers: int = 4, rounds: int = 3,
                 tasks_per_round: int = 20) -> Dict:
    fn = _noop_fn()
    _drain(rt, [r for i in range(4) for r in _submit_as(rt, fn, None, i)])
    baseline_dev = rt.device_store.total_bytes()
    dead_jobs: List[bytes] = []
    dead_lock = threading.Lock()
    completed = [0] * drivers
    kills = [0] * drivers

    def driver(ix: int) -> None:
        for rnd in range(rounds):
            job = os.urandom(16)
            rt.register_client_job(job, {"type": "bench-churn"},
                                   quota={"priority": 1 + ix % 2})
            rids = [r for i in range(tasks_per_round)
                    for r in _submit_as(rt, fn, job, i)]
            rt.put_object(b"y" * 1024, job_id=job)
            if (ix + rnd) % 3 == 2:
                # the SIGKILL analog: no goodbye, tasks still in flight
                # — the sweep must cancel and reclaim them all
                rt.sweep_job(job, trigger="watchdog")
                kills[ix] += 1
            else:
                completed[ix] += _drain(rt, rids)
                rt.sweep_job(job, trigger="disconnect")
            with dead_lock:
                dead_jobs.append(job)

    threads = [threading.Thread(target=driver, args=(i,),
                                name=f"bench-driver-{i}")
               for i in range(drivers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    leaked_rows = sum(rt.gcs.count_job_rows(j) for j in dead_jobs)
    live = rt.job_usage()
    ghost_ledgers = sum(1 for j in dead_jobs if j.hex() in live)
    leaked_dev = max(0, rt.device_store.total_bytes() - baseline_dev)
    return {
        "churn_tasks_per_s": round(sum(completed) / wall, 1)
        if wall > 0 else 0.0,
        "churn_jobs": len(dead_jobs),
        "churn_kills": sum(kills),
        "churn_leaked_rows": leaked_rows + ghost_ledgers,
        "churn_leaked_device_bytes": leaked_dev,
    }


def run_job_plane_suite(mini: bool = False) -> Dict:
    import ray_memory_management_tpu_torch as rmt
    from .. import _worker_context

    owns = _worker_context.get_runtime() is None
    if owns:
        rmt.init(num_cpus=4)
    rt = _worker_context.get_runtime()
    try:
        out: Dict = {"mini": bool(mini)}
        out.update(_isolation_suite(rt, n_tasks=40 if mini else 160))
        out.update(_sweep_suite(rt, counts=(100,) if mini
                                else (100, 1000)))
        if mini:
            out.setdefault("sweep_ms_1000", out.get("sweep_ms_100", 0.0))
        out.update(_churn_suite(
            rt, drivers=4, rounds=2 if mini else 3,
            tasks_per_round=8 if mini else 20))
        return out
    finally:
        if owns:
            rmt.shutdown()


if __name__ == "__main__":
    import json

    print(json.dumps(run_job_plane_suite(mini=True), indent=1))
