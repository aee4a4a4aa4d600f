"""Profiling-overhead bench: CPU-burning fan-out with the plane on/off.

The profiling plane touches the hot path in three places: the per-tick
``sys._current_frames`` walk in every process (the continuous sampler),
the per-task rusage begin/end snapshots riding done replies, and the
per-flush ``drain_samples`` attach. This measures that cost the way the
logging bench does — tasks/s on a fan-out of tasks that each burn a
slice of CPU (busy stacks are the workload the sampler actually has to
walk) with ``RMT_PROFILE`` on vs off. Off disables the sampler and the
rusage snapshots in every process (workers inherit the env var), so the
delta isolates the profiling plane.

Acceptance target: overhead <= 5% tasks/s, like logging.
"""

from __future__ import annotations

import os
import time
from typing import Dict

PROFILE_DEFAULTS = dict(n_tasks=200, trials=3)


def run_profile_suite(n_tasks: int = 200, trials: int = 3) -> Dict:
    import ray_memory_management_tpu_torch as rmt
    from . import profiler

    @rmt.remote
    def burner(i):
        # enough frames + cycles that a sample tick lands on real work
        acc = 0
        for j in range(4000):
            acc += (i * j) % 97
        return acc

    def run_mode(enabled: bool) -> float:
        prev_env = os.environ.get("RMT_PROFILE")
        prev_local = profiler.is_enabled()
        os.environ["RMT_PROFILE"] = "1" if enabled else "0"
        profiler.set_enabled(enabled)
        rt = rmt.init(num_cpus=2)
        try:
            rt.add_node({"num_cpus": 2})
            # warm worker pools so no measured trial pays a spawn
            rmt.get([burner.remote(i) for i in range(8)])
            best = 0.0
            for _ in range(trials):
                t0 = time.perf_counter()
                rmt.get([burner.remote(i) for i in range(n_tasks)])
                dt = time.perf_counter() - t0
                best = max(best, n_tasks / dt)
            return best
        finally:
            rmt.shutdown()
            if prev_env is None:
                os.environ.pop("RMT_PROFILE", None)
            else:
                os.environ["RMT_PROFILE"] = prev_env
            profiler.set_enabled(prev_local)
            profiler.stop_sampler()
            profiler.clear()

    # off first: the on-run's leftover sampler state can't skew baseline
    off = run_mode(False)
    on = run_mode(True)
    overhead_pct = (off - on) / off * 100.0 if off > 0 else 0.0
    return {
        "n_tasks": n_tasks,
        "trials": trials,
        "profile_on_tasks_per_s": round(on, 1),
        "profile_off_tasks_per_s": round(off, 1),
        # negative = noise (on-run happened to be faster); the contract
        # only promises it stays under the 5% ceiling
        "profile_overhead_pct": round(overhead_pct, 2),
    }
