"""Core-runtime microbenchmark suite.

Mirrors the reference's ``ray microbenchmark`` (release/microbenchmark/
run_microbenchmark.py → python/ray/_private/ray_perf.py; CLI scripts.py:1744):
the same metric names as release/release_logs/2.0.0/microbenchmark.json so
results compare one-to-one against BASELINE.md.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

# reference numbers from release/release_logs/2.0.0/microbenchmark.json
# (duplicated in BASELINE.md)
BASELINE = {
    "single_client_tasks_sync": 1424.0,
    "single_client_tasks_async": 13150.0,
    "1_1_actor_calls_sync": 2490.0,
    "1_1_actor_calls_async": 6146.0,
    "1_1_actor_calls_concurrent": 4825.0,
    "1_1_async_actor_calls_async": 3322.0,
    "1_n_actor_calls_async": 11532.0,
    "single_client_put_calls": 5390.0,
    "single_client_get_calls": 5403.0,
    "single_client_put_gigabytes": 19.67,
    "single_client_get_object_containing_10k_refs": 13.3,
    "placement_group_create/removal": 1243.0,
    "client__put_gigabytes": 0.044,
    "client__1_1_actor_calls_sync": 536.0,
}


def _timeit(fn: Callable[[int], None], n: int, warmup: int = 1,
            trials: int = 3, warmup_n: int = 0) -> "_Row":
    """Run ``fn(n)`` ``trials`` times after a warmup; report the MEDIAN
    rate with min/max dispersion. Single-trial numbers made every perf
    regression unfalsifiable — a swing could always be noise; the median
    of three with recorded spread is cheap and decidable. ``warmup_n``
    overrides the warmup size (default n//10): burst-shaped rows need a
    FULL-SCALE untimed pass to reach steady state (worker pool at final
    size, pipelining depth built up) — the same discipline as the scale
    bench's untimed actor burst."""
    for _ in range(warmup):
        fn(max(1, warmup_n or n // 10))
    rates = []
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        fn(n)
        dt = time.perf_counter() - t0
        rates.append(n / dt)
    rates.sort()
    return _Row(rates[len(rates) // 2], rates[0], rates[-1], len(rates))


class _Row:
    """A measured rate with dispersion. Behaves as its median (float
    arithmetic, formatting) so existing consumers keep working."""

    __slots__ = ("median", "min", "max", "trials")

    def __init__(self, median: float, lo: float, hi: float, trials: int):
        self.median = median
        self.min = lo
        self.max = hi
        self.trials = trials

    def scaled(self, k: float) -> "_Row":
        return _Row(self.median * k, self.min * k, self.max * k,
                    self.trials)

    def stats(self) -> Dict[str, float]:
        return {"median": round(self.median, 4), "min": round(self.min, 4),
                "max": round(self.max, 4), "trials": self.trials}

    def __float__(self) -> float:
        return self.median


def run_microbenchmark(scale: float = 1.0,
                       select: Optional[list] = None,
                       collect_stats: Optional[Dict] = None
                       ) -> Dict[str, float]:
    """Run the suite against the current runtime; returns {metric: ops/s}
    (or GB/s for put_gigabytes) — medians of 3 trials. Pass
    ``collect_stats`` (a dict) to also receive per-metric
    median/min/max/trials dispersion."""
    import ray_memory_management_tpu_torch as rmt

    results: Dict[str, float] = {}

    def want(name):
        return select is None or name in select

    @rmt.remote(max_retries=0)
    def small_task(x=None):
        return b"ok"

    @rmt.remote
    class Sink:
        def ping(self, x=None):
            return b"ok"

        async def aping(self, x=None):
            return b"ok"

    # warm the worker pool so cold starts don't pollute throughput
    rmt.get([small_task.remote() for _ in range(4)], timeout=120)

    if want("single_client_tasks_sync"):
        def tasks_sync(n):
            for _ in range(n):
                rmt.get(small_task.remote(), timeout=60)

        results["single_client_tasks_sync"] = _timeit(tasks_sync, int(300 * scale))

    if want("single_client_tasks_async"):
        def tasks_async(n):
            rmt.get([small_task.remote() for _ in range(n)], timeout=300)

        # 5 trials: this row's inter-trial spread on the 1-core host is
        # the widest in the suite (±20%); the median of five is the same
        # honest statistic with half the run-to-run bounce
        results["single_client_tasks_async"] = _timeit(
            tasks_async, int(3000 * scale), warmup_n=int(3000 * scale),
            trials=5)

    if want("1_1_actor_calls_sync") or want("1_1_actor_calls_async"):
        actor = Sink.remote()
        rmt.get(actor.ping.remote(), timeout=120)

    if want("1_1_actor_calls_sync"):
        def actor_sync(n):
            for _ in range(n):
                rmt.get(actor.ping.remote(), timeout=60)

        results["1_1_actor_calls_sync"] = _timeit(actor_sync, int(300 * scale))

    if want("1_1_actor_calls_async"):
        def actor_async(n):
            rmt.get([actor.ping.remote() for _ in range(n)], timeout=300)

        results["1_1_actor_calls_async"] = _timeit(actor_async, int(3000 * scale))

    if want("1_1_actor_calls_concurrent"):
        conc = Sink.options(max_concurrency=4).remote()
        rmt.get(conc.ping.remote(), timeout=120)

        def actor_concurrent(n):
            rmt.get([conc.ping.remote() for _ in range(n)], timeout=300)

        results["1_1_actor_calls_concurrent"] = _timeit(
            actor_concurrent, int(3000 * scale))

    if want("1_1_async_actor_calls_async"):
        aactor = Sink.remote()
        rmt.get(aactor.aping.remote(), timeout=120)

        def async_actor(n):
            rmt.get([aactor.aping.remote() for _ in range(n)], timeout=300)

        results["1_1_async_actor_calls_async"] = _timeit(
            async_actor, int(2000 * scale))

    if want("1_n_actor_calls_async"):
        n_actors = 4
        actors = [Sink.remote() for _ in range(n_actors)]
        rmt.get([a.ping.remote() for a in actors], timeout=120)

        def one_n(n):
            refs = []
            per = n // n_actors
            for a in actors:
                refs.extend(a.ping.remote() for _ in range(per))
            rmt.get(refs, timeout=300)

        results["1_n_actor_calls_async"] = _timeit(one_n, int(3000 * scale))

    if want("single_client_put_calls"):
        arr = np.ones(50_000, np.float32)  # 200KB -> shared-memory store

        def puts(n):
            for _ in range(n):
                rmt.put(arr)

        results["single_client_put_calls"] = _timeit(puts, int(1000 * scale))

    if want("single_client_get_calls"):
        ref = rmt.put(np.ones(50_000, np.float32))

        def gets(n):
            for _ in range(n):
                rmt.get(ref)

        results["single_client_get_calls"] = _timeit(gets, int(1000 * scale))

    if want("single_client_put_gigabytes"):
        chunk = np.ones(16 * 1024 * 1024 // 4, np.float32)  # 16 MB
        total_gb = 0.5 * scale
        n_chunks = max(1, int(total_gb * 1024 / 16))

        def put_gb(n):
            # free each ref immediately: measures store write bandwidth, not
            # capacity-pressure spilling
            for _ in range(n):
                r = rmt.put(chunk)
                del r

        chunks_per_s = _timeit(put_gb, n_chunks)
        results["single_client_put_gigabytes"] = chunks_per_s.scaled(
            16 / 1024)

    if want("single_client_get_object_containing_10k_refs"):
        inner = [rmt.put(i) for i in range(10_000)]
        wrapper = rmt.put(inner)

        def get_refs(n):
            for _ in range(n):
                got = rmt.get(wrapper)
                assert len(got) == 10_000

        results["single_client_get_object_containing_10k_refs"] = _timeit(
            get_refs, max(3, int(10 * scale)))
        del inner, wrapper

    if want("placement_group_create/removal"):
        from ..core.placement_group import (
            placement_group, remove_placement_group,
        )

        def pgs(n):
            for _ in range(n):
                pg = placement_group([{"CPU": 0.01}], strategy="PACK")
                pg.wait(5)
                remove_placement_group(pg)

        results["placement_group_create/removal"] = _timeit(pgs, int(300 * scale))

    if want("client__put_gigabytes") or want("client__1_1_actor_calls_sync"):
        # thin-client rows: a ClientBackend drives the cluster over the
        # authenticated TCP channel (the reference's ray-client gRPC proxy)
        from .. import _worker_context
        from ..client import ClientBackend
        from ..client.server import ClusterServer

        server = ClusterServer(port=0)
        cb = ClientBackend(server.address[0], server.address[1])
        try:
            if want("client__put_gigabytes"):
                blob = np.ones(4 * 1024 * 1024 // 4, np.float32)  # 4 MB

                def client_puts(n):
                    for _ in range(n):
                        cb.put_object(blob)

                per_s = _timeit(client_puts, max(4, int(32 * scale)))
                results["client__put_gigabytes"] = per_s.scaled(4 / 1024)

            if want("client__1_1_actor_calls_sync"):
                actor = Sink.remote()
                rmt.get(actor.ping.remote(), timeout=120)
                actor_id = actor._actor_id

                def client_actor_sync(n):
                    for _ in range(n):
                        oids = cb.submit_actor_task({
                            "actor_id": actor_id, "method": "ping",
                            "args": [], "kwargs": {}, "num_returns": 1})
                        cb.get_objects(oids, timeout=60)

                results["client__1_1_actor_calls_sync"] = _timeit(
                    client_actor_sync, int(300 * scale))
        finally:
            cb.close()
            server.close()

    if collect_stats is not None:
        for k, v in results.items():
            collect_stats[k] = (v.stats() if isinstance(v, _Row)
                                else {"median": v})
    return {k: float(v) for k, v in results.items()}


def vs_baseline(results: Dict[str, float]) -> Dict[str, float]:
    return {
        k: results[k] / BASELINE[k] for k in results if k in BASELINE
    }


def geomean(ratios: Dict[str, float]) -> float:
    vals = np.array(list(ratios.values()), dtype=np.float64)
    return float(np.exp(np.log(vals).mean())) if len(vals) else 0.0
