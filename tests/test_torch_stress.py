"""Runtime stress tests: metadata GC under churn and multithreaded chaos.

The PyTorch port's copy of ``tests/test_stress.py``: the same two cases
against ``ray_memory_management_tpu_torch``; in the chaos case half of
``big``'s returns (odd ``i``) are CPU ``torch.Tensor``s, so the port's
tensor serialization runs under the chaos too.

The Python tier of the race-detection story (the C++ store runs under
TSAN/ASAN in tests/test_torch_native_stress.py; the reference sanitizes its
whole C++ runtime, .bazelrc:92-106): the driver runtime is dozens of
cooperating threads (router, sender pool, request pool, heartbeat,
accept), so these tests drive it concurrently from many client threads
and assert the invariants that racing would break — no deadlock, no lost
object, no negative refcount, bounded task metadata.
"""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

import ray_memory_management_tpu_torch as rmt
from _port_fixtures import one_intra_op_thread  # noqa: F401


def test_task_metadata_bounded_under_churn():
    """Distributed task-metadata GC at volume: across 50k task
    completions the runtime's task table must stay bounded (records prune
    once their returns are consumed and lineage no longer pins them —
    runtime._try_prune_record_locked); an unbounded table is exactly the
    head-memory leak the reference's _peak_memory tracking guards
    against."""
    rt = rmt.init(num_cpus=4)
    try:
        @rmt.remote(max_retries=0)
        def tiny(i):
            return i

        peak_tasks = 0
        peak_futures = 0
        total = 50_000
        batch = 2_000
        for start in range(0, total, batch):
            refs = [tiny.remote(i) for i in range(start, start + batch)]
            out = rmt.get(refs, timeout=300)
            assert out[0] == start and out[-1] == start + batch - 1
            del refs, out
            peak_tasks = max(peak_tasks, len(rt.tasks))
            peak_futures = max(peak_futures, len(rt.futures))
        # bound: a few in-flight batches worth, NOT O(total). The exact
        # constant is generous — the failure mode this guards against is
        # linear growth to ~50k entries.
        assert peak_tasks < 3 * batch, peak_tasks
        assert peak_futures < 3 * batch, peak_futures
    finally:
        rmt.shutdown()


class _Chaos:
    """Shared state for the chaos threads: first failure wins."""

    def __init__(self):
        self.stop = threading.Event()
        self.errors = []
        self.mu = threading.Lock()
        self.ops = 0

    def fail(self, err: str) -> None:
        with self.mu:
            self.errors.append(err)
        self.stop.set()

    def tick(self) -> None:
        with self.mu:
            self.ops += 1


def test_multithreaded_driver_chaos():
    """8+ driver threads run submit/get/put/free/actor-kill/node-churn
    concurrently for 60s: every get must return the right value (no lost
    objects), the run must not deadlock (bounded wall time enforced by
    joins), and at the end no refcount may be negative and task metadata
    must have pruned."""
    duration_s = float(os.environ.get("RMT_CHAOS_SECONDS", "60"))
    rt = rmt.init(num_cpus=4, num_nodes=2)
    chaos = _Chaos()
    try:
        @rmt.remote(max_retries=2)
        def add(a, b):
            return a + b

        @rmt.remote(max_retries=2)
        def big(i):
            # 800KB: store object; odd i a CPU tensor
            if i % 2:
                return torch.full((100_000,), i, dtype=torch.int64)
            return np.full(100_000, i, np.int64)

        @rmt.remote(num_cpus=0, max_restarts=0)
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        def tasks_loop(seed):
            rng = np.random.default_rng(seed)
            while not chaos.stop.is_set():
                try:
                    n = int(rng.integers(4, 16))
                    vals = [int(rng.integers(0, 1000)) for _ in range(n)]
                    refs = [add.remote(v, seed) for v in vals]
                    out = rmt.get(refs, timeout=120)
                    if out != [v + seed for v in vals]:
                        chaos.fail(f"wrong task results: {out[:4]}...")
                    chaos.tick()
                except Exception as e:  # noqa: BLE001
                    chaos.fail(f"tasks_loop: {e!r}")

        def objects_loop(seed):
            rng = np.random.default_rng(seed)
            while not chaos.stop.is_set():
                try:
                    i = int(rng.integers(0, 100))
                    ref = big.remote(i)
                    if rng.random() < 0.3:
                        del ref  # free a possibly-unfinished task's return
                        chaos.tick()
                        continue
                    arr = rmt.get(ref, timeout=120)
                    kind = torch.Tensor if i % 2 else np.ndarray
                    if (not isinstance(arr, kind) or arr[0] != i
                            or arr[-1] != i or arr.shape != (100_000,)):
                        chaos.fail(f"lost/corrupt object: {type(arr)} "
                                   f"{arr[:2]}")
                    del ref, arr
                    chaos.tick()
                except Exception as e:  # noqa: BLE001
                    chaos.fail(f"objects_loop: {e!r}")

        def put_loop(seed):
            rng = np.random.default_rng(seed)
            while not chaos.stop.is_set():
                try:
                    v = int(rng.integers(0, 1 << 30))
                    ref = rmt.put((v, bytes(int(rng.integers(1, 2000)))))
                    got = rmt.get(ref, timeout=60)
                    if got[0] != v:
                        chaos.fail(f"put/get mismatch: {got[0]} != {v}")
                    del ref
                    chaos.tick()
                except Exception as e:  # noqa: BLE001
                    chaos.fail(f"put_loop: {e!r}")

        def actor_loop(seed):
            from ray_memory_management_tpu_torch.exceptions import (
                ActorDiedError)

            rng = np.random.default_rng(seed)
            while not chaos.stop.is_set():
                try:
                    c = Counter.remote()
                    k = int(rng.integers(1, 4))
                    out = rmt.get([c.inc.remote() for _ in range(k)],
                                  timeout=120)
                    if out != list(range(1, k + 1)):
                        chaos.fail(f"actor ordering broke: {out}")
                    rmt.kill(c)
                    chaos.tick()
                except ActorDiedError:
                    # legitimate: the churn thread removed the node this
                    # max_restarts=0 actor landed on — the invariant under
                    # test is "correct results or a clean death error",
                    # never a hang or a wrong answer
                    chaos.tick()
                except Exception as e:  # noqa: BLE001
                    chaos.fail(f"actor_loop: {e!r}")

        def node_churn_loop():
            while not chaos.stop.is_set():
                nid = None
                try:
                    time.sleep(3.0)
                    nid = rt.add_node({"num_cpus": 2})
                    time.sleep(3.0)
                    chaos.tick()
                except Exception as e:  # noqa: BLE001
                    chaos.fail(f"node_churn add: {e!r}")
                finally:
                    if nid is not None:
                        try:
                            rt.remove_node(nid)
                        except Exception as e:  # noqa: BLE001
                            chaos.fail(f"node_churn remove: {e!r}")

        threads = (
            [threading.Thread(target=tasks_loop, args=(s,), daemon=True)
             for s in range(3)]
            + [threading.Thread(target=objects_loop, args=(10 + s,),
                                daemon=True) for s in range(2)]
            + [threading.Thread(target=put_loop, args=(20,), daemon=True)]
            + [threading.Thread(target=actor_loop, args=(30,), daemon=True),
               threading.Thread(target=actor_loop, args=(31,), daemon=True)]
            + [threading.Thread(target=node_churn_loop, daemon=True)]
        )
        for t in threads:
            t.start()
        chaos.stop.wait(duration_s)
        chaos.stop.set()
        deadline = time.monotonic() + 180
        for t in threads:
            t.join(max(1.0, deadline - time.monotonic()))
        stuck = [t.name for t in threads if t.is_alive()]
        assert not stuck, f"threads wedged (deadlock?): {stuck}"
        assert not chaos.errors, chaos.errors[:3]
        assert chaos.ops > 50, f"chaos barely ran: {chaos.ops} ops"

        # invariant sweep after the storm
        with rt._lock:
            negative = {k.hex()[:8]: v for k, v in rt.local_refs.items()
                        if v < 0}
        assert not negative, f"negative refcounts: {negative}"
        # task table pruned back to O(in-flight), not O(everything ever)
        time.sleep(1.0)
        assert len(rt.tasks) < 5_000, len(rt.tasks)
    finally:
        rmt.shutdown()


def test_actor_calls_keep_order_across_alive_transition():
    """The chaos case's ordering fault, made deterministic: a call
    submitted while the ALIVE transition is still dispatching the calls
    queued before it must run after them. The actor's ``__init__`` keeps
    it PENDING while the first call is submitted; the second is submitted
    from another thread while the first is on its way out of the queue."""
    rt = rmt.init(num_cpus=2)
    try:
        @rmt.remote(num_cpus=0)
        class Counter:
            def __init__(self):
                time.sleep(1.0)
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        dispatch = rt._dispatch_actor_task
        later = []

        def racing_dispatch(info, spec):
            if (spec.method == "inc" and spec.seq == 0 and not later
                    and threading.current_thread()
                    is not threading.main_thread()):
                t = threading.Thread(
                    target=lambda: later.append(c.inc.remote()))
                t.start()
                t.join(30)
                assert not t.is_alive()
            return dispatch(info, spec)

        rt._dispatch_actor_task = racing_dispatch
        c = Counter.remote()
        first = c.inc.remote()
        assert rmt.get(first, timeout=60) == 1
        assert len(later) == 1
        assert rmt.get(later[0], timeout=60) == 2
    finally:
        rmt.shutdown()


def test_stolen_tasks_never_requeue_on_a_dead_node():
    """The chaos case's lost tasks: a worker's 'stolen' reply that lands
    after its node died must not put the tasks back on that node's
    queue, which its death handler drained once and nobody reads again;
    ``return_stolen`` hands them back unqueued for placement elsewhere."""
    rt = rmt.init(num_cpus=1)
    try:
        nid = rt.add_node({"num_cpus": 1})
        rt.remove_node(nid)
        nm = rt.nodes[nid]
        spec = SimpleNamespace(task_id=b"stolen", runtime_env=None,
                               fn_id=b"fn")
        handle = SimpleNamespace(
            steal_pending=True, inflight={spec.task_id: spec},
            re_inflight=0, known_fns={b"fn"}, lease_resources=None,
            visible_chips=None, actor_id=None, idle=False,
            alive=lambda: False)
        specs, queued = nm.return_stolen(handle, [spec.task_id])
        assert specs == [spec] and not queued
        assert not nm.queue and not handle.inflight
    finally:
        rmt.shutdown()
