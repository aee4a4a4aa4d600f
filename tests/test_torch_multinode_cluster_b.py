"""Multi-node scheduling, transfer, FT tests (reference:
python/ray/tests/test_multinode_failures.py, test_object_spilling.py,
test_reconstruction.py coverage — via the in-process cluster).

The PyTorch port's copy of ``tests/test_cluster.py``: the same cases run
against ``ray_memory_management_tpu_torch`` (its last five cases; the
first nine are in ``test_torch_multinode_cluster_a.py``).
"""

import os
import time

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt


@rmt.remote(scheduling_strategy="SPREAD")
def whereami():
    return os.environ["RMT_NODE_ID"]


@rmt.remote(scheduling_strategy="SPREAD")
def make(n):
    return np.full(n, 7, dtype=np.float32)


def test_push_under_pressure_remote_node():
    """Regression for the round-2 failing path: args exceeding the remote
    agent's store force spills while tasks hold reader refs; allocation must
    wait for refs to drain (and fall back to inline serves) instead of
    surfacing ObjectLostError."""
    from ray_memory_management_tpu_torch.config import Config
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    cfg = Config(object_store_memory=32 << 20)
    rt = rmt.init(num_cpus=2, _config=cfg)
    try:
        remote_id = rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(max_retries=0)
        def consume(arr):
            import time as _t

            _t.sleep(0.1)  # hold the arg's reader ref under pressure
            return float(arr[0])

        refs = [rmt.put(np.full(1 << 20, i, dtype=np.float64))
                for i in range(8)]  # 64 MB of args into a 32 MB agent store
        outs = [consume.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=remote_id, soft=False)).remote(r)
            for r in refs]
        assert rmt.get(outs, timeout=180) == [float(i) for i in range(8)]
    finally:
        rmt.shutdown()


def test_actor_args_under_pressure_remote_node():
    """The actor-task flavor of the pressure path: big args pushed to a
    full remote store must degrade (retry / dispatch-without-prefetch,
    worker fetches inline) — never hang the dispatch or surface
    ObjectLostError while the source copy is live."""
    from ray_memory_management_tpu_torch.config import Config
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    cfg = Config(object_store_memory=32 << 20)
    rt = rmt.init(num_cpus=2, _config=cfg)
    try:
        remote_id = rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(max_restarts=0)
        class Consumer:
            def eat(self, arr):
                import time as _t

                _t.sleep(0.1)
                return float(arr[0])

        actors = [Consumer.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=remote_id, soft=False)).remote()
            for _ in range(2)]
        refs = [rmt.put(np.full(1 << 20, i, dtype=np.float64))
                for i in range(8)]
        outs = [actors[i % 2].eat.remote(r)
                for i, r in enumerate(refs)]
        assert rmt.get(outs, timeout=300) == [float(i) for i in range(8)]
    finally:
        rmt.shutdown()


def test_push_under_pressure_remote_node_with_cpu_load():
    """The same pressure scenario with the HOST itself loaded (the
    round-4 flake: on a busy 1-CPU box the transfer/allocation budgets
    stretched and a pressured push surfaced ObjectLostError). Pressure
    must cause slowness, never object loss: the receiver nacks
    retryable-full, the head retries holding its read ref, and a
    transfer that still fails degrades to dispatch-without-prefetch
    (the worker fetches inline). Reference behavior: pull-manager
    admission control + queued plasma creates (pull_manager.h:47,
    create_request_queue.h:32)."""
    import threading

    from ray_memory_management_tpu_torch.config import Config
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    stop = threading.Event()

    def burn():
        x = np.random.default_rng(0).random(200_000)
        while not stop.is_set():
            (x * x).sum()

    loaders = [threading.Thread(target=burn, daemon=True)
               for _ in range(3)]
    cfg = Config(object_store_memory=32 << 20)
    rt = rmt.init(num_cpus=2, _config=cfg)
    try:
        remote_id = rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(max_retries=0)
        def consume(arr):
            import time as _t

            _t.sleep(0.1)  # hold the arg's reader ref under pressure
            return float(arr[0])

        for th in loaders:
            th.start()
        refs = [rmt.put(np.full(1 << 20, i, dtype=np.float64))
                for i in range(8)]
        outs = [consume.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=remote_id, soft=False)).remote(r)
            for r in refs]
        assert rmt.get(outs, timeout=300) == [float(i) for i in range(8)]
    finally:
        stop.set()
        rmt.shutdown()


def test_custom_resources():
    rt = rmt.init(num_cpus=4, resources={"widget": 2})
    try:
        @rmt.remote(resources={"widget": 1}, num_cpus=0)
        def uses_widget():
            return "ok"

        assert rmt.get(uses_widget.remote(), timeout=60) == "ok"
        assert rmt.cluster_resources().get("widget") == 2.0
    finally:
        rmt.shutdown()


def test_worker_return_spills_full_store():
    """A task return larger than the node store's free space must trigger
    owner-side spilling (the raylet-spills-for-plasma-creates path) — not
    a task failure — on both local and remote-agent nodes."""
    from ray_memory_management_tpu_torch.config import Config
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    cfg = Config(object_store_memory=48 << 20)
    rt = rmt.init(num_cpus=2, _config=cfg)
    try:
        remote_id = rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(max_retries=0)
        def produce(mb):
            return np.ones(mb << 18, np.float32)  # mb MB

        for target in (rt.head_node().node_id, remote_id):
            refs = [produce.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=target, soft=False)).remote(20)
                for _ in range(3)]  # 60 MB of returns into a 48 MB store
            rmt.wait(refs, num_returns=3, timeout=180)
            if target == rt.head_node().node_id:
                # load-bearing: checked BEFORE the reads restore spilled
                # objects (restores pop the spill records) — the values
                # must have gone through the STORE via the make_room
                # spill path, not the inline last-resort fallback
                assert rt.head_node().store.spilled_count() > 0, \
                    "head store never spilled: returns bypassed the store"
            for r in refs:
                assert float(rmt.get(r, timeout=180)[0]) == 1.0
            del refs
    finally:
        rmt.shutdown()
