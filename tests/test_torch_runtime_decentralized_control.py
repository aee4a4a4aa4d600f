"""Decentralized control plane: agent-local leaf scheduling
with spillback, and lock hygiene of the sharded directory/refcount
tables under contended submission.

The leaf path hands eligible tasks (no strategy/placement/runtime_env,
<=1 CPU, ref args already in the driver store) straight to a node's
lease pool, skipping the central placement pass; saturated pools spill
back to the shared scheduler. The lockwatch stress drives submits,
puts and frees from several driver threads at once and asserts the
striped refcount shards + sharded GCS directory never form a
lock-order-inversion cycle.

The PyTorch port's copy of ``tests/test_decentralized_control.py``: the
same cases run against ``ray_memory_management_tpu_torch``.
"""

import threading

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from _port_fixtures import one_intra_op_thread  # noqa: F401


def _count(counter) -> float:
    return sum(counter.series().values())


def test_leaf_tasks_ride_local_lease_pool():
    """Plain small tasks are leaf-placed (counter moves), execute
    correctly, and spillback engages once the pools saturate."""
    rmt.init(num_cpus=2)
    try:
        placed0 = _count(mdefs.sched_local_placed())

        @rmt.remote(max_retries=0)
        def double(x):
            return 2 * x

        # burst far beyond the node's lease credits (2xCPU) so both
        # outcomes appear: leaf placements and head-side spillback
        refs = [double.remote(i) for i in range(60)]
        assert rmt.get(refs, timeout=120) == [2 * i for i in range(60)]
        assert _count(mdefs.sched_local_placed()) > placed0
    finally:
        rmt.shutdown()


def test_constrained_tasks_skip_the_leaf_path():
    """A scheduling strategy forces the central pass — the leaf counter
    must not move for SPREAD tasks."""
    rmt.init(num_cpus=2, num_nodes=2)
    try:
        @rmt.remote(max_retries=0)
        def noop():
            return b"ok"

        placed0 = _count(mdefs.sched_local_placed())
        refs = [noop.options(scheduling_strategy="SPREAD").remote()
                for _ in range(16)]
        assert rmt.get(refs, timeout=120) == [b"ok"] * 16
        assert _count(mdefs.sched_local_placed()) == placed0
    finally:
        rmt.shutdown()


def test_leaf_requires_resident_ref_args():
    """A task whose ref arg is another task's (not yet produced) output
    is not leaf-eligible at submit; it still runs via the central path
    once the dep resolves."""
    rmt.init(num_cpus=2)
    try:
        @rmt.remote(max_retries=0)
        def produce():
            return 21

        @rmt.remote(max_retries=0)
        def consume(x):
            return 2 * x

        assert rmt.get(consume.remote(produce.remote()), timeout=120) == 42
    finally:
        rmt.shutdown()


def test_lockwatch_contended_submit_no_cycles():
    """The concurrency-surgery gate: drive the striped refcount
    shards, the sharded GCS directory and both scheduling paths from
    several driver threads at once with the runtime lock-order detector
    installed (the RMT_LOCK_CHECK=1 machinery), then assert the order
    graph has zero inversion cycles."""
    from ray_memory_management_tpu_torch.analysis import lockwatch

    with lockwatch.watching() as lw:
        rmt.init(num_cpus=2, num_nodes=2)
        try:
            @rmt.remote(max_retries=0)
            def double(x):
                return 2 * x

            @rmt.remote(max_retries=0)
            def total(blob):
                return len(blob)

            errors = []

            def churn(seed: int) -> None:
                try:
                    for i in range(20):
                        # leaf-eligible: plain submit, inline arg
                        leaf = [double.remote(seed + j) for j in range(4)]
                        # ref-arg submit: put lands in the striped
                        # refcount tables + sharded directory; the task
                        # then pins/unpins it across threads
                        blob = rmt.put(bytes(64 + seed))
                        fanout = [total.remote(blob) for _ in range(2)]
                        # constrained: central scheduler pass
                        spread = total.options(
                            scheduling_strategy="SPREAD").remote(blob)
                        assert rmt.get(leaf, timeout=120) == [
                            2 * (seed + j) for j in range(4)]
                        assert rmt.get(fanout + [spread], timeout=120) \
                            == [64 + seed] * 3
                        del blob  # decref -> deferred-free churn
                except Exception as e:  # pragma: no cover - surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=churn, args=(s,))
                       for s in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
        finally:
            rmt.shutdown()
        rep = lw.report()

    assert rep["acquisitions"] > 1000, rep["acquisitions"]
    assert rep["cycles"] == [], (
        "lock-order inversion cycles under contended submit: "
        f"{rep['cycles']}")
