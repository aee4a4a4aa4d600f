"""Multi-node scheduling, transfer, FT tests (reference:
python/ray/tests/test_multinode_failures.py, test_object_spilling.py,
test_reconstruction.py coverage — via the in-process cluster).

The PyTorch port's copy of ``tests/test_cluster.py``: the same cases run
against ``ray_memory_management_tpu_torch`` (its first nine cases; the
rest are in ``test_torch_multinode_cluster_b.py``), with its own
fixtures (the shared conftest starts the JAX package's runtime).
"""

import os
import time

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt


_shared = []  # the runtime of the cases that take rmt_start_cluster


@pytest.fixture
def rmt_start_cluster():
    """One runtime for every case of this module that takes this fixture
    (the conftest's fixture starts one per case): made at the first such
    case and kept for the next; ``_own_runtime`` shuts it down before a
    case that starts its own, and ``_end_shared`` at the module's end."""
    from ray_memory_management_tpu_torch import _worker_context

    if not _shared or _worker_context.get_runtime() is not _shared[0]:
        rmt.shutdown()
        _shared[:] = [rmt.init(num_cpus=4, num_nodes=3)]
    return _shared[0]


@pytest.fixture
def rmt_fresh_runtime():
    """A cluster of the case's own, for a case that removes nodes."""
    rt = rmt.init(num_cpus=4, num_nodes=3)
    yield rt
    rmt.shutdown()


@pytest.fixture(autouse=True)
def _own_runtime(request):
    if _shared and "rmt_start_cluster" not in request.fixturenames:
        rmt.shutdown()
        _shared.clear()


@pytest.fixture(autouse=True, scope="module")
def _end_shared():
    yield
    rmt.shutdown()
    _shared.clear()


@pytest.fixture
def rmt_small_store():
    from ray_memory_management_tpu_torch.config import Config

    cfg = Config(object_store_memory=64 << 20)
    rt = rmt.init(num_cpus=4, _config=cfg)
    yield rt
    rmt.shutdown()


@rmt.remote(scheduling_strategy="SPREAD")
def whereami():
    return os.environ["RMT_NODE_ID"]


@rmt.remote(scheduling_strategy="SPREAD")
def make(n):
    return np.full(n, 7, dtype=np.float32)


def test_spread_uses_multiple_nodes(rmt_start_cluster):
    # occupy workers long enough that spreading is observable
    @rmt.remote(scheduling_strategy="SPREAD")
    def spot(t):
        time.sleep(t)
        return os.environ["RMT_NODE_ID"]

    nodes = set(rmt.get([spot.remote(0.3) for _ in range(12)], timeout=120))
    assert len(nodes) >= 2, nodes


def test_cross_node_object_transfer(rmt_start_cluster):
    @rmt.remote(scheduling_strategy="SPREAD")
    def consume(a, b):
        return float(a.sum() + b.sum())

    a, b = make.remote(500_000), make.remote(500_000)
    assert rmt.get(consume.remote(a, b), timeout=60) == 7.0 * 1_000_000


def test_task_retry_on_worker_crash(rmt_start_cluster, tmp_path):
    @rmt.remote(max_retries=4)
    def flaky(path):
        n = 0
        if os.path.exists(path):
            n = int(open(path).read())
        open(path, "w").write(str(n + 1))
        if n < 2:
            os._exit(1)
        return "survived"

    p = str(tmp_path / "count")
    assert rmt.get(flaky.remote(p), timeout=90) == "survived"
    assert int(open(p).read()) == 3


def test_no_retry_when_disabled(rmt_start_cluster):
    @rmt.remote(max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(rmt.WorkerCrashedError):
        rmt.get(die.remote(), timeout=60)


def test_lineage_reconstruction_on_node_death(rmt_fresh_runtime):
    rt = rmt_fresh_runtime
    big = make.remote(400_000)
    rmt.get(big, timeout=30)
    locs = rt.gcs.get_object_locations(big.binary())
    assert locs
    rt.remove_node(next(iter(locs)))
    time.sleep(0.5)
    val = rmt.get(big, timeout=90)
    assert float(val.sum()) == 7.0 * 400_000


def test_transitive_lineage_survives_upstream_ref_drop(rmt_fresh_runtime):
    """Lineage pinning: dropping the driver's handle on an UPSTREAM object
    must not prune its lineage while a downstream object derived from it
    is still referenced — recovering the downstream value may need to
    re-execute the whole chain (reference_count.h lineage refcounting)."""
    rt = rmt_fresh_runtime

    @rmt.remote(scheduling_strategy="SPREAD")
    def double(arr):
        return arr * 2.0

    a = make.remote(400_000)
    b = double.remote(a)
    rmt.get(b, timeout=60)
    a_bin = a.binary()
    del a  # upstream handle gone; only b keeps the chain alive
    import gc

    gc.collect()
    # the value of a may be GC'd, but its lineage must survive
    with rt._lock:
        assert a_bin in rt.lineage, "upstream lineage pruned while " \
            "a downstream object is still referenced"
    # lose every copy of b's value: recovery re-runs double, which
    # re-runs make for its lost arg
    for node_id in list(rt.gcs.get_object_locations(b.binary())):
        rt.remove_node(node_id)
    time.sleep(0.5)
    val = rmt.get(b, timeout=120)
    assert float(val.sum()) == 14.0 * 400_000


def test_node_affinity(rmt_start_cluster):
    rt = rmt_start_cluster
    from ray_memory_management_tpu_torch.utils import NodeAffinitySchedulingStrategy

    target = list(rt.nodes.keys())[1]

    @rmt.remote
    def here():
        return os.environ["RMT_NODE_ID"]

    pinned = here.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(target)
    )
    assert rmt.get(pinned.remote(), timeout=60) == target.hex()


def test_spilling_and_restore(rmt_small_store):
    rt = rmt_small_store
    refs = [rmt.put(np.full(4_000_000, i, dtype=np.float32))
            for i in range(8)]
    store = rt.head_node().store
    assert store.spilled_count() > 0
    for i, r in enumerate(refs):
        v = rmt.get(r)
        assert v[0] == i
        del v


def test_concurrent_restore_spill_churn():
    """Regression: a restore's seal and a concurrent spill pass used to race
    — the spiller could evict the freshly-restored object and the restorer
    then erased the NEW spill record, losing the object entirely. Hammer
    restore/spill/ensure from many threads and assert nothing is ever lost."""
    import threading

    from ray_memory_management_tpu_torch.config import Config
    from ray_memory_management_tpu_torch.core.object_store import NodeObjectStore

    cfg = Config(object_store_memory=32 << 20,
                 object_store_full_timeout_s=15.0)
    store = NodeObjectStore(f"/rmt_churn_{os.getpid()}", cfg, create=True)
    try:
        blobs = {bytes([i]) * 16: bytes([i]) * (4 << 20) for i in range(12)}
        for oid, data in blobs.items():
            store.put_bytes(oid, data)  # 48 MB into 32 MB: spills

        errors = []

        def churn(seed):
            oids = list(blobs)
            try:
                for k in range(40):
                    oid = oids[(seed + k) % len(oids)]
                    if not store.ensure_resident(oid):
                        errors.append(f"lost {oid.hex()}")
                        return
                    view = store.get(oid)
                    if view is None:
                        errors.append(f"get miss {oid.hex()}")
                        return
                    ok = bytes(view[:8]) == blobs[oid][:8]
                    del view
                    store.release(oid)
                    if not ok:
                        errors.append(f"corrupt {oid.hex()}")
                        return
            except Exception as e:  # noqa: BLE001 — a thread death must
                errors.append(f"raised {e!r}")  # fail the test, not vanish

        threads = [threading.Thread(target=churn, args=(s,)) for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        for oid in blobs:
            assert store.contains(oid), f"{oid.hex()} vanished"
    finally:
        store.close(unlink=True)


