"""GCS fault tolerance: durable tables survive a head restart.

The reference keeps GCS tables in Redis (redis_store_client.h:28) so a
restarted GCS restores detached actors and cluster KV
(python/ray/tests/test_gcs_fault_tolerance.py). Here the durable backend is
a sqlite file (core/gcs_storage.py); these tests restart the whole runtime
on the same storage path.

The PyTorch port's copy of ``tests/test_gcs_persistence.py``: the same
cases run against ``ray_memory_management_tpu_torch``.
"""

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.config import Config
from _port_fixtures import one_intra_op_thread  # noqa: F401


def _boot(db):
    return rmt.init(num_cpus=2, _config=Config(gcs_storage_path=db))


def test_detached_actor_survives_head_restart(tmp_path):
    db = str(tmp_path / "gcs.db")
    rt = _boot(db)

    @rmt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.options(name="persistent_counter",
                        lifetime="detached").remote()
    assert rmt.get(c.inc.remote(), timeout=60) == 1
    rmt.shutdown()

    # second boot on the same tables: the actor is recreated from its
    # durable creation spec (fresh state — restart semantics, not
    # state checkpointing, exactly as the reference restarts actors)
    rt = _boot(db)
    c2 = rmt.get_actor("persistent_counter")
    assert rmt.get(c2.inc.remote(), timeout=60) == 1
    rmt.kill(c2)
    rmt.shutdown()

    # third boot: an explicitly killed detached actor stays gone
    rt = _boot(db)
    with pytest.raises(ValueError):
        rmt.get_actor("persistent_counter")
    rmt.shutdown()


def test_kv_survives_head_restart(tmp_path):
    db = str(tmp_path / "gcs.db")
    rt = _boot(db)
    rt.gcs.kv_put("cluster/config", b"v1")
    rmt.shutdown()

    rt = _boot(db)
    assert rt.gcs.kv_get("cluster/config") == b"v1"
    rt.gcs.kv_del("cluster/config")
    rmt.shutdown()

    rt = _boot(db)
    assert rt.gcs.kv_get("cluster/config") is None
    rmt.shutdown()


def test_head_restart_mid_traffic_keeps_sealed_objects(tmp_path):
    """Durability acceptance: kill the head while traffic is
    in flight. Every SEALED small object (task returns + puts, whose WAL
    write precedes future resolution) must be resolvable after restart;
    creates that never sealed — and sealed values too big for the WAL,
    whose only holders died with the old process tree — are swept from
    the restored directory instead of resurfacing as dangling rows."""
    import time

    from ray_memory_management_tpu_torch.core.object_ref import ObjectRef

    db = str(tmp_path / "gcs.db")
    rt = _boot(db)

    @rmt.remote(max_retries=0)
    def produce(i):
        return ("sealed-%d" % i).encode() * 4

    @rmt.remote(max_retries=0)
    def crawl():
        time.sleep(30)
        return b"never lands"

    refs = [produce.remote(i) for i in range(8)]
    vals = rmt.get(refs, timeout=120)
    put_ref = rmt.put(b"small put payload")
    put_val = rmt.get(put_ref, timeout=60)
    big_ref = rmt.put(b"x" * (256 * 1024))  # over sealed_wal_max_bytes
    assert rmt.get(big_ref, timeout=60)
    slow = crawl.remote()  # still running when the head dies
    sealed = [(r.binary(), v) for r, v in zip(refs, vals)]
    sealed.append((put_ref.binary(), put_val))
    big_oid, slow_oid = big_ref.binary(), slow.binary()
    rmt.shutdown()  # head goes down mid-traffic, no drain

    rt = _boot(db)
    try:
        # sealed values restore from the WAL and resolve as before
        for oid, val in sealed:
            assert rmt.get(ObjectRef(oid), timeout=60) == val
        # the oversized sealed value and the never-sealed return are
        # swept: their only holders died with the old process tree
        assert big_oid not in rt.memory_store
        assert slow_oid not in rt.memory_store
        assert big_oid not in rt.gcs.directory_keys()
        assert slow_oid not in rt.gcs.directory_keys()
    finally:
        rmt.shutdown()


def test_volatile_default_unchanged(tmp_path):
    rt = rmt.init(num_cpus=2)

    @rmt.remote
    class A:
        def ping(self):
            return "ok"

    a = A.options(name="volatile_actor", lifetime="detached").remote()
    assert rmt.get(a.ping.remote(), timeout=60) == "ok"
    rmt.shutdown()
    rt = rmt.init(num_cpus=2)
    with pytest.raises(ValueError):
        rmt.get_actor("volatile_actor")
    rmt.shutdown()


def test_head_restart_accounts_for_spilled_cold_rows(tmp_path):
    """A head that dies with directory rows spilled COLD (on
    the same sqlite surface) must fold them into the boot-path sweep —
    cold rows are part of the full directory the restarted head accounts
    for, their holders died with the old process tree, and no orphan
    cold blobs may leak in storage. WAL-sealed values keep resolving."""
    from ray_memory_management_tpu_torch.core.object_ref import ObjectRef

    db = str(tmp_path / "gcs.db")
    rt = rmt.init(num_cpus=2, _config=Config(
        gcs_storage_path=db,
        gcs_directory_hot_max_rows=64,   # per-shard floor: spill early
        gcs_directory_cold_s=0.0))

    @rmt.remote(max_retries=0)
    def produce(i):
        return ("sealed-%d" % i).encode() * 4

    refs = [produce.remote(i) for i in range(4)]
    vals = rmt.get(refs, timeout=120)
    sealed = [(r.binary(), v) for r, v in zip(refs, vals)]
    # flood the directory with synthetic store-resident rows so the hot
    # cap forces cold spills onto the durable surface
    node = next(iter(rt.gcs.nodes))
    oids = [b"coldrow" + i.to_bytes(4, "big") + bytes(9)
            for i in range(600)]
    for oid in oids:
        rt.gcs.add_object_location(oid, node, size=32)
    stats = rt.gcs.directory_stats()
    assert stats["cold"] > 0, "hot cap never engaged — test is vacuous"
    rmt.shutdown()  # head dies with cold batches on disk

    rt = rmt.init(num_cpus=2, _config=Config(
        gcs_storage_path=db,
        gcs_directory_hot_max_rows=64,
        gcs_directory_cold_s=0.0))
    try:
        # cold rows were merged into the boot sweep: the dead node's
        # rows are gone from the directory AND no cold blob leaked
        keys = set(rt.gcs.directory_keys())
        assert not (set(oids) & keys)
        assert list(rt.gcs.storage.items("dir_cold")) == []
        assert rt.gcs.directory_stats()["cold"] == 0
        # WAL-sealed values are untouched by the cold-tier sweep
        for oid, val in sealed:
            assert rmt.get(ObjectRef(oid), timeout=60) == val
    finally:
        rmt.shutdown()
