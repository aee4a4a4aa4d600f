"""Deterministic fault-injection plane + the data-plane failure matrix.

Unit layer: the plane itself (seeded schedules, spec grammar, RetryPolicy,
crc32_combine). Matrix layer: injected faults at each registered site —
transfer send/recv/dial, spill write/read, control dispatch, worker exec —
against real workloads (p2p pulls, striped pulls, spill/restore, task
execution), asserting BOUNDED recovery: retries/failover/re-pull converge
and corruption is detected, never served.

The plane is process-global, so every test configures it explicitly and
the autouse fixture resets it (and the propagation env vars) afterwards.

The PyTorch port's copy of ``tests/test_faults.py``: the same cases run
against ``ray_memory_management_tpu_torch``.
"""

import os
import random
import threading
import time
import zlib

import numpy as np
import pytest

from ray_memory_management_tpu_torch.analysis import lockwatch
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from ray_memory_management_tpu_torch.core.object_store import NodeObjectStore
from ray_memory_management_tpu_torch.core.transfer import (
    TransferServer, fetch_object,
)
from ray_memory_management_tpu_torch.utils import events, faults
from ray_memory_management_tpu_torch.utils.integrity import crc32, crc32_combine
from ray_memory_management_tpu_torch.utils.retry import (
    RetryExhausted, RetryPolicy, is_retryable_error,
)

CHUNK = 1 << 20


@pytest.fixture(autouse=True)
def _clean_fault_plane():
    yield
    os.environ.pop("RMT_fault_injection_spec", None)
    os.environ.pop("RMT_fault_injection_seed", None)
    faults.reset()


@pytest.fixture
def two_stores():
    cfg = Config(object_store_memory=64 << 20)
    a = NodeObjectStore(f"/rmt_fltA_{os.getpid()}", cfg, create=True)
    b = NodeObjectStore(f"/rmt_fltB_{os.getpid()}", cfg, create=True)
    yield a, b
    a.close(unlink=True)
    b.close(unlink=True)


# --- the plane: determinism, grammar, replay ---------------------------------

def test_same_seed_same_schedule():
    """The k-th decision at a site is a pure function of (seed, site,
    mode, k): two planes with the same seed agree bit-for-bit, a
    different seed diverges."""
    s1 = faults.FaultPlane(seed=123).schedule("transfer.send", "error", 64)
    s2 = faults.FaultPlane(seed=123).schedule("transfer.send", "error", 64)
    s3 = faults.FaultPlane(seed=124).schedule("transfer.send", "error", 64)
    assert s1 == s2
    assert s1 != s3
    assert any(s1) and not all(s1)  # p=0.5 probe actually branches


def test_schedule_immune_to_cross_site_interleaving():
    """Firing OTHER sites between hits must not perturb a site's
    schedule — each (site, mode) rule owns its RNG stream."""
    spec = "transfer.send:error:p=0.5;spill.write:error:p=0.5"
    solo = faults.FaultPlane(seed=9, spec=spec)
    only_send = [solo.fire("transfer.send") is not None for _ in range(32)]

    mixed = faults.FaultPlane(seed=9, spec=spec)
    interleaved = []
    for _ in range(32):
        interleaved.append(mixed.fire("transfer.send") is not None)
        mixed.fire("spill.write")  # extra traffic on an unrelated site
    assert interleaved == only_send


def test_after_and_max_gates():
    plane = faults.FaultPlane(seed=1,
                              spec="transfer.send:error:after=2:max=2")
    decisions = [plane.fire("transfer.send") is not None for _ in range(8)]
    assert decisions == [False, False, True, True, False, False, False,
                         False]
    assert plane.counters() == {"transfer.send:error": 2}


def test_spec_grammar_rejects_typos():
    for bad in ("transfer.send",             # no mode
                "transfer.send:explode",     # unknown mode
                "transfer.send:error:0.5",   # param not k=v
                "transfer.send:error:q=1"):  # unknown key
        with pytest.raises(ValueError):
            faults.parse_spec(bad)


def test_spec_multiple_rules_and_params():
    rules = faults.parse_spec(
        "transfer.recv:corrupt:p=0.25;spill.write:error:max=3;"
        "worker.exec:stall:stall=0.5:after=1", seed=4)
    assert [(r.site, r.mode) for r in rules] == [
        ("transfer.recv", "corrupt"), ("spill.write", "error"),
        ("worker.exec", "stall")]
    assert rules[0].p == 0.25
    assert rules[1].max_injections == 3
    assert rules[2].stall_s == 0.5 and rules[2].after == 1


def test_corrupt_bytes_flips_one_byte_copy():
    data = bytes(range(256))
    out = faults.corrupt_bytes(data, offset=7)
    assert out != data and len(out) == len(data)
    assert sum(1 for x, y in zip(out, data) if x != y) == 1
    assert data == bytes(range(256))  # input never mutated
    assert faults.corrupt_bytes(b"") == b""


def test_env_propagation_to_fresh_process_state():
    """configure_from exports the spec/seed to os.environ (what spawned
    agents/workers inherit); a reset plane re-discovers it from the env
    exactly as a child process would."""
    cfg = Config(fault_injection_spec="transfer.send:error:max=1",
                 fault_injection_seed=77)
    faults.configure_from(cfg)
    assert os.environ["RMT_fault_injection_spec"] == \
        "transfer.send:error:max=1"
    assert os.environ["RMT_fault_injection_seed"] == "77"
    faults.reset()  # simulate the child: no plane, env only
    act = faults.fire("transfer.send")
    assert act is not None and act.mode == "error"
    assert faults.fire("transfer.send") is None  # max=1 spent


def test_injection_counter_and_event():
    before = mdefs.faults_injected().get(
        tags={"site": "spill.read", "mode": "error"})
    faults.configure("spill.read:error:max=1")
    assert faults.fire("spill.read") is not None
    assert mdefs.faults_injected().get(
        tags={"site": "spill.read", "mode": "error"}) == before + 1
    assert any(e["label"] == "FAULT_INJECTED"
               for e in events.list_events({"source": "fault_plane"}))


def test_counters_exported_to_prometheus():
    faults.configure("transfer.send:error:max=1")
    assert faults.fire("transfer.send") is not None
    from ray_memory_management_tpu_torch.utils.metrics import export_prometheus

    text = export_prometheus()
    assert "rmt_faults_injected_total" in text


# --- RetryPolicy -------------------------------------------------------------

def test_retryable_classification():
    assert not is_retryable_error("authentication failed dialing 1.2.3.4")
    assert not is_retryable_error("wire protocol mismatch: v1 vs v2")
    assert not is_retryable_error(TypeError("bad arg"))
    assert not is_retryable_error(None)
    assert is_retryable_error("connect to 1.2.3.4 failed: timeout")
    assert is_retryable_error(OSError("connection reset"))
    assert is_retryable_error(faults.FaultInjected("injected error"))


def test_retry_run_recovers_and_counts():
    plane_tag = {"plane": "test-recover"}
    before = mdefs.retry_attempts().get(tags=plane_tag)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    pol = RetryPolicy(max_attempts=5, base_backoff_s=0.001,
                      plane="test-recover", rng=random.Random(0))
    assert pol.run(flaky) == "ok"
    assert calls["n"] == 3
    assert mdefs.retry_attempts().get(tags=plane_tag) == before + 2


def test_retry_run_exhausts_loudly():
    plane_tag = {"plane": "test-exhaust"}
    before = mdefs.retry_exhausted().get(tags=plane_tag)
    pol = RetryPolicy(max_attempts=2, base_backoff_s=0.001,
                      plane="test-exhaust")
    with pytest.raises(RetryExhausted):
        pol.run(lambda: (_ for _ in ()).throw(OSError("always")))
    assert mdefs.retry_exhausted().get(tags=plane_tag) == before + 1


def test_retry_nonretryable_raises_immediately():
    calls = {"n": 0}

    def auth_fail():
        calls["n"] += 1
        raise TypeError("programming error")

    with pytest.raises(TypeError):
        RetryPolicy(max_attempts=5, base_backoff_s=0.001).run(auth_fail)
    assert calls["n"] == 1


def test_retry_deadline_bounds_attempts():
    pol = RetryPolicy(max_attempts=1000, base_backoff_s=0.05,
                      deadline_s=0.12, plane="test-deadline")
    t0 = time.monotonic()
    with pytest.raises(RetryExhausted):
        pol.run(lambda: (_ for _ in ()).throw(OSError("always")))
    assert time.monotonic() - t0 < 2.0


# --- CRC32 combination -------------------------------------------------------

def test_crc32_combine_matches_full_pass():
    rng = random.Random(42)
    data = bytes(rng.getrandbits(8) for _ in range(65_537))
    for cut in (0, 1, 17, 4096, 65_000, len(data)):
        a, b = data[:cut], data[cut:]
        assert crc32_combine(crc32(a), crc32(b), len(b)) == \
            zlib.crc32(data)


# --- transfer failure matrix -------------------------------------------------

@pytest.mark.parametrize("site,mode", [
    ("transfer.send", "drop"),
    ("transfer.send", "stall"),
    ("transfer.send", "error"),
    ("transfer.recv", "drop"),
    ("transfer.recv", "error"),
    ("transfer.dial", "error"),
])
def test_transfer_matrix_single_fault_recovers(two_stores, site, mode):
    """One injected fault per (site, mode) on a p2p pull: the unified
    retry loop must converge to byte-exact delivery. Runs under the
    lock-order detector: the retry/failover path (server recv threads +
    client pool) must produce zero inversion cycles."""
    a, b = two_stores
    key = os.urandom(16)
    with lockwatch.watching() as lw:
        srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
        try:
            payload = np.arange(2 << 20, dtype=np.uint8).tobytes()
            a.put_bytes(b"M" * 16, payload)
            faults.configure(f"{site}:{mode}:max=1:stall=0.2", seed=5)
            before = mdefs.faults_injected().get(
                tags={"site": site, "mode": mode})
            err = fetch_object("127.0.0.1", srv.port, key, b"M" * 16, b,
                               CHUNK,
                               retry=RetryPolicy(max_attempts=4,
                                                 base_backoff_s=0.01))
            assert err is None, err
            assert mdefs.faults_injected().get(
                tags={"site": site, "mode": mode}) == before + 1
            view = b.get(b"M" * 16)
            assert bytes(view) == payload
            del view
            b.release(b"M" * 16)
        finally:
            srv.close()
        rep = lw.report()
    assert rep["cycles"] == [], rep["cycles"]


def test_wire_corruption_detected_and_repaired(two_stores):
    """A corrupted payload (single-stream pull) must be caught by the
    end-to-end crc — never sealed — and repaired by the outer re-pull."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = np.arange(2 << 20, dtype=np.uint8).tobytes()
        a.put_bytes(b"X" * 16, payload)
        faults.configure("transfer.send:corrupt:max=1", seed=6)
        before = mdefs.transfer_checksum_mismatch().get()
        err = fetch_object("127.0.0.1", srv.port, key, b"X" * 16, b, CHUNK,
                           retry=RetryPolicy(max_attempts=3,
                                             base_backoff_s=0.01))
        assert err is None, err
        assert mdefs.transfer_checksum_mismatch().get() == before + 1
        view = b.get(b"X" * 16)
        assert bytes(view) == payload  # repaired copy, not the corrupt one
        del view
        b.release(b"X" * 16)
    finally:
        srv.close()


def test_striped_corruption_detected_and_repaired(two_stores):
    """Same contract on the striped path: per-stripe crcs combined via
    crc32_combine must catch a single flipped byte in one stripe."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = np.arange(24 << 18, dtype=np.uint32).tobytes()  # 24 MiB
        a.put_bytes(b"Y" * 16, payload)
        faults.configure("transfer.recv:corrupt:max=1", seed=7)
        before = mdefs.transfer_checksum_mismatch().get()
        err = fetch_object("127.0.0.1", srv.port, key, b"Y" * 16, b, CHUNK,
                           stripe_threshold=8 << 20, stripe_count=4,
                           retry=RetryPolicy(max_attempts=3,
                                             base_backoff_s=0.01))
        assert err is None, err
        assert mdefs.transfer_checksum_mismatch().get() == before + 1
        view = b.get(b"Y" * 16)
        assert bytes(view) == payload
        del view
        b.release(b"Y" * 16)
    finally:
        srv.close()


def test_mid_stripe_holder_failover_to_alt_source(two_stores, monkeypatch):
    """A stripe dying mid-pull re-pulls ONLY the missing ranges from an
    alternate live holder into the same unsealed create — no outer
    retry (max_attempts=1), no lineage reconstruction."""
    from ray_memory_management_tpu_torch.core import transfer as tr

    a, b = two_stores
    cfg = Config(object_store_memory=64 << 20)
    c = NodeObjectStore(f"/rmt_fltC_{os.getpid()}", cfg, create=True)
    key = os.urandom(16)
    srv_a = TransferServer(a, authkey=key, chunk_size=CHUNK)
    srv_c = TransferServer(c, authkey=key, chunk_size=CHUNK)
    try:
        payload = np.arange(24 << 18, dtype=np.uint32).tobytes()
        a.put_bytes(b"F" * 16, payload)
        c.put_bytes(b"F" * 16, payload)  # the alternate holder
        real = tr._recv_exact
        calls = {"n": 0}

        def killed(conn, sub):
            calls["n"] += 1
            if calls["n"] == 2:  # one stripe dies mid-payload
                raise OSError("connection killed mid-stripe")
            return real(conn, sub)

        monkeypatch.setattr(tr, "_recv_exact", killed)
        served_before = srv_c.requests_served
        failovers_before = mdefs.transfer_failovers().get()
        err = fetch_object(
            "127.0.0.1", srv_a.port, key, b"F" * 16, b, CHUNK,
            stripe_threshold=8 << 20, stripe_count=4,
            alt_sources=lambda: [("127.0.0.1", srv_c.port)],
            retry=RetryPolicy(max_attempts=1))
        assert err is None, err
        assert mdefs.transfer_failovers().get() > failovers_before
        deadline = time.monotonic() + 5.0
        while (srv_c.requests_served == served_before
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert srv_c.requests_served > served_before  # alt really served
        view = b.get(b"F" * 16)
        assert bytes(view) == payload
        del view
        b.release(b"F" * 16)
    finally:
        srv_a.close()
        srv_c.close()
        c.close(unlink=True)


def test_dial_auth_failure_not_retryable(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        a.put_bytes(b"A" * 16, b"locked")
        before = mdefs.transfer_auth_failures().get()
        err = fetch_object("127.0.0.1", srv.port, b"wrong-key", b"A" * 16,
                           b, CHUNK)
        assert err is not None and "authentication failed" in err
        assert not is_retryable_error(err)
        assert mdefs.transfer_auth_failures().get() > before
        assert not b.contains(b"A" * 16)
    finally:
        srv.close()


# --- spill failure matrix ----------------------------------------------------

@pytest.fixture
def spilling_store(tmp_path):
    cfg = Config(object_store_memory=64 << 20,
                 object_store_fallback_directory=str(tmp_path),
                 spill_retry_backoff_s=0.01,
                 object_store_full_timeout_s=2.0)
    s = NodeObjectStore(f"/rmt_fltS_{os.getpid()}", cfg, create=True)
    yield s
    s.close(unlink=True)


def _fill_until_spill(store):
    blobs = {bytes([i]) * 16: bytes([i]) * (16 << 20) for i in range(6)}
    for oid, data in blobs.items():  # 96 MB into 64 MB: must spill
        store.put_bytes(oid, data)
    assert store.spilled_count() > 0
    return blobs


def test_spill_write_error_retried(spilling_store):
    faults.configure("spill.write:error:max=1", seed=11)
    before = mdefs.spill_errors().get(tags={"op": "write"})
    blobs = _fill_until_spill(spilling_store)
    assert mdefs.spill_errors().get(tags={"op": "write"}) == before + 1
    assert not spilling_store.spill_degraded()  # one transient ≠ degraded
    oid = next(iter(spilling_store._spilled))
    data = spilling_store.read(oid)
    assert bytes(data[:4]) == blobs[oid][:4]


def test_spill_read_corruption_detected_and_retried(spilling_store):
    blobs = _fill_until_spill(spilling_store)
    oid = next(iter(spilling_store._spilled))
    faults.configure("spill.read:corrupt:max=1", seed=12)
    before = mdefs.spill_errors().get(tags={"op": "checksum"})
    data = spilling_store.read(oid)  # corrupt restore retried clean
    assert bytes(data) == blobs[oid]
    assert mdefs.spill_errors().get(tags={"op": "checksum"}) == before + 1


def test_spill_read_persistent_corruption_is_loss_not_silent(spilling_store):
    """Corruption on EVERY restore attempt must surface as object loss
    (read returns None) — corrupted bytes are never handed out."""
    _fill_until_spill(spilling_store)
    oid = next(iter(spilling_store._spilled))
    faults.configure("spill.read:corrupt", seed=13)  # p=1, no budget
    assert spilling_store.read(oid) is None


def test_spill_persistent_failure_degrades_not_crashes(
        spilling_store, monkeypatch):
    """Persistent spill-write failure: the store degrades to keeping
    objects in memory under backpressure (ObjectStoreFullError when truly
    full) with a loud event — and recovers once the storage heals."""
    def broken(*a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(spilling_store._storage, "spill", broken)
    degraded_before = mdefs.spill_degraded().get()
    first_oid = b"\x00" * 16
    from ray_memory_management_tpu_torch.exceptions import ObjectStoreFullError

    overflowed = False
    try:
        for i in range(6):
            spilling_store.put_bytes(bytes([i]) * 16,
                                     bytes([i]) * (16 << 20))
    except ObjectStoreFullError:
        overflowed = True
    assert overflowed  # backpressure, not a crash or a hang
    assert spilling_store.spill_degraded()
    assert mdefs.spill_degraded().get() > degraded_before
    assert events.list_events({"label": "SPILL_DEGRADED"})
    view = spilling_store.get(first_oid)  # earlier objects stay readable
    assert view is not None and bytes(view[:4]) == b"\x00" * 4
    del view
    spilling_store.release(first_oid)

    # storage heals: the next allowed-check probes and recovers loudly
    monkeypatch.undo()
    spilling_store._spill_degraded_until = time.monotonic() - 1.0
    assert spilling_store._spill_allowed()
    assert not spilling_store.spill_degraded()
    assert events.list_events({"label": "SPILL_RECOVERED"})


# --- stale unsealed creates --------------------------------------------------

def test_sweep_unsealed_aborts_stale_spares_sealed(spilling_store):
    s = spilling_store
    dead = b"D" * 16
    buf = s.create(dead, 4096)  # fetcher that "died" mid-pull
    del buf
    sealed = b"S" * 16
    s.put_bytes(sealed, b"real data")
    s._unsealed[sealed] = time.monotonic() - 400  # stale-looking entry
    s._unsealed[dead] = time.monotonic() - 400
    fresh = b"R" * 16
    buf2 = s.create(fresh, 4096)  # live in-flight create: under deadline

    before = mdefs.stale_creates_aborted().get()
    assert s.sweep_unsealed(deadline_s=300.0) == 1
    assert not s.contains(dead)         # leak reclaimed
    assert s.contains(sealed)           # sealed data never aborted
    assert fresh in s._unsealed         # young create untouched
    assert mdefs.stale_creates_aborted().get() == before + 1
    assert events.list_events({"label": "STALE_CREATE_ABORTED"})
    buf2[:] = b"\x01" * 4096
    del buf2
    s.seal(fresh)                       # still sealable after the sweep
    assert s.contains(fresh)


# --- object directory repair -------------------------------------------------

def test_gcs_prune_location():
    from ray_memory_management_tpu_torch.core.gcs import GCS

    g = GCS()
    oid, nid = b"o" * 16, b"n" * 8
    g.add_object_location(oid, nid)
    before = mdefs.object_directory_prunes().get()
    g.prune_location(oid, nid)
    assert g.get_object_locations(oid) == set()
    assert mdefs.object_directory_prunes().get() == before + 1


# --- control plane + worker exec (e2e, in-process cluster) -------------------

def test_control_dispatch_fault_recovered():
    """Injected dispatch errors ride the unified dispatch retry — every
    task still completes. Runs under the lock-order detector: the
    dispatch-retry path across runtime/agent/worker locks must stay
    inversion-free."""
    import ray_memory_management_tpu_torch as rmt

    faults.configure("control.dispatch:error:max=2", seed=21)
    with lockwatch.watching() as lw:
        rt = rmt.init(num_cpus=2)
        try:
            @rmt.remote
            def double(x):
                return x * 2

            out = rmt.get([double.remote(i) for i in range(6)],
                          timeout=120)
            assert out == [0, 2, 4, 6, 8, 10]
            assert mdefs.faults_injected().get(
                tags={"site": "control.dispatch", "mode": "error"}) >= 1
        finally:
            rmt.shutdown()
        rep = lw.report()
    assert rep["acquisitions"] > 0, "lock detector saw no runtime locks"
    assert rep["cycles"] == [], rep["cycles"]


def test_worker_exec_fault_rides_task_retry():
    """A worker.exec fault propagated via the env spec (the child-process
    path) surfaces as an app error; task retries recover it."""
    import ray_memory_management_tpu_torch as rmt

    os.environ["RMT_fault_injection_spec"] = "worker.exec:error:max=1"
    os.environ["RMT_fault_injection_seed"] = "31"
    rt = rmt.init(num_cpus=2)
    try:
        @rmt.remote(max_retries=4, retry_exceptions=True)
        def answer():
            return 42

        assert rmt.get(answer.remote(), timeout=120) == 42
    finally:
        rmt.shutdown()


# --- directory hot/cold failure matrix ---------------------------------------

def _bounded_gcs(hot_max_rows=64, shards=4):
    """A GCS whose directory spills aggressively: per-shard hot cap at
    the floor (16) and cold_s=0 so every untouched row is a candidate."""
    from ray_memory_management_tpu_torch.core.gcs import GCS
    from ray_memory_management_tpu_torch.core.gcs_storage import InMemoryGcsStorage

    return GCS(InMemoryGcsStorage(), directory_shards=shards,
               hot_max_rows=hot_max_rows, cold_s=0.0)


def _fill_directory(g, node, n=500):
    oids = [b"dirflt" + i.to_bytes(4, "big") + bytes(10) for i in range(n)]
    for oid in oids:
        g.add_object_location(oid, node, size=64)
    return oids


def test_directory_spill_failure_degrades_to_ram_never_loses_rows():
    """Persistent spill-write failure (site directory.spill) must leave
    every row RAM-resident and locatable — degraded, not lossy — and
    recover to actual spilling once the fault clears."""
    from ray_memory_management_tpu_torch.ids import NodeID

    faults.configure("directory.spill:error", seed=41)  # p=1, no budget
    g = _bounded_gcs()
    node = NodeID(b"n" * 16)
    oids = _fill_directory(g, node, 400)
    stats = g.directory_stats()
    assert stats["cold"] == 0, "failed spills must not move rows cold"
    assert stats["hot"] == 400
    located = g.locate_objects(oids)
    assert len(located) == 400  # every row still served
    faults.reset()
    # fault cleared + backoff expired (cold_s=0): next over-cap adds spill
    _fill_directory(g, node, 200)
    deadline = time.monotonic() + 5
    while (g.directory_stats()["cold"] == 0
           and time.monotonic() < deadline):
        g.add_object_location(os.urandom(16), node, size=1)
    assert g.directory_stats()["cold"] > 0
    assert mdefs.gcs_directory_spills().get() > 0


def test_directory_fault_read_failure_is_miss_not_loss():
    """An injected cold-batch read failure (site directory.fault) must
    surface as a lookup MISS while the blob and index stay intact, so
    the next locate faults the row in bit-exact."""
    from ray_memory_management_tpu_torch.ids import NodeID

    g = _bounded_gcs()
    node = NodeID(b"m" * 16)
    oids = _fill_directory(g, node, 400)
    assert g.directory_stats()["cold"] > 0
    cold_oid = next(o for sh in g._shards for o in sh.cold)
    faults.configure("directory.fault:error:max=1", seed=42)
    before = mdefs.gcs_directory_faults().get()
    assert g.locate_objects([cold_oid]) == {}  # miss, not a crash
    # retry with the budget exhausted: the batch faults in intact
    located = g.locate_objects([cold_oid])
    assert cold_oid in located
    size, holders, tiers = located[cold_oid]
    assert size == 64 and node in holders
    assert mdefs.gcs_directory_faults().get() == before + 1
    # and nothing was lost along the way: every row still resolvable
    assert len(g.locate_objects(oids)) == 400
