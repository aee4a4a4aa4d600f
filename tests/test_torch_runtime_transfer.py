"""Peer-to-peer transfer plane: TransferServer + fetch_object.

Unit-level (two stores in one process, TCP loopback between them) — the
e2e agent-to-agent path is covered in test_multihost.py.

The PyTorch port's copy of ``tests/test_transfer.py``: the same cases
run against ``ray_memory_management_tpu_torch``.
"""

import os
import threading

import numpy as np
import pytest

from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core.object_store import NodeObjectStore
from ray_memory_management_tpu_torch.core.transfer import (
    ConnectionPool, TransferServer, fetch_object,
)

CHUNK = 1 << 20


@pytest.fixture
def two_stores():
    cfg = Config(object_store_memory=64 << 20)
    a = NodeObjectStore(f"/rmt_xferA_{os.getpid()}", cfg, create=True)
    b = NodeObjectStore(f"/rmt_xferB_{os.getpid()}", cfg, create=True)
    yield a, b
    a.close(unlink=True)
    b.close(unlink=True)


def test_fetch_roundtrip(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = np.arange(3 << 20, dtype=np.uint8).tobytes()
        a.put_bytes(b"A" * 16, payload)
        err = fetch_object("127.0.0.1", srv.port, key, b"A" * 16, b, CHUNK)
        assert err is None
        view = b.get(b"A" * 16)
        assert bytes(view) == payload
        del view
        b.release(b"A" * 16)
    finally:
        srv.close()


def test_fetch_serves_spilled_without_restore(two_stores):
    """A spilled object streams from its spill file; the source store's
    shm usage must not change (no restore allocation)."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        blobs = {bytes([i]) * 16: bytes([i]) * (16 << 20) for i in range(6)}
        for oid, data in blobs.items():  # 96 MB into 64 MB: spills
            a.put_bytes(oid, data)
        assert a.spilled_count() > 0
        spilled_oid = next(iter(a._spilled))
        used_before = a.shm.usage()[0]
        err = fetch_object("127.0.0.1", srv.port, key, spilled_oid, b, CHUNK)
        assert err is None
        assert a.shm.usage()[0] == used_before  # served from file, no restore
        view = b.get(spilled_oid)
        assert bytes(view[:4]) == blobs[spilled_oid][:4]
        del view
        b.release(spilled_oid)
    finally:
        srv.close()


def test_fetch_missing_object_reports_error(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        err = fetch_object("127.0.0.1", srv.port, key, b"Z" * 16, b, CHUNK)
        assert err is not None and "not in store" in err
    finally:
        srv.close()


def test_fetch_existing_object_is_noop(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        a.put_bytes(b"C" * 16, b"src-version")
        b.put_bytes(b"C" * 16, b"dst-version")
        err = fetch_object("127.0.0.1", srv.port, key, b"C" * 16, b, CHUNK)
        assert err is None
        view = b.get(b"C" * 16)
        assert bytes(view) == b"dst-version"  # racing copy kept, not clobbered
        del view
        b.release(b"C" * 16)
    finally:
        srv.close()


def test_wrong_authkey_rejected(two_stores):
    a, b = two_stores
    srv = TransferServer(a, authkey=b"right-key", chunk_size=CHUNK)
    try:
        a.put_bytes(b"D" * 16, b"secret")
        err = fetch_object("127.0.0.1", srv.port, b"wrong-key", b"D" * 16,
                           b, CHUNK)
        assert err is not None
        assert not b.contains(b"D" * 16)
    finally:
        srv.close()


def test_connect_phase_retries_once(two_stores, monkeypatch):
    """A transient connect/handshake failure (GIL-starved peer missing
    the challenge budget on a loaded host — the observed full-suite
    flake) must retry once before reporting failure; nothing has
    streamed yet so the retry is free. A wrong AUTHKEY must still fail
    without a retry (it will not become right)."""
    import socket as socket_mod

    from ray_memory_management_tpu_torch.core import transfer as tr

    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        a.put_bytes(b"R" * 16, b"retry-payload")
        real = socket_mod.create_connection
        fails = {"n": 1}

        def flaky(*args, **kwargs):
            if fails["n"] > 0:
                fails["n"] -= 1
                raise BlockingIOError(11, "Resource temporarily unavailable")
            return real(*args, **kwargs)

        monkeypatch.setattr(tr.socket, "create_connection", flaky)
        err = fetch_object("127.0.0.1", srv.port, key, b"R" * 16, b, CHUNK)
        assert err is None and b.contains(b"R" * 16)
        assert fails["n"] == 0  # the first attempt really failed
    finally:
        srv.close()


def test_concurrent_fetches(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK, max_conns=2)
    try:
        oids = [bytes([40 + i]) * 16 for i in range(8)]
        for i, oid in enumerate(oids):
            a.put_bytes(oid, bytes([i]) * (1 << 20))
        errs = []

        def fetch(oid):
            e = fetch_object("127.0.0.1", srv.port, key, oid, b, CHUNK)
            if e:
                errs.append(e)

        threads = [threading.Thread(target=fetch, args=(oid,))
                   for oid in oids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs, errs
        for oid in oids:
            assert b.contains(oid)
    finally:
        srv.close()


# --- v2 wire protocol: version gate, striping, abort path --------------------

def test_v1_peer_refused_with_mismatch_error(two_stores):
    """A peer speaking the old protocol gets a loud refusal naming both
    versions (the strict-equality wire contract), never a mis-parse."""
    from multiprocessing.connection import Client

    from ray_memory_management_tpu_torch.config import WIRE_PROTOCOL_VERSION

    a, _b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        a.put_bytes(b"V" * 16, b"versioned")
        conn = Client(("127.0.0.1", srv.port), authkey=key)
        try:
            conn.send({"oid": b"V" * 16, "proto": 1})
            hdr = conn.recv()
        finally:
            conn.close()
        assert "mismatch" in hdr["error"]
        assert f"v{WIRE_PROTOCOL_VERSION}" in hdr["error"]
        assert "v1" in hdr["error"]
    finally:
        srv.close()


def test_striped_fetch_byte_exact(two_stores):
    """A striped pull must reassemble the exact bytes a single stream
    delivers — a patterned payload catches any slice misplacement."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = np.arange(24 << 18, dtype=np.uint32).tobytes()  # 24 MiB
        a.put_bytes(b"S" * 16, payload)
        before = srv.requests_served
        err = fetch_object("127.0.0.1", srv.port, key, b"S" * 16, b, CHUNK,
                           stripe_threshold=8 << 20, stripe_count=4)
        assert err is None
        # deferred size request + 4 range requests prove the striped path
        # (server counters tick just AFTER the client's last recv: wait)
        import time
        deadline = time.monotonic() + 5.0
        while (srv.requests_served - before < 5
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert srv.requests_served - before >= 5
        view = b.get(b"S" * 16)
        assert bytes(view) == payload
        del view
        b.release(b"S" * 16)
    finally:
        srv.close()


def test_mid_stripe_failure_aborts_unsealed(two_stores, monkeypatch):
    """A connection dying mid-stripe must abort the whole fetch (under a
    single-attempt policy, no failover source) and leave NO sealed
    truncated object; an unpatched retry then succeeds."""
    from ray_memory_management_tpu_torch.core import transfer as tr
    from ray_memory_management_tpu_torch.utils.retry import RetryPolicy

    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = np.arange(24 << 18, dtype=np.uint32).tobytes()
        a.put_bytes(b"K" * 16, payload)
        real = tr._recv_exact
        calls = {"n": 0}

        def killed(conn, sub):
            calls["n"] += 1
            if calls["n"] == 2:  # second stripe dies mid-payload
                raise OSError("connection killed mid-stripe")
            return real(conn, sub)

        monkeypatch.setattr(tr, "_recv_exact", killed)
        err = fetch_object("127.0.0.1", srv.port, key, b"K" * 16, b, CHUNK,
                           stripe_threshold=8 << 20, stripe_count=4,
                           retry=RetryPolicy(max_attempts=1))
        assert err is not None
        assert not b.contains(b"K" * 16)  # aborted, never sealed truncated

        monkeypatch.setattr(tr, "_recv_exact", real)
        err = fetch_object("127.0.0.1", srv.port, key, b"K" * 16, b, CHUNK,
                           stripe_threshold=8 << 20, stripe_count=4)
        assert err is None
        view = b.get(b"K" * 16)
        assert bytes(view) == payload
        del view
        b.release(b"K" * 16)
    finally:
        srv.close()


# --- connection-pool lifecycle ------------------------------------------------

def test_pool_reuses_connection_across_pulls(two_stores):
    """Sequential pooled pulls ride ONE authenticated connection: the
    server accepts once, the pool records a hit on the second pull."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    pool = ConnectionPool()
    try:
        for i in (1, 2):
            oid = bytes([i]) * 16
            a.put_bytes(oid, bytes([i]) * 4096)
            err = fetch_object("127.0.0.1", srv.port, key, oid, b, CHUNK,
                               pool=pool)
            assert err is None and b.contains(oid)
        assert srv.connections_accepted == 1
        assert pool.hits == 1 and pool.misses == 1
    finally:
        pool.close()
        srv.close()


def test_pool_evicts_stale_conn_on_server_restart(two_stores):
    """A pooled connection to a RESTARTED server is stale: the next pull
    must detect the dead stream, discard it, and transparently retry on a
    fresh dial — not hard-fail."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    pool = ConnectionPool()
    try:
        a.put_bytes(b"P" * 16, b"first")
        err = fetch_object("127.0.0.1", srv.port, key, b"P" * 16, b, CHUNK,
                           pool=pool)
        assert err is None
        b.delete(b"P" * 16)
        port = srv.port
        srv.close()  # pooled conn is now stale
        # Listener sets SO_REUSEADDR on posix: rebind the same port
        srv = TransferServer(a, authkey=key, chunk_size=CHUNK,
                             bind_port=port)
        err = fetch_object("127.0.0.1", port, key, b"P" * 16, b, CHUNK,
                           pool=pool)
        assert err is None and b.contains(b"P" * 16)
        assert pool.hits == 1  # the stale conn WAS handed out, then evicted
    finally:
        pool.close()
        srv.close()


def test_create_or_wait_wakes_on_seal(two_stores):
    """A fetch racing an in-flight copy must resolve via the store's
    change condition (microseconds after the seal), not a poll tick."""
    import time

    from ray_memory_management_tpu_torch.core.transfer import create_or_wait

    a, _b = two_stores
    oid = b"W" * 16
    buf = a.create(oid, 64)  # unsealed in-flight copy

    def seal_soon():
        time.sleep(0.2)
        buf[:] = b"x" * 64
        a.seal(oid)

    t = threading.Thread(target=seal_soon)
    t.start()
    t0 = time.perf_counter()
    got, err = create_or_wait(a, oid, 64, timeout=10.0)
    waited = time.perf_counter() - t0
    t.join()
    assert got is None and err is None  # racing copy became readable
    assert 0.15 < waited < 2.0  # woke promptly, didn't burn the timeout
    del buf
