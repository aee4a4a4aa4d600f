"""Compressed movement plane: wire codecs, negotiation, integrity, spill.

Unit layer: codec frames (zlib / zrle / downcast), the compressibility
probe + payload-aware codec choice, and the numpy quantization kernels.
Wire layer: codec-negotiated pulls between two real stores over TCP
loopback — old-v2 peer interop BOTH directions, the size threshold, the
incompressible skip, striped compressed pulls, and the
``corrupt-compressed`` fault proving the frame CRC catches wire bit
flips BEFORE the decoder runs (and that a decode failure re-pulls, never
seals). Spill layer: compressed spill copies restore byte-exact and
corruption on disk is caught at the stored-bytes crc.

The PyTorch port's copy of ``tests/test_compression.py``: the same cases
run against ``ray_memory_management_tpu_torch`` (the wire and spill
layers; the codec unit layer is ``tests/test_torch_codec.py``).
"""

import os
import struct
import time

import numpy as np
import pytest

from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import codec
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from ray_memory_management_tpu_torch.core.object_store import NodeObjectStore
from ray_memory_management_tpu_torch.core.transfer import (
    TransferServer, fetch_object,
)
from ray_memory_management_tpu_torch.utils import faults
from ray_memory_management_tpu_torch.utils.retry import RetryPolicy

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
    a = NodeObjectStore(f"/rmt_cmpA_{os.getpid()}", cfg, create=True)
    b = NodeObjectStore(f"/rmt_cmpB_{os.getpid()}", cfg, create=True)
    yield a, b
    a.close(unlink=True)
    b.close(unlink=True)


def _text(n: int) -> bytes:
    para = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. ")
    return (para * (n // len(para) + 1))[:n]


def _sparse(n: int) -> bytes:
    """Float-gradient-shaped payload dominated by whole zero pages."""
    rng = np.random.default_rng(3)
    arr = rng.standard_normal(n // 4).astype(np.float32)
    raw = np.frombuffer(arr.tobytes(), np.uint8).copy()
    pages = raw[:len(raw) // 4096 * 4096].reshape(-1, 4096)
    pages[rng.random(len(pages)) < 0.875] = 0
    return raw.tobytes()


def _fetch(srv, key, oid, dst, **kw):
    return fetch_object("127.0.0.1", srv.port, key, oid, dst, CHUNK, **kw)


def _settle(srv, nreq: int, deadline_s: float = 10.0) -> None:
    """Wait for the server thread to finish accounting ``nreq`` requests:
    the client's fetch returns as soon as the LAST byte lands, which on a
    single-core host can be before the serving thread runs its counter
    updates."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline and srv.requests_served < nreq:
        time.sleep(0.005)
    assert srv.requests_served >= nreq


def _pulled(dst, oid):
    view = dst.get(oid)
    try:
        return bytes(view)
    finally:
        del view
        dst.release(oid)


# --- wire layer: negotiated pulls -------------------------------------------

def test_compressed_pull_byte_exact_and_fewer_wire_bytes(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = _sparse(6 << 20)
        a.put_bytes(b"S" * 16, payload)
        err = _fetch(srv, key, b"S" * 16, b,
                     codecs=codec.available_codecs())
        assert err is None, err
        assert _pulled(b, b"S" * 16) == payload
        _settle(srv, 1)
        assert srv.compressed_serves >= 1
        assert srv.bytes_served_wire < srv.bytes_served // 4
    finally:
        srv.close()


def test_old_client_interops_with_codec_aware_server(two_stores):
    """A codec-unaware v2 peer sends no "codecs" key: the new server
    must stream raw, byte-exact (codecs=None IS that peer's wire shape)."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = _text(3 << 20)
        a.put_bytes(b"O" * 16, payload)
        err = _fetch(srv, key, b"O" * 16, b, codecs=None)
        assert err is None, err
        assert _pulled(b, b"O" * 16) == payload
        _settle(srv, 1)
        assert srv.compressed_serves == 0
        assert srv.bytes_served_wire == srv.bytes_served
    finally:
        srv.close()


def test_new_client_interops_with_codec_unaware_server(two_stores):
    """The other direction: a server that never answers with "codec"
    (compression off — what an old v2 peer looks like on the wire) must
    leave the offering client on the raw path, byte-exact."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK,
                         compression="off")
    try:
        payload = _sparse(3 << 20)
        a.put_bytes(b"U" * 16, payload)
        err = _fetch(srv, key, b"U" * 16, b,
                     codecs=codec.available_codecs())
        assert err is None, err
        assert _pulled(b, b"U" * 16) == payload
        _settle(srv, 1)
        assert srv.compressed_serves == 0
    finally:
        srv.close()


def test_threshold_boundary_skips_small_spans(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK,
                         compress_min_bytes=1 << 20)
    try:
        before = mdefs.transfer_compress_skipped().get(
            tags={"reason": "below_threshold"})
        a.put_bytes(b"T" * 16, bytes((1 << 20) - 1))  # 1 byte under
        err = _fetch(srv, key, b"T" * 16, b,
                     codecs=codec.available_codecs())
        assert err is None, err
        _settle(srv, 1)
        assert srv.compressed_serves == 0
        assert mdefs.transfer_compress_skipped().get(
            tags={"reason": "below_threshold"}) == before + 1
        a.put_bytes(b"t" * 16, bytes(1 << 20))  # at the threshold
        err = _fetch(srv, key, b"t" * 16, b,
                     codecs=codec.available_codecs())
        assert err is None, err
        _settle(srv, 2)
        assert srv.compressed_serves == 1
    finally:
        srv.close()


def test_incompressible_payload_served_raw(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        before = mdefs.transfer_compress_skipped().get(
            tags={"reason": "incompressible"})
        payload = os.urandom(2 << 20)
        a.put_bytes(b"R" * 16, payload)
        err = _fetch(srv, key, b"R" * 16, b,
                     codecs=codec.available_codecs())
        assert err is None, err
        assert _pulled(b, b"R" * 16) == payload
        _settle(srv, 1)
        assert srv.compressed_serves == 0
        assert srv.bytes_served_wire == srv.bytes_served
        assert mdefs.transfer_compress_skipped().get(
            tags={"reason": "incompressible"}) == before + 1
    finally:
        srv.close()


def test_striped_compressed_pull_byte_exact(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = _sparse(24 << 20)
        a.put_bytes(b"P" * 16, payload)
        err = _fetch(srv, key, b"P" * 16, b, stripe_threshold=8 << 20,
                     stripe_count=4, codecs=codec.available_codecs())
        assert err is None, err
        assert _pulled(b, b"P" * 16) == payload
        _settle(srv, 5)  # the deferred size answer + four stripes
        assert srv.compressed_serves >= 4  # every stripe negotiated
    finally:
        srv.close()


def test_corrupt_compressed_frame_caught_and_repulled(two_stores):
    """The ``corrupt-compressed`` fault flips a byte INSIDE a compressed
    frame after its CRC is stamped — exactly a wire bit flip. The frame
    CRC must catch it BEFORE the decoder runs, the fetch must re-pull
    (never seal), and the repaired copy must be byte-exact."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = _text(2 << 20)
        a.put_bytes(b"C" * 16, payload)
        faults.configure("transfer.send:corrupt-compressed:max=1", seed=8)
        before = mdefs.transfer_checksum_mismatch().get()
        err = _fetch(srv, key, b"C" * 16, b,
                     codecs=codec.available_codecs(),
                     retry=RetryPolicy(max_attempts=3,
                                       base_backoff_s=0.01))
        assert err is None, err
        assert mdefs.transfer_checksum_mismatch().get() == before + 1
        assert _pulled(b, b"C" * 16) == payload
    finally:
        srv.close()


def test_corrupt_compressed_decode_failure_repulls_never_seals(two_stores):
    """With frame verification OFF the poison reaches the decoder: the
    decode failure must take the same loss path (abort the unsealed
    create, re-pull) — garbage is never sealed even without checksums."""
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = _text(2 << 20)  # zlib: the flipped CMF byte must raise
        a.put_bytes(b"D" * 16, payload)
        faults.configure("transfer.send:corrupt-compressed:max=1", seed=9)
        err = _fetch(srv, key, b"D" * 16, b,
                     codecs=(codec.ZLIB,), verify_checksum=False,
                     retry=RetryPolicy(max_attempts=3,
                                       base_backoff_s=0.01))
        assert err is None, err
        assert _pulled(b, b"D" * 16) == payload
    finally:
        srv.close()


def test_corrupt_compressed_is_noop_on_raw_serves(two_stores):
    a, b = two_stores
    key = os.urandom(16)
    srv = TransferServer(a, authkey=key, chunk_size=CHUNK)
    try:
        payload = _text(2 << 20)
        a.put_bytes(b"N" * 16, payload)
        faults.configure("transfer.send:corrupt-compressed:max=1", seed=4)
        err = _fetch(srv, key, b"N" * 16, b)  # no codecs offered
        assert err is None, err
        assert _pulled(b, b"N" * 16) == payload
    finally:
        srv.close()


# --- spill tier --------------------------------------------------------------

def test_compressed_spill_restores_byte_exact():
    cfg = Config(object_store_memory=32 << 20, min_spilling_size=1 << 20,
                 transfer_compression="auto")
    store = NodeObjectStore(f"/rmt_cmpS_{os.getpid()}", cfg, create=True)
    try:
        blobs = {bytes([i]) * 16: _sparse(8 << 20) for i in range(6)}
        for oid, data in blobs.items():  # 48 MB into 32 MB: spills
            store.put_bytes(oid, data)
        assert store.spilled_count() > 0
        spilled = [o for o in blobs if o in store._spilled]
        # the sparse corpus must have spilled under a codec (zrle)
        assert any(store._spill_codec.get(o) for o in spilled)
        for oid in spilled:
            view = store.get(oid)  # restores (verify + decode)
            try:
                assert bytes(view) == blobs[oid]
            finally:
                del view
                store.release(oid)
    finally:
        store.close(unlink=True)


def test_compressed_spill_corruption_caught_on_restore():
    """A byte flipped in a COMPRESSED restore read must fail the
    stored-bytes crc BEFORE the decoder runs and re-read clean — the
    corrupt copy is never decoded into the store."""
    cfg = Config(object_store_memory=32 << 20, min_spilling_size=1 << 20,
                 transfer_compression="auto")
    store = NodeObjectStore(f"/rmt_cmpX_{os.getpid()}", cfg, create=True)
    try:
        blobs = {bytes([i]) * 16: _sparse(8 << 20) for i in range(6)}
        for oid, data in blobs.items():
            store.put_bytes(oid, data)
        assert store.spilled_count() > 0
        oid = next(o for o in store._spilled
                   if store._spill_codec.get(o))
        faults.configure("spill.read:corrupt:max=1", seed=14)
        before = mdefs.spill_errors().get(tags={"op": "checksum"})
        data = store.read(oid)
        assert data is not None and bytes(data) == blobs[oid]
        assert mdefs.spill_errors().get(
            tags={"op": "checksum"}) == before + 1
    finally:
        store.close(unlink=True)
