"""Unit tests for the substrate: IDs, config, serialization, native store.

(reference: C++ gtest coverage of common/ and plasma/, e.g.
src/ray/object_manager/plasma/test/ and src/ray/common tests.)

The PyTorch port's copy of ``tests/test_substrate.py``: the same cases
run against ``ray_memory_management_tpu_torch``, with its own fixtures
(the shared conftest starts the JAX package's runtime), with the
jax.Array round trip held by a CPU tensor made from the same numpy
values.
"""

import os

import numpy as np
import pytest

from ray_memory_management_tpu_torch import serialization as ser
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core.resources import (
    NodeResources, Resources, task_resources,
)
from ray_memory_management_tpu_torch.ids import JobID, NodeID, ObjectID, TaskID
from ray_memory_management_tpu_torch.native import ShmStore, ShmStoreFullError
from _port_fixtures import one_intra_op_thread  # noqa: F401


# --------------------------------------------------------------------- ids
def test_return_object_id_embeds_lineage():
    job = JobID.from_random()
    t = TaskID.for_task(job)
    o = ObjectID.for_return(t, 7)
    assert o.task_id() == t
    assert o.return_index() == 7


def test_id_value_semantics():
    a = NodeID.from_random()
    b = NodeID(a.binary())
    assert a == b and hash(a) == hash(b)
    assert a != NodeID.from_random()
    import pickle

    assert pickle.loads(pickle.dumps(a)) == a


# ------------------------------------------------------------------ config
def test_config_defaults_and_env_override(monkeypatch):
    cfg = Config()
    assert cfg.max_direct_call_object_size == 100 * 1024
    monkeypatch.setenv("RMT_max_direct_call_object_size", "12345")
    assert Config().max_direct_call_object_size == 12345
    with pytest.raises(ValueError):
        Config(no_such_flag=1)


# --------------------------------------------------------------- resources
def test_fixed_point_resources_no_drift():
    r = Resources({"CPU": 0.1})
    acc = Resources({})
    for _ in range(10):
        acc = acc + r
    assert acc.get("CPU") == 1.0
    total = Resources({"CPU": 1.0})
    assert acc.fits_in(total)


def test_node_resources_utilization():
    nr = NodeResources(task_resources(num_cpus=4, num_gpus=4))
    assert nr.utilization() == 0.0
    nr.allocate(Resources({"CPU": 2}))
    assert nr.utilization() == 0.5
    nr.free(Resources({"CPU": 2}))
    assert nr.utilization() == 0.0


# ----------------------------------------------------------- serialization
def test_roundtrip_plain_values():
    for v in [None, 1, "s", [1, 2], {"a": (1, 2)}, b"bytes"]:
        assert ser.loads(ser.dumps(v)) == v


def test_roundtrip_numpy_zero_copy():
    arr = np.arange(100_000, dtype=np.int64)
    data = ser.dumps({"a": arr})
    out = ser.loads(memoryview(data))
    assert np.array_equal(out["a"], arr)
    assert out["a"].base is not None  # zero-copy view


def test_bulk_array_stream_cache_is_exact():
    """The memoized pickle stream for plain bulk ndarrays (the bulk-put
    hot path) must byte-match a fresh pickler run for every cached
    layout — C/F order, writeable/readonly — and round-trip with the
    values intact."""
    ser._ARRAY_STREAM_CACHE.clear()
    variants = []
    base = np.arange(ser._ARRAY_CACHE_MIN_BYTES // 8 * 2,
                     dtype=np.float64).reshape(2, -1)
    variants.append(base.copy())                       # C contiguous
    variants.append(np.asfortranarray(base.copy()))    # F contiguous
    ro = base.copy()
    ro.setflags(write=False)
    variants.append(ro)                                # readonly
    for arr in variants:
        first = ser.serialize(arr)          # miss: populates the cache
        cached = ser.serialize(arr)         # hit: memoized stream
        assert cached._pickled == first._pickled
        assert cached.total_size == first.total_size
        out = ser.loads(memoryview(cached.to_bytes()))
        np.testing.assert_array_equal(out, arr)
        # different VALUES, same layout: the hit must carry the new data
        arr2 = arr * 0 + 7.0 if arr.flags.writeable else base + 7.0
        out2 = ser.loads(memoryview(ser.serialize(arr2).to_bytes()))
        np.testing.assert_array_equal(out2, arr2)


def test_on_release_fires_when_views_die():
    released = []
    arr = np.ones(1000)
    data = ser.dumps(arr)
    out = ser.deserialize(memoryview(data),
                          on_release=lambda: released.append(1))
    assert not released
    del out
    assert released == [1]


def test_on_release_immediate_without_buffers():
    released = []
    data = ser.dumps({"x": 1})
    ser.deserialize(memoryview(data), on_release=lambda: released.append(1))
    assert released == [1]


def test_tensor_roundtrip():
    import torch

    v = ser.loads(ser.dumps({"j": np.ones((4, 4))}))
    assert np.array_equal(v["j"], np.ones((4, 4)))
    j = torch.from_numpy(np.ones((2, 2)))
    out = ser.loads(ser.dumps(j))
    assert isinstance(out, torch.Tensor)
    assert np.array_equal(out.numpy(), np.ones((2, 2)))


# ------------------------------------------------------------ native store
@pytest.fixture
def store():
    name = f"/rmt_test_{os.getpid()}"
    try:
        ShmStore.unlink(name)
    except Exception:
        pass
    s = ShmStore(name, 32 << 20, create=True)
    yield s
    s.close()
    ShmStore.unlink(name)


def test_store_create_seal_get(store):
    oid = os.urandom(16)
    buf = store.create(oid, 100)
    buf[:] = b"z" * 100
    assert store.get(oid) is None or not store.contains(oid) or True
    store.seal(oid)
    v = store.get(oid)
    assert bytes(v) == b"z" * 100
    store.release(oid)
    del v, buf


def test_store_unsealed_not_visible(store):
    oid = os.urandom(16)
    store.create(oid, 10)
    assert store.get(oid) is None
    assert not store.contains(oid)


def test_store_refcount_blocks_delete(store):
    oid = os.urandom(16)
    b = store.create(oid, 10)
    del b
    store.seal(oid)
    v = store.get(oid)
    assert not store.delete(oid)
    store.release(oid)
    del v
    assert store.delete(oid)


def test_store_full_and_eviction_candidates(store):
    ids = []
    for _ in range(10):
        oid = os.urandom(16)
        ids.append(oid)
        b = store.create(oid, 1 << 20)
        del b
        store.seal(oid)
    with pytest.raises(ShmStoreFullError):
        store.create(os.urandom(16), 64 << 20)
    cands = store.evict_candidates(3 << 20)
    assert cands and all(c in ids for c in cands)
    # LRU order: first-created objects come first
    assert cands[0] == ids[0]


def test_store_usage_returns_to_zero(store):
    oid = os.urandom(16)
    b = store.create(oid, 1 << 20)
    del b
    store.seal(oid)
    used, cap, n = store.usage()
    assert used == 1 << 20 and n == 1
    store.delete(oid)
    used, cap, n = store.usage()
    assert used == 0 and n == 0


def test_store_cross_handle_visibility(store):
    other = ShmStore(store.name)
    oid = os.urandom(16)
    buf = store.create(oid, 64)
    buf[:] = bytes(range(64))
    store.seal(oid)
    v = other.get(oid)
    assert bytes(v) == bytes(range(64))
    other.release(oid)
    del v, buf
    other.close()
