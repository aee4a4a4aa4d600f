"""Multi-destination distribution tree (runtime broadcast gate).

When one object resolves to many destinations, the head's broadcast gate
(`_broadcast_admit`) caps concurrent pulls per holder; waiters resume
after an earlier copy lands and pull from the NEW holder. The source must
not serve every destination — that is the O(n·size) egress the gate
removes. (The point-to-point mechanics live in test_transfer.py; this
covers the head-side source-selection/gating layer over virtual nodes.)

The PyTorch port's copy of ``tests/test_broadcast_tree.py``: the same
cases run against ``ray_memory_management_tpu_torch``.
"""

import os
import threading

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.config import Config


N_DESTS = 6


@pytest.fixture
def rmt_many_nodes():
    cfg = Config(object_store_memory=64 << 20,
                 transfer_broadcast_fanout=1)
    rt = rmt.init(num_cpus=2, _config=cfg)
    yield rt
    rmt.shutdown()


def test_broadcast_does_not_serialize_on_source(rmt_many_nodes):
    rt = rmt_many_nodes
    src = rt.head_node().node_id
    dests = [rt.add_node({"num_cpus": 1}) for _ in range(N_DESTS)]

    oid = os.urandom(16)
    payload = os.urandom(4 << 20)
    rt.nodes[src].store.put_bytes(oid, payload)
    rt.gcs.add_object_location(oid, src)

    errors = []

    def pull(dst):
        try:
            rt._transfer_from(oid, [src], dst)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=pull, args=(d,)) for d in dests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors

    for d in dests:
        assert rt.nodes[d].store.contains(oid)
    assert rt.gcs.get_object_locations(oid) >= set(dests) | {src}

    # the tree property: with fanout=1 the source serves ONE copy at a
    # time and later pulls go to the new holders — total source egress
    # stays well under destination count (naive broadcast = N_DESTS)
    served = rt._xfer_served_total
    assert served.get(src, 0) < N_DESTS, served
    assert len(served) >= 2, served  # later pulls used other holders


def test_fanout_zero_disables_gate(rmt_many_nodes):
    """transfer_broadcast_fanout=0 must admit every pull immediately
    (the pre-gate behavior) — no waiting, no counters left behind."""
    rt = rmt_many_nodes
    rt.config.transfer_broadcast_fanout = 0
    src = rt.head_node().node_id
    dst = rt.add_node({"num_cpus": 1})

    oid = os.urandom(16)
    rt.nodes[src].store.put_bytes(oid, b"x" * 1024)
    rt.gcs.add_object_location(oid, src)
    rt._transfer_from(oid, [src], dst)
    assert rt.nodes[dst].store.contains(oid)
    assert not rt._oid_pulls  # gate bookkeeping fully drained
