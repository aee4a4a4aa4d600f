"""Decentralized ownership: worker-owned puts and the borrowed-ref
protocol (the first step of the reference's per-worker ReferenceCounter,
reference_count.h:39-61,139-156).

- A worker's put mints its own id and writes its node store directly —
  ZERO blocking head round trips; the registration is a one-way frame.
- Refs a worker retains past a task (actor state) ship in the done
  reply's borrowed-ref table and hold a head-side pin until the worker
  drops them — the driver freeing its own handle must not pull the
  value out from under the borrower.
- Owned puts whose ids never escaped the worker free outright when the
  owner drops them; escaped ids only drop attribution.

The PyTorch port's copy of ``tests/test_ownership.py``: the same cases
run against ``ray_memory_management_tpu_torch``, with its own fixtures
(the shared conftest starts the JAX package's runtime).
"""

import gc
import time

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt
from _port_fixtures import one_intra_op_thread  # noqa: F401

BIG = 300_000  # floats: ~2.4 MB, comfortably over the inline limit


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def test_worker_put_zero_head_round_trips():
    """put+get of a worker-owned object performs no blocking owner
    round trips and resolves from the local node store."""
    rt = rmt.init(num_cpus=2)
    try:
        @rmt.remote(max_retries=0)
        def put_get_cycle():
            from ray_memory_management_tpu_torch import _worker_context

            proxy = _worker_context.backend()
            before = proxy.head_round_trips
            ref = rmt.put(np.ones(BIG))
            val = rmt.get(ref)
            after = proxy.head_round_trips
            return float(val.sum()), after - before

        total, rts = rmt.get(put_get_cycle.remote(), timeout=120)
        assert total == float(BIG)
        assert rts == 0, f"expected 0 head round trips, saw {rts}"
    finally:
        rmt.shutdown()


def test_borrowed_ref_survives_driver_release():
    """An actor stores a deserialized ref; the driver then drops its own
    handle and forces the free path. The borrow pin from the done
    reply's table must keep the value alive until the actor drops it."""
    rt = rmt.init(num_cpus=2)
    try:
        @rmt.remote(max_restarts=0)
        class Holder:
            def __init__(self):
                self.ref = None

            def hold(self, wrapped):
                self.ref = wrapped[0]
                return "held"

            def read(self):
                return float(rmt.get(self.ref).sum())

            def drop(self):
                self.ref = None
                return "dropped"

        h = Holder.remote()
        ref = rmt.put(np.ones(BIG))
        oid = ref.binary()
        # nested (not top-level) so the ref arrives AS A REF
        assert rmt.get(h.hold.remote([ref]), timeout=60) == "held"
        # the borrow pin is registered by hold()'s done reply
        _wait(lambda: any(oid in s
                          for s in rt._worker_borrows.values()),
              msg="borrow pin")
        del ref
        gc.collect()
        rt._flush_deferred_frees()
        # the driver's handle is gone; without the borrow pin the free
        # path would have dropped the value
        assert rmt.get(h.read.remote(), timeout=60) == float(BIG)
        # actor drops it -> release rides the next done -> pin gone
        assert rmt.get(h.drop.remote(), timeout=60) == "dropped"
    finally:
        rmt.shutdown()


def test_borrow_release_unpins():
    rt = rmt.init(num_cpus=2)
    try:
        @rmt.remote(max_restarts=0)
        class Holder:
            def __init__(self):
                self.ref = None

            def hold(self, wrapped):
                self.ref = wrapped[0]
                return "held"

            def drop(self):
                self.ref = None
                return "dropped"

            def nop(self):
                return "ok"

        h = Holder.remote()
        ref = rmt.put(np.ones(BIG))
        oid = ref.binary()
        rmt.get(h.hold.remote([ref]), timeout=60)
        _wait(lambda: any(oid in s
                          for s in rt._worker_borrows.values()),
              msg="borrow pin")
        rmt.get(h.drop.remote(), timeout=60)
        # the release is buffered worker-side; the next done flushes it
        rmt.get(h.nop.remote(), timeout=60)
        _wait(lambda: not any(oid in s
                              for s in rt._worker_borrows.values()),
              msg="borrow release")
    finally:
        rmt.shutdown()


def test_unescaped_owned_put_freed_on_owner_drop():
    """A put whose ref never leaves the task frees when the frame
    drops — the release rides the same done reply."""
    rt = rmt.init(num_cpus=2)
    try:
        @rmt.remote(max_retries=0)
        def ephemeral_put():
            ref = rmt.put(np.ones(BIG))
            return ref.binary().hex()

        oid = bytes.fromhex(rmt.get(ephemeral_put.remote(), timeout=120))
        head_store = next(iter(rt.nodes.values())).store
        _wait(lambda: not head_store.contains(oid)
              and not rt.gcs.get_object_locations(oid),
              msg="unescaped owned put freed")
    finally:
        rmt.shutdown()


def test_escaped_owned_put_survives_owner_drop():
    """A put RETURNED from the task (id escaped) must survive the
    worker's refs dying: the driver still gets it."""
    rt = rmt.init(num_cpus=2)
    try:
        @rmt.remote(max_retries=0)
        def producer():
            return rmt.put(np.full(BIG, 7.0))

        @rmt.remote(max_retries=0)
        def nop():
            return "ok"

        ref = rmt.get(producer.remote(), timeout=120)  # ref-as-value
        # flush the worker's owned_drop buffer through another done
        assert rmt.get(nop.remote(), timeout=60) == "ok"
        val = rmt.get(ref, timeout=60)
        assert float(val[0]) == 7.0 and len(val) == BIG
    finally:
        rmt.shutdown()
