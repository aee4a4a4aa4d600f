"""Two faults of the port's plumbing, repaired, and the tests that show it.

- ``native/shm_client.py``: ``close()`` freed the C handle while other
  threads could still call into it (a transfer thread serving a pull as
  its runtime shut down segfaulted the process). Every store call now
  takes the client's lock and raises ``ShmStoreClosedError`` on a closed
  client; ``release`` is a no-op there. Shown by threads that hammer
  ``get``/``release``/``contains`` while the main thread closes. The lock
  is reentrant: ``release`` runs from finalizers, which a GC pass fires
  at any allocation, also inside a call that holds the lock.
- ``utils/local_world.py``: a ``run`` that missed its deadline left the
  ranks stuck in a collective, and every later ``run`` waited its whole
  deadline again. Now a missed deadline (or a dead rank) terminates the
  ranks and breaks the world, and every later ``run`` raises at once.
"""

import gc
import os
import sys
import threading
import time
import weakref

import pytest

from ray_memory_management_tpu_torch.native.shm_client import (
    ShmStore,
    ShmStoreClosedError,
)
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld


ROUNDS = 20  # without the lock, about one round in three segfaulted


def _race_once(name):
    """Eight threads hammer a store's calls while this thread closes it.
    Returns the closed store and what each thread ended with."""
    store = ShmStore(name, 8 << 20, create=True)
    oids = [os.urandom(16) for _ in range(8)]
    for oid in oids:
        store.create(oid, 64)[:] = b"x" * 64
        store.seal(oid)
    outcomes, started = [], threading.Barrier(len(oids) + 1)

    def hammer(oid):
        started.wait(10)
        calls = 0
        try:
            while True:
                view = store.get(oid)
                if view is not None:
                    store.release(oid)
                store.contains(oid)
                store.usage()
                calls += 1
        except ShmStoreClosedError:
            outcomes.append(("closed", calls))
        except BaseException as e:  # noqa: BLE001 — the test reports it
            outcomes.append(("error", repr(e)))

    threads = [threading.Thread(target=hammer, args=(oid,))
               for oid in oids]
    for t in threads:
        t.start()
    started.wait(10)
    time.sleep(0.05)
    store.close()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    return store, oids, outcomes


def test_close_racing_store_calls_raises_and_never_touches_a_freed_handle():
    name = f"/rmt_race_{os.getpid()}"
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(ROUNDS):
            try:
                store, oids, outcomes = _race_once(name)
            finally:
                ShmStore.unlink(name)
            assert len(outcomes) == len(oids)
            assert all(kind == "closed" for kind, _ in outcomes), outcomes
    finally:
        sys.setswitchinterval(old)
    store.release(oids[0])  # finalizers release after close: a no-op
    for call in (lambda: store.get(oids[0]), lambda: store.contains(oids[0]),
                 lambda: store.delete(oids[0]), store.usage,
                 lambda: store.create(os.urandom(16), 8)):
        with pytest.raises(ShmStoreClosedError):
            call()
    store.close()  # idempotent


class _CollectingView:
    """A store's mapping that runs a GC pass where the store allocates
    under its lock: the slice ``get`` returns, and ``close()``'s release
    of the mapping (which raises ``BufferError`` while views live)."""

    def __init__(self, mv):
        self.mv = mv

    def __getitem__(self, key):
        gc.collect()
        return self.mv[key]

    def release(self):
        gc.collect()
        self.mv.release()


class _Cycle:
    def __init__(self):
        self.me = self  # freed by the cycle collector only


@pytest.mark.parametrize("call", ["get", "close"])
def test_a_finalizer_releasing_inside_a_locked_store_call_does_not_hang(
        call):
    """A ``weakref.finalize`` callback that calls ``release`` (as the
    object store's do) fires from a GC pass inside a store call that
    holds the lock, on the same thread: the call finishes, the release
    takes effect (or is a no-op on a closing store), and nothing hangs."""
    name = f"/rmt_fin_{os.getpid()}_{call}"
    store = ShmStore(name, 8 << 20, create=True)
    try:
        oid = os.urandom(16)
        store.create(oid, 64)[:] = b"x" * 64
        store.seal(oid)
        view = store.get(oid)  # a reference the finalizer drops
        fired = []

        def on_release(oid=oid):
            store.release(oid)
            fired.append(threading.get_ident())

        gc.collect()
        weakref.finalize(_Cycle(), on_release)  # garbage from here on
        mv, store._mv = store._mv, _CollectingView(store._mv)
        done = []
        worker = threading.Thread(
            target=lambda: done.append(store.get(oid) if call == "get"
                                       else store.close()),
            daemon=True)
        worker.start()
        worker.join(10)
        assert not worker.is_alive(), (
            f"release from a finalizer inside {call}() deadlocked")
        assert fired == [worker.ident]
        if call == "get":
            store._mv = mv
            assert done[0] is not None and bytes(done[0]) == b"x" * 64
            del done, view
            # the finalizer dropped one of the two references taken
            store.release(oid)
            assert store.delete(oid)
            store.close()
        else:
            assert store._closed
            del view
    finally:
        ShmStore.unlink(name)


def _deadlock(rank, world):
    """Rank 0 waits in an all-reduce the other ranks never join."""
    import torch
    import torch.distributed as dist

    if rank == 0:
        dist.all_reduce(torch.ones(1))
    return rank


def _ranks(rank, world):
    return rank


def test_a_deadlocked_run_breaks_the_world_within_its_deadline():
    with LocalWorld(2, timeout_s=5) as world:
        assert world.run(_ranks) == [0, 1]
        procs = list(world._procs)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="timed out"):
            world.run(_deadlock)
        assert time.monotonic() - t0 < 5 + 15  # deadline + terminating
        assert not any(p.is_alive() for p in procs)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="broken.*timed out"):
            world.run(_ranks)
        assert time.monotonic() - t0 < 1


def _refuse(rank, world):
    raise ValueError(f"rank {rank} refuses")


def _die_on_1(rank, world):
    if rank == 1:
        os._exit(3)
    return rank


def test_a_failure_on_every_rank_keeps_the_world_and_a_death_breaks_it():
    """A function that raises on every rank is an error, not a broken
    world; a rank that dies breaks it."""
    with LocalWorld(2, timeout_s=30) as world:
        with pytest.raises(RuntimeError, match="refuses"):
            world.run(_refuse)
        assert world.run(_ranks) == [0, 1]
        with pytest.raises(RuntimeError, match="rank 1 died"):
            world.run(_die_on_1)
        with pytest.raises(RuntimeError, match="broken.*died"):
            world.run(_ranks)
