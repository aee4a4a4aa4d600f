"""Device object store: a first-class device-memory tier of the object
plane.

The north-star capability ("ObjectRefs pinned in device memory"): the
reference's plasma store is host-shm only, so this is net-new, designed
per SURVEY.md §7, with CUDA memory in the place of TPU HBM:

  - PyTorch's caching allocator owns device memory: a device object IS a
    live ``torch.Tensor`` pinned by the process that produced it. CUDA
    memory has no cross-process mmap analog here, so device objects are
    process-local by construction; the process is the natural ownership
    unit.
  - Same-process consumers get the tensor back zero-copy (actor-to-actor
    handoff without leaving the card); a ``consume=True`` last-reader
    get TAKES the entry, so the caller holds the sole reference and may
    update the tensor in place (the torch reading of buffer donation).
  - The tier has a budget (``device_store_capacity_bytes``): putting
    past it demotes least-recently-used UNPINNED entries to the host
    shm tier through a caller-supplied demote callback (the existing
    NodeObjectStore create/seal path, optionally bf16-downcast via the
    codec quantize envelopes); the spill plane takes over below shm.
    device → host shm → spill, each tier evicting into the next.
  - Cross-process consumers trigger on-demand materialization: the
    owning process copies device→host and writes the serialized value
    into its node's shm store, after which the normal object plane
    takes over. The device copy stays pinned for local readers until
    budget pressure or the ref count drops it.
  - A dead owner process loses its device objects; recovery is lineage
    re-execution, same as any lost object.

Observability: every resident/pinned-bytes change lands in the
``rmt_device_objects_pinned`` / ``rmt_device_bytes_pinned`` gauges,
one series per process (``node_id``, ``pid``; the sum over the
process's stores, a serve replica's KV pool included), so the head's
merge of every worker's gauges keeps each process's tier instead of the
last writer's; zero-copy reads bump ``rmt_device_zero_copy_hits_total``, demotions
bump ``rmt_device_evictions_total{to_tier}``; the demotion path carries
the injectable ``device.evict`` fault site (an injected error DEFERS
the eviction — the object stays resident and readable; pressure causes
slowness, never loss).
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import events, faults


def is_device_array(value: Any) -> bool:
    """True for a torch.Tensor (CPU tensors also benefit from zero-copy
    process-local pinning). One shared detector with the serializer so
    the put and serialize paths always agree."""
    from ..serialization import _is_tensor

    return _is_tensor(value)


def resolve_capacity(config) -> int:
    """Device-tier budget in bytes for this process. Explicit flag wins;
    0 = auto from the card's memory (60% of the current device's total
    — the rest belongs to the program's own compute), read ONLY when
    CUDA is already initialized in this process: a worker sizes its
    tier at start-up, before its GPU lease arrives, and initializing
    CUDA then would pin it to ``CUDA_VISIBLE_DEVICES=""`` for life.
    Otherwise 1 GiB (CPU tensors in tier-1). Negative disables eviction
    (unbounded pinning)."""
    import sys

    cap = int(getattr(config, "device_store_capacity_bytes", 0) or 0)
    if cap:
        return cap
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        _free, total = torch.cuda.mem_get_info()
        return int(total * 0.6)
    return 1 << 30


class _Entry:
    __slots__ = ("array", "nbytes", "pins")

    def __init__(self, array: Any, nbytes: int):
        self.array = array
        self.nbytes = nbytes
        self.pins = 0


def _entry_nbytes(array: Any) -> int:
    try:
        return int(array.nbytes)
    except Exception:  # noqa: BLE001
        return 0


# every device store of this process: the gauges report their sum
_LIVE_STORES: "weakref.WeakSet" = weakref.WeakSet()


def _process_tags() -> Dict[str, str]:
    """The device gauges' tags: this process's node (a worker's
    ``RMT_NODE_ID``; the driver's head node) and pid."""
    node = os.environ.get("RMT_NODE_ID")
    if node is None:
        from .. import _worker_context

        rt = _worker_context.get_runtime()
        node = rt.head_node().node_id.hex() if rt is not None else ""
    return {"node_id": node, "pid": str(os.getpid())}


class DeviceObjectStore:
    """Process-local refcounted device pin table with LRU demotion.

    ``on_demote(oid, array) -> bool`` writes the host copy (node-store
    create/seal) and returns True on success; it runs OUTSIDE the store
    lock (serialization + shm writes must never convoy readers). A
    failed or faulted demotion re-inserts the entry at the cold end —
    eviction is deferred, never lossy.
    """

    def __init__(self, capacity_bytes: int = -1,
                 on_demote: Optional[Callable[[bytes, Any], bool]] = None):
        self._lock = threading.Lock()
        # MRU at the end; OrderedDict gives O(1) LRU via move_to_end
        self._objects: "OrderedDict[bytes, _Entry]" = OrderedDict()  # guarded-by: _lock
        self._total = 0  # guarded-by: _lock
        self._bytes_avoided = 0  # guarded-by: _lock
        self.capacity_bytes = int(capacity_bytes)
        self._on_demote = on_demote
        self._victim_rank: Optional[Callable[[bytes], int]] = None
        _LIVE_STORES.add(self)

    # -- configuration --------------------------------------------------------
    def set_demoter(self, on_demote: Callable[[bytes, Any], bool],
                    capacity_bytes: Optional[int] = None) -> None:
        self._on_demote = on_demote
        if capacity_bytes is not None:
            self.capacity_bytes = int(capacity_bytes)

    def set_victim_rank(self,
                        rank: Optional[Callable[[bytes], int]]) -> None:
        """Optional job-aware demotion order: ``rank(oid)`` returns a
        sort key and LOWER demotes first (the runtime passes the owning
        job's priority, so a low-priority tenant's cold pins leave the card
        before a high-priority tenant's, with plain LRU breaking ties
        within one rank). None restores pure LRU."""
        self._victim_rank = rank

    # -- core tier operations -------------------------------------------------
    def put(self, object_id: bytes, array: Any) -> List[bytes]:
        """Pin an array; returns the oids demoted to make room (empty
        when under budget, eviction is disabled, or nothing was
        evictable)."""
        n = _entry_nbytes(array)
        with self._lock:
            prev = self._objects.pop(object_id, None)
            if prev is not None:
                self._total -= prev.nbytes
            self._objects[object_id] = _Entry(array, n)
            self._total += n
        demoted = self._evict_over_budget(keep=object_id)
        self._publish_gauges()
        return demoted

    def get(self, object_id: bytes) -> Optional[Any]:
        """Zero-copy read of the live array; bumps LRU recency and the
        zero-copy counters."""
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is None:
                return None
            self._objects.move_to_end(object_id)
            self._bytes_avoided += entry.nbytes
            array = entry.array
        try:
            from . import metrics_defs as mdefs

            mdefs.device_zero_copy_hits().inc()
        except Exception:  # noqa: BLE001 — metrics never fail a read
            pass
        return array

    def take(self, object_id: bytes) -> Optional[Any]:
        """Consume: remove the entry and hand the caller the live array
        (the last-reader donation path — the store drops its reference
        so the consumer holds the sole one and may update it in place). The
        object is no longer readable through this store afterwards."""
        with self._lock:
            entry = self._objects.pop(object_id, None)
            if entry is None:
                return None
            self._total -= entry.nbytes
            array = entry.array
            entry.array = None
        self._publish_gauges()
        return array

    # -- refcount pinning ------------------------------------------------------
    def pin(self, object_id: bytes) -> bool:
        """Make an entry ineligible for demotion (a reader holding the
        live buffer across a demotion would see it vanish mid-use)."""
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is None:
                return False
            entry.pins += 1
            return True

    def unpin(self, object_id: bytes) -> None:
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is not None and entry.pins > 0:
                entry.pins -= 1

    def pin_count(self, object_id: bytes) -> int:
        with self._lock:
            entry = self._objects.get(object_id)
            return entry.pins if entry is not None else 0

    # -- eviction --------------------------------------------------------------
    def _evict_over_budget(self, keep: Optional[bytes] = None) -> List[bytes]:
        """Demote LRU unpinned entries until the tier fits its budget.
        Victims are chosen and unlinked under the lock, but demotion IO
        (serialize + host-store write) runs outside it."""
        if self.capacity_bytes < 0 or self._on_demote is None:
            return []
        rank = self._victim_rank
        order: Optional[Dict[bytes, int]] = None
        if rank is not None:
            with self._lock:
                cands = [oid for oid, e in self._objects.items()
                         if e.pins == 0 and oid != keep]
            # ranks resolve OUTSIDE the store lock: the callback reads
            # runtime/GCS state, and nesting those locks under this one
            # would invert the runtime -> store lock order
            order = {}
            for oid in cands:
                try:
                    order[oid] = rank(oid)
                except Exception:  # noqa: BLE001 — rank is advisory
                    order[oid] = 1 << 62
        victims: List[Tuple[bytes, _Entry]] = []
        with self._lock:
            if self._total <= self.capacity_bytes:
                return []
            walk = list(self._objects)
            if order is not None:
                # stable sort: LRU order survives within one rank tier;
                # entries added since the snapshot demote last
                walk.sort(key=lambda o: order.get(o, 1 << 62))
            for oid in walk:
                if self._total <= self.capacity_bytes:
                    break
                entry = self._objects[oid]
                if entry.pins > 0 or oid == keep:
                    continue
                del self._objects[oid]
                self._total -= entry.nbytes
                victims.append((oid, entry))
        demoted: List[bytes] = []
        for oid, entry in victims:
            if self._demote_one(oid, entry):
                demoted.append(oid)
            else:
                # deferred, not lost: back in at the cold end so the
                # next put retries it first
                with self._lock:
                    self._objects[oid] = entry
                    self._objects.move_to_end(oid, last=False)
                    self._total += entry.nbytes
        return demoted

    def _demote_one(self, oid: bytes, entry: _Entry) -> bool:
        act = faults.fire("device.evict")
        if act is not None:
            if act.mode == "stall":
                act.sleep()
            elif act.mode in ("error", "drop"):
                events.emit(
                    "DEVICE_EVICT_DEFERRED",
                    f"demotion of {oid.hex()[:12]} deferred by injected "
                    f"{act.mode}", severity=events.WARNING,
                    source="device_store")
                return False
        try:
            ok = bool(self._on_demote(oid, entry.array))
        except Exception as e:  # noqa: BLE001 — demotion IO must not lose data
            events.emit(
                "DEVICE_EVICT_DEFERRED",
                f"demotion of {oid.hex()[:12]} failed ({e!r}); object "
                "stays device-resident", severity=events.WARNING,
                source="device_store")
            return False
        if ok:
            try:
                from . import metrics_defs as mdefs

                mdefs.device_evictions().inc(tags={"to_tier": "shm"})
            except Exception:  # noqa: BLE001
                pass
        return ok

    # -- introspection ---------------------------------------------------------
    def contains(self, object_id: bytes) -> bool:
        with self._lock:
            return object_id in self._objects

    def delete(self, object_id: bytes) -> None:
        with self._lock:
            entry = self._objects.pop(object_id, None)
            if entry is not None:
                self._total -= entry.nbytes
        self._publish_gauges()

    def ids(self) -> List[bytes]:
        with self._lock:
            return list(self._objects)

    def nbytes(self, object_id: bytes) -> Optional[int]:
        with self._lock:
            entry = self._objects.get(object_id)
            return entry.nbytes if entry is not None else None

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def count(self) -> int:
        with self._lock:
            return len(self._objects)

    def bytes_avoided(self) -> int:
        """Serialization/copy bytes the zero-copy path never paid (one
        full payload per zero-copy read)."""
        with self._lock:
            return self._bytes_avoided

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "objects": len(self._objects),
                "bytes": self._total,
                "pinned": sum(1 for e in self._objects.values() if e.pins),
                "capacity_bytes": self.capacity_bytes,
                "bytes_avoided": self._bytes_avoided,
            }

    def clear(self) -> None:
        with self._lock:
            self._objects.clear()
            self._total = 0
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        try:
            from . import metrics_defs as mdefs

            count = total = 0
            for store in list(_LIVE_STORES):
                with store._lock:
                    count += len(store._objects)
                    total += store._total
            tags = _process_tags()
            mdefs.device_objects_pinned().set(float(count), tags=tags)
            mdefs.device_bytes_pinned().set(float(total), tags=tags)
        except Exception:  # noqa: BLE001 — gauges never fail the data path
            pass
