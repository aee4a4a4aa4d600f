"""Device object store: the device-memory tier of the object plane.

Counterpart of ``core/device_store.py`` in the JAX package. A device
object is a live ``torch.Tensor`` pinned by the process that produced it
(CUDA memory has no cross-process mmap analog, so device objects are
process-local by construction). Same-process readers get the tensor
back without a copy; :meth:`DeviceObjectStore.take` is the last-reader
read: the store drops its reference, so the caller then holds the sole
one and may update the tensor in place (the torch reading of JAX's
buffer donation).

This slice ports the pin table only. Demotion to the host tier
(``set_demoter``, LRU eviction over a byte budget) and
``resolve_capacity`` need the host object store and wait for the
device-tier slice: the one mode used here is ``capacity_bytes=-1``
(unbounded, nothing evicted), which the serve engine's KV page pool runs
with because it enforces its budget by page accounting.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional


class _Entry:
    __slots__ = ("array", "nbytes", "pins")

    def __init__(self, array: Any, nbytes: int):
        self.array = array
        self.nbytes = nbytes
        self.pins = 0


def _entry_nbytes(array: Any) -> int:
    try:
        return int(array.nbytes)
    except (AttributeError, TypeError):
        return 0


class DeviceObjectStore:
    """Process-local refcounted pin table over device tensors."""

    def __init__(self, capacity_bytes: int = -1):
        if int(capacity_bytes) >= 0:
            raise NotImplementedError(
                "a bounded device tier needs demotion to the host store, "
                "which the port does not have yet; use capacity_bytes=-1")
        self._lock = threading.Lock()
        # MRU at the end: get() keeps recency as the JAX store does
        self._objects: "OrderedDict[bytes, _Entry]" = OrderedDict()  # guarded-by: _lock
        self._total = 0  # guarded-by: _lock
        self._bytes_avoided = 0  # guarded-by: _lock
        self.capacity_bytes = int(capacity_bytes)

    # -- core tier operations -------------------------------------------------
    def put(self, object_id: bytes, array: Any) -> List[bytes]:
        """Pin a tensor; returns the oids demoted to make room (always
        empty: this store never evicts)."""
        n = _entry_nbytes(array)
        with self._lock:
            prev = self._objects.pop(object_id, None)
            if prev is not None:
                self._total -= prev.nbytes
            self._objects[object_id] = _Entry(array, n)
            self._total += n
        return []

    def get(self, object_id: bytes) -> Optional[Any]:
        """Zero-copy read of the live tensor; bumps LRU recency."""
        with self._lock:
            entry = self._objects.get(object_id)
            if entry is None:
                return None
            self._objects.move_to_end(object_id)
            self._bytes_avoided += entry.nbytes
            return entry.array

    def take(self, object_id: bytes) -> Optional[Any]:
        """Consume: remove the entry and hand the caller the live tensor.
        The object is no longer readable through this store afterwards."""
        with self._lock:
            entry = self._objects.pop(object_id, None)
            if entry is None:
                return None
            self._total -= entry.nbytes
            array = entry.array
            entry.array = None
        return array

    # -- refcount pinning ------------------------------------------------------
    def pin(self, object_id: bytes) -> bool:
        """Make an entry ineligible for demotion."""
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

    # -- introspection ---------------------------------------------------------
    def contains(self, object_id: bytes) -> bool:
        with self._lock:
            return object_id in self._objects

    def delete(self, object_id: bytes) -> None:
        with self._lock:
            entry = self._objects.pop(object_id, None)
            if entry is not None:
                self._total -= entry.nbytes

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "objects": len(self._objects),
                "bytes": self._total,
                "pinned": sum(1 for e in self._objects.values() if e.pins),
                "capacity_bytes": self.capacity_bytes,
                "bytes_avoided": self._bytes_avoided,
            }

