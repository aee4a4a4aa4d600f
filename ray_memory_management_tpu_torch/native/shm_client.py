"""ctypes client for the native shared-memory object store.

The plasma-client analog (reference: src/ray/object_manager/plasma/client.cc:240
— mmap-cached zero-copy buffer access). Each process opens the store file once
and maps it once; ``get`` returns a memoryview directly into the mapping.
"""

from __future__ import annotations

import contextlib
import ctypes
import mmap
import os
import threading
from typing import List, Optional, Tuple

from .build import lib_path

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(lib_path("shmstore"))
    lib.store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.store_create.restype = ctypes.c_int64
    lib.store_open.argtypes = [ctypes.c_char_p]
    lib.store_open.restype = ctypes.c_int64
    lib.store_close.argtypes = [ctypes.c_int64]
    lib.store_unlink.argtypes = [ctypes.c_char_p]
    lib.store_unlink.restype = ctypes.c_int
    lib.obj_create.argtypes = [ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint64]
    lib.obj_create.restype = ctypes.c_int64
    lib.obj_seal.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.obj_seal.restype = ctypes.c_int
    lib.obj_get.argtypes = [
        ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    lib.obj_get.restype = ctypes.c_int
    lib.obj_release.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.obj_release.restype = ctypes.c_int
    lib.obj_delete.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.obj_delete.restype = ctypes.c_int
    lib.obj_contains.argtypes = [ctypes.c_int64, ctypes.c_char_p]
    lib.obj_contains.restype = ctypes.c_int
    lib.store_usage.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.evict_candidates.argtypes = [
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.evict_candidates.restype = ctypes.c_int
    _lib = lib
    return lib


class ShmStoreFullError(Exception):
    pass


class ShmStoreClosedError(RuntimeError):
    """A store call on a client whose ``close()`` freed its handle."""


def reap_stale_stores(prefix: str) -> None:
    """Unlink /dev/shm segments named ``<prefix><pid>_...`` whose owning
    pid is gone — a SIGKILLed owner cannot unlink its own stores, and
    without this a crash-looping process fills /dev/shm. Called at head
    init (prefix "rmt_") and agent start (prefix "rmtA_")."""
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return
    for name in names:
        if not name.startswith(prefix):
            continue
        try:
            pid = int(name[len(prefix):].split("_")[0])
        except (IndexError, ValueError):
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            try:
                os.unlink(f"/dev/shm/{name}")
            except OSError:
                pass
        except PermissionError:
            pass  # pid alive under another uid


class ShmStore:
    """One named store; open with ``create=True`` exactly once per store."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        # close() frees the C handle under this lock, and every store call
        # takes it: a thread still serving a pull while the store closes
        # gets ShmStoreClosedError, never a call on freed memory. It is
        # reentrant because ``release`` runs from finalizers, which a GC
        # pass may fire at any allocation inside a locked section on the
        # same thread (no C call is in flight there)
        self._lock = threading.RLock()
        self._closed = True  # until the handle and the mapping exist
        lib = _load()
        self.name = name
        if create:
            self.handle = lib.store_create(name.encode(), capacity)
        else:
            self.handle = lib.store_open(name.encode())
        if self.handle < 0:
            raise OSError(f"failed to open shm store {name}: rc={self.handle}")
        # Map the same file for zero-copy python-side access.
        self._file = open(f"/dev/shm{name}", "r+b")
        self._map = mmap.mmap(self._file.fileno(), 0)
        self._mv = memoryview(self._map)
        self._closed = False
        if create and self._prefault_ok(capacity):
            # Pre-fault the arena in the background: first-touch page
            # faults otherwise dominate the first pass of large writes
            # (plasma pre-touches its mmap the same way). 23 is
            # MADV_POPULATE_WRITE (Linux 5.14+), not yet in the mmap
            # module; unsupported kernels just raise and skip.
            def _prefault(m=self._map):
                try:
                    m.madvise(23)
                except (OSError, ValueError):
                    pass

            threading.Thread(target=_prefault, daemon=True,
                             name="shm-prefault").start()

    @staticmethod
    def _prefault_ok(capacity: int) -> bool:
        """Populating dirties the WHOLE arena as resident tmpfs — only do
        it when that commit is clearly affordable (< 1/4 of MemAvailable)
        AND the arena is modest (<= 1 GiB): beyond that the kernel-side
        cost of thousands of worker processes mapping a fully-resident
        multi-GB shared file dominates worker spawn (measured: 2,000 live
        workers spawn at ~90/s against a sparse 3 GiB store but ~30/s
        against a populated one), which is a far worse trade than lazy
        first-touch faults on large writes."""
        if os.environ.get("RMT_DISABLE_PREFAULT"):
            return False
        if (capacity > (1 << 30)
                and not os.environ.get("RMT_FORCE_PREFAULT")):
            # RMT_FORCE_PREFAULT=1 opts a large-store, few-worker
            # deployment (bulk ingest) back into first-touch-free writes
            return False
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        avail_kb = int(line.split()[1])
                        return capacity < (avail_kb << 10) // 4
        except (OSError, ValueError, IndexError):
            pass
        return False

    @contextlib.contextmanager
    def _open(self):
        """The native library, with the lock held, on an open store only:
        ``close()`` cannot free the handle or the mapping meanwhile."""
        with self._lock:
            if self._closed:
                raise ShmStoreClosedError(f"store {self.name} is closed")
            yield _load()

    # -- object lifecycle -----------------------------------------------------
    def create(self, object_id: bytes, size: int) -> memoryview:
        """Allocate; returns a writable view. Seal before readers can get it."""
        with self._open() as lib:
            rc = lib.obj_create(self.handle, object_id, size)
            if rc > 0:
                return self._mv[rc : rc + size]
        if rc == 0:
            raise ShmStoreFullError(
                f"store {self.name} full allocating {size} bytes"
            )
        if rc == -2:
            raise ValueError(f"object {object_id.hex()} already exists")
        raise OSError(f"obj_create failed rc={rc}")

    def seal(self, object_id: bytes) -> None:
        with self._open() as lib:
            rc = lib.obj_seal(self.handle, object_id)
        if rc != 0:
            raise OSError(f"seal({object_id.hex()}) failed rc={rc}")

    def get(self, object_id: bytes, inc_ref: bool = True) -> Optional[memoryview]:
        """Zero-copy read view of a sealed object, or None if absent."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        with self._open() as lib:
            rc = lib.obj_get(
                self.handle, object_id, ctypes.byref(off), ctypes.byref(size),
                1 if inc_ref else 0,
            )
            if rc == -1:
                return None
            if rc == -2:
                return None  # created but unsealed: not visible yet
            return self._mv[off.value : off.value + size.value]

    def release(self, object_id: bytes) -> None:
        """Drop a reference; a no-op once the store is closed (finalizers
        and serving threads release after shutdown)."""
        with self._lock:
            if not self._closed:
                _load().obj_release(self.handle, object_id)

    def delete(self, object_id: bytes) -> bool:
        """True if freed; False while readers still hold references."""
        with self._open() as lib:
            return lib.obj_delete(self.handle, object_id) == 0

    def contains(self, object_id: bytes) -> bool:
        with self._open() as lib:
            return lib.obj_contains(self.handle, object_id) == 1

    # -- store-level ----------------------------------------------------------
    def usage(self) -> Tuple[int, int, int]:
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        n = ctypes.c_uint64()
        with self._open() as lib:
            lib.store_usage(
                self.handle, ctypes.byref(used), ctypes.byref(cap),
                ctypes.byref(n)
            )
        return used.value, cap.value, n.value

    def evict_candidates(self, need_bytes: int, max_out: int = 256) -> List[bytes]:
        buf = ctypes.create_string_buffer(16 * max_out)
        with self._open() as lib:
            n = lib.evict_candidates(self.handle, need_bytes, buf, max_out)
        return [buf.raw[16 * i : 16 * (i + 1)] for i in range(max(n, 0))]

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            _load().store_close(self.handle)
            try:
                self._mv.release()
                self._map.close()
            except BufferError:
                # Zero-copy views handed to callers are still alive; the
                # mapping stays until they are garbage-collected (the
                # reference's client mmap cache has the same lifetime
                # behavior, plasma/client.cc:240).
                pass
            self._file.close()

    @staticmethod
    def unlink(name: str) -> None:
        _load().store_unlink(name.encode())

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
