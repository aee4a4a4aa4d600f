"""Paged KV-cache page pool for the serve engine.

Counterpart of ``serve/kv_cache.py`` in the JAX package. A slot's KV rows
are allocated in pages of ``kv_page_tokens`` positions from a
per-replica pool and held as pinned device objects in a dedicated
:class:`~..core.device_store.DeviceObjectStore`:

  - :meth:`KVPagePool.reserve` claims the pages a request's whole
    lifetime needs (prompt + token budget, page-aligned) at admission; a
    ``False`` return is the engine's backpressure signal. The pool never
    overcommits, so decode cannot hit an allocation failure mid-request.
  - :meth:`KVPagePool.put_row` / :meth:`KVPagePool.take_row` move a
    slot's live KV tensors in and out of the store between engine
    iterations; ``take_row`` consumes them, so the engine holds the sole
    reference while it updates its working slab.
  - :meth:`KVPagePool.free` at retire drops the slot's KV objects and
    returns its pages: device memory held by a replica's cache scales
    with live tokens, not with ``max_slots x max_seq``.

The budget is enforced by page accounting, not by store eviction.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..core.device_store import DeviceObjectStore


def row_token_bytes(cfg) -> int:
    """Device bytes one KV position of one slot occupies (k + v across
    all layers)."""
    itemsize = cfg.dtype.itemsize
    return 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * itemsize


class KVPagePool:
    """Page-granular KV allocator over a device-object store.

    ``pool_bytes <= 0`` sizes the pool to the monolithic slab it
    replaces (``max_slots x max_seq`` positions)."""

    def __init__(self, cfg, max_slots: int, page_tokens: int,
                 pool_bytes: int = 0):
        self.cfg = cfg
        self.page_tokens = max(1, int(page_tokens))
        self.token_bytes = row_token_bytes(cfg)
        self.page_bytes = self.page_tokens * self.token_bytes
        if pool_bytes and pool_bytes > 0:
            budget = int(pool_bytes)
        else:
            budget = max_slots * cfg.max_seq * self.token_bytes
        self.capacity_pages = max(1, budget // self.page_bytes)
        self.store = DeviceObjectStore(capacity_bytes=-1)
        self._lock = threading.Lock()
        self._row_pages: Dict[int, int] = {}  # guarded-by: _lock

    # -- accounting -----------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return max(1, -(-int(tokens) // self.page_tokens))

    def round_tokens(self, tokens: int) -> int:
        """Page-align a token count (a slot's reserved KV capacity)."""
        return self.pages_for(tokens) * self.page_tokens

    def reserve(self, row: int, tokens: int) -> bool:
        """Claim the pages ``row`` needs for ``tokens`` KV positions.
        False = pool exhausted (admission backpressure)."""
        need = self.pages_for(tokens)
        with self._lock:
            in_use = sum(self._row_pages.values()) \
                - self._row_pages.get(row, 0)
            if in_use + need > self.capacity_pages:
                return False
            self._row_pages[row] = need
        return True

    def free(self, row: int) -> None:
        """Return ``row``'s pages and drop its KV objects."""
        with self._lock:
            self._row_pages.pop(row, None)
        self.store.delete(self._oid(row, "k"))
        self.store.delete(self._oid(row, "v"))

    def free_all(self) -> None:
        with self._lock:
            rows = list(self._row_pages)
            self._row_pages.clear()
        for row in rows:
            self.store.delete(self._oid(row, "k"))
            self.store.delete(self._oid(row, "v"))

    # -- KV row movement ------------------------------------------------------
    def put_row(self, row: int, cache: Dict[str, Any]) -> None:
        """Pin a slot's live KV tensors in the device tier (between
        engine iterations the store is the owner)."""
        koid, void = self._oid(row, "k"), self._oid(row, "v")
        self.store.put(koid, cache["k"])
        self.store.put(void, cache["v"])
        self.store.pin(koid)
        self.store.pin(void)

    def take_row(self, row: int) -> Optional[Dict[str, Any]]:
        """Consume a slot's KV tensors out of the store: the engine gets
        the sole reference."""
        k = self.store.take(self._oid(row, "k"))
        v = self.store.take(self._oid(row, "v"))
        if k is None or v is None:
            return None
        return {"k": k, "v": v}

    # -- introspection --------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return sum(self._row_pages.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            pages = sum(self._row_pages.values())
        return {
            "page_tokens": self.page_tokens,
            "page_bytes": self.page_bytes,
            "capacity_pages": self.capacity_pages,
            "pages_in_use": pages,
            "bytes_in_use": pages * self.page_bytes,
            "store_bytes": self.store.total_bytes(),
        }

    @staticmethod
    def _oid(row: int, part: str) -> bytes:
        return f"serve.kv.{part}.{row}".encode()
