"""Typed, env-overridable configuration flags (the port's own copy).

Same registry as ``config.py`` in the JAX package: every flag has a type,
a default and an environment override spelled ``RMT_<NAME>``. The port
carries only the flags its modules read so far, under the same names and
defaults.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_FLAG_DEFS: Dict[str, tuple] = {}


def _flag(name: str, typ, default, doc: str = ""):
    _FLAG_DEFS[name] = (typ, default, doc)
    return default


_flag("kv_page_tokens", int, 64,
      "KV-cache page size in tokens for the serve engine's paged "
      "device cache: a slot's KV rows grow in pages of this many "
      "positions instead of reserving max_seq up front, so device memory "
      "held by a replica scales with live tokens.")
_flag("serve_kv_pool_bytes", int, 0,
      "Per-replica KV page-pool budget in bytes. 0 sizes the pool to "
      "the monolithic slab's footprint (max_slots x max_seq), so the "
      "paged engine can never hold more device memory than the slab it "
      "replaced; exhaustion causes admission backpressure, never an "
      "allocation failure.")


def _coerce(typ, raw: str) -> Any:
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return typ(raw)


class Config:
    """A scoped snapshot of all flags, with ``RMT_<NAME>`` env overrides
    applied at construction time."""

    def __init__(self, **overrides: Any):
        for name, (typ, default, _doc) in _FLAG_DEFS.items():
            env = os.environ.get(f"RMT_{name}")
            value = _coerce(typ, env) if env is not None else default
            setattr(self, name, value)
        for k, v in overrides.items():
            if k not in _FLAG_DEFS:
                raise ValueError(f"unknown config flag: {k}")
            setattr(self, k, v)


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config
