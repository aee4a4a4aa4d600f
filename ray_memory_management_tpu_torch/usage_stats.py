"""Usage stats: opt-out telemetry collection (DISABLED by default here).

The reference collects opt-out usage reports through the dashboard
(dashboard/modules/usage_stats, CLI toggles scripts.py:1688,1702). This
build ships the same surface but records ONLY to a local JSON file and
never performs network IO (this environment has no egress; a real
deployment would point ``report()`` at a collector).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict

_ENV_FLAG = "RMT_USAGE_STATS_ENABLED"
_DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "rmt_usage_stats.json")


def usage_stats_enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "0") == "1"


def enable() -> None:
    os.environ[_ENV_FLAG] = "1"


def disable() -> None:
    os.environ[_ENV_FLAG] = "0"


def collect() -> Dict[str, Any]:
    """The reference's payload shape: versions, cluster shape, library
    usage — no user data."""
    from . import __version__, _worker_context

    rt = _worker_context.get_runtime()
    payload = {
        "schema_version": "0.1",
        "timestamp": time.time(),
        "library_version": __version__,
        "num_nodes": sum(1 for nm in rt.nodes.values() if nm.alive)
        if rt else 0,
        "total_resources": (
            rt.scheduler.cluster_resources() if rt else {}),
    }
    return payload


def report(path: str = _DEFAULT_PATH) -> str | None:
    """Write one usage record locally if enabled; returns the path."""
    if not usage_stats_enabled():
        return None
    payload = collect()
    with open(path, "a") as f:
        f.write(json.dumps(payload) + "\n")
    return path
