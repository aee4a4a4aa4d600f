"""State observability API.

The reference's state API (python/ray/experimental/state/api.py —
list_actors:719, list_tasks:942, list_objects:986, summaries :1233-1297)
plus the GCS global-state reads in ray._private.state.
"""

from .api import (  # noqa: F401
    get_alerts,
    get_logs,
    get_profile,
    get_trace,
    list_actors,
    list_cluster_events,
    list_jobs,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_tasks,
    list_workers,
    query_series,
    summarize_actors,
    summarize_critical_path,
    summarize_objects,
    summarize_task_latencies,
    summarize_tasks,
)
