"""State API: structured views over live cluster state.

The reference serves these from the dashboard's state head backed by GCS
(experimental/state/api.py + state_aggregator); the single-process
runtime answers them directly from the owner runtime + GCS tables. Every
function returns plain list-of-dicts (the reference's .to_dict() rows)
and supports the same filters=[(key, "=", value)] shape.

A process without the runtime (a worker, or a thin client after
``client.connect``) asks the head: each public function sends its call
through the process's channel (``state_query``) and the head answers it
with ``answer``. A serve controller's worker reads object holders this
way for tier-affine placement.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import _worker_context

# public name -> function, each answerable on the head for a remote caller
_HEAD_QUERIES: Dict[str, Callable[..., Any]] = {}


def _answered_by_head(fn):
    """Run ``fn`` here when this process holds the runtime; else send the
    call to the head through the worker's or thin client's channel."""
    _HEAD_QUERIES[fn.__name__] = fn

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _worker_context.get_runtime() is None:
            proxy = _worker_context.get_proxy()
            if proxy is not None:
                return proxy.state_query(fn.__name__, args, kwargs)
        return fn(*args, **kwargs)
    return call


def answer(name: str, args: tuple, kwargs: dict) -> Any:
    """The head's side of ``state_query``: run one public state call."""
    fn = _HEAD_QUERIES.get(name)
    if fn is None:
        raise ValueError(f"unknown state query {name!r}")
    return fn(*args, **kwargs)


def _runtime():
    rt = _worker_context.get_runtime()
    if rt is None:
        raise RuntimeError("state API requires an initialized runtime "
                           "(call init() first)")
    return rt


def _apply_filters(rows: List[Dict[str, Any]],
                   filters: Optional[List[Tuple[str, str, Any]]]):
    if not filters:
        return rows
    out = []
    for row in rows:
        ok = True
        for key, op, value in filters:
            have = row.get(key)
            if op in ("=", "=="):
                ok = have == value
            elif op == "!=":
                ok = have != value
            else:
                raise ValueError(f"unsupported filter op {op!r}")
            if not ok:
                break
        if ok:
            out.append(row)
    return out


def _job_task_prefix(job_id: str) -> str:
    """Task ids (and their return-object ids) embed the owning job's
    first 4 id bytes (ids.TaskID.for_task), so an 8-hex-char prefix match
    attributes rows whose full job tag was pruned — task-history tuples,
    log records, profile samples."""
    return job_id.lower()[:8]


@_answered_by_head
def list_nodes(filters=None, limit: int = 10000) -> List[Dict[str, Any]]:
    rt = _runtime()
    rows = []
    with rt.gcs._lock:  # snapshot: registrations mutate this concurrently
        infos = list(rt.gcs.nodes.values())
    for info in infos:
        rows.append({
            "node_id": info.node_id.hex(),
            "state": "ALIVE" if info.alive else "DEAD",
            "resources_total": info.resources.total.to_dict(),
            "labels": info.labels,
            "store": info.store_name,
        })
    return _apply_filters(rows, filters)[:limit]


@_answered_by_head
def list_actors(filters=None, limit: int = 10000) -> List[Dict[str, Any]]:
    rt = _runtime()
    rows = []
    with rt.gcs._lock:
        records = list(rt.gcs.actors.values())
    for rec in records:
        rows.append({
            "actor_id": rec.actor_id.hex(),
            "class_name": getattr(rec.spec, "name", "Actor"),
            "state": rec.state,
            "node_id": rec.node_id.hex() if rec.node_id else None,
            "name": getattr(rec.spec, "registered_name", None),
            "num_restarts": rec.num_restarts,
            "death_cause": rec.death_cause,
        })
    return _apply_filters(rows, filters)[:limit]


@_answered_by_head
def list_tasks(filters=None, limit: int = 10000,
               job_id: Optional[str] = None) -> List[Dict[str, Any]]:
    rt = _runtime()
    with rt._lock:
        records = list(rt.tasks.items())
        # GC'd tasks stay observable through the bounded history
        # (runtime.task_history; the reference's GcsTaskManager log) —
        # stored as raw tuples on the completion hot path, rendered here
        history = list(rt.task_history)
    from ..core.runtime import stage_durations

    rows = [{
        "task_id": tid.hex(), "name": name, "state": state,
        "num_returns": nret, "retries_left": retries,
        "is_actor_task": is_actor,
        "durations": stage_durations(ts),
        "trace_id": trace_ctx[0] if trace_ctx else None,
        "span_id": trace_ctx[1] if trace_ctx else None,
        "parent_span_id": trace_ctx[2] if trace_ctx else None,
        "cpu_s": rusage.get("cpu_s") if rusage else None,
        "peak_rss": rusage.get("peak_rss") if rusage else None,
        "hbm_bytes": rusage.get("hbm_bytes") if rusage else None,
        "job_id": None,  # pruned to the id prefix; see _job_task_prefix
    } for tid, name, state, nret, retries, is_actor, ts, trace_ctx, rusage
        in history]
    for task_id, rec in records:
        tctx = rec.spec.trace_ctx
        ru = rec.rusage
        jid = getattr(rec.spec, "job_id", None)
        rows.append({
            "task_id": task_id.hex(),
            "name": rec.spec.name,
            "state": rec.state,
            "num_returns": rec.spec.num_returns,
            "retries_left": rec.retries_left,
            "is_actor_task": rec.spec.is_actor_task,
            "durations": stage_durations(rec.ts),
            "trace_id": tctx[0] if tctx else None,
            "span_id": tctx[1] if tctx else None,
            "parent_span_id": tctx[2] if tctx else None,
            "cpu_s": ru.get("cpu_s") if ru else None,
            "peak_rss": ru.get("peak_rss") if ru else None,
            "hbm_bytes": ru.get("hbm_bytes") if ru else None,
            "job_id": jid.hex() if jid else None,
        })
    if job_id is not None:
        want, pref = job_id.lower(), _job_task_prefix(job_id)
        rows = [r for r in rows
                if (r["job_id"] == want if r["job_id"] is not None
                    else r["task_id"].startswith(pref))]
    return _apply_filters(rows, filters)[:limit]


@_answered_by_head
def list_objects(filters=None, limit: int = 10000,
                 job_id: Optional[str] = None) -> List[Dict[str, Any]]:
    rt = _runtime()
    rows = []
    with rt._lock:
        mem = {oid: len(data) for oid, data in rt.memory_store.items()}
    # job attribution: quota ledgers know every byte a client job charged
    # (including inline memory_store puts the directory never sees); the
    # directory's jobs table tags store/device rows. An oid in neither is
    # driver-owned and reports job_id=None.
    owner_by_oid: Dict[bytes, str] = {}
    for jid, led in list(getattr(rt, "_job_ledgers", {}).items()):
        with led.lock:
            for o in led.object_sizes:
                owner_by_oid[o] = jid.hex()
            for o in led.device_sizes:
                owner_by_oid[o] = jid.hex()
    for oid, size in mem.items():
        rows.append({
            "object_id": oid.hex(),
            "size_bytes": size,
            "where": "memory_store",
            "node_id": None,
            "job_id": owner_by_oid.get(oid),
        })
    oids = rt.gcs.directory_keys()
    # one batched directory read replaces the old per-(object, node) shm
    # get/release round-trips — for remote stores each of those was an
    # IPC, making the listing O(objects * nodes) remote calls
    located = rt.gcs.locate_objects(oids)
    with rt._lock:
        node_managers = dict(rt.nodes)
    # spill metadata is only visible for in-process stores; a remote
    # node's spilled set would cost the very round-trips we're avoiding
    spilled_by_node: Dict[Any, set] = {}
    for node_id, nm in node_managers.items():
        store = getattr(nm, "store", None)
        lock = getattr(store, "_spill_lock", None)
        if lock is None:
            continue
        try:
            with lock:
                spilled_by_node[node_id] = set(store._spilled)
        except Exception:
            continue
    for oid, (size, holders, tiers) in located.items():
        for node_id in holders:
            tier = tiers.get(node_id, "shm")
            if tier == "hbm":
                where = "device"  # live HBM pin (process-local)
            elif oid in spilled_by_node.get(node_id, ()):
                where = "spilled"
            else:
                where = "store"
            tag = rt.gcs.object_job(oid)
            rows.append({
                "object_id": oid.hex(),
                "size_bytes": size or None,
                "where": where,
                "tier": tier,
                "node_id": node_id.hex(),
                "job_id": tag.hex() if tag else owner_by_oid.get(oid),
            })
    if job_id is not None:
        # explicit tag wins; untagged rows (task returns) match through
        # the job prefix their minting task id embeds
        want, pref = job_id.lower(), _job_task_prefix(job_id)
        rows = [r for r in rows
                if r["job_id"] == want
                or (r["job_id"] is None and r["object_id"].startswith(pref))]
    return _apply_filters(rows, filters)[:limit]


@_answered_by_head
def list_jobs(filters=None, limit: int = 10000) -> List[Dict[str, Any]]:
    """Job table rows (the driver plus every thin-client connection; the
    reference's list_jobs over the GcsJobManager table,
    gcs_job_manager.h:28). Live jobs carry their quota-ledger ``usage``
    snapshot (bytes charged, slots, preemption/demotion counters)."""
    rt = _runtime()
    rows = rt.gcs.list_jobs()
    usage = rt.job_usage() if hasattr(rt, "job_usage") else {}
    for row in rows:
        row["usage"] = usage.get(row.get("job_id"))
    return _apply_filters(rows, filters)[:limit]


@_answered_by_head
def list_workers(filters=None, limit: int = 10000) -> List[Dict[str, Any]]:
    rt = _runtime()
    rows = []
    with rt._lock:
        node_managers = list(rt.nodes.values())
    for nm in node_managers:
        for handle in list(nm.workers.values()):
            rows.append({
                "worker_id": handle.worker_id.hex(),
                "node_id": nm.node_id.hex(),
                "pid": handle.proc.pid if handle.proc else None,
                "alive": handle.alive(),
                "is_actor_worker": handle.actor_id is not None,
            })
    return _apply_filters(rows, filters)[:limit]


@_answered_by_head
def list_placement_groups(filters=None,
                          limit: int = 10000) -> List[Dict[str, Any]]:
    rt = _runtime()
    if rt.pg_manager is None:
        return []
    from ..core.placement_group import placement_group_table

    rows = list(placement_group_table().values())
    return _apply_filters(rows, filters)[:limit]


@_answered_by_head
def list_cluster_events(filters=None,
                        limit: int = 10000) -> List[Dict[str, Any]]:
    """Structured cluster events (the dashboard event module analog —
    NODE_ADDED/NODE_DEAD/TASK_RETRY/ACTOR_RESTARTING/WORKER_OOM_KILLED/
    OBJECT_SPILLED, utils/events.py). Accepts both this module's
    [(key, op, value)] filter tuples and events.list_events' {key: value}
    dict form, so it composes like every sibling list_* API."""
    from ..utils import events

    if isinstance(filters, dict):
        return events.list_events(filters, limit)
    # filter BEFORE limiting (like every sibling list_* API) and return the
    # newest matches (like events.list_events does for the dict form)
    rows = _apply_filters(events.list_events(None, limit=1 << 62), filters)
    return rows[-limit:] if limit > 0 else []


# ------------------------------------------------------------- summaries
@_answered_by_head
def summarize_tasks() -> Dict[str, Any]:
    counts = Counter(r["state"] for r in list_tasks())
    by_name = Counter(r["name"] for r in list_tasks())
    return {"by_state": dict(counts),
            "by_name": dict(by_name.most_common(20)),
            "total": sum(counts.values())}


@_answered_by_head
def summarize_actors() -> Dict[str, Any]:
    counts = Counter(r["state"] for r in list_actors())
    return {"by_state": dict(counts), "total": sum(counts.values())}


@_answered_by_head
def summarize_objects() -> Dict[str, Any]:
    rows = list_objects()
    total_bytes = sum(r["size_bytes"] or 0 for r in rows)
    return {"count": len(rows), "total_bytes": total_bytes}


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted sample."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


# --------------------------------------------------------------- tracing
def _trace_task_rows(trace_id: str) -> List[Dict[str, Any]]:
    """All tasks indexed under one trace, from live records first and the
    bounded history for anything already pruned. Rows keep the raw
    transition-stamp dict (``ts``) so the critical-path sweep can build
    intervals without re-deriving them from durations."""
    rt = _runtime()
    with rt._lock:
        task_ids = list(rt._traces.get(trace_id, ()))
        found: Dict[bytes, tuple] = {}
        for tid in task_ids:
            rec = rt.tasks.get(tid)
            if rec is not None:
                found[tid] = (rec.spec.name, rec.state,
                              rec.spec.trace_ctx, dict(rec.ts))
        missing = [t for t in task_ids if t not in found]
        history = list(rt.task_history) if missing else []
    if missing:
        want = set(missing)
        for tid, name, state, _n, _r, _a, ts, tctx, _ru in history:
            if tid in want and tctx:
                found[tid] = (name, state, tctx, dict(ts))
    rows = []
    for tid in task_ids:
        got = found.get(tid)
        if got is None:
            continue
        name, state, tctx, ts = got
        rows.append({
            "task_id": tid.hex(),
            "name": name,
            "state": state,
            "span_id": tctx[1] if tctx else None,
            "parent_span_id": tctx[2] if tctx else None,
            "ts": ts,
        })
    return rows


@_answered_by_head
def get_trace(trace_id: str) -> Dict[str, Any]:
    """Span tree for one trace: every task whose submit minted a span
    under ``trace_id``, linked parent→child the way nested ``.remote()``
    calls chained their contexts. ``roots``/``children`` reference spans
    by span_id (flat ``spans`` list holds the payload), so the result
    JSON-serializes without recursion."""
    from ..core.runtime import stage_durations

    rows = _trace_task_rows(trace_id)
    spans = []
    for r in rows:
        ts = r["ts"]
        stamps = [v for v in ts.values() if v is not None]
        spans.append({
            "span_id": r["span_id"],
            "parent_span_id": r["parent_span_id"],
            "task_id": r["task_id"],
            "name": r["name"],
            "state": r["state"],
            "start_ts": min(stamps) if stamps else None,
            "end_ts": max(stamps) if stamps else None,
            "durations": stage_durations(ts),
            "children": [],
        })
    by_span = {s["span_id"]: s for s in spans if s["span_id"]}
    roots = []
    for s in spans:
        parent = s["parent_span_id"]
        if parent and parent in by_span:
            by_span[parent]["children"].append(s["span_id"])
        else:
            roots.append(s["span_id"])
    return {"trace_id": trace_id, "num_spans": len(spans),
            "roots": roots, "spans": spans}


@_answered_by_head
def get_logs(task_id: Optional[str] = None,
             trace_id: Optional[str] = None,
             node_id: Optional[str] = None,
             level: Optional[str] = None,
             since: Optional[float] = None,
             limit: int = 1000,
             job_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Query the cluster's structured log plane (utils/structlog.py):
    every record a worker/agent/driver process captured — package-logger
    lines, user ``logging`` calls, and teed task ``print()`` output —
    stamped with node/pid/role/task/actor/trace/span identity. Filters
    are ANDed; ``level`` is a MINIMUM severity (``"WARNING"`` returns
    WARNING and above), ``since`` an exclusive ts lower bound; the
    newest ``limit`` records return oldest-first. Id filters take hex
    strings (the ids list_tasks/get_trace rows carry); ``job_id``
    matches records through the job prefix their task id embeds."""
    rt = _runtime()
    store = getattr(rt, "log_store", None)
    if store is None:
        return []
    if job_id is None:
        return store.query(task_id=task_id, trace_id=trace_id,
                           node_id=node_id, level=level, since=since,
                           limit=limit)
    # job filter is applied here (the store doesn't index jobs): fetch
    # unbounded so the newest-``limit`` cut happens AFTER narrowing
    pref = _job_task_prefix(job_id)
    rows = [r for r in store.query(task_id=task_id, trace_id=trace_id,
                                   node_id=node_id, level=level,
                                   since=since, limit=None)
            if (r.get("task_id") or "").startswith(pref)]
    return rows[-limit:] if limit > 0 else []


@_answered_by_head
def get_profile(node_id: Optional[str] = None,
                task_id: Optional[str] = None,
                trace_id: Optional[str] = None,
                since: Optional[float] = None,
                limit: int = 10000,
                fold: bool = True,
                job_id: Optional[str] = None):
    """Query the cluster's profiling plane (utils/profiler.py): stack
    samples every worker/agent/driver process captured, stamped with
    node/pid/role/thread/task/trace identity. Filters are ANDed; id
    filters take hex strings (the ids list_tasks/get_trace rows carry).

    With ``fold=True`` (default) matching samples merge into collapsed
    form: ``[{"stack": "root;child;leaf", "count": n}, ...]``, heaviest
    first — one ``"\\n".join(f"{r['stack']} {r['count']}")`` away from
    flamegraph.pl / Speedscope input. ``fold=False`` returns the raw
    sample records (newest ``limit``, oldest-first)."""
    rt = _runtime()
    store = getattr(rt, "profile_store", None)
    if store is None:
        return []
    if job_id is None:
        samples = store.query(task_id=task_id, trace_id=trace_id,
                              node_id=node_id, since=since, limit=limit)
    else:
        # narrow by the job prefix task ids embed, THEN cut to newest
        # ``limit`` — same post-filter shape as get_logs(job_id=)
        pref = _job_task_prefix(job_id)
        samples = [s for s in store.query(task_id=task_id,
                                          trace_id=trace_id,
                                          node_id=node_id, since=since,
                                          limit=None)
                   if (s.get("task_id") or "").startswith(pref)]
        samples = samples[-limit:] if limit > 0 else []
    if not fold:
        return samples
    from ..utils import profiler as _profiler

    folded = _profiler.fold(samples)
    return [{"stack": stack, "count": count} for stack, count in
            sorted(folded.items(), key=lambda kv: (-kv[1], kv[0]))]


@_answered_by_head
def query_series(name: str,
                 tags: Optional[Dict[str, str]] = None,
                 since: Optional[float] = None,
                 window: float = 60.0,
                 rate: bool = False,
                 delta: bool = False,
                 quantile: Optional[float] = None) -> Dict[str, Any]:
    """Query the health plane's time-series store (utils/tsdb.py): the
    heartbeat-tick history of one ``rmt_*`` metric. ``series`` holds
    per-tag-combo point lists ``[[ts, value], ...]`` (coarse downsampled
    history first, then the raw tick-resolution ring; ``tags`` is a
    subset match, ``since`` a ts lower bound). ``rate=True`` /
    ``delta=True`` / ``quantile=q`` additionally evaluate the named
    aggregate over the trailing ``window`` seconds — ``delta`` is the
    exact counted increments between the window's first and last
    samples, and ``rate * span_s == delta`` by construction. Empty
    under ``RMT_HEALTH=0`` (the store never filled)."""
    rt = _runtime()
    store = getattr(rt, "tsdb", None)
    if store is None:
        return {"name": name, "series": []}
    out: Dict[str, Any] = {
        "name": name,
        "series": store.range(name, tags=tags, since=since),
    }
    if rate or delta:
        out["span_s"] = store.span(name, window, tags=tags)
    if rate:
        out["rate"] = store.rate(name, window, tags=tags)
    if delta:
        out["delta"] = store.delta(name, window, tags=tags)
    if quantile is not None:
        out["quantile"] = store.quantile_over_time(
            name, quantile, window, tags=tags)
    return out


@_answered_by_head
def get_alerts(state: Optional[str] = None,
               limit: int = 100) -> List[Dict[str, Any]]:
    """Query the SLO rules engine (core/health.py): currently-firing
    alerts plus the bounded resolved history, most severe first. Each
    row carries the rule, its expr/threshold/observed value, the
    evidence samples (``[[ts, value], ...]`` of the offending series),
    and — when the runtime could attribute one — an exemplar
    task_id/trace_id that pivots into get_trace/get_logs/get_profile.
    ``state`` filters to ``"firing"`` or ``"resolved"``."""
    rt = _runtime()
    engine = getattr(rt, "health", None)
    if engine is None:
        return []
    return engine.alerts(state=state, limit=limit)


# Critical-path attribution: stage -> transition-stamp intervals, listed
# in PRIORITY order. A wall-clock instant covered by several overlapping
# intervals (a sibling executing while another waits in queue) is charged
# to the highest-priority stage only — exec beats transfer beats queue
# beats schedule-wait — so the stage seconds sum to at most the wall time
# and the uncovered remainder is, by construction, runtime overhead.
_CP_STAGES = (
    ("exec", (("RUNNING", "WORKER_DONE"),)),
    ("transfer", (("PREFETCH_START", "PREFETCH_DONE"),
                  ("WORKER_DONE", "FINISHED"))),
    ("queue", (("DISPATCHED", "RUNNING"),)),
    ("schedule_wait", (("SUBMITTED", "SCHEDULED"),)),
)


@_answered_by_head
def summarize_critical_path(trace_id: str) -> Dict[str, Any]:
    """Attribute a trace's wall time (first submit stamp → last stamp of
    any of its spans) to named stages via a priority interval sweep.
    Every second lands somewhere: ``stages`` + ``overhead_s`` equals
    ``wall_time_s`` exactly; ``coverage`` is the fraction explained by
    the named (non-overhead) stages."""
    rows = _trace_task_rows(trace_id)
    empty = {"trace_id": trace_id, "tasks": len(rows),
             "wall_time_s": 0.0, "stages": {}, "overhead_s": 0.0,
             "coverage": 0.0}
    if not rows:
        return empty
    intervals: List[Tuple[float, float, int, str]] = []
    t_min, t_max = float("inf"), float("-inf")
    for r in rows:
        ts = r["ts"]
        for v in ts.values():
            if v is not None:
                t_min = min(t_min, v)
                t_max = max(t_max, v)
        for prio, (stage, edges) in enumerate(_CP_STAGES):
            for a, b in edges:
                ta, tb = ts.get(a), ts.get(b)
                if ta is not None and tb is not None and tb > ta:
                    intervals.append((ta, tb, prio, stage))
    if t_max <= t_min:
        return empty
    wall = t_max - t_min
    # boundary sweep: between consecutive stamp boundaries exactly one
    # stage (or none) wins, so each segment is charged exactly once
    points = sorted({t_min, t_max,
                     *(p for iv in intervals for p in iv[:2])})
    stages: Dict[str, float] = {}
    overhead = 0.0
    for lo, hi in zip(points, points[1:]):
        seg = hi - lo
        if seg <= 0:
            continue
        best = None
        for ta, tb, prio, stage in intervals:
            if ta <= lo and tb >= hi and (best is None or prio < best[0]):
                best = (prio, stage)
        if best is None:
            overhead += seg
        else:
            stages[best[1]] = stages.get(best[1], 0.0) + seg
    return {"trace_id": trace_id, "tasks": len(rows),
            "wall_time_s": wall,
            "stages": stages,
            "overhead_s": overhead,
            "coverage": (wall - overhead) / wall}


@_answered_by_head
def summarize_task_latencies() -> Dict[str, Dict[str, float]]:
    """Per-lifecycle-stage latency summary (count / mean / p50 / p95 /
    p99, milliseconds) over the runtime's bounded stage-duration samples
    — the ``ray summary tasks`` timing breakdown analog. Exact
    percentiles from raw samples, not bucket interpolation (the
    rmt_task_stage_seconds histogram serves the monitoring view).

    When finished tasks carried rusage deltas (the profiling plane's
    per-task attribution), a ``resources`` stage reports cpu_s /
    peak_rss / hbm_bytes percentiles in native units (seconds / bytes),
    keyed ``<resource>_{count,mean,p50,p95,p99}``."""
    rt = _runtime()
    out: Dict[str, Dict[str, float]] = {}
    for stage, buf in list(rt.task_latencies.items()):
        vals = sorted(buf)
        if not vals:
            continue
        out[stage] = {
            "count": len(vals),
            "mean_ms": (sum(vals) / len(vals)) * 1e3,
            "p50_ms": _percentile(vals, 0.50) * 1e3,
            "p95_ms": _percentile(vals, 0.95) * 1e3,
            "p99_ms": _percentile(vals, 0.99) * 1e3,
        }
    resources: Dict[str, float] = {}
    for key, buf in list(getattr(rt, "task_resources", {}).items()):
        vals = sorted(buf)
        if not vals:
            continue
        resources.update({
            f"{key}_count": len(vals),
            f"{key}_mean": sum(vals) / len(vals),
            f"{key}_p50": _percentile(vals, 0.50),
            f"{key}_p95": _percentile(vals, 0.95),
            f"{key}_p99": _percentile(vals, 0.99),
        })
    if resources:
        out["resources"] = resources
    return out
