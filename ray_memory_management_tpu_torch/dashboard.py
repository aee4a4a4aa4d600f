"""Dashboard: HTTP observability endpoint over the live cluster.

The reference's dashboard (dashboard/head.py:62 aiohttp head + per-node
agents + React UI) reduced to its data surface: a stdlib HTTP server in
the driver process exposing the state API as JSON, cluster resources,
jobs, and Prometheus metrics, plus a minimal HTML overview. Runs
in-process because cluster state lives in the driver runtime.

Routes::

    /                       HTML overview
    /api/cluster            resources total/available
    /api/nodes|actors|tasks|objects|workers|placement_groups
                            (tasks/objects take ?job_id= to narrow to
                            one tenant's rows)
    /api/jobs               job-submission table
    /api/drivers            GCS job table (driver + client jobs) with
                            live quota-ledger usage per job
    /api/events             structured cluster events
    /api/task_summary       task-state counts + per-stage latency p50/95/99
    /api/timeline           Chrome traceEvents JSON (load in Perfetto);
                            filters: ?task_id=&trace_id=&cat=&limit=
    /api/trace?trace_id=    span tree + critical-path attribution
    /api/logs               structured log records + dropped count;
                            filters: ?task_id=&trace_id=&node_id=
                            &level=&since=&limit=&job_id=
                            (400 on bad params)
    /api/profile            folded stack samples + dropped count;
                            filters: ?task_id=&trace_id=&node_id=
                            &since=&limit=&fold=&job_id=
                            (400 on bad params)
    /api/series?name=       health-plane time-series history for one
                            rmt_* metric; ?since=&window=&rate=&delta=
                            &quantile= plus any other key=value as a
                            tag filter (400 on bad params)
    /api/alerts             SLO rules engine alerts (firing + resolved
                            history); filters: ?state=&limit=
                            (400 on bad params)
    /metrics                Prometheus exposition text
"""

from __future__ import annotations

import json
import threading
from typing import Optional

_HTML = """<!doctype html>
<title>rmt dashboard</title>
<style>body{font-family:monospace;margin:2em}td,th{padding:2px 10px;
text-align:left}h2{margin-top:1.2em}</style>
<h1>rmt cluster</h1>
<div id=out>loading…</div>
<script>
const SECTIONS = ["cluster","nodes","actors","tasks","workers"];
async function refresh() {
  const out = document.createElement("div");
  for (const s of SECTIONS) {
    const data = await (await fetch("/api/" + s)).json();
    const h2 = document.createElement("h2");
    h2.textContent = s;                       // textContent: cluster data
    const pre = document.createElement("pre"); // is untrusted for HTML
    pre.textContent = JSON.stringify(data, null, 2);
    out.append(h2, pre);
  }
  document.getElementById("out").replaceChildren(...out.children);
}
refresh(); setInterval(refresh, 5000);
</script>
"""


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    status, ctype, body = dash._route(self.path)
                except Exception as e:  # noqa: BLE001
                    status, ctype = 500, "application/json"
                    body = json.dumps({"error": str(e)}).encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="rmt-dashboard")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _route(self, path: str):
        from urllib.parse import parse_qs, urlsplit

        from . import state

        parts = urlsplit(path)
        # first value per key: these routes take scalar filters only
        query = {k: v[0] for k, v in parse_qs(parts.query).items() if v}
        path = parts.path.rstrip("/") or "/"
        if path == "/":
            return 200, "text/html", _HTML.encode()
        if path == "/metrics":
            from .utils.metrics import export_prometheus

            return 200, "text/plain; version=0.0.4", \
                export_prometheus().encode()
        if path == "/api/cluster":
            from . import api

            data = {
                "resources_total": api.cluster_resources(),
                "resources_available": api.available_resources(),
                "nodes": len(api.nodes()),
            }
        elif path == "/api/nodes":
            data = state.list_nodes()
        elif path == "/api/actors":
            data = state.list_actors()
        elif path == "/api/tasks":
            data = state.list_tasks(job_id=query.get("job_id"))
        elif path == "/api/objects":
            data = state.list_objects(job_id=query.get("job_id"))
        elif path == "/api/workers":
            data = state.list_workers()
        elif path == "/api/placement_groups":
            data = state.list_placement_groups()
        elif path == "/api/jobs":
            from .job_submission import JobSubmissionClient

            data = JobSubmissionClient().list_jobs()
        elif path == "/api/drivers":
            # the GCS job table: the in-process driver + every thin-client
            # connection (gcs_job_manager.h:28), distinct from the
            # submission-queue jobs above
            data = state.list_jobs()
        elif path == "/api/events":
            from .utils import events as _events

            data = _events.list_events()
        elif path == "/api/task_summary":
            data = {
                "tasks": state.summarize_tasks(),
                "latencies": state.summarize_task_latencies(),
            }
        elif path == "/api/timeline":
            from .utils import timeline as _timeline

            limit = None
            if "limit" in query:
                try:
                    limit = max(0, int(query["limit"]))
                except ValueError:
                    limit = None
            data = {
                "traceEvents": _timeline.chrome_trace_events(
                    task_id=query.get("task_id"),
                    trace_id=query.get("trace_id"),
                    cat=query.get("cat"),
                    limit=limit),
                # ring evictions since start/clear: a non-zero value
                # warns that the export is a suffix, not the full run
                "dropped": _timeline.dropped_count(),
            }
        elif path == "/api/trace":
            trace_id = query.get("trace_id")
            if not trace_id:
                return (400, "application/json",
                        b'{"error": "trace_id query param required"}')
            data = {
                "trace": state.get_trace(trace_id),
                "critical_path": state.summarize_critical_path(trace_id),
            }
        elif path == "/api/logs":
            from .utils import structlog as _structlog

            limit = 1000
            if "limit" in query:
                try:
                    limit = int(query["limit"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "limit must be an integer"}')
                if limit < 0:
                    return (400, "application/json",
                            b'{"error": "limit must be >= 0"}')
            since = None
            if "since" in query:
                try:
                    since = float(query["since"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "since must be a timestamp"}')
            level = query.get("level")
            if level is not None and \
                    level.upper() not in _structlog.LEVELS:
                return (400, "application/json",
                        json.dumps({"error": "level must be one of "
                                    + "/".join(_structlog.LEVELS)}).encode())
            data = {
                "logs": state.get_logs(
                    task_id=query.get("task_id"),
                    trace_id=query.get("trace_id"),
                    node_id=query.get("node_id"),
                    level=level, since=since, limit=limit,
                    job_id=query.get("job_id")),
                # drops since start (worker buffer overflow seen locally
                # + store retention evictions): non-zero warns the view
                # is a suffix — mirrors /api/timeline
                "dropped": _structlog.dropped_count(),
            }
        elif path == "/api/profile":
            from .utils import profiler as _profiler

            limit = 10000
            if "limit" in query:
                try:
                    limit = int(query["limit"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "limit must be an integer"}')
                if limit < 0:
                    return (400, "application/json",
                            b'{"error": "limit must be >= 0"}')
            since = None
            if "since" in query:
                try:
                    since = float(query["since"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "since must be a timestamp"}')
            fold = True
            if "fold" in query:
                raw = query["fold"].lower()
                if raw not in ("0", "1", "true", "false"):
                    return (400, "application/json",
                            b'{"error": "fold must be 0/1/true/false"}')
                fold = raw in ("1", "true")
            data = {
                "profile": state.get_profile(
                    task_id=query.get("task_id"),
                    trace_id=query.get("trace_id"),
                    node_id=query.get("node_id"),
                    since=since, limit=limit, fold=fold,
                    job_id=query.get("job_id")),
                # drops since start (sampler aggregation overflow seen
                # locally + store retention evictions): non-zero warns
                # the view is a suffix — mirrors /api/logs
                "dropped": _profiler.dropped_count(),
            }
        elif path == "/api/series":
            name = query.get("name")
            if not name:
                return (400, "application/json",
                        b'{"error": "name query param required"}')
            since = None
            if "since" in query:
                try:
                    since = float(query["since"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "since must be a timestamp"}')
            window = 60.0
            if "window" in query:
                try:
                    window = float(query["window"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "window must be seconds"}')
                if window <= 0:
                    return (400, "application/json",
                            b'{"error": "window must be > 0"}')
            rate = delta = False
            for key in ("rate", "delta"):
                if key in query:
                    raw = query[key].lower()
                    if raw not in ("0", "1", "true", "false"):
                        return (400, "application/json",
                                json.dumps({"error": f"{key} must be "
                                            "0/1/true/false"}).encode())
                    if key == "rate":
                        rate = raw in ("1", "true")
                    else:
                        delta = raw in ("1", "true")
            quantile = None
            if "quantile" in query:
                try:
                    quantile = float(query["quantile"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "quantile must be a number"}')
                if not 0.0 <= quantile <= 1.0:
                    return (400, "application/json",
                            b'{"error": "quantile must be in [0, 1]"}')
            # every remaining key=value is a tag filter (the series
            # analog of /api/logs' id filters)
            reserved = ("name", "since", "window", "rate", "delta",
                        "quantile")
            tags = {k: v for k, v in query.items() if k not in reserved}
            data = state.query_series(
                name, tags=tags or None, since=since, window=window,
                rate=rate, delta=delta, quantile=quantile)
        elif path == "/api/alerts":
            alert_state = query.get("state")
            if alert_state is not None and \
                    alert_state not in ("firing", "resolved"):
                return (400, "application/json",
                        b'{"error": "state must be firing or resolved"}')
            limit = 100
            if "limit" in query:
                try:
                    limit = int(query["limit"])
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "limit must be an integer"}')
                if limit < 0:
                    return (400, "application/json",
                            b'{"error": "limit must be >= 0"}')
            data = {"alerts": state.get_alerts(state=alert_state,
                                               limit=limit)}
        else:
            return 404, "application/json", b'{"error": "not found"}'
        return 200, "application/json", json.dumps(data).encode()

    def stop(self) -> None:
        self._server.shutdown()


_dashboard: Optional[Dashboard] = None


def start_dashboard(host: str = "127.0.0.1",
                    port: int = 8265) -> Dashboard:
    global _dashboard
    if _dashboard is None:
        _dashboard = Dashboard(host, port)
    return _dashboard


def stop_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        _dashboard.stop()
        _dashboard = None
