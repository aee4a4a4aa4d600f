"""HTTP ingress proxy.

The reference runs an HTTP proxy per node (serve/_private/http_proxy.py:189,
333) routing ``/<deployment>`` to replicas. Here a single proxy actor runs
a stdlib ThreadingHTTPServer (no aiohttp dependency): request bodies are
passed as the deployment's argument, JSON bodies decoded, responses
JSON-encoded. Enough surface for curl/load-balancer ingress; Python-side
traffic should prefer handles (zero-copy through the object plane).

Two data-plane behaviors live here:

  - **Tracing** — every request mints a ROOT trace context before
    dispatch; the runtime's submit path then parents the
    router→replica→engine spans under it, so one trace id (returned in
    the ``x-rmt-trace-id`` response header) walks a p99 outlier
    end-to-end through ``rmt trace`` / ``summarize_critical_path`` /
    the log plane.
  - **Load shedding** — a request arriving while the deployment's known
    queue depth exceeds ``serve_shed_queue_factor x replicas x
    max_concurrent_queries`` is rejected with HTTP 429 up front
    (counted under ``rmt_serve_shed_total{reason="queue_full"}``);
    router-level backpressure timeouts and empty routing tables also
    map to 429 rather than a generic 500 — clients can tell "retry
    later" from "broken".
"""

from __future__ import annotations

import json
import threading
from typing import Dict

from .. import api as core_api
from ..utils import tracing

PROXY_NAME = "SERVE_HTTP_PROXY"


def _count_shed_queue_full() -> None:
    try:
        from ..core import metrics_defs as mdefs

        mdefs.serve_shed().inc(tags={"reason": "queue_full"})
    except Exception:  # noqa: BLE001
        pass


class HTTPProxy:
    def __init__(self, controller, port: int):
        self._controller = controller
        self._port = port
        self._handles: Dict[str, object] = {}
        self._server = None
        self._thread = None

    def ready(self) -> int:
        if self._server is not None:  # idempotent: already listening
            return self._port
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from .handle import BackpressureTimeout, NoReplicasError

        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, status: int, payload: dict, trace_id=None):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                if trace_id is not None:
                    self.send_header("x-rmt-trace-id", trace_id)
                self.end_headers()
                self.wfile.write(json.dumps(payload).encode())

            def _dispatch(self):
                # root span for the whole request: submits below inherit
                # it, so proxy->router->replica->engine share one trace id
                ctx = tracing.new_root()
                trace_id = ctx[0]
                token = tracing.set_current(ctx)
                try:
                    self._dispatch_traced(trace_id)
                finally:
                    tracing.reset(token)

            def _dispatch_traced(self, trace_id: str):
                name = self.path.strip("/").split("/")[0]
                if not name:
                    self._reply(404, {"error": "no deployment in path"},
                                trace_id)
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                arg = None
                if body:
                    try:
                        arg = json.loads(body)
                    except json.JSONDecodeError:
                        arg = body.decode("utf-8", "replace")
                try:
                    handle = proxy._handle_for(name)
                    if handle._router.overloaded():
                        # reject BEFORE routing: a request past the shed
                        # threshold would only wait out its whole
                        # backpressure window and time out anyway
                        _count_shed_queue_full()
                        self._reply(429, {"error": "overloaded: queue "
                                          f"full for {name}"}, trace_id)
                        return
                    ref = handle.remote(arg) if arg is not None \
                        else handle.remote()
                    result = core_api.get(ref, timeout=60)
                    self._reply(200, result, trace_id)
                except (BackpressureTimeout, NoReplicasError) as e:
                    self._reply(429, {"error": str(e)}, trace_id)
                except Exception as e:  # noqa: BLE001 — surface to client
                    self._reply(500, {"error": str(e)}, trace_id)

            do_GET = _dispatch
            do_POST = _dispatch

        self._server = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serve-http")
        self._thread.start()
        return self._port

    def _handle_for(self, name: str):
        from .handle import DeploymentHandle

        h = self._handles.get(name)
        if h is None:
            h = DeploymentHandle(self._controller, name)
            self._handles[name] = h
        return h

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()


def start_proxy(controller, port: int) -> int:
    """Start (or reuse) the proxy actor; returns the bound port."""
    try:
        proxy = core_api.get_actor(PROXY_NAME)
    except Exception:
        try:
            proxy = core_api.remote(HTTPProxy).options(
                name=PROXY_NAME, lifetime="detached", num_cpus=0,
                max_concurrency=32,
            ).remote(controller, port)
        except Exception:
            proxy = core_api.get_actor(PROXY_NAME)
    return core_api.get(proxy.ready.remote(), timeout=60)
