"""Deployment handles + client-side router.

The reference's RayServeHandle (serve/handle.py:77,285) backed by the
Router/ReplicaSet with in-flight caps (serve/_private/router.py:62,261,298)
and a LongPollClient keeping the routing table fresh
(serve/_private/long_poll.py:179).

Router policy: power-of-two-choices — sample two replicas with open
slots and take the one with the lower load score, where the score is the
router's OWN in-flight count plus the replica's last-reported queue
depth (snapshots the controller piggybacks on its ``metrics()`` poll
replies and pushes through the long-poll channel, including timeout
ticks, so depth stays fresh without version churn). Scan-all least-
loaded degrades at fleet size (every router herds onto the same
momentarily-idle replica); two random choices keep the max queue within
O(log log n) of optimal while reading O(1) state. When every replica is
at ``max_concurrent_queries``, block on wait() until one drains — the
reference's backpressure behavior — and give up after
``serve_backpressure_timeout_s`` with a typed, counted error
(:class:`BackpressureTimeout`, ``rmt_serve_shed_total``).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

from .. import api


# how long a new router waits for its first non-empty routing table
ROUTING_TABLE_WAIT_S = 30.0


class NoReplicasError(RuntimeError):
    """The routing table stayed empty for the whole backpressure window
    (deployment deleted, all replicas dead, or never started)."""


class BackpressureTimeout(RuntimeError):
    """Every replica sat at ``max_concurrent_queries`` for the whole
    backpressure window — the load-shedding signal (HTTP 429 at the
    proxy)."""


def _count_shed(reason: str) -> None:
    try:
        from ..core import metrics_defs as mdefs

        mdefs.serve_shed().inc(tags={"reason": reason})
    except Exception:  # noqa: BLE001 — metrics never fail routing
        pass


class Router:
    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        self._lock = threading.Lock()
        self._version = -1
        self._replicas: Dict[str, Any] = {}
        self._max_q = 100
        self._inflight: Dict[str, List[Any]] = {}
        self._depths: Dict[str, int] = {}  # replica-reported queue depth
        self._stop = threading.Event()
        self._refresh(block=True)
        self._poller = threading.Thread(
            target=self._poll_loop, daemon=True,
            name=f"serve-poll-{deployment_name}")
        self._poller.start()

    def _refresh(self, block: bool = False) -> None:
        state = api.get(
            self._controller.get_replicas.remote(self._name), timeout=30)
        deadline = time.monotonic() + ROUTING_TABLE_WAIT_S
        while block and not state["replicas"] and \
                time.monotonic() < deadline:
            time.sleep(0.05)
            state = api.get(
                self._controller.get_replicas.remote(self._name), timeout=30)
        self._apply_state(state)

    def _apply_state(self, state: Dict[str, Any]) -> None:
        """Install a routing-table snapshot; ``replicas is None`` means a
        long-poll timeout tick, which still refreshes queue depths (they
        change every request — bumping the table version for them would
        defeat long-polling)."""
        with self._lock:
            depths = state.get("queue_depths")
            if depths is not None:
                self._depths = dict(depths)
            if state.get("replicas") is None:
                return
            self._version = state["version"]
            self._replicas = state["replicas"] or {}
            self._max_q = state.get("max_concurrent_queries", 100)
            self._inflight = {
                t: self._inflight.get(t, []) for t in self._replicas
            }
        self._publish_depth()

    def _publish_depth(self) -> None:
        try:
            from ..core import metrics_defs as mdefs

            with self._lock:
                depth = sum(len(v) for v in self._inflight.values())
            mdefs.serve_queue_depth().set(
                float(depth), tags={"deployment": self._name})
        except Exception:  # noqa: BLE001
            pass

    def _poll_loop(self) -> None:
        """LongPollClient: blocks server-side until the table changes."""
        while not self._stop.is_set():
            try:
                state = api.get(self._controller.listen.remote(
                    self._name, self._version, 10.0), timeout=40)
            except Exception:
                if self._stop.is_set():
                    return
                time.sleep(0.5)
                continue
            self._apply_state(state)

    def _prune(self) -> None:
        # drop completed refs from in-flight tracking (router.py:298 —
        # the reference decrements on reply callbacks; we poll readiness)
        # in ONE batched zero-timeout wait across all replicas — the old
        # per-replica loop paid one runtime round-trip per replica per
        # assign, which dominated routing cost at fleet size
        all_refs = [r for refs in self._inflight.values() for r in refs]
        if not all_refs:
            return
        ready, _ = api.wait(all_refs, num_returns=len(all_refs), timeout=0)
        done = set(ready)
        if not done:
            return
        for tag, refs in self._inflight.items():
            self._inflight[tag] = [r for r in refs if r not in done]

    def _score(self, tag: str) -> int:
        """Load score: locally-tracked in-flight plus the replica's last
        self-reported queue depth (covers load from OTHER routers)."""
        return len(self._inflight.get(tag, [])) + self._depths.get(tag, 0)

    def assign(self, method: str, args, kwargs):
        from ..config import global_config

        deadline = time.monotonic() + \
            global_config().serve_backpressure_timeout_s
        while True:
            with self._lock:
                self._prune()
                open_slots = [
                    (t, h) for t, h in self._replicas.items()
                    if len(self._inflight.get(t, [])) < self._max_q
                ]
                if open_slots:
                    # power of two choices over the open slots
                    picks = random.sample(open_slots, 2) \
                        if len(open_slots) > 2 else open_slots
                    tag, handle = min(
                        picks,
                        key=lambda th: (self._score(th[0]),
                                        random.random()))
                    ref = handle.handle_request.remote(method, args, kwargs)
                    self._inflight.setdefault(tag, []).append(ref)
                    return ref
                pending = [r for refs in self._inflight.values()
                           for r in refs]
            if not pending:
                # no replicas yet: wait for the routing table to fill
                if time.monotonic() > deadline:
                    _count_shed("no_replicas")
                    raise NoReplicasError(
                        f"no replicas available for {self._name}")
                time.sleep(0.05)
                continue
            # every replica at max_concurrent_queries: wait for one to drain
            api.wait(pending, num_returns=1, timeout=1.0)
            if time.monotonic() > deadline:
                _count_shed("backpressure_timeout")
                raise BackpressureTimeout(
                    f"backpressure timeout routing to {self._name}")

    def queue_depth(self) -> int:
        """Known outstanding requests for this deployment: the larger of
        this router's in-flight view and the replicas' self-reported
        depths (other routers' load)."""
        with self._lock:
            local = sum(len(v) for v in self._inflight.values())
            remote = sum(self._depths.get(t, 0) for t in self._replicas)
        return max(local, remote)

    def overloaded(self) -> bool:
        """Proxy-side shed signal: queue depth at or beyond
        ``serve_shed_queue_factor x replicas x max_concurrent_queries``
        means a new request would only wait out its whole backpressure
        window — reject it up front (HTTP 429) instead."""
        from ..config import global_config

        with self._lock:
            n = len(self._replicas)
        if n == 0:
            return False  # cold table: let assign() wait for replicas
        cap = global_config().serve_shed_queue_factor * n * self._max_q
        return self.queue_depth() >= cap

    def shutdown(self) -> None:
        self._stop.set()


class DeploymentHandle:
    """User-facing handle: ``h.remote(*args)`` → ObjectRef; method handles
    via ``h.method_name.remote(...)`` (reference handle.py:285
    RayServeSyncHandle / method handles)."""

    def __init__(self, controller, deployment_name: str,
                 method: str = "__call__", _router: Optional[Router] = None):
        self._controller = controller
        self._name = deployment_name
        self._method = method
        self._router_inst = _router
        self._router_lock = threading.Lock()

    @property
    def _router(self) -> Router:
        # created lazily so handles pickle cleanly into replicas (the
        # router holds live threads; each process builds its own)
        with self._router_lock:
            if self._router_inst is None:
                self._router_inst = Router(self._controller, self._name)
            return self._router_inst

    def remote(self, *args, **kwargs):
        return self._router.assign(self._method, args, kwargs)

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_") or name in ("remote",):
            raise AttributeError(name)
        return DeploymentHandle(
            self._controller, self._name, method=name,
            _router=self._router_inst)

    def __reduce__(self):
        return (DeploymentHandle, (self._controller, self._name,
                                   self._method))

    def __repr__(self):
        return f"DeploymentHandle({self._name!r}, method={self._method!r})"
