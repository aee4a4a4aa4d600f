"""Autoscaler: reconcile node count against resource demand.

The reference's StandardAutoscaler.update loop (autoscaler/_private/
autoscaler.py:154,345) driven by the Monitor (monitor.py:125,333) reading
load from GCS, with pluggable NodeProviders (AWS/GCP/.../fake_multi_node).
Here: demand = tasks the scheduler could not place (the runtime's pending
queue) plus per-node queue backlog; the provider contract is create/
terminate; ``VirtualNodeProvider`` adds in-process nodes (the
fake_multi_node analog used for tests), ``ProcessNodeProvider`` starts
node-agent processes that may lease the host's cards (``num_gpus``), and
a cloud GPU provider slots in by implementing the same two methods over
real hosts.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from . import _worker_context

# -- explicit demand (autoscaler sdk request_resources analog) ----------------
# The elastic trainer pins a demand floor here so the Monitor replaces a
# dead training node even while no tasks are queued (a gang that lost a
# member holds its survivors and queues NOTHING — invisible to the
# pending/backlog signals below).
_request_mu = threading.Lock()
_requested_bundles: List[Dict[str, float]] = []


def request_resources(bundles: Optional[List[Dict[str, float]]] = None
                      ) -> None:
    """Pin a resource-demand floor (ray.autoscaler.sdk.request_resources
    analog): the autoscaler scales until the cluster's TOTAL capacity can
    hold every requested bundle. Replaces any previous request; ``None``
    or ``[]`` clears it. A worker (a serve controller's, say) sends the
    request to the head, whose autoscaler reads it."""
    if _worker_context.get_runtime() is None:
        proxy = _worker_context.get_proxy()
        if proxy is not None:
            proxy.request_resources(bundles)
            return
    with _request_mu:
        _requested_bundles[:] = [dict(b) for b in (bundles or [])]


def requested_bundles() -> List[Dict[str, float]]:
    with _request_mu:
        return [dict(b) for b in _requested_bundles]


class NodeProvider:
    """Provider contract (autoscaler/node_provider.py): create/terminate
    nodes and enumerate the ones this autoscaler manages."""

    def create_node(self, node_config: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def terminate_node(self, node_id: Any) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Any]:
        raise NotImplementedError


class _RuntimeNodeProvider(NodeProvider):
    """Shared bookkeeping for providers that add nodes to the local
    runtime: tracks managed node ids and filters on cluster liveness;
    subclasses supply the create/terminate mechanism."""

    def __init__(self, runtime=None):
        self._rt = runtime or _worker_context.get_runtime()
        self._managed: List[Any] = []

    def _create(self, node_config: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def _terminate(self, node_id: Any) -> None:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any]) -> Any:
        node_id = self._create(node_config)
        self._managed.append(node_id)
        return node_id

    def terminate_node(self, node_id: Any) -> None:
        if node_id in self._managed:
            self._managed.remove(node_id)
        self._terminate(node_id)

    def non_terminated_nodes(self) -> List[Any]:
        return [n for n in self._managed
                if self._rt.nodes.get(n) and self._rt.nodes[n].alive]


class VirtualNodeProvider(_RuntimeNodeProvider):
    """Adds/removes virtual nodes on the in-process runtime — the
    fake_multi_node provider analog for tests and laptops."""

    def _create(self, node_config: Dict[str, Any]) -> Any:
        return self._rt.add_node(dict(node_config))

    def _terminate(self, node_id: Any) -> None:
        self._rt.remove_node(node_id)


class ProcessNodeProvider(_RuntimeNodeProvider):
    """Scales real node-agent PROCESSES joined to the head over TCP (the
    multi-host plane, core/node_agent.py) — each node shares nothing with
    the head but the channel, so this is the faithful stand-in for a
    cloud GPU provider on one box; ``num_gpus`` cards of the host (the
    names ``CUDA_VISIBLE_DEVICES`` lists) are leased by the agent. A
    real provider implements the same two methods with GCE create/delete
    calls (``launcher.GCEGPUProvider``)."""

    def _create(self, node_config: Dict[str, Any]) -> Any:
        return self._rt.add_remote_node_process(
            num_cpus=node_config.get("num_cpus", 4),
            num_gpus=node_config.get("num_gpus", 0))

    def _terminate(self, node_id: Any) -> None:
        self._rt.stop_remote_node(node_id)


class StandardAutoscaler:
    """One reconciliation pass per ``update()`` (autoscaler.py:345):
    scale up while unplaceable demand exists and below max_workers;
    scale down nodes idle longer than idle_timeout_s."""

    def __init__(self, provider: NodeProvider,
                 node_config: Optional[Dict[str, Any]] = None,
                 min_workers: int = 0, max_workers: int = 4,
                 idle_timeout_s: float = 30.0,
                 upscaling_speed: float = 1.0,
                 runtime=None):
        self.provider = provider
        self.node_config = dict(node_config or {"num_cpus": 4})
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.upscaling_speed = max(upscaling_speed, 0.1)
        self._rt = runtime or _worker_context.get_runtime()
        # the cluster can grow now: a task no node can hold yet waits as
        # demand instead of failing (the reference's infeasible queue)
        if self._rt is not None:
            self._rt.autoscaling = True
        self._idle_since: Dict[Any, float] = {}
        self.num_launches = 0
        self.num_terminations = 0

    # -- demand signals -------------------------------------------------------
    def pending_demand(self) -> int:
        """Tasks with nowhere to go right now (the load-metrics 'pending'
        the reference monitor reads from GCS)."""
        rt = self._rt
        with rt._lock:  # nodes dict mutates under this same lock
            pending = len(rt._pending_schedule)
            node_managers = list(rt.nodes.values())
        backlog = sum(nm.backlog() for nm in node_managers if nm.alive)
        return pending + backlog + self._unmet_requests(node_managers)

    def _unmet_requests(self, node_managers) -> int:
        """Requested bundles (request_resources) that the cluster's TOTAL
        capacity cannot hold — charged against totals, not availability,
        so a running gang does not read as perpetual demand."""
        req = requested_bundles()
        if not req:
            return 0
        from .core.resources import Resources

        totals = [Resources.from_fixed(nm.resources.total.fixed())
                  for nm in node_managers if nm.alive]
        unmet = 0
        for b in req:
            r = Resources(b)
            for i, free in enumerate(totals):
                if r.fits_in(free):
                    totals[i] = free - r
                    break
            else:
                unmet += 1
        return unmet

    def _node_busy(self, node_id) -> bool:
        nm = self._rt.nodes.get(node_id)
        if nm is None or not nm.alive:
            return False
        if nm.queue:
            return True
        return any(h.inflight or h.actor_id is not None
                   for h in nm.workers.values())

    # -- reconciliation -------------------------------------------------------
    def update(self) -> None:
        managed = self.provider.non_terminated_nodes()
        demand = self.pending_demand()

        # scale up: below min, or unplaceable work exists
        want = 0
        if len(managed) < self.min_workers:
            want = self.min_workers - len(managed)
        elif demand > 0 and len(managed) < self.max_workers:
            want = max(1, int(len(managed) * self.upscaling_speed) or 1)
        want = min(want, self.max_workers - len(managed))
        for _ in range(max(want, 0)):
            self.provider.create_node(self.node_config)
            self.num_launches += 1

        # scale down: idle past the timeout, but never below min_workers
        now = time.monotonic()
        managed = self.provider.non_terminated_nodes()
        for node_id in list(managed):
            if self._node_busy(node_id):
                self._idle_since.pop(node_id, None)
                continue
            since = self._idle_since.setdefault(node_id, now)
            if (now - since >= self.idle_timeout_s
                    and len(self.provider.non_terminated_nodes())
                    > self.min_workers):
                self.provider.terminate_node(node_id)
                self._idle_since.pop(node_id, None)
                self.num_terminations += 1


class Monitor:
    """Background loop driving the autoscaler (monitor.py:333)."""

    def __init__(self, autoscaler: StandardAutoscaler,
                 update_interval_s: float = 1.0):
        self.autoscaler = autoscaler
        self.update_interval_s = update_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="rmt-autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        import logging

        log = logging.getLogger(__name__)
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception:
                # keep reconciling, but a failing provider must be visible
                log.exception("autoscaler update failed")
            self._stop.wait(self.update_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
