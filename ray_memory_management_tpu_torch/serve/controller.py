"""Serve controller: desired-state reconciler + long-poll host.

The reference's ServeController actor (serve/controller.py:61, deploy
:330-393) with the DeploymentState reconciler
(serve/_private/deployment_state.py:942,1612), long-poll config push
(serve/_private/long_poll.py:63 LongPollHost) and the queue-depth
autoscaling policy (serve/_private/autoscaling_policy.py).

All methods are async: they run on the controller actor's event loop, so
state needs no locks and long-poll ``listen`` calls park on awaits
without holding threads. A background reconcile task converges actual
replicas toward desired state and applies autoscaling decisions.

The reconcile tick also polls every replica's ``metrics()`` — those
replies carry each replica's queue depth, which the controller
piggybacks on its routing-table replies (``get_replicas`` and long-poll
``listen``, including timeout ticks) so routers can make power-of-two-
choices decisions against near-real-time load without extra RPCs.
Scaling decisions are logged, counted
(``rmt_serve_autoscale_decisions_total{direction}``), and pinned into
the cluster autoscaler's demand set (``request_resources``) so scale-up
provisions nodes instead of silently queueing replicas.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional

from .. import api
from ..utils import events, structlog

CONTROLLER_NAME = "SERVE_CONTROLLER"

log = structlog.get_logger(__name__)


class _DeploymentInfo:
    def __init__(self, name: str, cfg: dict):
        self.name = name
        self.cfg = cfg  # func_or_class, init_args/kwargs, num_replicas,
        #                 max_concurrent_queries, user_config, actor_options,
        #                 autoscaling (dict or None), placement_hint
        self.replicas: Dict[str, Any] = {}  # tag -> ActorHandle, ready
        # tag -> ActorHandle still in __init__: counted toward the target
        # but never routed to, so a replica that fails to start is never
        # handed a request
        self.starting: Dict[str, Any] = {}
        self.version = 0
        self.target_replicas = cfg.get("num_replicas", 1)
        self.deleting = False
        self.next_replica_idx = 0
        self.queue_depths: Dict[str, int] = {}  # tag -> last reported
        self.resources_pinned = False


class ServeController:
    def __init__(self):
        self.deployments: Dict[str, _DeploymentInfo] = {}
        self._listeners: Dict[str, asyncio.Event] = {}
        self._reconcile_task: Optional[asyncio.Task] = None
        self._autoscale_interval_s = 0.5
        self._shutdown = False

    @staticmethod
    async def _aget(ref, timeout: float):
        """api.get without blocking the controller loop: the blocking wait
        runs on the default thread pool so listen()/deploy()/status() stay
        responsive during slow replica startups."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: api.get(ref, timeout=timeout))

    async def ready(self) -> str:
        if self._reconcile_task is None:
            self._reconcile_task = asyncio.get_running_loop().create_task(
                self._reconcile_loop())
        return "ok"

    # ------------------------------------------------------------- deploy api
    async def deploy(self, name: str, cfg: dict) -> None:
        """Register/refresh desired state; reconciliation makes it real
        (controller.py:330 deploy → DeploymentState.deploy)."""
        info = self.deployments.get(name)
        if info is None or info.deleting:
            info = _DeploymentInfo(name, cfg)
            self.deployments[name] = info
        else:
            old = info.cfg
            info.cfg = cfg
            info.target_replicas = cfg.get("num_replicas", 1)
            if cfg.get("user_config") != old.get("user_config"):
                await self._reconfigure_replicas(info)
            # init args may hold arrays or tensors, whose == is
            # elementwise: compare the digest to_config recorded instead
            if (cfg.get("func_or_class_blob") !=
                    old.get("func_or_class_blob") or
                    cfg.get("init_digest") != old.get("init_digest")):
                # code change: rolling replace — drop all, reconcile restarts
                await self._stop_replicas(
                    info, list(info.replicas) + list(info.starting))
        await self._reconcile_deployment(info)
        # config-only changes (max_concurrent_queries, autoscaling) must
        # still reach long-polling routers even when no replica changed
        self._bump(name)

    async def delete_deployment(self, name: str) -> None:
        info = self.deployments.get(name)
        if info is None:
            return
        info.deleting = True
        info.target_replicas = 0
        await self._reconcile_deployment(info)
        del self.deployments[name]
        self._bump(name)

    async def get_deployment_info(self, name: str) -> Optional[dict]:
        info = self.deployments.get(name)
        if info is None:
            return None
        return {
            "name": name,
            "num_replicas": len(info.replicas),
            "target_replicas": info.target_replicas,
            "version": info.version,
            "max_concurrent_queries": info.cfg.get(
                "max_concurrent_queries", 100),
            "autoscaling": info.cfg.get("autoscaling"),
        }

    async def list_deployments(self) -> List[str]:
        return [n for n, i in self.deployments.items() if not i.deleting]

    # ---------------------------------------------------------- replica state
    async def get_replicas(self, name: str) -> dict:
        """Current routing table for a deployment (what routers consume)."""
        info = self.deployments.get(name)
        if info is None:
            return {"version": -1, "replicas": {},
                    "max_concurrent_queries": 100}
        return {
            "version": info.version,
            "replicas": dict(info.replicas),
            "max_concurrent_queries": info.cfg.get(
                "max_concurrent_queries", 100),
            "queue_depths": dict(info.queue_depths),
        }

    async def listen(self, name: str, last_version: int,
                     timeout_s: float = 30.0) -> dict:
        """Long-poll: return when the deployment's routing table changes
        past ``last_version`` or on timeout (long_poll.py:63 LongPollHost —
        the reply-when-changed contract)."""
        deadline = time.monotonic() + timeout_s
        while not self._shutdown:
            info = self.deployments.get(name)
            if info is not None and info.version > last_version:
                return await self.get_replicas(name)
            if info is None and last_version >= 0:
                return await self.get_replicas(name)  # deleted
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # timeout tick still refreshes queue depths: depth moves
                # every request, versioning it would defeat long-polling
                return {"version": last_version, "replicas": None,
                        "timeout": True,
                        "queue_depths": dict(info.queue_depths)
                        if info is not None else {}}
            ev = self._listeners.setdefault(name, asyncio.Event())
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                pass
        info = self.deployments.get(name)
        return {"version": last_version, "replicas": None, "timeout": True,
                "queue_depths": dict(info.queue_depths)
                if info is not None else {}}

    def _bump(self, name: str) -> None:
        info = self.deployments.get(name)
        if info is not None:
            info.version += 1
        ev = self._listeners.pop(name, None)
        if ev is not None:
            ev.set()

    # ------------------------------------------------------------- reconcile
    async def _reconcile_loop(self) -> None:
        while not self._shutdown:
            try:
                for info in list(self.deployments.values()):
                    await self._autoscale(info)
                    await self._reconcile_deployment(info)
            except Exception:
                log.warning("serve reconcile tick failed", exc_info=True)
            await asyncio.sleep(self._autoscale_interval_s)

    async def _reconcile_deployment(self, info: _DeploymentInfo) -> None:
        current = len(info.replicas) + len(info.starting)
        target = 0 if info.deleting else info.target_replicas
        if current < target:
            await self._start_replicas(info, target - current)
        elif current > target:
            tags = (list(info.replicas) +
                    list(info.starting))[: current - target]
            await self._stop_replicas(info, tags)

    @staticmethod
    def _placement_strategy(info: _DeploymentInfo):
        """Tier-affine placement: when the deployment carries a
        ``placement_hint`` (hex object id of e.g. its shipped weights),
        prefer the node whose DEVICE tier already holds that object —
        the replica's params materialize from the card's memory instead
        of a cross-node fetch. Soft affinity: a gone node falls back to
        default placement. Inside the controller's worker the state API
        has no runtime to read, so for now this returns "default"."""
        hint = info.cfg.get("placement_hint")
        if not hint:
            return None, "default"
        try:
            from ..core.scheduling_strategies import (
                NodeAffinitySchedulingStrategy,
            )
            from ..state import api as state_api

            rows = state_api.list_objects(
                filters=[("object_id", "=", hint)])
            rows.sort(key=lambda r: r.get("tier") != "hbm")  # hbm first
            for row in rows:
                node_id = row.get("node_id")
                if node_id:
                    return (NodeAffinitySchedulingStrategy(
                        node_id, soft=True), "tier_affine")
        except Exception:  # noqa: BLE001 — placement is best-effort
            pass
        return None, "default"

    async def _start_replicas(self, info: _DeploymentInfo, n: int) -> None:
        from .replica import Replica

        opts = dict(info.cfg.get("actor_options") or {})
        opts.setdefault("num_cpus", 0)
        opts["max_concurrency"] = max(
            info.cfg.get("max_concurrent_queries", 100), 2)
        strategy, placement_mode = self._placement_strategy(info)
        if strategy is not None and "scheduling_strategy" not in opts:
            opts["scheduling_strategy"] = strategy
        try:
            from ..core import metrics_defs as mdefs
            mdefs.serve_replica_placements().inc(
                n, tags={"mode": placement_mode})
        except Exception:  # noqa: BLE001
            pass
        new_tags = []
        user_config = info.cfg.get("user_config")
        for _ in range(n):
            tag = f"{info.name}#{info.next_replica_idx}"
            info.next_replica_idx += 1
            handle = api.remote(Replica).options(**opts).remote(
                info.name, tag, info.cfg["func_or_class_blob"],
                info.cfg.get("init_args") or (),
                info.cfg.get("init_kwargs") or {},
                user_config,
            )
            info.starting[tag] = handle
            new_tags.append(tag)
        # wait for readiness so the routing table only ever lists live
        # replicas (deployment_state reconciler waits for replica startup)
        ready_refs = [info.starting[t].ready.remote() for t in new_tags]
        for tag, ref in zip(new_tags, ready_refs):
            try:
                await self._aget(ref, timeout=60)
            except Exception:
                # failed/hung startup: remove AND kill, or the actor would
                # finish init later and sit leaked holding its resources
                handle = info.starting.pop(tag, None)
                if handle is not None:
                    try:
                        api.kill(handle)
                    except Exception:
                        pass
                continue
            handle = info.starting.pop(tag, None)
            if handle is None:  # stopped while it started
                continue
            if info.cfg.get("user_config") != user_config:
                # reconfigured while it started: it missed that push
                handle.reconfigure.remote(info.cfg.get("user_config"))
            info.replicas[tag] = handle
        self._bump(info.name)

    async def _stop_replicas(self, info: _DeploymentInfo,
                             tags: List[str]) -> None:
        for tag in tags:
            handle = info.replicas.pop(tag, None)
            if handle is None:
                handle = info.starting.pop(tag, None)
            if handle is None:
                continue
            try:
                handle.drain.remote(2.0)
                api.kill(handle)
            except Exception:
                pass
        self._bump(info.name)

    async def _reconfigure_replicas(self, info: _DeploymentInfo) -> None:
        refs = [h.reconfigure.remote(info.cfg.get("user_config"))
                for h in info.replicas.values()]
        for r in refs:
            try:
                await self._aget(r, timeout=30)
            except Exception:
                pass

    # ------------------------------------------------------------ autoscaler
    async def _poll_metrics(self, info: _DeploymentInfo) -> List[int]:
        """Fetch every replica's queue depth (runs each reconcile tick
        whether or not autoscaling is on — the depths feed routers' p2c
        choices via the long-poll channel). Failed fetches are COUNTED
        and logged, never swallowed into a silently stale table."""
        if info.deleting or not info.replicas:
            info.queue_depths = {}
            return []
        tagged = [(t, h.metrics.remote())
                  for t, h in info.replicas.items()]
        depths: Dict[str, int] = {}
        ongoing: List[int] = []
        for tag, ref in tagged:
            try:
                m = await self._aget(ref, timeout=5)
                depths[tag] = int(m["num_ongoing_requests"])
                ongoing.append(depths[tag])
            except Exception:
                try:
                    from ..core import metrics_defs as mdefs
                    mdefs.serve_autoscale_errors().inc()
                except Exception:  # noqa: BLE001
                    pass
                log.warning(
                    "metrics fetch failed for replica %s of %s",
                    tag, info.name, exc_info=True)
        info.queue_depths = depths
        return ongoing

    def _pin_demand(self, info: _DeploymentInfo, desired: int) -> None:
        """Feed the scaling decision into the cluster autoscaler's demand
        set: bumping ``target_replicas`` alone only queues actor creation
        — ``request_resources`` makes the autoscaler PROVISION nodes for
        replicas that don't fit the current cluster."""
        opts = info.cfg.get("actor_options") or {}
        bundle = {k: float(opts[k])
                  for k in ("num_cpus", "num_gpus")
                  if opts.get(k)}
        if not bundle:
            bundle = {"num_cpus": 1.0}
        try:
            from ..autoscaler import request_resources

            request_resources([dict(bundle)] * desired)
            info.resources_pinned = True
        except Exception:  # noqa: BLE001 — no autoscaler running is fine
            pass

    async def _autoscale(self, info: _DeploymentInfo) -> None:
        ongoing = await self._poll_metrics(info)
        cfg = info.cfg.get("autoscaling")
        if not cfg or info.deleting or not ongoing:
            return
        avg = sum(ongoing) / len(ongoing)
        target_per = cfg.get("target_num_ongoing_requests_per_replica", 1.0)
        desired = max(
            cfg.get("min_replicas", 1),
            min(cfg.get("max_replicas", 1),
                int(round(len(ongoing) * avg / max(target_per, 1e-9)))
                or cfg.get("min_replicas", 1)),
        )
        if desired != info.target_replicas:
            direction = "up" if desired > info.target_replicas else "down"
            log.info(
                "autoscaling %s %s: %d -> %d replicas "
                "(avg ongoing %.2f, target/replica %.2f)",
                info.name, direction, info.target_replicas, desired,
                avg, target_per)
            events.emit(
                "SERVE_AUTOSCALE",
                f"{info.name}: {info.target_replicas} -> {desired} "
                f"(avg ongoing {avg:.2f})",
                severity=events.INFO, source="serve")
            try:
                from ..core import metrics_defs as mdefs
                mdefs.serve_autoscale_decisions().inc(
                    tags={"direction": direction})
            except Exception:  # noqa: BLE001
                pass
            info.target_replicas = desired
            self._pin_demand(info, desired)

    async def shutdown(self) -> None:
        self._shutdown = True
        pinned = any(i.resources_pinned
                     for i in self.deployments.values())
        for info in list(self.deployments.values()):
            info.deleting = True
            info.target_replicas = 0
            await self._reconcile_deployment(info)
        self.deployments.clear()
        if pinned:
            try:
                from ..autoscaler import request_resources

                request_resources([])
            except Exception:  # noqa: BLE001
                pass


def get_or_create_controller():
    """Get the singleton controller actor, creating it if needed (the
    serve.start path; controller is a detached named actor so every
    driver/worker resolves the same one)."""
    try:
        handle = api.get_actor(CONTROLLER_NAME)
    except Exception:
        try:
            handle = api.remote(ServeController).options(
                name=CONTROLLER_NAME, lifetime="detached", num_cpus=0,
                max_concurrency=64,
            ).remote()
        except Exception:
            # lost a concurrent-create race: connect to the winner
            handle = api.get_actor(CONTROLLER_NAME)
    api.get(handle.ready.remote(), timeout=60)
    return handle
