"""Cluster scheduler: node selection policies over GCS node state.

The ClusterResourceScheduler / policy-set analog (src/ray/raylet/scheduling/):
  - DEFAULT = hybrid pack-then-spread (policy/hybrid_scheduling_policy.h:48):
    prefer low-index nodes while their utilization stays under the spread
    threshold, then fall back to least-utilized.
  - SPREAD = least utilized first (spread_scheduling_policy).
  - NodeAffinity hard/soft (scheduling_strategies.py:41).
  - Placement-group bundles reserve resources up front and tasks draw from the
    bundle, not the free pool (placement_group_resource_manager.h) — handled
    in placement_group.py, which calls back into this scheduler for the
    initial bundle placement with PACK/SPREAD/STRICT_* policies
    (bundle_scheduling_policy.h:82-109).

The reference's two-level lease protocol (raylet_client.h:398) now has a
partial analog: LEAF tasks (no placement/affinity constraint, args
inline) are handed to a node agent's local lease pool and the AGENT
picks the worker, spilling back to this scheduler when its pool
saturates (Runtime._try_leaf_place / NodeManager.submit_leaf). Every
constrained task still takes this centralized pass, which is exact —
not an approximation — for a single driver.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..config import Config
from ..ids import NodeID
from .gcs import GCS
from .metrics_defs import (
    scheduler_locality_bytes_avoided,
    scheduler_locality_hits,
    scheduler_locality_misses,
    scheduler_placements,
    scheduler_queue_depth,
)
from .resources import NodeResources, Resources
from .scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SPREAD,
)


class InfeasibleRequestError(ValueError):
    """No alive node can ever hold the request (a node an autoscaler adds
    might)."""


class ClusterScheduler:
    def __init__(self, gcs: GCS, config: Optional[Config] = None,
                 load_fn=None):
        self.gcs = gcs
        self.config = config or Config()
        self._lock = threading.RLock()
        self._rr_counter = 0
        # queued-task depth per node (injected by the runtime); used to
        # balance leases when every feasible node is at capacity
        self.load_fn = load_fn or (lambda node_id: 0)
        self._m_placements = scheduler_placements()
        self._m_loc_hits = scheduler_locality_hits()
        self._m_loc_misses = scheduler_locality_misses()
        self._m_loc_bytes = scheduler_locality_bytes_avoided()

    # -- policy entry ---------------------------------------------------------
    def pick_node(self, req: Resources, strategy=None,
                  queue_if_busy: bool = True,
                  locality: Optional[Dict[NodeID, int]] = None
                  ) -> Optional[NodeID]:
        """``locality`` maps candidate node -> argument bytes already
        resident there (computed by the router's batched scheduling pass
        from the GCS object directory). None/empty means no ref args or
        locality disabled — the pre-locality policies apply unchanged."""
        node_id = self._pick_node(req, strategy, queue_if_busy, locality)
        if node_id is not None:
            self._m_placements.inc()
            if locality and self.config.scheduler_locality_weight > 0:
                resident = locality.get(node_id, 0)
                # hit/miss accounting engages only past the gate — below
                # it the policy never weighed data placement at all
                if max(locality.values()) >= self.config.locality_min_bytes:
                    if resident >= self.config.locality_min_bytes:
                        self._m_loc_hits.inc()
                    else:
                        self._m_loc_misses.inc()
                if resident:
                    # bytes the data plane never moves, however we landed
                    self._m_loc_bytes.inc(resident)
        return node_id

    def publish_load(self) -> None:
        """Refresh the per-node dispatch-queue-depth gauge (called from
        the runtime's heartbeat loop — not per pick, which is the task
        hot path)."""
        g = scheduler_queue_depth()
        for n in self.gcs.alive_nodes():
            g.set(float(self.load_fn(n.node_id)),
                  tags={"node_id": n.node_id.hex()[:12]})

    def _locality_pick(self, fitting, locality) -> Optional[NodeID]:
        """Soft locality score over the FITTING set (so it can never pick
        an infeasible or saturated node — spillback and feasibility were
        already decided). Engages only when some fitting node holds >=
        locality_min_bytes of the task's args; the weighted score trades
        resident bytes against utilization and dispatch-queue depth so a
        busy holder loses to an idle peer once the queue-delay cost
        outweighs the transfer it avoids. Device-tier (HBM-pinned) args
        arrive pre-weighted from _batch_locality — the holder of a live
        device pin counts the bytes double, since placing elsewhere pays
        a device→host materialization before the wire hop."""
        w = self.config.scheduler_locality_weight
        if not locality or w <= 0:
            return None
        max_bytes = max(locality.get(n.node_id, 0) for n in fitting)
        if max_bytes < self.config.locality_min_bytes:
            return None

        def score(n):
            # bytes term normalized to [0, w]; utilization in [0, 1];
            # queue depth squashed to [0, 1) so one pathological backlog
            # can't dominate the comparison
            load = self.load_fn(n.node_id)
            return (w * (locality.get(n.node_id, 0) / max_bytes)
                    - n.resources.utilization()
                    - load / (load + 4.0))

        return max(fitting, key=lambda n: (score(n), -n.index)).node_id

    def _pick_node(self, req: Resources, strategy=None,
                   queue_if_busy: bool = True, locality=None
                   ) -> Optional[NodeID]:
        """Select a node to lease the task to.

        With ``queue_if_busy`` (the task path) a task always lands on SOME
        feasible node: when every feasible node is at capacity it leases to
        the least-queued one and drains from that node's dispatch queue as
        resources free (the raylet-queue model — the owner never re-runs
        cluster scheduling per pump, which would be quadratic in backlog
        depth). Without it (the actor path, which allocates immediately on
        the chosen node) a busy cluster returns None so the caller can wait
        for real capacity. Raises ValueError if no alive node could EVER
        host the request (infeasible — the reference surfaces this as a
        pending infeasible task warning)."""
        with self._lock:
            nodes = self.gcs.alive_nodes()
            # single-node fast path: with one alive node and no strategy the
            # full policy walk always lands there — skip it (this sits on
            # the per-task submit path)
            if strategy is None and queue_if_busy and len(nodes) == 1:
                node = nodes[0]
                if node.resources.is_feasible(req):
                    return node.node_id
                raise InfeasibleRequestError(
                    f"infeasible resource request {req.to_dict()}: no alive "
                    f"node can ever satisfy it"
                )
            if isinstance(strategy, PlacementGroupSchedulingStrategy):
                raise RuntimeError(
                    "PG strategies are resolved by PlacementGroupManager"
                )
            if isinstance(strategy, NodeAffinitySchedulingStrategy):
                target = next(
                    (n for n in nodes if n.node_id == strategy.node_id), None
                )
                if target and target.resources.is_feasible(req):
                    if queue_if_busy or target.resources.can_fit(req):
                        return target.node_id  # queue on the pinned node
                    return None  # wait for resources on the pinned node
                if not strategy.soft:
                    raise ValueError(
                        f"node affinity unsatisfiable for {strategy.node_id}"
                    )
                # soft: fall through to default policy
            feasible = [n for n in nodes if n.resources.is_feasible(req)]
            if not feasible:
                raise InfeasibleRequestError(
                    f"infeasible resource request {req.to_dict()}: no alive "
                    f"node can ever satisfy it"
                )
            fitting = [n for n in feasible if n.resources.can_fit(req)]
            if not fitting:
                if not queue_if_busy:
                    return None
                # every feasible node is at capacity: lease to the node with
                # the shortest dispatch queue
                return min(
                    feasible,
                    key=lambda n: (self.load_fn(n.node_id), n.index),
                ).node_id
            if strategy == SPREAD:
                self._rr_counter += 1
                n_fit = len(fitting)
                rr = self._rr_counter
                fitting.sort(
                    key=lambda n: (n.resources.utilization(),
                                   (n.index + rr) % n_fit)
                )
                return fitting[0].node_id
            # soft locality (default policy only — SPREAD is explicit
            # anti-affinity, hard NodeAffinity/PG returned above): go to
            # the data when enough of it already sits on a fitting node
            chosen = self._locality_pick(fitting, locality)
            if chosen is not None:
                return chosen
            # hybrid: pack onto lowest-index node under the threshold, else
            # least-utilized (hybrid_scheduling_policy.h:48)
            threshold = self.config.scheduler_spread_threshold
            under = [n for n in fitting
                     if n.resources.utilization() < threshold]
            if under:
                return min(under, key=lambda n: n.index).node_id
            return min(fitting, key=lambda n: n.resources.utilization()).node_id

    # -- resource accounting --------------------------------------------------
    def allocate(self, node_id: NodeID, req: Resources) -> None:
        with self._lock:
            self.gcs.nodes[node_id].resources.allocate(req)

    def free(self, node_id: NodeID, req: Resources) -> None:
        with self._lock:
            info = self.gcs.nodes.get(node_id)
            if info is not None:
                info.resources.free(req)

    def cluster_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for n in self.gcs.alive_nodes():
            for k, v in n.resources.total.to_dict().items():
                total[k] = total.get(k, 0) + v
        return total

    def available_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for n in self.gcs.alive_nodes():
            for k, v in n.resources.available.to_dict().items():
                total[k] = total.get(k, 0) + v
        return total

    # -- bundle placement (used by PlacementGroupManager) ---------------------
    def place_bundles(
        self, bundles: List[Resources], policy: str
    ) -> Optional[List[NodeID]]:
        """Choose a node per bundle under PACK/SPREAD/STRICT_PACK/
        STRICT_SPREAD (bundle_scheduling_policy.h:82-109). Returns None if
        unplaceable now. Resources are NOT allocated here — the PG manager
        commits them (two-phase prepare/commit, as in the reference)."""
        with self._lock:
            nodes = self.gcs.alive_nodes()
            avail = {
                n.node_id: Resources.from_fixed(
                    n.resources.available.fixed()
                )
                for n in nodes
            }
            order = sorted(nodes, key=lambda n: n.index)

            def fit_on(node_id, req) -> bool:
                return req.fits_in(avail[node_id])

            def take(node_id, req):
                avail[node_id] = avail[node_id] - req

            result: List[Optional[NodeID]] = []
            if policy == "STRICT_PACK":
                for n in order:
                    trial = Resources.from_fixed(avail[n.node_id].fixed())
                    ok = True
                    for b in bundles:
                        if b.fits_in(trial):
                            trial = trial - b
                        else:
                            ok = False
                            break
                    if ok:
                        return [n.node_id] * len(bundles)
                return None
            if policy == "STRICT_SPREAD":
                used: set = set()
                for b in bundles:
                    cand = next(
                        (n for n in order
                         if n.node_id not in used and fit_on(n.node_id, b)),
                        None,
                    )
                    if cand is None:
                        return None
                    used.add(cand.node_id)
                    take(cand.node_id, b)
                    result.append(cand.node_id)
                return result
            if policy == "SPREAD":
                for b in bundles:
                    cands = [n for n in order if fit_on(n.node_id, b)]
                    if not cands:
                        return None
                    counts = {n.node_id: result.count(n.node_id) for n in cands}
                    cand = min(cands, key=lambda n: (counts[n.node_id], n.index))
                    take(cand.node_id, b)
                    result.append(cand.node_id)
                return result
            # PACK (default): fill low-index nodes first
            for b in bundles:
                cand = next((n for n in order if fit_on(n.node_id, b)), None)
                if cand is None:
                    return None
                take(cand.node_id, b)
                result.append(cand.node_id)
            return result
