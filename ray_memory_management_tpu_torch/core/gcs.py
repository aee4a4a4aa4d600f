"""Global control state — the GCS equivalent (src/ray/gcs/gcs_server/).

Holds cluster-level state only, as in the reference: node membership +
liveness (gcs_node_manager.h:36, gcs_heartbeat_manager.h:36), the actor
directory (gcs_actor_manager.h:214), placement groups
(gcs_placement_group_manager.h:173), jobs, an internal KV
(gcs_kv_manager.h), pubsub channels (src/ray/pubsub/), and the object
directory (ownership_based_object_directory.h — centralized here because the
driver owns all objects in the single-host round-1 model).

In-process and thread-safe; a gRPC front-end can wrap this for multi-host the
way the reference fronts GcsServer with services, without changing callers.
"""

from __future__ import annotations

import pickle
import threading
import time
import zlib
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Set

from ..ids import ActorID, NodeID
from ..utils import events
from .resources import NodeResources


class NodeInfo:
    __slots__ = ("node_id", "resources", "store_name", "alive",
                 "last_heartbeat", "labels", "index")

    def __init__(self, node_id: NodeID, resources: NodeResources,
                 store_name: str, labels: Dict[str, str], index: int):
        self.node_id = node_id
        self.resources = resources
        self.store_name = store_name
        self.alive = True
        self.last_heartbeat = time.monotonic()
        self.labels = labels
        self.index = index


ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"


class ActorRecord:
    __slots__ = ("actor_id", "spec", "state", "node_id", "worker_id",
                 "num_restarts", "death_cause")

    def __init__(self, actor_id: ActorID, spec):
        self.actor_id = actor_id
        self.spec = spec
        self.state = ACTOR_PENDING
        self.node_id: Optional[NodeID] = None
        self.worker_id = None
        self.num_restarts = 0
        self.death_cause: Optional[str] = None


def resolve_directory_shards(n: int, max_shards: int = 64) -> int:
    """0 = auto: one shard per core, clamped to [4, max_shards] (fewer
    shards than cores re-serializes directory updates; the default 64
    ceiling stops paying off around 8 virtual nodes and bloats the
    per-GCS footprint — pod-scale runs raise it via
    gcs_directory_shards_max)."""
    if n > 0:
        return n
    import os

    return max(4, min(max(4, max_shards), os.cpu_count() or 4))


class _DirectoryShard:
    """One lock-striped slice of the object directory. Every table is
    keyed by object id and an oid hashes to exactly one shard, so
    directory updates and free batches for different objects never
    contend on one lock. The three tables live and die together: a
    holder-set entry always has a tier entry, and both are dropped (with
    the size and the job tag) when the last holder leaves.

    Rows split HOT/COLD: the tables below hold the hot set; rows idle
    past gcs_directory_cold_s (or squeezed out by the per-shard hot-row
    cap, LRU order) spill in pickled batches to the gcs_storage blob
    surface, leaving only the ``cold`` index entry RAM-resident. A
    touched cold row faults its whole batch back in (gcs.py spill /
    fault helpers)."""

    __slots__ = ("lock", "index", "locations", "sizes", "tiers", "jobs",
                 "touch", "cold", "cold_live", "cold_seq", "spill_backoff")

    def __init__(self, index: int = 0):
        self.lock = threading.Lock()
        self.index = index  # shard number: names this shard's cold blobs
        # object_id bytes -> set of NodeID with a sealed copy
        self.locations: Dict[bytes, Set[NodeID]] = {}  # guarded-by: lock
        # payload sizes alongside the directory (the reference's object
        # directory carries object_size for exactly this reason:
        # locality-aware leasing needs bytes, not just holder sets)
        self.sizes: Dict[bytes, int] = {}  # guarded-by: lock
        # storage tier per (object, node): "hbm" marks a live device copy
        # pinned by a process on that node — visible to locality scoring
        # but NOT host-readable; "shm" is the default host tier
        self.tiers: Dict[bytes, Dict[NodeID, str]] = {}  # guarded-by: lock
        # owning job per object (16-byte job id). An EXPLICIT tag, not a
        # task-id prefix match: a job-death sweep walks these rows and
        # must never be able to touch another job's objects through a
        # 4-byte prefix collision.
        self.jobs: Dict[bytes, bytes] = {}  # guarded-by: lock
        # last locate/renew time per HOT row, kept in access order
        # (re-inserted on touch) so the spill pass reads the shard's LRU
        # tail off the front without sorting
        self.touch: Dict[bytes, float] = {}  # guarded-by: lock
        # oid -> cold-batch seq for spilled rows. The whole row (holders,
        # size, tiers, job) lives in the batch blob; this index costs one
        # dict slot + the key bytes per row, the RAM floor the memory
        # bound cannot go below.
        self.cold: Dict[bytes, int] = {}  # guarded-by: lock
        # batch seq -> rows still cold in that blob (blob GC bookkeeping)
        self.cold_live: Dict[int, int] = {}  # guarded-by: lock
        self.cold_seq = 0  # guarded-by: lock
        # set after a degraded/fruitless spill pass so a hot shard does
        # not re-scan its pinned tail on every single add
        self.spill_backoff = 0.0  # guarded-by: lock


class Pubsub:
    """Callback-based pub/sub (the long-poll channels of src/ray/pubsub/
    collapse to direct callbacks in-process)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)  # guarded-by: _lock
        self._lock = threading.Lock()

    def subscribe(self, channel: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs[channel].append(callback)

    def publish(self, channel: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, ()))
        for cb in subs:
            try:
                cb(message)
            except Exception:
                pass


_COLD_NS = "dir_cold"  # storage namespace for spilled directory batches


class GCS:
    def __init__(self, storage=None, directory_shards: int = 0,
                 hot_max_rows: int = 0, cold_s: float = 5.0,
                 shards_max: int = 64):
        from .gcs_storage import InMemoryGcsStorage

        self._lock = threading.RLock()
        # pluggable table storage (gcs_storage.py — the Redis-FT analog,
        # redis_store_client.h:28): durable backends persist the internal KV
        # and detached-actor specs across head restarts
        self.storage = storage or InMemoryGcsStorage()
        self.durable = not isinstance(self.storage, InMemoryGcsStorage)
        self.nodes: Dict[NodeID, NodeInfo] = {}  # guarded-by: _lock
        self.actors: Dict[ActorID, ActorRecord] = {}  # guarded-by: _lock
        self.named_actors: Dict[str, ActorID] = {}  # guarded-by: _lock
        self.placement_groups: Dict[Any, Any] = {}  # guarded-by: _lock
        self.jobs: Dict[Any, dict] = {}  # guarded-by: _lock
        self.kv: Dict[str, bytes] = {  # guarded-by: _lock
            k: v for k, v in self.storage.items("kv")}
        self.pubsub = Pubsub()
        # The object directory is lock-striped into shards keyed by oid
        # (gcs_directory_shards) so add/remove/locate traffic from
        # different nodes never contends on one lock — the GCS-side half
        # of the decentralized control plane. Shard locks are LEAF locks:
        # nothing is acquired while holding one, and batched operations
        # take one shard lock at a time (never two at once), so no
        # ordering edges exist between them.
        self._num_shards = resolve_directory_shards(directory_shards,
                                                    shards_max)
        self._shards = [_DirectoryShard(i) for i in range(self._num_shards)]
        # hot-row budget split evenly across shards; 0 = unbounded (every
        # row RAM-resident, the pre-pod-scale behavior)
        self._hot_cap = (max(16, hot_max_rows // self._num_shards)
                         if hot_max_rows > 0 else 0)
        self._cold_s = max(0.0, cold_s)
        self._node_index = 0  # guarded-by: _lock

    def _shard(self, oid: bytes) -> _DirectoryShard:
        # crc32, not hash(): python seeds str/bytes hashing per process
        # (PYTHONHASHSEED), so hash(oid) lands rows on DIFFERENT shards
        # after a head restart — breaking delta snapshots and making
        # pod-scale shard behavior unreproducible across runs
        return self._shards[zlib.crc32(oid) % self._num_shards]

    def _by_shard(self, oids) -> Dict[int, list]:
        """Group a batch of oids by shard index so batched lookups
        acquire each touched shard lock exactly once."""
        groups: Dict[int, list] = defaultdict(list)
        for oid in oids:
            groups[zlib.crc32(oid) % self._num_shards].append(oid)
        return groups

    # -- hot/cold row split --------------------------------------------------
    # The memory bound: beyond the per-shard hot cap the shard's LRU tail
    # (rows idle past gcs_directory_cold_s; the cap wins over recency)
    # serializes in batches to the gcs_storage blob surface and only a
    # per-oid index entry stays RAM-resident. Any read or mutation of a
    # cold row faults its whole batch back in. All helpers run under the
    # owning shard's (leaf) lock — storage put/get under a shard lock is
    # safe because nothing else is ever acquired while holding one.
    def _cold_key(self, sh: _DirectoryShard, seq: int) -> str:
        return f"{sh.index}:{seq}"

    def _touch_locked(self, sh: _DirectoryShard, oid: bytes) -> None:  # rmtcheck: holds=lock
        sh.touch.pop(oid, None)
        sh.touch[oid] = time.monotonic()

    def _fault_in_locked(self, sh: _DirectoryShard, oid: bytes) -> bool:  # rmtcheck: holds=lock
        """Restore the cold batch holding ``oid`` into the hot tables and
        delete its blob. Returns False when the row is not cold or the
        read was (injected-)failed — a failed fault is a MISS, never a
        loss: the blob and the index entry stay intact for the retry."""
        seq = sh.cold.get(oid)
        if seq is None:
            return False
        from ..utils import faults
        from . import metrics_defs as mdefs

        act = faults.fire("directory.fault")
        if act is not None:
            if act.mode == "stall":
                # a stall models slow blob IO, which genuinely happens
                # under the shard stripe (fault-in reads inside the lock)
                # rmtcheck: disable=blocking-under-lock
                act.sleep()
            else:
                events.emit("DIRECTORY_FAULT_FAILED",
                            f"injected fault reading cold directory batch "
                            f"{self._cold_key(sh, seq)}; row "
                            f"{oid.hex()[:12]} stays cold",
                            severity=events.WARNING, source="gcs")
                return False
        key = self._cold_key(sh, seq)
        try:
            blob = self.storage.get(_COLD_NS, key)
            rows = pickle.loads(blob) if blob is not None else None
        except Exception:  # noqa: BLE001 — unreadable blob: stays a miss
            rows = None
        if rows is None:
            return False
        now = time.monotonic()
        for roid, (locs, size, tiers, job) in rows.items():
            if sh.cold.get(roid) != seq:
                continue  # row was individually dropped since the spill
            sh.cold.pop(roid, None)
            if roid in sh.locations:
                # belt and braces (mutators fault in before re-creating a
                # row, so hot+cold coexistence should not happen): the
                # hot row is newer — union holders, hot tiers win
                sh.locations[roid] |= set(locs)
                merged = dict(tiers)
                merged.update(sh.tiers.get(roid, {}))
                sh.tiers[roid] = merged
            else:
                sh.locations[roid] = set(locs)
                sh.sizes[roid] = size
                sh.tiers[roid] = dict(tiers)
                if job is not None:
                    sh.jobs[roid] = job
            sh.touch[roid] = now
        sh.cold_live.pop(seq, None)
        try:
            self.storage.delete(_COLD_NS, key)
        except Exception:  # noqa: BLE001 — orphan blob; index is gone
            pass
        mdefs.gcs_directory_faults().inc()
        # a fault-in re-admits a whole batch: re-enforce the cap here so
        # a locate sweep over cold rows cannot quietly unbound the hot
        # set (the just-touched row is the MRU end — it stays)
        self._maybe_spill_locked(sh)
        return True

    def _maybe_spill_locked(self, sh: _DirectoryShard) -> None:  # rmtcheck: holds=lock
        """Enforce the per-shard hot-row cap: batch the LRU tail into one
        pickled blob on the storage surface. Spills down to 3/4 of the
        cap so one blob amortizes ~cap/4 adds. A failed write degrades
        to RAM-resident — counted, backed off, rows NEVER lost."""
        cap = self._hot_cap
        if cap <= 0 or len(sh.locations) <= cap:
            return
        now = time.monotonic()
        if now < sh.spill_backoff:
            return
        from ..utils import faults
        from . import metrics_defs as mdefs

        want = len(sh.locations) - max(1, (cap * 3) // 4)
        batch: Dict[bytes, tuple] = {}
        scanned = 0
        for oid, t in sh.touch.items():
            scanned += 1
            if len(batch) >= want or scanned > want * 4 + 1024:
                break
            if sh.jobs.get(oid) is not None:
                # job-tagged rows stay RAM-resident: job-death sweeps
                # walk them by tag and must not fault the cold tier in
                continue
            # the hard cap wins over recency: an over-budget shard spills
            # its full LRU tail down to 3/4 cap even when some of it is
            # younger than cold_s — stopping at just-under-the-cap would
            # degenerate into one tiny blob write per add during a row
            # flood, and blob writes are the expensive half of a spill
            batch[oid] = (list(sh.locations[oid]), sh.sizes.get(oid, 0),
                          dict(sh.tiers.get(oid, {})), sh.jobs.get(oid))
        if not batch:
            sh.spill_backoff = now + self._cold_s
            return
        sh.cold_seq += 1
        seq = sh.cold_seq
        act = faults.fire("directory.spill")
        ok = True
        if act is not None:
            if act.mode == "stall":
                # a stall models slow blob IO, which genuinely happens
                # under the shard stripe (spill writes inside the lock)
                # rmtcheck: disable=blocking-under-lock
                act.sleep()
            else:
                ok = False  # injected write failure (drop/error/corrupt)
        if ok:
            try:
                self.storage.put(_COLD_NS, self._cold_key(sh, seq),
                                 pickle.dumps(batch, protocol=4))
            except Exception:  # noqa: BLE001 — degraded, never lossy
                ok = False
        if not ok:
            for oid in batch:
                self._touch_locked(sh, oid)  # re-age: no immediate retry
            sh.spill_backoff = now + self._cold_s
            events.emit("DIRECTORY_SPILL_DEGRADED",
                        f"directory shard {sh.index} could not spill "
                        f"{len(batch)} cold rows; staying RAM-resident",
                        severity=events.WARNING, source="gcs")
            return
        for oid in batch:
            del sh.locations[oid]
            sh.sizes.pop(oid, None)
            sh.tiers.pop(oid, None)
            sh.touch.pop(oid, None)
            sh.cold[oid] = seq
        sh.cold_live[seq] = len(batch)
        mdefs.gcs_directory_spills().inc()

    def directory_stats(self) -> Dict[str, int]:
        """Hot/cold row counts across shards (one lock acquisition each)
        — the rmt_gcs_directory_{hot,cold}_rows gauge sample and the
        pod-bench memory-bound probe."""
        hot = cold = 0
        for sh in self._shards:
            with sh.lock:
                hot += len(sh.locations)
                cold += len(sh.cold)
        return {"hot": hot, "cold": cold, "shards": self._num_shards}

    # -- jobs ----------------------------------------------------------------
    # The job table (GcsJobManager analog, gcs_job_manager.h:28): one row
    # per driver — the in-process driver plus every connected thin client.
    # Rows outlive the job (state flips to FINISHED/FAILED) so the state
    # API can show what ran.
    def register_job(self, job_id: bytes, info: Optional[dict] = None
                     ) -> None:
        with self._lock:
            self.jobs[job_id] = {
                "job_id": job_id.hex(),
                "state": "RUNNING",
                "start_time": time.time(),
                "end_time": None,
                **(info or {}),
            }

    def tag_job(self, job_id: bytes, **fields) -> None:
        """Add fields to a job's row (a submitted driver's submission
        id, say)."""
        with self._lock:
            row = self.jobs.get(job_id)
            if row is not None:
                row.update(fields)

    def set_job_state(self, job_id: bytes, state: str,
                      message: str = "") -> None:
        with self._lock:
            row = self.jobs.get(job_id)
            if row is None:
                return
            row["state"] = state
            row["end_time"] = time.time()
            if message:
                row["message"] = message

    def list_jobs(self) -> list:
        with self._lock:
            return [dict(v) for v in self.jobs.values()]

    # -- nodes ---------------------------------------------------------------
    def register_node(self, node_id: NodeID, resources: NodeResources,
                      store_name: str,
                      labels: Optional[Dict[str, str]] = None) -> NodeInfo:
        with self._lock:
            info = NodeInfo(node_id, resources, store_name, labels or {},
                            self._node_index)
            self._node_index += 1
            self.nodes[node_id] = info
        self.pubsub.publish("node_added", node_id)
        events.emit("NODE_ADDED", f"node {node_id.hex()[:12]} joined",
                    source="gcs", node_id=node_id.hex())
        return info

    def heartbeat(self, node_id: NodeID) -> None:
        with self._lock:
            info = self.nodes.get(node_id)
            if info:
                info.last_heartbeat = time.monotonic()

    def check_heartbeats(self, timeout_s: float) -> List[NodeID]:
        """Returns nodes newly declared dead (gcs_heartbeat_manager.h:94)."""
        now = time.monotonic()
        dead = []
        with self._lock:
            for info in self.nodes.values():
                if info.alive and now - info.last_heartbeat > timeout_s:
                    info.alive = False
                    dead.append(info.node_id)
        for nid in dead:
            self.pubsub.publish("node_dead", nid)
            events.emit("NODE_DEAD",
                        f"node {nid.hex()[:12]} missed heartbeats",
                        severity=events.ERROR, source="gcs",
                        node_id=nid.hex())
        return dead

    def mark_node_dead(self, node_id: NodeID) -> None:
        with self._lock:
            info = self.nodes.get(node_id)
            if not info or not info.alive:
                return
            info.alive = False
        self.pubsub.publish("node_dead", node_id)
        events.emit("NODE_DEAD", f"node {node_id.hex()[:12]} marked dead",
                    severity=events.ERROR, source="gcs",
                    node_id=node_id.hex())

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    # -- actors --------------------------------------------------------------
    def register_actor(self, record: ActorRecord) -> None:
        with self._lock:
            self.actors[record.actor_id] = record
            name = record.spec.registered_name
            if name:
                if name in self.named_actors:
                    raise ValueError(f"actor name already taken: {name}")
                self.named_actors[name] = record.actor_id

    def get_actor(self, actor_id: ActorID) -> Optional[ActorRecord]:
        with self._lock:
            return self.actors.get(actor_id)

    def get_named_actor(self, name: str) -> Optional[ActorRecord]:
        with self._lock:
            aid = self.named_actors.get(name)
            return self.actors.get(aid) if aid else None

    def set_actor_state(self, actor_id: ActorID, state: str,
                        death_cause: Optional[str] = None) -> None:
        with self._lock:
            rec = self.actors.get(actor_id)
            if not rec:
                return
            rec.state = state
            if death_cause:
                rec.death_cause = death_cause
            if state == ACTOR_DEAD and rec.spec.registered_name:
                self.named_actors.pop(rec.spec.registered_name, None)
        self.pubsub.publish("actor_state", (actor_id, state))

    # -- kv ------------------------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        with self._lock:  # storage write under the lock: persisted order
            self.kv[key] = value  # must match in-memory order
            self.storage.put("kv", key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self.kv.get(key)

    def kv_del(self, key: str) -> None:
        with self._lock:
            self.kv.pop(key, None)
            self.storage.delete("kv", key)

    def kv_keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self.kv if k.startswith(prefix)]

    # -- object directory ----------------------------------------------------
    # Sharded: every method routes through the oid's _DirectoryShard and
    # takes only that shard's (leaf) lock; batched calls group by shard
    # and acquire each touched shard lock once.
    def add_object_location(self, oid: bytes, node_id: NodeID,
                            size: Optional[int] = None,
                            tier: str = "shm",
                            job: Optional[bytes] = None) -> None:
        sh = self._shard(oid)
        with sh.lock:
            if sh.cold and oid in sh.cold:
                self._fault_in_locked(sh, oid)
            locs = sh.locations.get(oid)
            if locs is None:
                locs = sh.locations[oid] = set()
                sh.tiers[oid] = {}
            locs.add(node_id)
            sh.tiers[oid][node_id] = tier
            if size is not None:
                sh.sizes[oid] = size
            if job is not None:
                sh.jobs[oid] = job
            self._touch_locked(sh, oid)
            self._maybe_spill_locked(sh)

    def remove_object_location(self, oid: bytes, node_id: NodeID) -> None:
        sh = self._shard(oid)
        with sh.lock:
            if sh.cold and oid in sh.cold:
                self._fault_in_locked(sh, oid)
            locs = sh.locations.get(oid)
            if locs:
                locs.discard(node_id)
                tiers = sh.tiers.get(oid)
                if tiers:
                    tiers.pop(node_id, None)
                if not locs:
                    del sh.locations[oid]
                    sh.sizes.pop(oid, None)
                    sh.tiers.pop(oid, None)
                    sh.jobs.pop(oid, None)
                    sh.touch.pop(oid, None)

    def remove_device_location(self, oid: bytes, node_id: NodeID) -> None:
        """Drop a holder only while its copy is still device-tier: the
        owner process died or consumed the buffer. A host copy written
        since (materialization overwrote the tag to 'shm') survives —
        it lives in the node store, not the dead process."""
        sh = self._shard(oid)
        with sh.lock:
            if sh.cold and oid in sh.cold:
                self._fault_in_locked(sh, oid)
            if sh.tiers.get(oid, {}).get(node_id) != "hbm":
                return
        self.remove_object_location(oid, node_id)

    def get_object_locations(self, oid: bytes) -> Set[NodeID]:
        """HOST-READABLE holders only: device-tier (hbm) copies are live
        process-local jax buffers the transfer plane cannot shm-read —
        those readers go through the materialization path instead."""
        sh = self._shard(oid)
        with sh.lock:
            if sh.cold and oid in sh.cold:
                self._fault_in_locked(sh, oid)
            tiers = sh.tiers.get(oid, {})
            out = {n for n in sh.locations.get(oid, ())
                   if tiers.get(n, "shm") != "hbm"}
            if out:
                self._touch_locked(sh, oid)
            return out

    def locate_objects(self, oids) -> Dict[bytes, tuple]:
        """Batched directory lookup for the scheduler's locality pass:
        ``{oid: (size_bytes, (holder NodeIDs...), {node: tier})}`` with
        ONE lock acquisition per touched shard (the router calls this
        once per scheduling batch, not per oid per candidate node). Size
        is 0 when the directory never learned it (the holder set is
        still valid — the scheduler just can't weigh those bytes).
        Holders INCLUDE device-tier (hbm) copies — an HBM-resident
        argument is the best possible placement target — with the tier
        map telling readers which holders are host-readable. Objects
        with no live directory entry are absent from the result."""
        out: Dict[bytes, tuple] = {}
        for idx, group in self._by_shard(oids).items():
            sh = self._shards[idx]
            with sh.lock:
                for oid in group:
                    if sh.cold and oid in sh.cold:
                        self._fault_in_locked(sh, oid)
                    locs = sh.locations.get(oid)
                    if locs:
                        out[oid] = (sh.sizes.get(oid, 0), tuple(locs),
                                    dict(sh.tiers.get(oid, {})))
                        self._touch_locked(sh, oid)
        return out

    def directory_keys(self) -> List[bytes]:
        """Every oid with a live directory entry (the state API's object
        listing) — hot AND cold — merged across shards, one lock
        acquisition each. Cold rows list from the index alone: no
        fault-in for an enumeration."""
        out: List[bytes] = []
        for sh in self._shards:
            with sh.lock:
                out.extend(sh.locations.keys())
                out.extend(sh.cold.keys())
        return out

    def prune_location(self, oid: bytes, node_id: NodeID) -> None:
        """Drop a directory entry a fetch proved STALE (the holder said
        "object not in store"): distinct from remove_object_location so
        the repair is visible — counted and evented — because a directory
        that keeps lying re-routes every retry back to the same empty
        holder."""
        self.remove_object_location(oid, node_id)
        try:
            from ..utils import events
            from . import metrics_defs as mdefs

            mdefs.object_directory_prunes().inc()
            events.emit("OBJECT_LOCATION_PRUNED",
                        f"pruned stale holder {node_id[:8] if isinstance(node_id, str) else node_id} "
                        f"of {oid.hex()[:12]} from the object directory",
                        source="gcs")
        except Exception:  # noqa: BLE001
            pass

    def take_objects_locations(self, oids) -> Dict[bytes, Set[NodeID]]:
        """Batch pop: every listed object's location set, removed from
        the directory, ONE lock acquisition per touched shard. The free
        path over a completion burst calls this once instead of 2N
        per-oid calls (per-oid get+remove was a measurable slice of the
        router's free work at high task rates); oids with no locations —
        inline returns — are simply absent from the result."""
        out: Dict[bytes, Set[NodeID]] = {}
        for idx, group in self._by_shard(oids).items():
            sh = self._shards[idx]
            with sh.lock:
                for oid in group:
                    if sh.cold and oid in sh.cold:
                        self._fault_in_locked(sh, oid)
                    locs = sh.locations.pop(oid, None)
                    sh.sizes.pop(oid, None)
                    sh.tiers.pop(oid, None)
                    sh.jobs.pop(oid, None)
                    sh.touch.pop(oid, None)
                    if locs:
                        out[oid] = locs
        return out

    def job_object_keys(self, job_id: bytes) -> List[bytes]:
        """Every directory oid explicitly tagged as owned by ``job_id``
        — the walk a job-death sweep starts from. Only tagged rows are
        returned: an untagged row belongs to the in-process driver and
        is never a sweep candidate."""
        out: List[bytes] = []
        for sh in self._shards:
            with sh.lock:
                out.extend(oid for oid, j in sh.jobs.items() if j == job_id)
        return out

    def count_job_rows(self, job_id: bytes) -> int:
        """Live directory rows still tagged to ``job_id`` (leak probe:
        must be zero after the job's sweep completes)."""
        n = 0
        for sh in self._shards:
            with sh.lock:
                n += sum(1 for j in sh.jobs.values() if j == job_id)
        return n

    def object_job(self, oid: bytes) -> Optional[bytes]:
        sh = self._shard(oid)
        with sh.lock:
            return sh.jobs.get(oid)

    def drop_node_objects(self, node_id: NodeID) -> List[bytes]:
        """Remove a dead node from the directory; returns objects that now
        have zero locations (candidates for lineage reconstruction).
        Cold batches are scrubbed IN PLACE (load, drop the node, rewrite
        or delete the blob) — node death must not fault the whole cold
        tier back into head RAM just to forget one holder."""
        orphaned = []
        for sh in self._shards:
            with sh.lock:
                for oid, locs in list(sh.locations.items()):
                    locs.discard(node_id)
                    tiers = sh.tiers.get(oid)
                    if tiers:
                        tiers.pop(node_id, None)
                    if not locs:
                        del sh.locations[oid]
                        sh.sizes.pop(oid, None)
                        sh.tiers.pop(oid, None)
                        sh.jobs.pop(oid, None)
                        sh.touch.pop(oid, None)
                        orphaned.append(oid)
                for seq in list(sh.cold_live.keys()):
                    key = self._cold_key(sh, seq)
                    try:
                        blob = self.storage.get(_COLD_NS, key)
                        rows = pickle.loads(blob) if blob is not None else {}
                    except Exception:  # noqa: BLE001 — unreadable: skip
                        continue
                    changed = False
                    for oid in list(rows.keys()):
                        locs, size, tiers, job = rows[oid]
                        if node_id not in locs:
                            continue
                        changed = True
                        locs = [n for n in locs if n != node_id]
                        if locs:
                            rows[oid] = (
                                locs, size,
                                {n: t for n, t in tiers.items()
                                 if n != node_id}, job)
                        else:
                            del rows[oid]
                            sh.cold.pop(oid, None)
                            orphaned.append(oid)
                    if not changed:
                        continue
                    try:
                        if rows:
                            sh.cold_live[seq] = len(rows)
                            self.storage.put(
                                _COLD_NS, key,
                                pickle.dumps(rows, protocol=4))
                        else:
                            sh.cold_live.pop(seq, None)
                            self.storage.delete(_COLD_NS, key)
                    except Exception:  # noqa: BLE001 — stale holders in
                        pass  # the blob; prune-on-fetch repairs later
        return orphaned

    def reconcile_node_rows(self, node_id: NodeID, held) -> int:
        """Full-resync repair for one node's delta-reported holdings:
        drop every row that still names ``node_id`` but is absent from
        ``held`` (oids the node asserts, post-gap). Cold batches are
        scrubbed IN PLACE like drop_node_objects — without it, a later
        batch fault-in would resurrect stale holders that a fetch then
        has to discover dead. A resync is a rare safety net, so the
        O(cold-tier) blob walk here is off the steady-state path; the
        common case stays O(changes). Returns rows dropped."""
        removed = 0
        for sh in self._shards:
            with sh.lock:
                for oid, locs in list(sh.locations.items()):
                    if node_id not in locs or oid in held:
                        continue
                    locs.discard(node_id)
                    tiers = sh.tiers.get(oid)
                    if tiers:
                        tiers.pop(node_id, None)
                    removed += 1
                    if not locs:
                        del sh.locations[oid]
                        sh.sizes.pop(oid, None)
                        sh.tiers.pop(oid, None)
                        sh.jobs.pop(oid, None)
                        sh.touch.pop(oid, None)
                for seq in list(sh.cold_live.keys()):
                    key = self._cold_key(sh, seq)
                    try:
                        blob = self.storage.get(_COLD_NS, key)
                        rows = pickle.loads(blob) if blob is not None else {}
                    except Exception:  # noqa: BLE001 — unreadable: skip
                        continue
                    changed = False
                    for oid in list(rows.keys()):
                        locs, size, tiers, job = rows[oid]
                        if node_id not in locs or oid in held:
                            continue
                        changed = True
                        removed += 1
                        locs = [n for n in locs if n != node_id]
                        if locs:
                            rows[oid] = (
                                locs, size,
                                {n: t for n, t in tiers.items()
                                 if n != node_id}, job)
                        else:
                            del rows[oid]
                            sh.cold.pop(oid, None)
                    if not changed:
                        continue
                    try:
                        if rows:
                            sh.cold_live[seq] = len(rows)
                            self.storage.put(
                                _COLD_NS, key,
                                pickle.dumps(rows, protocol=4))
                        else:
                            sh.cold_live.pop(seq, None)
                            self.storage.delete(_COLD_NS, key)
                    except Exception:  # noqa: BLE001 — stale holders in
                        pass  # the blob; fetch-failure repairs later
        return removed

    # -- recoverable head state ----------------------------------------------
    # With a durable storage backend, small sealed object VALUES ride a
    # write-ahead log (ns "sealed_objects") and the directory's
    # oid -> size map snapshots per shard (ns "dir_snapshot"), so a head
    # restart can restore every sealed small object and sweep directory
    # rows whose holders died with the old process tree. The runtime
    # gates the WAL on config (sealed_wal_max_bytes); these helpers are
    # storage plumbing only.
    def wal_put_sealed(self, oid: bytes, payload: bytes) -> None:
        self.storage.put("sealed_objects", oid.hex(), payload)

    def wal_del_sealed(self, oids) -> None:
        for oid in oids:
            self.storage.delete("sealed_objects", oid.hex())

    def wal_sealed_items(self) -> List[tuple]:
        return [(bytes.fromhex(k), v)
                for k, v in self.storage.items("sealed_objects")]

    def snapshot_directory(self) -> None:
        """Persist each shard's HOT oid -> size map (holder sets are
        process identities and meaningless across a restart). One
        storage row per NON-EMPTY shard; empty shards delete their row
        so the snapshot never accretes stale entries. Cold rows need no
        snapshot: their batches ALREADY live on the same storage surface
        and take_directory_snapshot merges them on the boot path."""
        for i, sh in enumerate(self._shards):
            with sh.lock:
                rows = {oid: sh.sizes.get(oid, 0) for oid in sh.locations}
            if rows:
                self.storage.put("dir_snapshot", str(i),
                                 pickle.dumps(rows, protocol=4))
            else:
                self.storage.delete("dir_snapshot", str(i))

    def take_directory_snapshot(self) -> Dict[bytes, int]:
        """Read-and-clear the persisted directory snapshot (boot path),
        MERGED with any cold batches the dead head spilled — a row that
        went cold before the crash is still part of the full directory
        the restarted head must account for. Returned entries describe
        objects sealed before the restart; the caller restores
        WAL-backed values and sweeps the rest — their shm-store holders
        died with the old process tree."""
        out: Dict[bytes, int] = {}
        for key, blob in self.storage.items("dir_snapshot"):
            try:
                out.update(pickle.loads(blob))
            except Exception:  # noqa: BLE001 — corrupt row: sweep it
                pass
            self.storage.delete("dir_snapshot", key)
        for key, blob in list(self.storage.items(_COLD_NS)):
            try:
                for oid, row in pickle.loads(blob).items():
                    out[oid] = row[1]
            except Exception:  # noqa: BLE001 — corrupt batch: sweep it
                pass
            self.storage.delete(_COLD_NS, key)
        return out
