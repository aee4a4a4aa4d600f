"""Driver-side runtime: ownership, submission, routing, fault tolerance.

This is the CoreWorker-of-the-driver (src/ray/core_worker/core_worker.h:63)
fused with the pieces of the raylet the single-host model centralizes:

  - TaskManager: owner-side task state, retries, lineage for reconstruction
    (task_manager.h:86,135);
  - ReferenceCounter (simplified): local python refs pin objects; task args
    are pinned for the task's duration (reference_count.h:61);
  - ObjectRecoveryManager: a lost object with recorded lineage re-submits its
    producing task (object_recovery_manager.h:41);
  - scheduling: dependency resolution then node selection then node-local
    dispatch (direct_task_transport.cc:22 + cluster_task_manager.cc:44);
  - the router thread plays the role of the per-worker gRPC reply streams:
    one thread multiplexes all worker pipes (multiprocessing.connection.wait),
    handling replies inline and farming potentially-blocking worker requests
    (nested get/wait) to a service pool.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _CFTimeoutError
from multiprocessing import connection as mpc
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import _worker_context
from .. import serialization as ser
from ..config import Config
from ..exceptions import (
    ActorDiedError,
    GetTimeoutError,
    NodeDeadError,
    ObjectLostError,
    ObjectStoreFullError,
    QuotaExceededError,
    RmtError,
    TaskError,
    WorkerCrashedError,
)
from ..ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ..utils import events, timeline, tracing
from .gcs import (
    ACTOR_ALIVE, ACTOR_DEAD, ACTOR_PENDING, ACTOR_RESTARTING, ActorRecord, GCS,
)
from . import codec as wire_codec
from . import metrics_defs as mdefs
from .node_manager import NodeManager, WorkerHandle
from .object_ref import ObjectRef
from .object_store import StoreClient
from .resources import CPU, NodeResources, Resources, GPU, task_resources
from .scheduler import ClusterScheduler, InfeasibleRequestError
from .scheduling_strategies import PlacementGroupSchedulingStrategy
from .task_spec import ActorCreationSpec, TaskSpec


class _SendChannel:
    """Per-connection outbound queue drained by the shared sender pool."""

    __slots__ = ("conn", "handle", "q", "cond", "dead", "scheduled")

    def __init__(self, conn, handle):
        self.conn = conn
        self.handle = handle
        self.q: deque = deque()
        self.cond = threading.Condition()
        self.dead = False
        self.scheduled = False  # claimed by / queued for a pool thread


class _SenderPool:
    """Fixed thread pool draining per-connection send channels.

    Replaces one-sender-thread-per-connection: at hundreds of live workers
    (a Serve deployment, an actor-churn burst) per-connection threads cost
    a thread spawn on every worker's first dispatch and a scheduler that
    must juggle hundreds of mostly-idle threads. A channel with queued
    messages is claimed by exactly ONE pool thread at a time (so writes to
    a connection stay ordered), drained completely with back-to-back
    messages coalesced into batch frames, then released. A worker that
    stops draining its pipe pins only the one pool thread writing to it —
    when all threads are pinned the pool grows (bounded) so stalled
    consumers can never freeze everyone else's sends, and surplus threads
    retire once idle."""

    def __init__(self, runtime: "Runtime", base_threads: int = 4,
                 max_threads: int = 64):
        self._rt = runtime
        self._cond = threading.Condition()
        self._ready: deque = deque()  # scheduled channels awaiting a thread
        self._base = base_threads
        self._max = max_threads
        self._threads = 0
        self._idle = 0
        self._stopping = False
        with self._cond:
            for _ in range(base_threads):
                self._spawn_locked()

    def stop(self) -> None:
        """Retire every pool thread (runtime shutdown). Without this a
        test suite creating hundreds of runtimes accumulates hundreds of
        parked daemon threads for the process lifetime."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()

    def _spawn_locked(self) -> None:
        self._threads += 1
        threading.Thread(target=self._loop, daemon=True,
                         name="rmt-sender").start()

    def enqueue(self, chan: _SendChannel, msg: dict) -> bool:
        with chan.cond:
            if chan.dead:
                return False
            chan.q.append(msg)
            claim = not chan.scheduled
            if claim:
                chan.scheduled = True
        if claim:
            with self._cond:
                self._ready.append(chan)
                # isolation guarantee: if every pool thread is pinned on a
                # blocked pipe (worker not draining), GROW rather than let
                # one stalled consumer freeze cluster-wide sends; surplus
                # threads retire after idling (see _loop). The cap bounds
                # the pathological case of dozens of simultaneously
                # wedged workers.
                if self._idle == 0 and self._threads < self._max:
                    self._spawn_locked()
                else:
                    self._cond.notify()
        return True

    def _loop(self) -> None:
        while True:
            with self._cond:
                self._idle += 1
                while not self._ready:
                    if self._stopping:
                        self._idle -= 1
                        self._threads -= 1
                        return
                    if not self._cond.wait(timeout=10.0):
                        if self._threads > self._base:
                            # surplus grow-thread with nothing to do
                            self._idle -= 1
                            self._threads -= 1
                            return
                self._idle -= 1
                chan = self._ready.popleft()
            while True:
                with chan.cond:
                    if chan.dead or not chan.q:
                        chan.scheduled = False
                        chan.q.clear()
                        break
                    msgs = list(chan.q)
                    chan.q.clear()
                payload = msgs[0] if len(msgs) == 1 else {
                    "type": "batch", "msgs": msgs}
                if not self._rt._send_payload(chan.conn, payload):
                    with chan.cond:
                        chan.dead = True
                        chan.q.clear()
                        chan.scheduled = False
                    self._rt._on_worker_death(chan.handle)
                    break


class _SlimFuture:
    """Minimal future for object resolution (the values in
    ``runtime.futures``). One is allocated per task return on the submit
    hot path, where ``concurrent.futures.Future``'s per-instance lock +
    condition cost ~9us each — this one allocates three slots and shares
    a single class-level condition across all instances (completions far
    outnumber waiters, and a waiter re-checking its own future on a
    broadcast costs microseconds). API-compatible with the stdlib Future
    for the operations the runtime uses: done / result / set_result /
    set_exception / add_done_callback."""

    __slots__ = ("_state", "_value", "_cbs")

    _cond = threading.Condition()
    _PENDING, _RESULT, _EXC = 0, 1, 2

    def __init__(self):
        self._state = 0
        self._value = None
        self._cbs = None

    def done(self) -> bool:
        return self._state != 0

    def _finish(self, state: int, value, notify: bool = True) -> None:
        with self._cond:
            if self._state:
                return  # first completion wins, like the stdlib
            self._value = value
            self._state = state
            cbs, self._cbs = self._cbs, None
            if notify:
                self._cond.notify_all()
        for cb in cbs or ():
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — parity with stdlib
                pass

    def set_result(self, value) -> None:
        self._finish(self._RESULT, value)

    def set_exception(self, exc) -> None:
        self._finish(self._EXC, exc)

    def set_result_quiet(self, value) -> None:
        """Resolve without waking waiters — for burst completion paths
        that call :meth:`broadcast` ONCE after resolving a whole batch
        (per-future notify_all made a parked getter context-switch per
        completion instead of per batch). Callbacks still fire here."""
        self._finish(self._RESULT, value, notify=False)

    @classmethod
    def broadcast(cls) -> None:
        with cls._cond:
            cls._cond.notify_all()

    def add_done_callback(self, cb) -> None:
        with self._cond:
            if not self._state:
                if self._cbs is None:
                    self._cbs = []
                self._cbs.append(cb)
                return
        cb(self)

    def result(self, timeout: Optional[float] = None):
        # fast path: no lock when already resolved (reads are safe: _state
        # is written last under the condition, and the GIL orders it)
        state = self._state
        if not state:
            with self._cond:
                self._cond.wait_for(lambda: self._state, timeout)
                state = self._state
        if state == self._RESULT:
            return self._value
        if state == self._EXC:
            raise self._value
        from concurrent.futures import TimeoutError as _FutTimeout

        raise _FutTimeout()


# lifecycle stage spans derived from a task's transition stamps (the
# reference's task_events state timeline): (stage, from-stamp, to-stamp)
_STAGE_EDGES = (
    ("submit_to_queue", "SUBMITTED", "QUEUED"),
    ("queue_to_schedule", "QUEUED", "SCHEDULED"),
    ("schedule_to_dispatch", "SCHEDULED", "DISPATCHED"),
    ("dispatch_to_run", "DISPATCHED", "RUNNING"),
    ("run", "RUNNING", "WORKER_DONE"),
    ("total", "SUBMITTED", "FINISHED"),
)


def stage_durations(ts: Dict[str, float]) -> Dict[str, float]:
    """Stage -> seconds from whichever transition stamps are present
    (actor tasks skip the queue/schedule stages; failed tasks have no
    FINISHED). Negative spans (clock adjustments) are dropped."""
    out: Dict[str, float] = {}
    for stage, a, b in _STAGE_EDGES:
        ta = ts.get(a)
        tb = ts.get(b)
        if ta is not None and tb is not None and tb >= ta:
            out[stage] = tb - ta
    return out


# Driver-side lifecycle spans emitted once per finished task from its
# transition stamps: (span name, start stamp, end stamp). The worker
# emits the matching exec slice (RUNNING→WORKER_DONE) in its own
# process; sharing the task's span_id makes them one flow group, which
# is how Perfetto draws submit→schedule→dispatch→exec→result arrows
# across the process boundary.
_LIFECYCLE_SPANS = (
    ("submit", "SUBMITTED", ("QUEUED", "SCHEDULED", "DISPATCHED",
                             "RUNNING")),
    ("schedule", "QUEUED", ("SCHEDULED",)),
    ("dispatch", "SCHEDULED", ("DISPATCHED",)),
    ("queue", "DISPATCHED", ("RUNNING",)),
    ("prefetch_wait", "PREFETCH_START", ("PREFETCH_DONE",)),
    ("result", "WORKER_DONE", ("FINISHED", "FAILED")),
)


def emit_lifecycle_spans(name: str, task_id: bytes, trace_ctx,
                         ts: Dict[str, float]) -> None:
    """Record the head-side stage spans of one completed task on the
    timeline, each carrying the task's trace context (actor tasks skip
    the queue/schedule stamps — their submit span ends at the first
    stamp that exists)."""
    targs = {"task_id": task_id.hex()}
    for stage, a, ends in _LIFECYCLE_SPANS:
        ta = ts.get(a)
        if ta is None:
            continue
        tb = next((ts[b] for b in ends if b in ts), None)
        if tb is None or tb < ta:
            continue
        timeline.record_event(
            f"{stage}::{name}", "lifecycle", ta, tb, tid="lifecycle",
            extra={**targs, "stage": stage}, trace=trace_ctx)


class _TaskRecord:
    __slots__ = ("spec", "retries_left", "state", "payload",
                 "args_released", "gc_returns", "ts", "rusage")

    def __init__(self, spec: TaskSpec, payload: dict, retries_left: int,
                 gc_returns: bool = True):
        self.spec = spec
        self.payload = payload  # original submission payload, for resubmit
        self.retries_left = retries_left
        self.state = "PENDING"
        # state-transition stamps (time.time()); worker-side RUNNING /
        # WORKER_DONE merge in from the done reply's piggybacked tstamps
        self.ts: Dict[str, float] = {"SUBMITTED": time.time()}
        # worker-side resource deltas (cpu_s, peak_rss, hbm_bytes) merged
        # from the done reply's piggybacked rusage, like ts above
        self.rusage: Optional[Dict[str, float]] = None
        # the task holds a reference on each of its ref args until it
        # reaches a terminal state (reference_count.h task-argument refs);
        # this flag makes the release idempotent across the several
        # terminal paths (done / permanent fail / cancel)
        self.args_released = False
        # False for worker/client submissions: their return handles are
        # bare (no distributed refcount), so neither their values nor
        # their metadata are ever GC'd — the pre-refactor behavior
        self.gc_returns = gc_returns


class _ActorInfo:
    __slots__ = ("spec", "record", "node_id", "handle", "seq", "pending",
                 "flushing", "creation_future", "handle_count")

    def __init__(self, spec: ActorCreationSpec, record: ActorRecord):
        self.spec = spec
        self.record = record
        self.node_id: Optional[NodeID] = None
        self.handle: Optional[WorkerHandle] = None
        self.seq = itertools.count()
        self.pending: deque = deque()  # TaskSpecs waiting for ALIVE
        # set while the ALIVE transition dispatches ``pending`` outside
        # the lock: a task submitted meanwhile queues behind it
        self.flushing = False
        self.creation_future: Future = Future()
        self.handle_count = 0


class _RefShard:
    """One stripe of the head's refcount table: a leaf lock over this
    stripe's counts and its zero-ref free buffer. oids map to stripes by
    hash, so ref churn on disjoint objects never shares a mutex (the
    single _ref_mu this replaces was the refcount hot path's last global
    serialization point)."""

    __slots__ = ("lock", "refs", "frees")

    def __init__(self):
        self.lock = threading.Lock()
        self.refs: Dict[bytes, int] = defaultdict(int)  # guarded-by: lock
        self.frees: List[bytes] = []  # zero-ref batch buffer  # guarded-by: lock


class Runtime:
    def __init__(self, config: Config, nodes_spec: List[dict],
                 namespace: Optional[str] = None):
        self.config = config
        self.job_id = JobID.from_random()
        self.namespace = namespace or f"rmt_{os.getpid()}_{id(self) & 0xffff}"
        from ..native import reap_stale_stores

        reap_stale_stores("rmt_")  # SIGKILLed drivers leave orphans
        from .gcs_storage import open_storage

        self.gcs = GCS(open_storage(config.gcs_storage_path),
                       directory_shards=config.gcs_directory_shards,
                       hot_max_rows=config.gcs_directory_hot_max_rows,
                       cold_s=config.gcs_directory_cold_s,
                       shards_max=config.gcs_directory_shards_max)
        import sys as _sys

        self.gcs.register_job(self.job_id.binary(), {
            "type": "driver",
            "entrypoint": " ".join(_sys.argv[:2]) or "driver",
        })
        self.scheduler = ClusterScheduler(
            self.gcs, config, load_fn=self._node_queue_depth)
        self.nodes: Dict[NodeID, NodeManager] = {}
        self._store_clients: Dict[NodeID, StoreClient] = {}
        self._head_node_id: Optional[NodeID] = None

        # owner state
        self.memory_store: Dict[bytes, bytes] = {}  # small objects (serialized)
        from .device_store import DeviceObjectStore

        from .device_store import resolve_capacity

        # driver-pinned tensors: a budgeted device tier that LRU-demotes
        # unpinned entries into the head node's shm store (which spills
        # below itself), bf16-downcasting f32 payloads when configured
        self.device_store = DeviceObjectStore(
            capacity_bytes=resolve_capacity(config),
            on_demote=self._demote_device_object)
        # job-aware demotion order: under device pressure a low-priority
        # tenant's cold pins demote before a high-priority tenant's
        # (LRU within one priority); driver-owned pins demote last
        self.device_store.set_victim_rank(self._device_victim_rank)
        # device-object ownership: oid -> "driver" | WorkerHandle
        self._device_locations: Dict[bytes, Any] = {}
        # driver device objects demoted to host, eligible for
        # re-promotion on their next device read
        self._demoted_device: Set[bytes] = set()  # guarded-by: _lock
        self._materialize_futs: Dict[bytes, Future] = {}
        self._log_tails: Dict[Any, bytes] = {}  # worker id -> partial line
        self.futures: Dict[bytes, Future] = {}
        # live promise ids (create_promise): freeing one PURGES its
        # pending future (a task future must outlive frees for its
        # waiters; a freed promise means the caller is gone and a late
        # external resolution must be dropped, not stored ownerless)
        self._promises: Set[bytes] = set()  # guarded-by: _lock
        self.tasks: Dict[bytes, _TaskRecord] = {}  # guarded-by: _lock
        self.lineage: Dict[bytes, bytes] = {}  # object id -> producing task id  # guarded-by: _lock
        # lock-STRIPED refcount shards (decentralized control plane):
        # ObjectRef __del__/__init__ storms on the APPLICATION thread,
        # worker ref-table ingestion, and the router's completion sweep
        # each touch disjoint oids most of the time — one refcount mutex
        # (the old _ref_mu) serialized them all. Each shard guards its
        # own refs dict + zero-ref free buffer; oid -> shard by hash.
        # Lock order: shard locks are LEAF locks nesting INSIDE _lock;
        # never take _lock (or a second shard) while holding one —
        # multi-oid paths acquire shards one at a time, or in ascending
        # index order when a check must span several (_try_prune).
        from .gcs import resolve_directory_shards

        self._ref_shard_n = resolve_directory_shards(
            config.gcs_directory_shards)
        self._ref_shards = [_RefShard() for _ in range(self._ref_shard_n)]
        self.actors: Dict[bytes, _ActorInfo] = {}
        self.fn_blobs: Dict[bytes, bytes] = {}
        self.cls_blobs: Dict[bytes, bytes] = {}
        self._waiting_deps: Dict[bytes, Set[bytes]] = {}  # task -> missing oids  # guarded-by: _lock
        self._dep_waiters: Dict[bytes, List[bytes]] = defaultdict(list)  # guarded-by: _lock
        self._pending_schedule: deque = deque()  # guarded-by: _lock
        # set by an attached autoscaler (autoscaler.StandardAutoscaler):
        # a task no alive node can hold then waits in _pending_schedule
        # as demand instead of failing
        self.autoscaling = False
        # decentralized ownership bookkeeping (reference_count.h:39-61):
        # per-worker borrow pins (each holds one local_refs count until
        # the worker releases or dies) and per-worker owned-put
        # attribution (objects whose owner is the producing worker)
        self._worker_borrows: Dict[bytes, set] = {}  # guarded-by: _lock
        self._worker_owned: Dict[bytes, set] = {}  # guarded-by: _lock
        # lineage pinning (reference_count.h lineage refcounting): how many
        # RETAINED task records list this oid as a ref arg. A producer's
        # record/lineage can only be pruned when no downstream record still
        # needs it for transitive reconstruction.
        self._lineage_dependents: Dict[bytes, int] = defaultdict(int)
        # bounded history of GC'd tasks so observability survives pruning
        # (the reference's GcsTaskManager keeps a capped task-event log
        # for the same reason); entries are tiny summary dicts
        self.task_history: deque = deque(maxlen=10_000)
        # per-stage latency samples (bounded) for exact percentile
        # summaries (state.summarize_task_latencies); the stage histogram
        # metric keeps the unbounded bucketed view
        self.task_latencies: Dict[str, deque] = {}
        # trace plane: trace_id -> [task_id, ...] so state.get_trace /
        # summarize_critical_path can find a trace's tasks without
        # scanning the whole table; insertion-ordered, oldest trace
        # evicted past the cap (one trace can hold many tasks, so the
        # bound is on traces, matching task_history's retention spirit)
        self._traces: Dict[str, List[bytes]] = {}
        self._traces_cap = 2_000
        # log plane: head-side store over every process's structured
        # records (worker done replies + flush frames, agent pongs, and
        # this process's own emits via the direct attach)
        from ..utils import structlog as _structlog

        self.log_store = _structlog.LogStore()
        _structlog.configure(role="driver")
        _structlog.install_logging_capture()
        _structlog.attach_store(self.log_store)
        # profiling plane: head-side store over every process's stack
        # samples (worker flush frames, agent pongs, and this process's
        # own continuous sampler via the direct attach)
        from ..utils import profiler as _profiler

        self.profile_store = _profiler.ProfileStore()
        _profiler.configure(role="driver")
        _profiler.attach_store(self.profile_store)
        _profiler.start_sampler(hz=float(config.profile_hz))
        # health plane: bounded time-series history over the head's
        # merged registry (sampled on the heartbeat tick) + the SLO
        # rules engine over it. Constructed even under RMT_HEALTH=0 so
        # the query surfaces exist; the gate keeps the store empty.
        from ..utils import tsdb as _tsdb
        from .health import HealthEngine

        self.tsdb = _tsdb.TSDB(
            raw_points=config.tsdb_raw_points,
            downsample_every=config.tsdb_downsample_every,
            downsample_points=config.tsdb_downsample_points,
            max_series_per_name=config.tsdb_max_series_per_name)
        self.health = HealthEngine(self.tsdb,
                                   exemplar=self._health_exemplar)
        # bounded per-resource samples from finished tasks' rusage deltas
        # (state.summarize_task_latencies resource percentiles)
        self.task_resources: Dict[str, deque] = {}
        # hot-path instruments hoisted once (accessor calls touch the
        # registry lock)
        self._m_submitted = mdefs.tasks_submitted()
        self._m_finished = mdefs.tasks_finished()
        self._m_failed = mdefs.tasks_failed()
        self._m_retried = mdefs.tasks_retried()
        self._m_stage_hist = mdefs.task_stage_seconds()
        self._m_prefetch_started = mdefs.prefetch_started()
        self._m_prefetch_completed = mdefs.prefetch_completed()
        self._m_leaf_placed = mdefs.sched_local_placed()
        self._m_leaf_spill = mdefs.sched_local_spillback()
        self._m_worker_exits = mdefs.workers_exited()
        self._leaf_rr = 0  # round-robin cursor over nodes (router only)
        self._leaf_run = 0  # tasks placed on the cursor node this run (router only)
        # recoverable head state: sealed small objects WAL through the
        # durable GCS kv (gcs_storage_path); directory snapshots ride
        # the heartbeat loop. Volatile (in-memory) storage skips both.
        self._wal_enabled = (self.gcs.durable
                             and config.sealed_wal_max_bytes > 0)
        self._wal_max = config.sealed_wal_max_bytes
        self._hb_ticks = 0
        if self.gcs.durable:
            # the previous head's directory rows name holders (stores,
            # workers) that died with its process tree: sweep them, then
            # restore every WAL-sealed object — a head restart loses no
            # sealed object (unsealed creates have no WAL row, so they
            # are swept with the directory)
            self.gcs.take_directory_snapshot()
            for oid, payload in self.gcs.wal_sealed_items():
                self.memory_store[oid] = payload
                fut = _SlimFuture()
                fut.set_result(True)
                self.futures[oid] = fut
        # dep-ready tasks awaiting scheduling, drained in BATCHES by the
        # router's pump: per-task inline scheduling cost ~7 lock/notify
        # round-trips; batching pays them once per burst (the reference
        # batches the same way through the raylet lease request queue)
        self._submit_q: deque = deque()
        self._submit_nudged = False
        self._cancelled: Set[bytes] = set()
        # multi-tenant job plane (job_plane.py): one ledger per live job
        # holding quota state, usage accounting, the cpu-slot throttle and
        # stride-scheduling virtual time. The in-process driver's own job
        # gets an unlimited ledger so the single-tenant path is unchanged.
        from .job_plane import JobLedger

        self._job_ledgers: Dict[bytes, JobLedger] = {
            self.job_id.binary(): JobLedger(self.job_id.binary())
        }  # guarded-by: _lock (ledger internals self-locked, leaf locks)
        self._swept_jobs: Set[bytes] = set()  # guarded-by: _lock
        # job -> (monotonic deadline, trigger) for re-running a sweep that
        # hit an error (job.sweep fault site); drained by the heartbeat loop
        self._sweep_retry: Dict[bytes, tuple] = {}  # guarded-by: _lock
        self._m_job_sweeps = mdefs.job_sweeps()
        self._m_job_preempted = mdefs.job_preemptions()
        self._m_quota_rej = mdefs.job_quota_rejections()
        mdefs.jobs_active().set(float(len(self._job_ledgers)))

        self._lock = threading.RLock()
        self._conn_handles: Dict[Any, WorkerHandle] = {}
        self._router_adds: List[Any] = []  # conns awaiting selector register
        self._router_removals: List[Any] = []  # closed conns to unregister
        self._request_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="rmt-serve"
        )
        self._transfer_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="rmt-xfer"
        )
        self._xfer_serving: Dict[NodeID, int] = {}  # outbound serves/node
        self._xfer_served_total: Dict[NodeID, int] = {}  # lifetime serves
        # broadcast distribution gate: per-oid in-flight pull count +
        # wakeup when a pull lands (a NEW holder exists to pull from)
        self._bcast_cond = threading.Condition()
        self._oid_pulls: Dict[bytes, int] = {}  # guarded-by: _bcast_cond
        import socket as _socket

        self._hostname = _socket.gethostname()  # fixed for process life
        self._conn_send_locks: Dict[Any, threading.Lock] = {}
        # lazy p2p transfer servers over LOCAL node stores (node_id -> srv)
        self._xfer_servers: Dict[NodeID, Any] = {}
        # authenticated transfer connections reused across head-side pulls
        from .transfer import ConnectionPool

        self._xfer_conn_pool = ConnectionPool(
            max_idle_per_peer=config.transfer_pool_size)
        # install the deterministic fault plane (no-op without a spec);
        # configure_from also exports RMT_fault_injection_* so spawned
        # agents/zygotes/workers replay the same schedule
        from ..utils import faults as _faults

        _faults.configure_from(config)
        # agent-local leaf scheduling: constraint-free small tasks take a
        # per-node lease credit (NodeManager.submit_leaf) instead of the
        # full pick_node pass; disabled under fault injection so chaos
        # runs keep exercising the battle-tested dispatch/retry path
        # (the leaf path intentionally skips the control.dispatch site)
        self._leaf_enabled = (
            config.leaf_lease_slots >= 0
            and not getattr(config, "fault_injection_spec", ""))
        from ..utils.retry import RetryPolicy

        # one dispatch policy for every queue hand-off (hoisted: a
        # policy object per submit showed in the task hot path)
        self._dispatch_retry = RetryPolicy(
            max_attempts=3, base_backoff_s=0.02, plane="dispatch")
        self._wakeup_r, self._wakeup_w = os.pipe()
        self._stop = threading.Event()
        self.pg_manager = None  # set by placement_group module on first use

        # worker registration socket (workers dial back in after exec).
        # No HMAC challenge on the SAME-HOST worker socket: connecting
        # requires write permission on the 0600 socket file, which is the
        # same same-user trust boundary the challenge would enforce — and
        # the challenge costs two extra round trips per worker connect,
        # measurable in actor-churn bursts (the reference's raylet/plasma
        # Unix sockets are likewise permission-trusted, raylet_client.h:236).
        # The cluster authkey still guards everything that crosses hosts.
        self._authkey = os.urandom(16)
        self._socket_path = f"/tmp/{self.namespace}.sock"
        from multiprocessing.connection import Listener

        self._listener = Listener(self._socket_path, family="AF_UNIX")
        os.chmod(self._socket_path, 0o600)
        self._workers_by_id: Dict[bytes, WorkerHandle] = {}
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rmt-accept"
        )
        self._accept_thread.start()

        # multi-host plane: TCP listener for node agents (node_agent.py) —
        # the head side of the raylet-joins-GCS handshake
        self._agent_nodes: Dict[Any, Any] = {}  # channel conn -> RemoteNodeManager
        self._node_listener = None
        self._node_listener_thread = None
        self.node_listener_address: Optional[Tuple[str, int]] = None
        self._agent_procs: List[Any] = []  # agents spawned by this driver
        self._agent_proc_by_node: Dict[NodeID, Any] = {}
        if config.enable_node_listener:
            from multiprocessing.connection import Listener as _TCPListener

            self._node_listener = _TCPListener(
                (config.node_listener_host, config.node_listener_port),
                family="AF_INET", authkey=self._authkey,
            )
            self.node_listener_address = self._node_listener.address
            self._node_listener_thread = threading.Thread(
                target=self._agent_accept_loop, daemon=True,
                name="rmt-node-accept",
            )
            self._node_listener_thread.start()

        for i, spec in enumerate(nodes_spec):
            self.add_node(spec, head=(i == 0))

        self._send_cond = threading.Condition()
        self._send_channels: Dict[Any, _SendChannel] = {}  # guarded-by: _send_cond
        self._sender_pool = _SenderPool(self)
        self._router = threading.Thread(
            target=self._router_loop, daemon=True, name="rmt-router"
        )
        self._router.start()
        self._hb = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="rmt-heartbeat"
        )
        self._hb.start()
        self._memory_monitor = None
        if config.memory_monitor_interval_s > 0:
            from .memory_monitor import MemoryMonitor, make_newest_task_killer

            self._memory_monitor = MemoryMonitor(
                make_newest_task_killer(self),
                usage_threshold=config.memory_usage_threshold,
                check_interval_s=config.memory_monitor_interval_s,
            )
            self._memory_monitor.start()
        for nm in self.nodes.values():
            nm.prestart()
        if config.gcs_storage_path:
            self._recreate_detached_actors()
        # best-effort cleanup if the driver exits without shutdown(): shm
        # stores are kernel objects and would otherwise outlive the process
        import atexit

        atexit.register(self._atexit_shutdown)

    # ------------------------------------------------------------------ nodes
    def add_node(self, spec: dict, head: bool = False) -> NodeID:
        node_id = NodeID.from_random()
        res = task_resources(
            num_cpus=spec.get("num_cpus", 4),
            num_gpus=spec.get("num_gpus", 0),
            resources=spec.get("resources"),
            default_cpus=spec.get("num_cpus", 4),
        )
        node_res = NodeResources(res)
        store_name = f"/{self.namespace}_{node_id.hex()[:8]}"
        nm = NodeManager(
            node_id, node_res, store_name, self.config,
            on_worker_started=self._register_worker,
            socket_path=self._socket_path,
            authkey_hex="",  # permission-trusted worker socket (see above)
        )
        with self._lock:
            self.nodes[node_id] = nm
            self.gcs.register_node(node_id, node_res, store_name,
                                   spec.get("labels"))
            if head or self._head_node_id is None:
                self._head_node_id = node_id
                # the driver process lives on the head node: stamp its
                # own log records with that identity
                from ..utils import structlog as _structlog

                _structlog.configure(node_id=node_id.hex())
        self._wakeup()
        return node_id

    def remove_node(self, node_id: NodeID) -> None:
        """Simulate node failure (Cluster.remove_node, cluster_utils.py:238):
        workers die, store contents are lost, GCS broadcasts node death."""
        with self._lock:
            nm = self.nodes.get(node_id)
            if nm is None:
                return
            nm.alive = False
            if hasattr(nm, "mark_dead"):  # remote: wake pending transfers
                nm.mark_dead()
            self.gcs.mark_node_dead(node_id)
            workers = list(nm.workers.values())
        # snapshot AFTER alive=False, under the node's own lock: a submit
        # racing this drain either lands before it (captured here) or
        # sees the dead flag and raises NodeDeadError (re-placed by
        # _submit_to_node). Without the ordering, a late submit wedges
        # the spec on a queue nobody drains again.
        with nm._lock:
            requeue = list(nm.queue)
            nm.queue.clear()
        for h in workers:
            try:
                h.proc.terminate()
            except Exception:
                pass
        # router will observe EOFs; handle queued (not yet dispatched) tasks
        for spec in requeue:
            self._schedule(spec)
        # agent-leased leaf tasks died with the node (the agent can no
        # longer report lease_dead) — retry them under their budget
        for task_id, spec in nm.take_leaf_inflight().items():
            self._maybe_retry(task_id, spec, WorkerCrashedError(
                f"node died with leased task {spec.name} in flight"))
        self.gcs.drop_node_objects(node_id)
        self._wakeup()

    def head_node(self) -> NodeManager:
        return self.nodes[self._head_node_id]

    def _node_queue_depth(self, node_id: NodeID) -> int:
        nm = self.nodes.get(node_id)
        return nm.backlog() if nm is not None else 0

    def _same_host_store(self, nm) -> Optional[str]:
        """The shm store name of ``nm`` if its store lives on THIS host
        (an agent that registered from the same hostname advertises its
        segment name in transfer_ready), else None. Same-host reads map
        the segment directly — one kernel, zero protocol."""
        name = getattr(nm, "remote_store_name", None)
        if name and getattr(nm, "hostname", None) == self._hostname:
            return name
        return None

    def _store_client_for(self, node_id: NodeID) -> StoreClient:
        # Same-host nodes: the driver maps the store directly (one kernel)
        # — including same-host AGENTS, whose store is just another named
        # shm segment. True remote nodes: reads ride the chunked DCN
        # object plane through the node's agent channel
        # (object_manager.proto:63-67 analog).
        with self._lock:
            cli = self._store_clients.get(node_id)
            if cli is None:
                nm = self.nodes[node_id]
                from .remote_node import RemoteNodeManager

                if isinstance(nm, RemoteNodeManager):
                    shm_name = self._same_host_store(nm)
                    if shm_name is not None:
                        try:
                            cli = StoreClient(shm_name)
                        except Exception:  # noqa: BLE001 — segment gone:
                            cli = nm.store  # fall back to the channel
                    else:
                        cli = nm.store  # RemoteStoreProxy
                elif nm is self.head_node():
                    # reuse the node's own mapping
                    cli = nm.store
                else:
                    cli = StoreClient(nm.store_name)
                self._store_clients[node_id] = cli
        return cli

    # ---------------------------------------------------------------- workers
    def _register_worker(self, handle: WorkerHandle) -> None:
        with self._lock:
            self._workers_by_id[handle.worker_id.binary()] = handle

    def _accept_loop(self) -> None:
        """Bind dialing-in worker processes to their handles (the raylet's
        RegisterClient handshake)."""
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                if self._stop.is_set():
                    return
                continue
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                conn.close()
                continue
            # a bootstrapped worker can reply so fast that its sender
            # coalesces ready + actor_ready into one batch frame
            trailing = []
            if msg.get("type") == "batch" and msg["msgs"]:
                trailing = msg["msgs"][1:]
                msg = msg["msgs"][0]
            if msg.get("type") != "ready":
                conn.close()
                continue
            with self._lock:
                handle = self._workers_by_id.get(msg["worker_id"])
                if handle is None or handle.death_processed:
                    # unknown, or the unborn-worker sweep already declared
                    # it dead — binding the conn would put a corpse back
                    # in the idle pool
                    conn.close()
                    continue
                handle.conn = conn
                self._conn_handles[conn] = handle
                self._conn_send_locks[conn] = threading.Lock()
                self._router_adds.append(conn)
                pending = list(handle.pending_msgs)
                handle.pending_msgs.clear()
            nm = self.nodes.get(handle.node_id)
            if nm:
                nm.on_worker_ready(handle)
            for m in pending:
                self._send(handle, m)
            for m in trailing:  # replies that rode the ready batch
                try:
                    self._handle_worker_message(handle, m)
                except Exception:  # noqa: BLE001 — never kill the accept
                    pass           # loop on one bad frame
            self._wakeup()
            self._pump()

    # ------------------------------------------------------------ node agents
    def _agent_accept_loop(self) -> None:
        """Admit node agents joining over TCP (GcsNodeManager::HandleRegister
        analog, gcs_node_manager.h:36): read the hello, create the head-side
        RemoteNodeManager, and hand the channel to the router."""
        from .remote_node import RemoteNodeManager

        while not self._stop.is_set():
            try:
                conn = self._node_listener.accept()
            except (OSError, EOFError):
                if self._stop.is_set():
                    return
                continue
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                conn.close()
                continue
            if msg.get("type") != "register_node":
                conn.close()
                continue
            from ..config import WIRE_PROTOCOL_VERSION

            if msg.get("proto") != WIRE_PROTOCOL_VERSION:
                # mixed-version cluster: refuse at the handshake, with
                # both versions named, rather than mis-parse frames later
                try:
                    conn.send({
                        "type": "error",
                        "error": (
                            "wire protocol mismatch: head speaks "
                            f"v{WIRE_PROTOCOL_VERSION}, agent spoke "
                            f"v{msg.get('proto')} — upgrade the older "
                            "side"),
                    })
                except (OSError, BrokenPipeError):
                    pass
                conn.close()
                continue
            node_id = NodeID.from_random()
            res = task_resources(
                num_cpus=msg.get("num_cpus", 4),
                num_gpus=msg.get("num_gpus", 0),
                resources=msg.get("resources"),
                default_cpus=msg.get("num_cpus", 4),
            )
            node_res = NodeResources(res)
            try:
                nm = RemoteNodeManager(
                    node_id, node_res, self.config,
                    on_worker_started=self._register_worker,
                    channel=conn, gcs=self.gcs,
                    hostname=msg.get("hostname", "?"),
                    gpu_names=msg.get("visible_devices"),
                )
            except ValueError as e:
                # GPUs the agent cannot name: refuse the node, with the
                # reason, rather than lease cards it was never given
                try:
                    conn.send({"type": "error", "error": str(e)})
                except (OSError, BrokenPipeError):
                    pass
                conn.close()
                continue
            # pid on the agent's host — fault-injection tooling (NodeKiller
            # sigkill mode) and diagnostics key off it
            nm.agent_pid = msg.get("pid")
            try:
                conn.send({
                    "type": "registered",
                    "node_id": node_id.binary(),
                    "config": self.config.to_dict(),
                })
            except (OSError, BrokenPipeError):
                conn.close()
                continue
            with self._lock:
                self.nodes[node_id] = nm
                self.gcs.register_node(node_id, node_res, nm.store_name,
                                       msg.get("labels"))
                self._agent_nodes[conn] = nm
                self._router_adds.append(conn)
            nm.prestart()
            self._wakeup()

    def _handle_agent_message(self, nm, msg: dict) -> None:
        mtype = msg["type"]
        if mtype == "wmsg":
            handle = nm.worker_by_wid(msg["wid"])
            if handle is None:
                return
            inner = msg["msg"]
            if inner.get("type") == "ready":
                self._bind_remote_worker(nm, handle)
                return
            self._handle_worker_message(handle, inner)
        elif mtype in ("push_ack", "pull_data", "ensure_ack", "fetch_ack",
                       "spill_ack"):
            nm.on_channel_reply(msg)
        elif mtype == "transfer_ready":
            # the agent's p2p transfer server is up: record where peers
            # (and the head) can pull this node's objects from — and its
            # shm store name, which same-host peers map directly
            nm.transfer_addr = (msg["host"], msg["port"])
            nm.remote_store_name = msg.get("store_name")
        elif mtype == "lease_spill":
            # the agent's local pool is saturated: take the lease credit
            # back and reroute through the full scheduling pass (NOT the
            # leaf path — spillbacks ride _pending_schedule)
            spec = nm.finish_leaf(msg["task_id"])
            if spec is not None:
                self._m_leaf_spill.inc()
                with self._lock:
                    self._pending_schedule.append(spec)
                self._wakeup()
        elif mtype == "lease_dead":
            # the worker the agent picked died before replying; the
            # agent unbound the lease — retry under the task's budget
            spec = nm.finish_leaf(msg["task_id"])
            if spec is not None:
                self._maybe_retry(msg["task_id"], spec, WorkerCrashedError(
                    f"leased worker died running {spec.name}"))
        elif mtype == "wdeath":
            handle = nm.worker_by_wid(msg["wid"])
            if handle is not None:
                if handle.proc.returncode is None:
                    handle.proc.returncode = 1
                self._on_worker_death(handle)
        elif mtype == "pong":
            # remote agents flush their structured-event buffer on the
            # keepalive reply (node_agent.py ping handler); timeline
            # spans recorded agent-side (transfer serves, spill IO) and
            # the agent's structured log records ride the same reply so
            # the head's dump covers every process
            events.ingest(msg.get("events") or [])
            timeline.ingest_events(msg.get("profile") or [])
            from ..utils import profiler as _profiler
            from ..utils import structlog as _structlog

            _structlog.ingest(msg.get("logs"))
            _profiler.ingest(msg.get("samples"))
            # delta-compressed control state rides the same reply:
            # status-key deltas merge into the node's head-side mirror
            # and held-row deltas (sim plane) land in the directory;
            # a seq gap raises the resync latch for the next ping
            nm.on_pong_delta(msg)

    def _bind_remote_worker(self, nm, handle: WorkerHandle) -> None:
        from .remote_node import VirtualConn

        vconn = VirtualConn(handle.worker_id.binary(), nm)
        with self._lock:
            handle.conn = vconn
            self._conn_handles[vconn] = handle
            self._conn_send_locks[vconn] = threading.Lock()
            pending = list(handle.pending_msgs)
            handle.pending_msgs.clear()
        nm.on_worker_ready(handle)
        for m in pending:
            self._send(handle, m)
        self._pump()

    def _on_agent_death(self, nm) -> None:
        """The agent channel broke: the whole remote node is gone (node
        death via heartbeat timeout / connection loss — NodeManager death
        handling, gcs_node_manager.h)."""
        with self._lock:
            if not nm.alive:
                return
            nm.mark_dead()
            self.gcs.mark_node_dead(nm.node_id)
            workers = list(nm.workers.values())
        # same drain ordering as remove_node: dead flag first, then the
        # queue snapshot under the node's lock, so a racing submit can
        # never land a spec behind the one-and-only drain
        with nm._lock:
            requeue = list(nm.queue)
            nm.queue.clear()
        for h in workers:
            self._on_worker_death(h)
        for spec in requeue:
            self._schedule(spec)
        # leases the dead agent held: no lease_dead frame is coming
        for task_id, spec in nm.take_leaf_inflight().items():
            self._maybe_retry(task_id, spec, WorkerCrashedError(
                f"node agent died with leased task {spec.name} in flight"))
        self.gcs.drop_node_objects(nm.node_id)
        self._wakeup()

    def add_remote_node_process(self, num_cpus: int = 4, num_gpus: int = 0,
                                timeout: float = 30.0) -> NodeID:
        """Spawn a node-agent subprocess joined to this head — the in-repo
        stand-in for ``rmt start --address`` on another host (and the test
        vehicle for the multi-host plane: the agent shares NOTHING with the
        head but the TCP channel)."""
        import subprocess
        import sys as _sys

        if self.node_listener_address is None:
            raise RuntimeError("node listener disabled by config")
        host, port = self.node_listener_address
        before = set(self.nodes)
        import os as _os

        env = dict(_os.environ)
        pkg_parent = _os.path.dirname(_os.path.dirname(
            _os.path.dirname(_os.path.abspath(__file__))))
        parts = [p for p in env.get("PYTHONPATH", "").split(_os.pathsep)
                 if p]
        if pkg_parent not in parts:
            env["PYTHONPATH"] = _os.pathsep.join([pkg_parent] + parts)
        proc = subprocess.Popen(
            [_sys.executable, "-m",
             "ray_memory_management_tpu_torch.core.node_agent",
             "--address", f"{host}:{port}",
             "--authkey", self._authkey.hex(),
             "--num-cpus", str(num_cpus),
             "--num-gpus", str(num_gpus)],
            env=env, close_fds=True,
        )
        self._agent_procs.append(proc)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                # match THIS child by its pid (registration carries the
                # agent's pid): a concurrently-registering agent must not
                # be attributed to our Popen handle
                new = [n for n in self.nodes if n not in before
                       and getattr(self.nodes[n], "agent_pid", None)
                       == proc.pid]
            if new:
                self._agent_proc_by_node[new[0]] = proc
                return new[0]
            if proc.poll() is not None:
                raise RuntimeError(
                    f"node agent exited rc={proc.returncode} before joining")
            time.sleep(0.05)
        raise TimeoutError("node agent did not register in time")

    def stop_remote_node(self, node_id: NodeID) -> None:
        """Gracefully retire an agent-process node: mark it dead in the
        cluster (requeueing its work) and terminate the agent process —
        the provider-side terminate half of the autoscaler contract."""
        self.remove_node(node_id)
        proc = self._agent_proc_by_node.pop(node_id, None)
        if proc is not None:
            try:
                proc.terminate()
                proc.wait(timeout=5.0)
            except Exception:
                pass

    def _send(self, handle: WorkerHandle, msg: dict) -> bool:
        with self._lock:
            if handle.conn is None:
                if handle.alive():
                    handle.pending_msgs.append(msg)
                    return True
                return False
            lock = self._conn_send_locks.get(handle.conn)
        if lock is None:
            return False
        try:
            with lock:
                handle.conn.send(msg)
            return True
        except (OSError, BrokenPipeError, ValueError):
            return False

    def _wakeup(self) -> None:
        try:
            os.write(self._wakeup_w, b"x")
        except OSError:
            pass

    # ---------------------------------------------------------- async sender
    def _sender_enqueue(self, handle: WorkerHandle, msg: dict) -> bool:
        """Queue a message for the connection's sender thread, which
        coalesces back-to-back dispatches to the same worker into one
        batch frame (one pickle + ONE pipe write). Every write to a worker
        pipe wakes its process — on a loaded host that is two context
        switches — so the write count, not the byte count, is the cost
        model; the calling thread never writes inline under load, it keeps
        producing while the pool drains (see _SenderPool for the
        slow-consumer isolation story)."""
        with self._lock:
            if handle.conn is None:
                if handle.alive():
                    handle.pending_msgs.append(msg)
                    return True
                return False
            conn = handle.conn
        with self._send_cond:
            chan = self._send_channels.get(conn)
            if chan is None:
                if conn not in self._conn_send_locks:
                    return False  # conn already swept by a death event
                chan = _SendChannel(conn, handle)
                self._send_channels[conn] = chan
        return self._sender_pool.enqueue(chan, msg)

    def _send_payload(self, conn, payload: dict) -> bool:
        lock = self._conn_send_locks.get(conn)
        if lock is None:
            return False
        try:
            with lock:
                conn.send(payload)
            return True
        except (OSError, BrokenPipeError, ValueError):
            return False

    # ---------------------------------------------------------------- router
    def _router_loop(self) -> None:
        """Single receive loop over all worker pipes.

        Uses one persistent epoll-backed selector: rebuilding a poll set per
        iteration (``multiprocessing.connection.wait``) costs ~100 us per
        round with tens of fds, which at high task rates was the single
        largest driver-side line item. Selectors are not thread-safe, so
        registration changes ride ``_router_adds`` and are applied here.
        """
        import selectors

        sel = selectors.DefaultSelector()
        sel.register(self._wakeup_r, selectors.EVENT_READ, None)
        registered: Dict[Any, Any] = {}

        def unregister(r) -> None:
            try:
                sel.unregister(r)
            except (KeyError, ValueError):
                pass
            registered.pop(r, None)

        def drain(r, on_msg, on_eof) -> None:
            # drain a bounded burst from this conn before moving on, so one
            # chatty peer cannot starve the others
            for _ in range(64):
                try:
                    msg = r.recv()
                except (EOFError, OSError):
                    unregister(r)
                    on_eof()
                    return
                on_msg(msg)
                try:
                    if not r.poll(0):
                        return
                except (OSError, ValueError):
                    return

        while not self._stop.is_set():
            with self._lock:
                adds = self._router_adds
                self._router_adds = []
                removals = self._router_removals
                self._router_removals = []
            for conn in removals:
                # conns closed outside the router (death by failed send)
                # must leave the selector HERE: a closed-but-registered fd
                # number can be reused by a new worker's pipe
                unregister(conn)
                try:
                    conn.close()
                except OSError:
                    pass
            for conn in adds:
                if conn not in registered and (
                        conn in self._conn_handles
                        or conn in self._agent_nodes):
                    try:
                        registered[conn] = sel.register(
                            conn, selectors.EVENT_READ, None)
                    except KeyError:
                        # fd number reused while a stale entry lingers:
                        # evict it and retry once
                        unregister(conn)
                        try:
                            registered[conn] = sel.register(
                                conn, selectors.EVENT_READ, None)
                        except (ValueError, KeyError, OSError):
                            pass
                    except (ValueError, OSError):
                        pass
            try:
                events = sel.select(timeout=0.25)
            except OSError:
                time.sleep(0.01)
                continue
            for key, _ in events:
                r = key.fileobj
                if r == self._wakeup_r:
                    try:
                        os.read(self._wakeup_r, 4096)
                    except OSError:
                        pass
                    continue
                handle = self._conn_handles.get(r)
                if handle is not None:
                    drain(r,
                          lambda m, h=handle: self._handle_worker_message(h, m),
                          lambda h=handle: self._on_worker_death(h))
                    continue
                nm = self._agent_nodes.get(r)
                if nm is not None:
                    def agent_eof(nm=nm, r=r):
                        self._agent_nodes.pop(r, None)
                        self._on_agent_death(nm)

                    drain(r, lambda m, n=nm: self._handle_agent_message(n, m),
                          agent_eof)
                    continue
                unregister(r)
            self._pump()

    def _handle_worker_message(self, handle: WorkerHandle, msg: dict) -> None:
        mtype = msg["type"]
        if mtype == "batch":  # coalesced replies from the worker's sender
            dones: List[dict] = []
            for m in msg["msgs"]:
                if m["type"] == "done":
                    dones.append(m)
                    continue
                if dones:  # flush in arrival order before the odd frame
                    self._on_tasks_done(handle, dones)
                    dones = []
                self._handle_worker_message(handle, m)
            if dones:
                self._on_tasks_done(handle, dones)
            return
        if mtype == "done":
            self._on_tasks_done(handle, [msg])
        elif mtype == "log":
            self._print_worker_log(handle, msg["data"])
        elif mtype == "stolen":
            self._on_tasks_stolen(handle, msg)
        elif mtype == "actor_created":
            self._on_actor_created(handle, msg)
        elif mtype == "device_materialized":
            self._on_device_materialized(handle, msg)
        elif mtype == "device_demoted":
            self._on_device_demoted(handle, msg)
        elif mtype == "device_consumed":
            self._on_device_consumed(handle, msg)
        elif mtype == "owned_put":
            # one-way registration of a worker-owned put: the worker
            # already minted the id and wrote its node store (zero
            # blocking round trips on the put path). Handled INLINE so
            # the location exists before the router reads this worker's
            # NEXT message — a nested submit referencing the id must not
            # race the registration on the request pool (the dep-ready
            # check treats future-less unknown ids as ready, so losing
            # that race would misread a live object as lost).
            self._on_owned_put(handle, msg)
        elif mtype == "profile":
            # flush frame from a worker's ticker (or its final exit
            # flush): straggler spans, plus optional piggybacked event,
            # log-record and metric-series batches that merge into the
            # head's buffers/registry (the agent->head aggregation path)
            if msg.get("profile"):
                timeline.ingest_events(msg["profile"])
            if msg.get("events"):
                events.ingest(msg["events"])
            if msg.get("logs"):
                from ..utils import structlog as _structlog

                _structlog.ingest(msg["logs"])
            if msg.get("series"):
                from ..utils import metrics as _metrics

                _metrics.merge_series(msg["series"])
            if msg.get("samples"):
                from ..utils import profiler as _profiler

                _profiler.ingest(msg["samples"])
        elif mtype == "pong":
            pass
        else:
            # nested-call requests from user code in the worker; may block on
            # futures, so never service them on the router thread
            self._request_pool.submit(self._serve_worker_request, handle, msg)

    def _print_worker_log(self, handle: WorkerHandle, data: bytes) -> None:
        """Worker stdout/stderr chunk -> driver output, one prefixed line at
        a time (the reference's log monitor format, ``(pid=..., ip=...)``).
        Chunks are joined per worker so a line split across reads does not
        print as two."""
        import sys

        wid = handle.worker_id
        buf = self._log_tails.get(wid, b"") + data
        lines, sep, tail = buf.rpartition(b"\n")
        self._log_tails[wid] = tail
        if not sep:
            return
        prefix = (f"(worker={wid.hex()[:8]} "
                  f"node={handle.node_id.hex()[:8]}) ")
        out = "".join(
            prefix + line + "\n"
            for line in lines.decode("utf-8", "replace").split("\n")
        )
        try:
            sys.stderr.write(out)
            sys.stderr.flush()
        except (OSError, ValueError):
            pass

    # ------------------------------------------------------- task submission
    def _index_trace_locked(self, trace_ctx, task_id: bytes) -> None:
        """With self._lock held: register a task under its trace so the
        state API can reconstruct the span tree after records prune.
        Python dicts iterate in insertion order, so eviction past the cap
        drops the OLDEST trace."""
        if not trace_ctx:
            return
        tasks = self._traces.get(trace_ctx[0])
        if tasks is None:
            while len(self._traces) >= self._traces_cap:
                self._traces.pop(next(iter(self._traces)), None)
            tasks = self._traces[trace_ctx[0]] = []
        tasks.append(task_id)

    def submit_task(self, payload: dict,
                    adopt_returns: bool = True) -> List[bytes]:
        # owning job: thin clients / job_submission drivers tag their
        # payloads; untagged submits (the in-process driver, worker-side
        # nested submits) belong to the root job. The task id inherits
        # the job's 4-byte prefix so returns are attributable by eye.
        job = payload.get("job_id") or self.job_id.binary()
        led = self.ledger_for(job)
        task_id = TaskID.for_task(
            self.job_id if job == self.job_id.binary() else JobID(job))
        num_returns = payload.get("num_returns", 1)
        return_ids = [
            ObjectID.for_return(task_id, i).binary() for i in range(num_returns)
        ]
        if payload.get("fn_blob") is not None:
            self.fn_blobs.setdefault(payload["fn_id"], payload["fn_blob"])
        # trace plane: a nested submit carries its parent context on the
        # payload (attached worker-side by WorkerRuntimeProxy); a driver
        # submit inherits any context the caller installed, else this
        # task roots a fresh trace
        parent_ctx = tracing.from_wire(payload.get("trace_parent")) \
            or tracing.get_current()
        trace_ctx = tracing.child_of(parent_ctx)
        spec = TaskSpec(
            task_id=task_id.binary(),
            name=payload.get("name", "task"),
            fn_id=payload["fn_id"],
            args=payload["args"],
            kwargs=payload.get("kwargs", {}),
            num_returns=num_returns,
            return_ids=return_ids,
            resources=payload.get("resources", {"CPU": 1.0}),
            strategy=payload.get("strategy"),
            max_retries=payload.get(
                "max_retries", self.config.task_max_retries
            ),
            retry_exceptions=payload.get("retry_exceptions", False),
            runtime_env=payload.get("runtime_env"),
            trace_ctx=trace_ctx,
            job_id=job,
        )
        rec = _TaskRecord(spec, payload, spec.max_retries,
                          gc_returns=adopt_returns)
        self._m_submitted.inc()
        with led.lock:
            led.tasks_submitted += 1
        with self._lock:
            self.tasks[spec.task_id] = rec
            self._index_trace_locked(trace_ctx, spec.task_id)
            for oid in return_ids:
                self.futures[oid] = _SlimFuture()
                self.lineage[oid] = spec.task_id
                if adopt_returns:
                    # pre-registered handle ref, ADOPTED by the
                    # caller's ObjectRef: without it a fast task
                    # completing before the wrap would see refcount
                    # zero and GC its result
                    self._incref(oid)
            # the pending task keeps its ref args (and their
            # lineage) alive even if the caller drops every handle
            # before it runs
            for oid in self._ref_deps(spec):
                self._incref(oid)
                self._lineage_dependents[oid] += 1
            nudge = self._queue_when_deps_ready_locked(spec)
        if nudge:
            self._wakeup()
        return return_ids

    def _ref_deps(self, spec: TaskSpec) -> List[bytes]:
        return spec.ref_deps  # cached on the spec (see TaskSpec.ref_deps)

    def _queue_when_deps_ready_locked(self, spec: TaskSpec) -> bool:  # rmtcheck: holds=_lock
        """With self._lock held: either park the task on its unresolved
        deps (LocalDependencyResolver analog, dependency_resolver.h:29) or
        append it to the submit queue for the router's batched scheduling
        pass. Returns True when the caller should nudge the router."""
        missing: Set[bytes] = set()
        for oid in self._ref_deps(spec):
            fut = self.futures.get(oid)
            if fut is not None and not fut.done():
                missing.add(oid)
        if missing:
            self._waiting_deps[spec.task_id] = missing
            for oid in missing:
                self._dep_waiters[oid].append(spec.task_id)
            return False
        rec = self.tasks.get(spec.task_id)
        if rec is not None:
            rec.ts["QUEUED"] = time.time()
        self._submit_q.append(spec)
        if self._submit_nudged:
            return False
        self._submit_nudged = True
        return True

    def _resolve_deps_then_schedule(self, spec: TaskSpec) -> None:
        """Queue the task once its args are materialized; the router pump
        schedules queued tasks in batches."""
        with self._lock:
            nudge = self._queue_when_deps_ready_locked(spec)
        if nudge:
            self._wakeup()

    def _deps_ready_locked(self, oid: bytes) -> bool:  # rmtcheck: holds=_lock
        """With self._lock held: resolve every task parked on ``oid``,
        queueing newly-unblocked specs for the router's batched scheduling
        pass. Returns True when the caller should nudge the router."""
        nudge = False
        for task_id in self._dep_waiters.pop(oid, ()):
            missing = self._waiting_deps.get(task_id)
            if missing is None:
                continue
            missing.discard(oid)
            if not missing:
                del self._waiting_deps[task_id]
                rec = self.tasks.get(task_id)
                if rec:
                    rec.ts["QUEUED"] = time.time()
                    self._submit_q.append(rec.spec)
                    if not self._submit_nudged:
                        self._submit_nudged = True
                        nudge = True
        return nudge

    def _on_dep_ready(self, oid: bytes) -> None:
        with self._lock:
            nudge = self._deps_ready_locked(oid)
        if nudge:
            self._wakeup()

    def _release_pg_allocation(self, spec: TaskSpec) -> None:
        if spec.placement is not None and self.pg_manager is not None:
            self.pg_manager.release_key(spec.task_id)

    def _release_task_args(self, spec: TaskSpec) -> None:
        """Drop the references a task held on its ref args (idempotent;
        called from every terminal path)."""
        with self._lock:
            rec = self.tasks.get(spec.task_id)
            if rec is None or rec.args_released:
                return
            rec.args_released = True
        for oid in self._ref_deps(spec):
            self.remove_local_ref(oid)

    def _fail_task(self, spec: TaskSpec, exc: Exception) -> None:
        self._release_pg_allocation(spec)
        with self._lock:
            for oid in spec.return_ids:
                fut = self.futures.get(oid)
                if fut and not fut.done():
                    fut.set_exception(exc)
            rec = self.tasks.get(spec.task_id)
            if rec:
                rec.state = "FAILED"
                rec.ts["FAILED"] = time.time()
        if rec:
            self._m_failed.inc()
        self._release_task_args(spec)
        self._release_job_slot(spec)

    # --------------------------------------------- agent-local leaf scheduling
    def _leaf_eligible(self, spec: TaskSpec) -> bool:
        """A LEAF task may bypass the head's full placement pass: no
        placement-group/affinity constraint, no runtime_env, not an
        actor method, at most one CPU (and nothing else), and every ref
        arg already in the driver memory store — so the exec frame is
        self-contained (args inline, no transfer planning, no locality
        scoring)."""
        if (spec.is_actor_task or spec.strategy is not None
                or spec.placement is not None or spec.runtime_env):
            return False
        req = spec.req
        for name in req.names():
            if name == CPU:
                if req.get(name) > 1.0:
                    return False
            elif req.get(name):
                return False
        for oid in self._ref_deps(spec):
            if oid not in self.memory_store:
                return False
        return True

    def _try_leaf_place(self, spec: TaskSpec) -> bool:
        """Decentralized leaf dispatch: hand the task straight to a node
        holding spare lease credit (round-robin over nodes), skipping
        pick_node + locality. A local node rides its ordinary dispatch
        queue; a remote node gets the fully-built exec frame and its
        AGENT picks the worker (lease_exec). Every pool saturated →
        spillback to the shared scheduler."""
        nodes = list(self.nodes.values())
        if not nodes:
            return False
        n = len(nodes)
        # sticky round-robin: place short RUNS (4 tasks) on one node
        # before advancing, so a burst reaches each node as a few
        # contiguous dispatches instead of a per-task interleave — the
        # node's dispatch thread wakes once per run, not once per task
        if self._leaf_run >= 4:
            self._leaf_rr += 1
            self._leaf_run = 0
        start = self._leaf_rr % n
        placed = False
        for i in range(n):
            idx = (start + i) % n
            nm = nodes[idx]
            if nm.submit_leaf(spec, self._leaf_task_msg):
                if idx == start:
                    self._leaf_run += 1
                else:
                    self._leaf_rr, self._leaf_run = idx, 1
                placed = True
                break
        if not placed:
            self._m_leaf_spill.inc()
            return False
        self._m_leaf_placed.inc()
        with self._lock:
            rec = self.tasks.get(spec.task_id)
            if rec:
                rec.state = "SCHEDULED"
                rec.ts["SCHEDULED"] = time.time()
        return True

    def _leaf_task_msg(self, nm, spec: TaskSpec) -> dict:
        """The exec frame for an agent-routed leaf task. Unlike
        _task_msg the fn blob ships once per NODE (the agent re-attaches
        it per worker from its own cache) and args are always inline —
        _leaf_eligible required every ref dep in the memory store."""
        args = [self._finalize_arg(a) for a in spec.args]
        kwargs = {k: self._finalize_arg(v) for k, v in spec.kwargs.items()}
        msg = {
            "type": "exec", "task_id": spec.task_id, "fn_id": spec.fn_id,
            "name": spec.name, "args": args, "kwargs": kwargs,
            "return_ids": spec.return_ids,
        }
        with nm._lock:
            if spec.fn_id not in nm.lease_known_fns:
                msg["fn_blob"] = self.fn_blobs[spec.fn_id]
                nm.lease_known_fns.add(spec.fn_id)
        if spec.trace_ctx:
            msg["trace_ctx"] = spec.trace_ctx
        return msg

    def _schedule(self, spec: TaskSpec, pump: bool = True,
                  locality: Optional[Dict[NodeID, int]] = None) -> None:
        if spec.task_id in self._cancelled:
            self._fail_task(spec, TaskError(spec.name, None, "cancelled"))
            return
        strategy = spec.strategy
        if isinstance(strategy, PlacementGroupSchedulingStrategy) or (
            spec.placement is not None
        ):
            from .placement_group import resolve_pg_node

            node_id = resolve_pg_node(self, spec)
            if node_id is None:
                with self._lock:
                    self._pending_schedule.append(spec)
                return
        else:
            if locality is None:
                # non-batched callers (retries, node-death re-placement):
                # compute this spec's locality solo
                locality = self._batch_locality([spec]).get(spec.task_id)
            try:
                node_id = self.scheduler.pick_node(spec.req, strategy,
                                                   locality=locality)
            except InfeasibleRequestError as e:
                if self.autoscaling:
                    # a node the autoscaler adds may hold it: it waits as
                    # the autoscaler's pending demand, retried every pass
                    # (the reference's infeasible queue)
                    with self._lock:
                        self._pending_schedule.append(spec)
                    return
                self._fail_task(spec, TaskError(spec.name, None, str(e)))
                return
            except ValueError as e:
                self._fail_task(spec, TaskError(spec.name, None, str(e)))
                return
            if node_id is None:
                with self._lock:
                    self._pending_schedule.append(spec)
                return
        self._place_on_node(spec, node_id, pump=pump)

    def _submit_to_node(self, node_id: NodeID, spec: TaskSpec) -> None:
        """Hand one spec to a node's dispatch queue under the dispatch
        RetryPolicy: a transient control.dispatch failure (the injectable
        fault site in NodeManager.submit) is retried with backoff instead
        of failing a task the cluster could still run."""
        try:
            self._dispatch_retry.run(self.nodes[node_id].submit, spec)
        except NodeDeadError:
            # the node died between placement and hand-off (e.g. while
            # this task's args were still in transfer) — re-place on a
            # live node instead of wedging on a queue nobody drains
            self._schedule(spec)

    def _place_on_node(self, spec: TaskSpec, node_id: NodeID,
                       pump: bool = True) -> None:
        nm = self.nodes[node_id]
        if not self._ensure_args_local(spec, node_id):
            return  # transfer in flight; re-placed when it completes
        had_backlog = bool(nm.queue)
        self._submit_to_node(node_id, spec)
        with self._lock:
            rec = self.tasks.get(spec.task_id)
            if rec:
                rec.state = "SCHEDULED"
                rec.ts["SCHEDULED"] = time.time()
        if not pump:
            return  # router pump dispatches for the whole batch
        if had_backlog:
            # a backlogged node dispatches from the router's pump on every
            # completion; re-running the head-of-line check per submit
            # would be O(queue) work for nothing. The self-pipe nudge is
            # ~1 us and wakes no other process.
            self._wakeup()
        else:
            self._pump_node(nm)

    def _ensure_args_local(self, spec: TaskSpec, node_id: NodeID) -> bool:
        """Make every ref arg readable on ``node_id``'s store. Inline args in
        the driver memory store don't need transfer (they ship in the exec
        message). Cross-node copies run on the transfer pool — the chunked
        push/pull object plane (object_manager.h:114) collapsed to a same-host
        memcpy."""
        to_fetch: List[Tuple[bytes, list]] = []
        with self._lock:
            for oid in self._ref_deps(spec):
                if oid in self.memory_store:
                    continue
                target_store = self.nodes[node_id].store
                if target_store.contains(oid):
                    continue
                locs = self.gcs.get_object_locations(oid)
                locs = [l for l in locs if l != node_id and
                        self.nodes.get(l) and self.nodes[l].alive]
                if not locs:
                    if oid in self._device_locations:
                        # device-resident dep: materialize off the router
                        # thread, then re-place the task
                        self._transfer_pool.submit(
                            self._materialize_then_reschedule, oid, spec,
                            node_id)
                        return False
                    # lost object: trigger recovery, then retry scheduling
                    self._transfer_pool.submit(
                        self._recover_then_reschedule, oid, spec, node_id
                    )
                    return False
                # hold the CANDIDATE set, not a picked source: the pick
                # happens inside _transfer_from on the transfer thread,
                # where the broadcast gate can first wait for an earlier
                # in-flight copy to land and then pull from the NEW holder
                # (distribution tree) — a pick taken here, possibly
                # seconds before the transfer runs, would always name the
                # original producer
                to_fetch.append((oid, locs))
        if not to_fetch:
            return True
        prestage = bool(self.config.argument_prefetch)

        def do_transfers(resubmit: bool = True):
            lost = None
            degraded = []
            landed = 0
            for oid, locs in to_fetch:
                try:
                    self._transfer_from(oid, locs, node_id)
                    landed += 1
                except Exception as e:  # noqa: BLE001
                    # A failed or backpressured prefetch must never fail
                    # the task while the object is still live somewhere:
                    # the worker's own arg fetch (get_objects ->
                    # _serve_get) re-transfers, restores from spill, or
                    # serves the bytes inline as its last resort. Only a
                    # genuinely lost object goes to lineage recovery.
                    if self._object_alive(oid):
                        degraded.append((oid, e))
                    elif lost is None:
                        lost = (oid, e)
            if lost is not None:
                if resubmit:
                    # recovery re-places the task (and fails it only when
                    # the object is unrecoverable)
                    self._recover_then_reschedule(lost[0], spec, node_id)
                    return
                # prestaged task is already on the node's dispatch queue:
                # its worker's arg get runs lineage recovery (_serve_get)
                degraded.append(lost)
            if degraded:
                events.emit(
                    "TRANSFER_DEGRADED",
                    f"dispatching {spec.name} with {len(degraded)} arg(s) "
                    f"not prefetched (first: {degraded[0][0].hex()[:8]}: "
                    f"{degraded[0][1]!r}); worker will fetch inline",
                    severity=events.WARNING, source="object_manager")
            if not resubmit:
                # prestage epilogue: the task was submitted before the
                # pull started — just account, stamp, and nudge dispatch
                if landed:
                    self._m_prefetch_completed.inc(landed)
                with self._lock:
                    rec = self.tasks.get(spec.task_id)
                    if rec:
                        rec.ts["PREFETCH_DONE"] = time.time()
                self._wakeup()
                return
            try:
                self._submit_to_node(node_id, spec)
                self._wakeup()
            except Exception as e:  # noqa: BLE001
                self._fail_task(spec, TaskError(spec.name, e))

        if prestage:
            # pipelined argument prestage: hand the task to the node's
            # dispatch queue NOW and pull its args concurrently, so the
            # striped pull overlaps queue wait instead of serializing in
            # front of execution. Safe because a worker that dequeues the
            # task early simply blocks in its arg get until the SAME copy
            # lands (create_or_wait dedupes racing fetches) or falls back
            # to the inline-serve path.
            with self._lock:
                rec = self.tasks.get(spec.task_id)
                if rec:
                    rec.ts.setdefault("PREFETCH_START", time.time())
            self._m_prefetch_started.inc(len(to_fetch))
            self._transfer_pool.submit(
                self._with_trace, spec.trace_ctx, do_transfers, False)
            return True
        self._transfer_pool.submit(
            self._with_trace, spec.trace_ctx, do_transfers)
        return False

    @staticmethod
    def _with_trace(ctx, fn, *args):
        """Run ``fn`` on this (pool) thread with ``ctx`` installed as the
        current trace context: transfers happen off the submitting thread,
        so the context must travel to the thread doing the IO for the
        spans/wire-requests it records to name the right task."""
        token = tracing.set_current(ctx)
        try:
            return fn(*args)
        finally:
            tracing.reset(token)

    def _object_alive(self, oid: bytes) -> bool:
        """True while ANY live copy exists: the driver memory store, or a
        live node's store/spill tier (GCS locations cover both — spilled
        objects keep their node's location)."""
        with self._lock:
            if oid in self.memory_store:
                return True
        return any(
            self.nodes.get(l) is not None and self.nodes[l].alive
            for l in self.gcs.get_object_locations(oid))

    def _xfer_dec_locked(self, src: NodeID) -> None:
        n = self._xfer_serving.get(src, 1) - 1
        if n > 0:
            self._xfer_serving[src] = n
        else:
            self._xfer_serving.pop(src, None)

    def _pick_transfer_source(self, locs) -> NodeID:
        """Least-loaded holder, taking a serve count the caller MUST pair
        with ``_xfer_dec_locked`` (``_transfer_from`` does) — the single
        source-selection point for every transfer path."""
        with self._lock:
            src = min(locs, key=lambda l: self._xfer_serving.get(l, 0))
            self._xfer_serving[src] = self._xfer_serving.get(src, 0) + 1
            self._xfer_served_total[src] = (
                self._xfer_served_total.get(src, 0) + 1)
        return src

    def _live_holders(self, oid: bytes, dst: NodeID) -> list:
        """Current live holders of ``oid`` other than ``dst`` — re-read at
        transfer time so pulls that waited at the broadcast gate see
        copies that landed while they waited."""
        return [l for l in self.gcs.get_object_locations(oid)
                if l != dst and self.nodes.get(l) is not None
                and self.nodes[l].alive]

    def _holder_addrs(self, oid: bytes) -> list:
        """Transfer-plane (host, port) addresses of the CURRENT live
        holders of ``oid`` — the alt-source resolver a fetch re-invokes
        at each failover, so holders that died mid-pull are excluded and
        copies that landed since are found. Head-local holders serve via
        their lazy local TransferServer ("" host = loopback for the
        head; agents receive their head_ip substitution in _obj_fetch)."""
        out = []
        for l in self.gcs.get_object_locations(oid):
            nm = self.nodes.get(l)
            if nm is None or not nm.alive:
                continue
            addr = getattr(nm, "transfer_addr", None)
            if addr is not None:
                out.append((addr[0], addr[1]))
            elif getattr(nm, "store", None) is not None:
                try:
                    out.append(("", self._local_transfer_server(l).port))
                except Exception:  # noqa: BLE001
                    pass
        return out

    def _fetch_policy(self):
        """The head-side transfer RetryPolicy from config knobs."""
        from ..utils.retry import RetryPolicy

        return RetryPolicy(
            max_attempts=self.config.transfer_retry_attempts,
            base_backoff_s=self.config.transfer_retry_backoff_s,
            plane="transfer")

    def _prune_stale_location(self, oid: bytes, node_id: NodeID,
                              err: Optional[str]) -> None:
        """Drop a GCS object-directory location that a fetch proved stale
        ("object not in store"): the directory said the holder had it, the
        holder disagreed — leaving the entry would re-route every retry
        and failover back to the same empty holder."""
        if not err or "object not in store" not in err:
            return
        try:
            self.gcs.prune_location(oid, node_id)
        except Exception:  # noqa: BLE001
            pass

    def _broadcast_admit(self, oid: bytes, timeout: float = 15.0) -> None:
        """Distribution-tree admission for multi-destination pulls of ONE
        object: at most ``transfer_broadcast_fanout`` concurrent pulls per
        live holder. Excess pulls WAIT until an in-flight copy lands —
        each landing registers a new holder in the GCS, raising the cap
        AND giving the waiter a closer source, so an n-destination
        broadcast becomes a pipelined tree (O(size·log n) source egress)
        instead of n serial streams off one node. The gate is advisory:
        waits are deadline-bounded and a timeout proceeds anyway (worst
        case is the old source-bottlenecked behavior, never a stall)."""
        fanout = self.config.transfer_broadcast_fanout
        if fanout <= 0:
            return
        deadline = time.monotonic() + timeout
        waited = False
        with self._bcast_cond:
            while True:
                holders = max(1, len(self._live_holders(oid, dst=None)))
                if self._oid_pulls.get(oid, 0) < fanout * holders:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                waited = True
                self._bcast_cond.wait(min(remaining, 1.0))
            self._oid_pulls[oid] = self._oid_pulls.get(oid, 0) + 1
        if waited:
            try:
                from . import metrics_defs as mdefs

                mdefs.transfer_broadcast_waits().inc()
            except Exception:  # noqa: BLE001
                pass

    def _broadcast_release(self, oid: bytes) -> None:
        with self._bcast_cond:
            n = self._oid_pulls.get(oid, 1) - 1
            if n > 0:
                self._oid_pulls[oid] = n
            else:
                self._oid_pulls.pop(oid, None)
            self._bcast_cond.notify_all()

    def _transfer_from(self, oid: bytes, locs, dst: NodeID) -> None:
        """Move ``oid`` to ``dst`` from the best CURRENT holder. Admission
        through the broadcast gate first (late pulls in a fan-out wait for
        an earlier copy, then pull from the new holder), then a fresh
        holder read — the passed ``locs`` is only the fallback when the
        re-read finds nothing (e.g. locations not yet registered). Serve
        accounting is balanced on every exit."""
        self._broadcast_admit(oid)
        try:
            fresh = self._live_holders(oid, dst)
            src = self._pick_transfer_source(fresh or locs)
            try:
                self._transfer_object(oid, src, dst)
            finally:
                with self._lock:
                    self._xfer_dec_locked(src)
        finally:
            self._broadcast_release(oid)

    def _local_transfer_server(self, node_id: NodeID):
        """Lazy TransferServer over a LOCAL node's store, so remote agents
        can pull its objects directly (the head serves like any peer)."""
        from .transfer import TransferServer

        with self._lock:
            srv = self._xfer_servers.get(node_id)
            if srv is None:
                srv = TransferServer(
                    self.nodes[node_id].store, self._authkey,
                    self.config.object_manager_chunk_size,
                    max_conns=self.config.transfer_max_conns,
                    idle_timeout=self.config.transfer_idle_timeout_s,
                    compress_min_bytes=(
                        self.config.transfer_compress_min_bytes))
                self._xfer_servers[node_id] = srv
        return srv

    def _transfer_object(self, oid: bytes, src: NodeID, dst: NodeID) -> None:
        """Move an object between node stores, recording ONE transfer
        span per movement (every path — memcpy, channel push, p2p pull —
        funnels through here). The span is a CHILD of the current trace
        context (the task the transfer serves, installed by _with_trace),
        so Perfetto draws task→transfer arrows and the critical-path
        summary can attribute the time."""
        cur = tracing.get_current()
        ctx = tracing.child_of(cur) if cur else None
        t0 = time.time()
        try:
            self._transfer_object_impl(oid, src, dst, trace=ctx)
        finally:
            timeline.record_event(
                f"transfer::{oid.hex()[:8]}", "transfer", t0, time.time(),
                extra={"oid": oid.hex(), "src": str(src), "dst": str(dst)},
                trace=ctx)

    def _transfer_object_impl(self, oid: bytes, src: NodeID, dst: NodeID,
                              trace=None) -> None:
        """Move an object between node stores. Same-host pairs memcpy
        between shm mappings. Pairs involving a remote node are
        RECEIVER-DRIVEN over the p2p transfer plane (transfer.py): the
        destination pulls chunks straight from the source's transfer
        server, so payload bytes never transit the head and never queue
        behind dispatch frames on the agent channel (the reference's
        object-manager peer pull, object_manager.h:114). The channel
        push/pull path remains as the fallback."""
        from .remote_node import RemoteNodeManager

        src_nm = self.nodes[src]
        dst_nm = self.nodes[dst]
        src_remote = isinstance(src_nm, RemoteNodeManager)
        dst_remote = isinstance(dst_nm, RemoteNodeManager)

        if dst_remote:
            # destination agent pulls from the source's server; when the
            # two share a host it maps the source's shm segment directly
            # and memcpys (no TCP, no chunk protocol)
            if src_remote:
                addr = src_nm.transfer_addr
                src_store = (src_nm.remote_store_name
                             if src_nm.hostname == dst_nm.hostname else None)
            else:
                addr = ("", self._local_transfer_server(src).port)
                src_store = (src_nm.store_name
                             if dst_nm.hostname == self._hostname else None)
            if addr is not None:
                err = dst_nm.fetch_from_peer(oid, addr[0], addr[1],
                                             src_store=src_store,
                                             alts=self._holder_addrs(oid),
                                             trace=trace)
                if err is None:
                    self.gcs.add_object_location(oid, dst)
                    return
                events.emit(
                    "TRANSFER_FALLBACK",
                    f"p2p fetch of {oid.hex()[:8]} failed ({err}); "
                    "falling back to channel push",
                    severity=events.WARNING, source="object_manager")
        elif src_remote:
            # local destination: the head pulls from the source's server
            # straight into the destination store (no staging buffer)
            addr = src_nm.transfer_addr
            if addr is not None:
                from .transfer import fetch_object

                err = fetch_object(
                    addr[0], addr[1], self._authkey, oid, dst_nm.store,
                    self.config.object_manager_chunk_size,
                    pool=self._xfer_conn_pool,
                    stripe_threshold=self.config.transfer_stripe_threshold,
                    stripe_count=self.config.transfer_stripe_count,
                    alt_sources=lambda: self._holder_addrs(oid),
                    retry=self._fetch_policy(),
                    verify_checksum=self.config.transfer_verify_checksum,
                    stripe_deadline=self.config.transfer_stripe_deadline_s,
                    trace=trace,
                    codecs=wire_codec.client_codecs(self.config))
                if err is None:
                    self.gcs.add_object_location(oid, dst)
                    return
                self._prune_stale_location(oid, src, err)
                events.emit(
                    "TRANSFER_FALLBACK",
                    f"p2p fetch of {oid.hex()[:8]} failed ({err}); "
                    "falling back to channel pull",
                    severity=events.WARNING, source="object_manager")

        # same-host memcpy, or the channel push/pull fallback
        src_cli = self._store_client_for(src)
        view = src_cli.get(oid)  # local: shm view; remote: pulled bytes
        if view is None and src_cli is not getattr(src_nm, "store", None):
            # same-host mapping can't see objects SPILLED inside the
            # source agent; the channel proxy serves them from the spill
            # file (mirror of the _read_from_stores fallback)
            proxy = getattr(src_nm, "store", None)
            if proxy is not None:
                view = proxy.get(oid)
                src_cli = proxy
        if view is None:
            raise ObjectLostError(oid.hex(), f"vanished from {src}")
        try:
            if dst_remote:
                ok, perr = dst_nm.push_object(oid, view)
                if not ok:
                    # our read ref (view) kept the source copy live the
                    # whole time — a receiver that stayed full past the
                    # retry budget is PRESSURE, not loss; type the error
                    # so callers degrade (inline-serve / dispatch-anyway)
                    # instead of reporting a live object lost
                    if perr and "retryable" in perr:
                        raise ObjectStoreFullError(
                            f"push of {oid.hex()[:8]} to "
                            f"{dst_nm.hostname} backpressured past the "
                            f"retry budget ({perr})")
                    raise ObjectLostError(
                        oid.hex(),
                        f"push to {dst_nm.hostname} failed ({perr})")
            else:
                dst_store = dst_nm.store
                chunk = self.config.object_manager_chunk_size
                try:
                    buf = dst_store.create(oid, view.nbytes)
                except ValueError:
                    return  # already there
                for off in range(0, view.nbytes, chunk):
                    end = min(off + chunk, view.nbytes)
                    buf[off:end] = view[off:end]
                dst_store.seal(oid)
                # same-host copies count as data movement too — without
                # this the virtual-node benches under-report bytes moved
                mdefs.transfer_bytes().observe(
                    float(view.nbytes), tags={"direction": "local_copy"})
            self.gcs.add_object_location(oid, dst, size=view.nbytes)
        finally:
            src_cli.release(oid)

    def _recover_then_reschedule(self, oid: bytes, spec: TaskSpec,
                                 node_id: NodeID) -> None:
        try:
            self._recover_object(oid)
            self._place_on_node(spec, node_id)
        except Exception as e:
            self._fail_task(spec, TaskError(spec.name, e))

    def _materialize_then_reschedule(self, oid: bytes, spec: TaskSpec,
                                     node_id: NodeID) -> None:
        try:
            if not self._ensure_device_materialized(oid):
                self._recover_object(oid)
            self._place_on_node(spec, node_id)
        except Exception as e:
            self._fail_task(spec, TaskError(spec.name, e))

    def _batch_locality(self, specs) -> Dict[TaskID, Dict[NodeID, int]]:
        """Per-task argument-bytes-by-node for a scheduling batch: ONE
        batched GCS directory lookup (locate_objects) over the union of
        every task's ref args, folded into ``{task_id: {node_id:
        bytes}}`` for the scheduler's soft locality score. Memory-store
        (inline) args never count — they ship in the exec message.
        Tasks with no ref args are absent from the result (the common
        no-arg task pays one attribute check, nothing else)."""
        if self.config.scheduler_locality_weight <= 0:
            return {}
        want: Set[bytes] = set()
        deps_by_task = []
        for spec in specs:
            deps = self._ref_deps(spec)
            if deps:
                deps_by_task.append((spec, deps))
                want.update(deps)
        if not want:
            return {}
        with self._lock:
            want = {oid for oid in want if oid not in self.memory_store}
        if not want:
            return {}
        directory = self.gcs.locate_objects(want)
        out: Dict[TaskID, Dict[NodeID, int]] = {}
        for spec, deps in deps_by_task:
            acc: Dict[NodeID, int] = {}
            for oid in deps:
                size, holders, tiers = directory.get(oid, (0, (), {}))
                if not size:
                    continue
                for nid in holders:
                    # device-resident args count double: running where
                    # the HBM pin lives avoids the device→host
                    # materialization on top of the wire transfer
                    w = 2 if tiers.get(nid) == "hbm" else 1
                    acc[nid] = acc.get(nid, 0) + size * w
            if acc:
                out[spec.task_id] = acc
        return out

    # ------------------------------------------------------------- dispatch
    def _pump(self) -> None:
        if self.pg_manager is not None:
            self.pg_manager.retry_pending()
        # free-flushing is ROUTER-only work: an application thread that
        # inline-pumps on submit must not pay for store deletes + record
        # prune cascades there (that cost on the submitting thread is
        # what the deferred buffer exists to avoid)
        if threading.current_thread() is self._router:
            self._flush_deferred_frees()
        with self._lock:
            submits = list(self._submit_q)
            self._submit_q.clear()
            self._submit_nudged = False
            pending = list(self._pending_schedule)
            self._pending_schedule.clear()
        # batched scheduling: place every queued task first (no per-task
        # dispatch pump), then run ONE dispatch pass per node below.
        # Locality is computed for the WHOLE batch up front — one GCS
        # directory lookup over the union of every task's ref args, not
        # one per task per candidate node
        multi_job = len(self._job_ledgers) > 1
        for batch, fresh in ((submits, True), (pending, False)):
            if not batch:
                continue
            if multi_job:
                # job plane: park specs whose job is at its cpu_slots cap
                # (they re-enter as slots free), then interleave the rest
                # by stride-scheduled virtual time so concurrent jobs get
                # priority-weighted fair shares of this drain
                batch = self._admit_batch(batch)
                if not batch:
                    continue
            if fresh and self._leaf_enabled:
                # leaf fast path: fresh submits only — spillbacks and
                # retries arrive via _pending_schedule and always take
                # the full pass (no leaf ping-pong)
                rest = []
                for spec in batch:
                    if (spec.task_id in self._cancelled
                            or not self._leaf_eligible(spec)
                            or not self._try_leaf_place_or_preempt(spec)):
                        rest.append(spec)
                batch = rest
                if not batch:
                    continue
            loc_by_task = self._batch_locality(batch)
            for spec in batch:
                self._schedule(spec, pump=False,
                               locality=loc_by_task.get(spec.task_id, {}))
        bounced = False
        for nm in list(self.nodes.values()):
            # ship this pass's buffered leaf grants: one lease_batch
            # frame per node instead of one lease_exec per task. Specs a
            # broken channel bounced reroute like a lease_spill.
            for spec in nm.flush_leases():
                self._m_leaf_spill.inc()
                with self._lock:
                    self._pending_schedule.append(spec)
                bounced = True
            self._pump_node(nm)
        if bounced:
            self._wakeup()

    def _pump_node(self, nm: NodeManager) -> None:
        nm.try_dispatch(self._send_task)
        victim = nm.pick_steal_victim()
        if victim is not None:
            # idle capacity + pipelined backlog elsewhere: ask the busiest
            # worker to hand back its not-yet-started tasks (work stealing).
            # The steal frame rides the SENDER QUEUE so it cannot overtake
            # task frames still queued for this conn, and holds the
            # victim's send_lock so it serializes with a concurrent
            # _send_task msg build — otherwise the steal could slip ahead
            # of a pipelined dispatch whose fn_blob decision predates it.
            with victim.send_lock:
                ok = self._sender_enqueue(victim, {"type": "steal"})
            if not ok:
                victim.steal_pending = False
                self._on_worker_death(victim)  # retries its inflight

    def _on_tasks_stolen(self, handle: WorkerHandle, msg: dict) -> None:
        nm = self.nodes.get(handle.node_id)
        if nm is None:
            return
        specs, queued = nm.return_stolen(handle, msg["task_ids"])
        if queued:
            if specs:
                self._pump_node(nm)
            return
        # the node died after the steal was asked for: its queue is gone,
        # so the returned tasks are placed again on a live node
        for spec in specs:
            self._schedule(spec)

    def _send_task(self, handle: WorkerHandle, spec: TaskSpec) -> None:
        # two dispatchers can target one worker concurrently (submit-path
        # pump + router pump); the fn_blob ships-once decision inside
        # _task_msg must stay atomic with enqueue order
        with handle.send_lock:
            msg = self._task_msg(handle, spec)
            ok = self._sender_enqueue(handle, msg)
        if not ok:
            self._on_worker_death(handle)
            return
        rec = self.tasks.get(spec.task_id)  # lock-free: dict read + stamp
        if rec is not None:
            rec.ts["DISPATCHED"] = time.time()

    def _task_msg(self, handle: WorkerHandle, spec: TaskSpec) -> dict:
        args = [self._finalize_arg(a) for a in spec.args]
        kwargs = {k: self._finalize_arg(v) for k, v in spec.kwargs.items()}
        if spec.is_actor_task:
            msg = {
                "type": "exec_actor", "task_id": spec.task_id,
                "actor_id": spec.actor_id, "method": spec.method,
                "name": spec.name, "args": args, "kwargs": kwargs,
                "return_ids": spec.return_ids, "seq": spec.seq,
            }
        else:
            msg = {
                "type": "exec", "task_id": spec.task_id, "fn_id": spec.fn_id,
                "name": spec.name, "args": args, "kwargs": kwargs,
                "return_ids": spec.return_ids,
            }
            if spec.runtime_env:
                msg["runtime_env"] = spec.runtime_env
            if spec.fn_id not in handle.known_fns:
                msg["fn_blob"] = self.fn_blobs[spec.fn_id]
                handle.known_fns.add(spec.fn_id)
            if handle.visible_chips is not None:
                msg["visible_chips"] = ",".join(
                    str(c) for c in handle.visible_chips
                )
        if spec.trace_ctx:
            # the dispatch frame carries the task's trace context so the
            # worker's exec span (and any nested submit inside the task
            # body) lands on the same causal chain
            msg["trace_ctx"] = spec.trace_ctx
        return msg

    def _finalize_arg(self, arg):
        kind, payload = arg
        if kind == "ref":
            data = self.memory_store.get(payload)
            if data is not None:
                return ("v", data)
        return arg

    # ------------------------------------------------------------ completion
    def _on_tasks_done(self, handle: WorkerHandle, msgs: List[dict]) -> None:
        """Process a burst of task completions from one worker. The success
        path takes self._lock ONCE for the whole burst (futures, return
        locations, dep-waiter resolution) — per-message locking was the
        completion side's dominant cost at high task rates."""
        profile: List[dict] = []
        logs: List[dict] = []
        samples: List[dict] = []
        for m in msgs:
            if m.get("profile"):
                profile.extend(m["profile"])
            if m.get("logs"):
                logs.extend(m["logs"])
            if m.get("samples"):
                samples.extend(m["samples"])
        if profile:
            timeline.ingest_events(profile)
        if logs:
            # BEFORE futures resolve: a task's last log line must be
            # queryable (state.get_logs) the moment its get() returns
            from ..utils import structlog as _structlog

            _structlog.ingest(logs)
        if samples:
            # same contract as logs: the burner's stacks are queryable
            # (state.get_profile) the moment its get() returns
            from ..utils import profiler as _profiler

            _profiler.ingest(samples)
        nm = self.nodes.get(handle.node_id)
        for m in msgs:
            # borrowed-ref tables ride every done reply (success or not)
            if m.get("borrows") or m.get("releases") \
                    or m.get("owned_drops"):
                self._apply_worker_ref_tables(
                    handle, m.get("borrows"), m.get("releases"),
                    m.get("owned_drops"))
        simple: List[tuple] = []
        errored: List[tuple] = []
        for m in msgs:
            task_id = m["task_id"]
            spec = handle.inflight.get(task_id)
            if spec is not None:
                if nm:
                    nm.finish_task(handle, task_id)
            elif nm:
                # agent-leased leaf task: the head's worker handle never
                # saw the dispatch, so finish_task would re-idle an
                # already-idle handle — return the lease credit instead
                spec = nm.finish_leaf(task_id)
            if spec is not None and spec.placement is not None:
                self._release_pg_allocation(spec)
            (errored if m["error"] is not None else simple).append((m, spec))
        for m, spec in errored:
            task_id = m["task_id"]
            with self._lock:
                rec = self.tasks.get(task_id)
            exc = ser.loads(m["error"])
            if rec and spec and rec.retries_left > 0 and spec.retry_exceptions:
                rec.retries_left -= 1
                self._m_retried.inc()
                events.emit(
                    "TASK_RETRY",
                    f"retrying {spec.name} after {type(exc).__name__}",
                    severity=events.WARNING, source="core_worker",
                    task_id=task_id.hex())
                self._resolve_deps_then_schedule(spec)
                continue
            if rec and spec:
                self._fail_task(spec, exc)
        if not simple:
            return
        if self._wal_enabled:
            # durability pre-pass BEFORE any future resolves: once a
            # get() returns, the sealed value must survive a head
            # restart (the WAL write is the seal). Outside the batch
            # lock — storage IO must not serialize completions.
            for m, _spec in simple:
                for oid, kind, data in m["returns"]:
                    if kind == "v" and len(data) <= self._wal_max:
                        self.gcs.wal_put_sealed(oid, data)
        nudge = False
        to_free: List[bytes] = []
        done_t = time.time()  # one stamp for the whole burst
        stage_durs: List[Dict[str, float]] = []
        rusage_list: List[Dict[str, float]] = []
        # head-side lifecycle spans: collected under the lock, emitted
        # outside it (record_event takes the timeline lock)
        trace_spans: Optional[List[tuple]] = \
            [] if timeline.is_enabled() else None
        with self._lock:
            for m, spec in simple:
                for oid, kind, data in m["returns"]:
                    if kind == "v":
                        self.memory_store[oid] = data
                    else:
                        # "store" returns carry total_size as the payload:
                        # the directory learns bytes for locality scoring
                        self.gcs.add_object_location(oid, handle.node_id,
                                                     size=data)
                    fut = self.futures.get(oid)
                    if fut is None:
                        self.futures[oid] = fut = _SlimFuture()
                    if not fut.done():
                        if isinstance(fut, _SlimFuture):
                            fut.set_result_quiet(True)  # broadcast below,
                        else:                           # once per burst
                            fut.set_result(True)
                    # dep-waiter resolution under the same (batch-wide) lock
                    if self._deps_ready_locked(oid):
                        nudge = True
                rec = self.tasks.get(m["task_id"])
                if rec:
                    rec.state = "FINISHED"
                    wt = m.get("tstamps")
                    if wt:
                        rec.ts.update(wt)
                    rec.ts["FINISHED"] = done_t
                    ru = m.get("rusage")
                    if ru:
                        rec.rusage = ru
                        rusage_list.append(ru)
                    stage_durs.append(stage_durations(rec.ts))
                    if trace_spans is not None:
                        trace_spans.append(
                            (rec.spec.name, rec.spec.task_id,
                             rec.spec.trace_ctx, dict(rec.ts)))
                # arg release + fire-and-forget GC stay inside the batch
                # lock (per-task locking was the completion side's
                # dominant cost); only the zero-ref free_object calls run
                # outside it
                if spec is not None and rec is not None \
                        and not rec.args_released:
                    rec.args_released = True
                    for oid in self._ref_deps(spec):
                        if self._decref(oid):
                            to_free.append(oid)
                if spec is not None and rec is not None and rec.gc_returns:
                    # returns whose every handle was dropped BEFORE the
                    # task finished have no refcount-zero transition left
                    # to trigger GC — sweep them now (driver-owned refs
                    # only: worker/client return handles are bare)
                    to_free.extend(
                        roid for roid in spec.return_ids
                        if not self._ref_held(roid))
        _SlimFuture.broadcast()  # wake getters once for the whole burst
        self._m_finished.inc(len(simple))
        if trace_spans:
            for name, tid_, tctx, ts in trace_spans:
                emit_lifecycle_spans(name, tid_, tctx, ts)
        if stage_durs:
            self._record_task_latencies(stage_durs)
        if rusage_list:
            self._record_task_resources(rusage_list)
        self.free_objects(to_free)
        if len(self._job_ledgers) > 1:
            # cpu_slots throttle: finished tasks return their slots and
            # pull the next parked spec of their job into the submit queue
            for m, spec in simple:
                if spec is not None:
                    self._release_job_slot(spec, finished=True)
        if nudge:
            self._wakeup()

    def _record_task_latencies(self,
                               durs_list: List[Dict[str, float]]) -> None:
        """Fold finished tasks' stage durations into the bounded
        percentile buffers and the stage histogram (outside the batch
        lock — histogram observes take the instrument lock)."""
        hist = self._m_stage_hist
        lat = self.task_latencies
        for durs in durs_list:
            for stage, d in durs.items():
                buf = lat.get(stage)
                if buf is None:
                    buf = lat[stage] = deque(maxlen=4096)
                buf.append(d)
                hist.observe(d, tags={"stage": stage})

    def _record_task_resources(self,
                               rusage_list: List[Dict[str, float]]) -> None:
        """Fold finished tasks' rusage deltas into bounded per-resource
        percentile buffers (state.summarize_task_latencies resources
        section), the attribution analog of _record_task_latencies."""
        res = self.task_resources
        for ru in rusage_list:
            for key in ("cpu_s", "peak_rss", "hbm_bytes"):
                v = ru.get(key)
                if v is None:
                    continue
                buf = res.get(key)
                if buf is None:
                    buf = res[key] = deque(maxlen=4096)
                buf.append(float(v))

    # --------------------------------------------------------------- actors
    def create_actor(self, payload: dict) -> bytes:
        actor_id = ActorID.from_random()
        # owning job: the job-death sweep kills the job's actors through
        # its ledger (detached actors included — detachment outlives the
        # DRIVER CONNECTION, not the job itself)
        job = payload.get("job_id") or self.job_id.binary()
        led = self.ledger_for(job)
        with led.lock:
            led.actors.add(actor_id.binary())
        if payload.get("cls_blob") is not None:
            self.cls_blobs.setdefault(payload["cls_id"], payload["cls_blob"])
        spec = ActorCreationSpec(
            actor_id=actor_id.binary(),
            name=payload.get("name", "Actor"),
            cls_id=payload["cls_id"],
            args=payload["args"],
            kwargs=payload.get("kwargs", {}),
            resources=payload.get("resources", {}),
            strategy=payload.get("strategy"),
            max_restarts=payload.get("max_restarts", 0),
            max_task_retries=payload.get("max_task_retries", 0),
            max_concurrency=payload.get("max_concurrency", 1),
            placement=payload.get("placement"),
            detached=payload.get("detached", False),
            registered_name=payload.get("registered_name"),
            runtime_env=payload.get("runtime_env"),
        )
        record = ActorRecord(actor_id, spec)
        self.gcs.register_actor(record)
        if spec.detached and spec.registered_name:
            # durable record: a head restarted on the same GCS storage
            # recreates this actor (fresh state, original creation spec —
            # the GCS-FT restart semantics of gcs_actor_manager.h:214)
            persist = dict(payload)
            if persist.get("cls_blob") is None:
                persist["cls_blob"] = self.cls_blobs.get(payload["cls_id"])
            try:
                self.gcs.storage.put("detached_actors",
                                     spec.registered_name,
                                     ser.dumps(persist))
            except Exception:
                pass  # non-picklable args: actor works, just not durable
        info = _ActorInfo(spec, record)
        with self._lock:
            self.actors[spec.actor_id] = info
        self._request_pool.submit(self._start_actor, info)
        return spec.actor_id

    def _recreate_detached_actors(self) -> None:
        """Head-restart path: re-run the creation spec of every persisted
        detached actor found in durable GCS storage."""
        for name, blob in self.gcs.storage.items("detached_actors"):
            if self.gcs.get_named_actor(name) is not None:
                continue
            try:
                payload = ser.loads(blob)
                self.create_actor(payload)
            except Exception:
                self.gcs.storage.delete("detached_actors", name)

    def _start_actor(self, info: _ActorInfo) -> None:
        spec = info.spec
        req = Resources(spec.resources)
        try:
            if spec.placement is not None:
                from .placement_group import resolve_pg_node_for_actor

                node_id = resolve_pg_node_for_actor(self, spec)
            else:
                node_id = None
                deadline = time.monotonic() + self.config.worker_lease_timeout_s
                while node_id is None and time.monotonic() < deadline:
                    node_id = self.scheduler.pick_node(
                        req, spec.strategy, queue_if_busy=False)
                    if node_id is None:
                        time.sleep(0.02)
            if node_id is None:
                raise TimeoutError(
                    f"no resources to place actor {spec.name}"
                )
        except Exception as e:
            self.gcs.set_actor_state(info.record.actor_id, ACTOR_DEAD, str(e))
            info.creation_future.set_exception(ActorDiedError(str(e)))
            self._fail_actor_queue(info, ActorDiedError(str(e)))
            return
        nm = self.nodes[node_id]
        info.node_id = node_id
        chips = None
        n_chips = int(req.get(GPU))
        if n_chips:
            chips = nm.take_chips(n_chips)
        # PG actors: the bundle reservation already deducted node resources
        lease = Resources({}) if spec.placement is not None else req
        msg = {
            "type": "create_actor", "actor_id": spec.actor_id,
            "cls_id": spec.cls_id, "name": spec.name,
            "args": [self._finalize_arg(a) for a in spec.args],
            "kwargs": {k: self._finalize_arg(v)
                       for k, v in spec.kwargs.items()},
            "max_concurrency": spec.max_concurrency,
            # the blob always rides along: this worker is brand new
            "cls_blob": self.cls_blobs[spec.cls_id],
        }
        if spec.runtime_env:
            msg["runtime_env"] = spec.runtime_env
        if chips is not None:
            msg["visible_chips"] = ",".join(str(c) for c in chips)

        def on_handle(h):
            # runs BEFORE the spawn: a bootstrapped fork can reply
            # actor_ready within milliseconds, so every lookup that reply
            # touches (dedication, info.handle, the record) must already
            # be in place
            h.known_classes.add(spec.cls_id)
            nm.dedicate_to_actor(h, spec.actor_id, lease, chips)
            info.handle = h
            info.record.node_id = node_id
            info.record.worker_id = h.worker_id

        # the create message is the spawn's startup token (dedicated
        # worker + assigned task, worker_pool.h:446): the fork path hands
        # it to the child in memory — no registration round trip on the
        # actor-creation critical path. Conda actors cold-spawn under the
        # env's python (dedicated runtime-env worker); local resolution
        # may block this (request-pool) thread like a pip install would.
        conda_spec = (spec.runtime_env or {}).get("conda") \
            if spec.runtime_env else None
        try:
            nm.start_worker(dedicated=True, bootstrap=msg,
                            on_handle=on_handle, conda_spec=conda_spec)
        except Exception as e:  # noqa: BLE001 — conda env unavailable
            self.gcs.set_actor_state(info.record.actor_id, ACTOR_DEAD,
                                     str(e))
            if not info.creation_future.done():
                info.creation_future.set_exception(ActorDiedError(str(e)))
            self._fail_actor_queue(info, ActorDiedError(str(e)))

    def _on_actor_created(self, handle: WorkerHandle, msg: dict) -> None:
        actor_id = msg["actor_id"]
        with self._lock:
            info = self.actors.get(actor_id)
        if info is None:
            return
        if msg["error"] is not None:
            exc = ser.loads(msg["error"])
            self.gcs.set_actor_state(
                info.record.actor_id, ACTOR_DEAD, str(exc)
            )
            if not info.creation_future.done():
                info.creation_future.set_exception(exc)
            self._fail_actor_queue(info, exc)
            return
        self.gcs.set_actor_state(info.record.actor_id, ACTOR_ALIVE)
        if not info.creation_future.done():
            info.creation_future.set_result(True)
        self._flush_actor_queue(info)

    def _flush_actor_queue(self, info: _ActorInfo) -> None:
        """Dispatch the actor's queued tasks in seq order until the queue
        stays empty, one thread at a time (``info.flushing``): a task
        submitted meanwhile joins the queue (see submit_actor_task)
        instead of overtaking it. With no live worker the queue waits
        for the death handler, which restarts the actor or fails it."""
        with self._lock:
            if info.flushing:
                return  # the flushing thread takes what was queued
            info.flushing = True
        try:
            while True:
                with self._lock:
                    handle = info.handle
                    if (not info.pending or handle is None
                            or handle.death_processed
                            or not handle.alive()):
                        info.flushing = False
                        return
                    flush = list(info.pending)
                    info.pending.clear()
                for spec in flush:
                    self._dispatch_actor_task(info, spec)
        except BaseException:
            with self._lock:
                info.flushing = False
            raise

    def _park_actor_task(self, info: _ActorInfo, spec: TaskSpec) -> None:
        """``spec`` found no live worker: queue it for the actor's next
        incarnation, or fail it if the actor is dead (its death handler
        has drained the queue, so a task queued after would wait
        forever)."""
        with self._lock:
            state = info.record.state
            if state != ACTOR_DEAD:
                info.pending.append(spec)
        if state == ACTOR_DEAD:
            self._fail_task(spec, ActorDiedError(
                info.record.death_cause or "actor is dead"))
        elif state == ACTOR_ALIVE:
            self._flush_actor_queue(info)  # a new incarnation may be up

    def submit_actor_task(self, payload: dict,
                          adopt_returns: bool = True) -> List[bytes]:
        actor_id = payload["actor_id"]
        with self._lock:
            info = self.actors.get(actor_id)
        if info is None:
            raise ActorDiedError("unknown actor")
        job = payload.get("job_id") or self.job_id.binary()
        led = self.ledger_for(job)
        task_id = TaskID.for_task(
            self.job_id if job == self.job_id.binary() else JobID(job))
        num_returns = payload.get("num_returns", 1)
        return_ids = [
            ObjectID.for_return(task_id, i).binary() for i in range(num_returns)
        ]
        parent_ctx = tracing.from_wire(payload.get("trace_parent")) \
            or tracing.get_current()
        trace_ctx = tracing.child_of(parent_ctx)
        spec = TaskSpec(
            task_id=task_id.binary(),
            name=f"{info.spec.name}.{payload['method']}",
            fn_id=b"",
            args=payload["args"],
            kwargs=payload.get("kwargs", {}),
            num_returns=num_returns,
            return_ids=return_ids,
            resources={},
            actor_id=actor_id,
            method=payload["method"],
            seq=next(info.seq),
            max_retries=info.spec.max_task_retries,
            trace_ctx=trace_ctx,
            job_id=job,
        )
        rec = _TaskRecord(spec, payload, info.spec.max_task_retries,
                          gc_returns=adopt_returns)
        self._m_submitted.inc()
        with led.lock:
            led.tasks_submitted += 1
        with self._lock:
            self.tasks[spec.task_id] = rec
            self._index_trace_locked(trace_ctx, spec.task_id)
            for oid in return_ids:
                self.futures[oid] = _SlimFuture()
                # lineage here serves record GC, not reconstruction —
                # _recover_object refuses actor results explicitly
                self.lineage[oid] = spec.task_id
                if adopt_returns:
                    self._incref(oid)
            for oid in self._ref_deps(spec):
                self._incref(oid)
                self._lineage_dependents[oid] += 1
            state = info.record.state
            # straight to the actor only with nothing queued before it:
            # an earlier task still in the queue, or in a batch the ALIVE
            # transition is dispatching, must not be overtaken
            direct = (state == ACTOR_ALIVE and not info.pending
                      and not info.flushing)
            if state != ACTOR_DEAD and not direct:
                info.pending.append(spec)  # pending / restarting / flushing
        if state == ACTOR_DEAD:
            self._fail_task(spec, ActorDiedError(
                info.record.death_cause or "actor is dead"))
        elif direct:
            self._dispatch_actor_task(info, spec)
        elif state == ACTOR_ALIVE:
            self._flush_actor_queue(info)  # queued behind earlier tasks
        return return_ids

    def _dispatch_actor_task(self, info: _ActorInfo, spec: TaskSpec) -> None:
        # Dependencies: actor tasks with pending-object args wait like normal
        # tasks, but must preserve seq order; the pipe preserves send order, so
        # we only defer if a dep is truly unready.
        missing = []
        with self._lock:
            for oid in self._ref_deps(spec):
                fut = self.futures.get(oid)
                if fut is not None and not fut.done():
                    missing.append(fut)
        if missing:
            # completion callbacks, NOT parked pool threads: a thread per
            # dep-blocked actor task starved the 8-thread request pool
            # (>8 blocked tasks deadlocked all worker-request service —
            # VERDICT r1 item 9). Only the final send runs on the pool.
            remaining = [len(missing)]
            count_lock = threading.Lock()

            def on_dep_done(_f):
                with count_lock:
                    remaining[0] -= 1
                    if remaining[0]:
                        return
                if self._stop.is_set():
                    return  # shutdown's future fail-pass fired us: do not
                    # resubmit dispatch work into a tearing-down pool
                # dep errors are ignored here on purpose: the send path
                # re-checks availability and runs recovery / fails the task
                try:
                    self._request_pool.submit(
                        self._ensure_actor_args_then_send, info, spec)
                except RuntimeError:
                    pass  # pool already shut down

            for fut in missing:
                fut.add_done_callback(on_dep_done)
            return
        self._ensure_actor_args_then_send(info, spec)

    def _ensure_actor_args_then_send(self, info: _ActorInfo,
                                     spec: TaskSpec) -> None:
        if self._stop.is_set():
            return  # tearing down: no materialize/recovery round trips
        handle = info.handle
        if handle is None or not handle.alive():
            self._park_actor_task(info, spec)
            return
        node_id = info.node_id
        # device-resident deps block on a worker round-trip the router
        # itself must service, and a store-resident transfer can park in
        # the pressured-push retry loop for the whole retry budget —
        # never do either on the router thread
        with self._lock:
            blocking_dep = any(
                o in self._device_locations
                or (o not in self.memory_store
                    and not self.nodes[node_id].store.contains(o))
                for o in self._ref_deps(spec))
        if blocking_dep and \
                threading.current_thread() is self._router:
            self._request_pool.submit(
                self._ensure_actor_args_then_send, info, spec)
            return
        # transfer any store-resident args to the actor's node
        for oid in self._ref_deps(spec):
            with self._lock:
                in_mem = oid in self.memory_store
            if in_mem:
                continue
            if self.nodes[node_id].store.contains(oid):
                continue
            self._ensure_device_materialized(oid)
            locs = [l for l in self.gcs.get_object_locations(oid)
                    if l != node_id and self.nodes.get(l)
                    and self.nodes[l].alive]
            if locs:
                try:
                    self._transfer_from(oid, locs, node_id)
                except Exception as e:  # noqa: BLE001
                    # same degrade rule as do_transfers: pressure (or a
                    # dying source) must not fail or hang the task while
                    # the object is live — the actor worker's own arg
                    # fetch re-transfers or reads the bytes inline
                    if self._object_alive(oid):
                        events.emit(
                            "TRANSFER_DEGRADED",
                            f"dispatching actor task {spec.name} with "
                            f"arg {oid.hex()[:8]} not prefetched "
                            f"({e!r}); worker will fetch inline",
                            severity=events.WARNING,
                            source="object_manager")
                        continue
                    try:
                        self._recover_object(oid)
                    except Exception as re:  # noqa: BLE001
                        self._fail_task(spec, TaskError(spec.name, re))
                        return
            elif not self.nodes[node_id].store.contains(oid):
                try:
                    self._recover_object(oid)
                except Exception as e:
                    self._fail_task(spec, TaskError(spec.name, e))
                    return
        with self._lock:
            # a worker whose death was already processed had its inflight
            # map swept: a task added now would wait there forever
            swept = handle.death_processed
            if not swept:
                handle.inflight[spec.task_id] = spec
        if swept:
            self._park_actor_task(info, spec)
            return
        if not self._sender_enqueue(handle, self._task_msg(handle, spec)):
            self._on_worker_death(handle)

    def kill_actor(self, actor_id: bytes, no_restart: bool = True) -> None:
        with self._lock:
            info = self.actors.get(actor_id)
        if info is None:
            return
        if no_restart:
            info.spec.max_restarts = 0
        if info.spec.detached and info.spec.registered_name:
            # an explicit kill retires the durable record too
            self.gcs.storage.delete("detached_actors",
                                    info.spec.registered_name)
        self.gcs.set_actor_state(
            info.record.actor_id, ACTOR_DEAD, "killed via kill()"
        )
        self._release_actor_pg(info)
        handle = info.handle
        if handle is not None:
            try:
                handle.proc.terminate()
            except Exception:
                pass
        self._fail_actor_queue(info, ActorDiedError("actor killed"))

    def _fail_actor_queue(self, info: _ActorInfo, exc: Exception) -> None:
        with self._lock:
            pending = list(info.pending)
            info.pending.clear()
        for spec in pending:
            self._fail_task(spec, exc)

    # ------------------------------------------------------- failure handling
    def _on_worker_death(self, handle: WorkerHandle) -> None:
        with self._lock:
            if handle.death_processed:
                return
            if handle.conn is not None and \
                    handle.conn not in self._conn_handles:
                return  # conn already swept by an earlier death event
            handle.death_processed = True
            # a late 'ready' dial-in must not resurrect this handle (the
            # accept loop checks death_processed too, belt-and-braces)
            self._workers_by_id.pop(handle.worker_id.binary(), None)
            dead_conn = handle.conn
            if dead_conn is not None:
                self._conn_handles.pop(dead_conn, None)
                self._conn_send_locks.pop(dead_conn, None)
            inflight = dict(handle.inflight)
            handle.inflight.clear()
            if dead_conn is None:
                pass  # never dialed in: nothing registered anywhere
            elif hasattr(dead_conn, "fileno"):
                # real pipe: the ROUTER must unregister it from the selector
                # before it is closed (a closed fd number can be reused)
                self._router_removals.append(dead_conn)
            else:
                dead_conn.close()  # VirtualConn: never in the selector
        if dead_conn is not None:
            with self._send_cond:
                chan = self._send_channels.pop(dead_conn, None)
            if chan is not None:
                with chan.cond:
                    chan.dead = True
                    chan.q.clear()
                    chan.cond.notify_all()  # retire its sender thread
        if dead_conn is not None and hasattr(dead_conn, "fileno"):
            self._wakeup()
        self._m_worker_exits.inc()  # health plane's worker-churn signal
        nm = self.nodes.get(handle.node_id)
        if nm:
            nm.remove_worker(handle)
            for task_id in inflight:
                # a locally-leased leaf task dies with its worker before
                # finish_task could return the node's lease credit
                nm.release_leaf(task_id)
        self._release_worker_refs(handle)  # borrow pins die with the worker
        self._drop_device_location(handle)
        if handle.actor_id is not None:
            self._on_actor_worker_death(handle, inflight)
        else:
            for task_id, spec in inflight.items():
                self._maybe_retry(task_id, spec, WorkerCrashedError(
                    f"worker {handle.worker_id} died running {spec.name}"
                ))
        if nm and nm.alive:
            self._pump_node(nm)

    def _maybe_retry(self, task_id: bytes, spec: TaskSpec,
                     exc: Exception) -> None:
        with self._lock:
            rec = self.tasks.get(task_id)
            can_retry = rec is not None and rec.retries_left > 0
            if can_retry:
                rec.retries_left -= 1
        if can_retry:
            self._m_retried.inc()
            events.emit("TASK_RETRY",
                        f"retrying {spec.name} after {type(exc).__name__}",
                        severity=events.WARNING, source="core_worker",
                        task_id=task_id.hex())
            self._resolve_deps_then_schedule(spec)
        else:
            self._fail_task(spec, exc)

    def _on_actor_worker_death(self, handle: WorkerHandle,
                               inflight: Dict[bytes, TaskSpec]) -> None:
        with self._lock:
            info = self.actors.get(handle.actor_id)
        if info is None:
            return
        if info.record.state == ACTOR_DEAD:
            for task_id, spec in inflight.items():
                self._fail_task(spec, ActorDiedError(
                    info.record.death_cause or "actor died"))
            return
        restartable = info.record.num_restarts < info.spec.max_restarts \
            or info.spec.max_restarts == -1
        if restartable:
            info.record.num_restarts += 1
            self.gcs.set_actor_state(info.record.actor_id, ACTOR_RESTARTING)
            limit = ("inf" if info.spec.max_restarts == -1
                     else info.spec.max_restarts)
            events.emit(
                "ACTOR_RESTARTING",
                f"actor {info.record.actor_id.hex()[:12]} restart "
                f"{info.record.num_restarts}/{limit}",
                severity=events.WARNING, source="core_worker",
                actor_id=info.record.actor_id.hex())
            # GCS-driven restart (gcs_actor_manager.h:214 RestartActor):
            # re-run the creation task; tasks in flight at the crash retry only
            # under max_task_retries, queued ones wait for ALIVE.
            with self._lock:
                retry = sorted(inflight.values(), key=lambda s: s.seq)
                # appendleft from the last: the queue keeps seq order
                for spec in reversed(retry):
                    rec = self.tasks.get(spec.task_id)
                    if rec and rec.retries_left > 0:
                        rec.retries_left -= 1
                        info.pending.appendleft(spec)
                    else:
                        self._fail_task(spec, ActorDiedError(
                            "actor died while running task (no retries left)"
                        ))
                info.handle = None
            self._request_pool.submit(self._start_actor, info)
        else:
            self.gcs.set_actor_state(
                info.record.actor_id, ACTOR_DEAD, "worker process died"
            )
            self._release_actor_pg(info)
            for task_id, spec in inflight.items():
                self._fail_task(spec, ActorDiedError("actor worker died"))
            self._fail_actor_queue(info, ActorDiedError("actor worker died"))

    def _release_actor_pg(self, info: _ActorInfo) -> None:
        if info.spec.placement is not None and self.pg_manager is not None:
            self.pg_manager.release_key(info.spec.actor_id)

    # ------------------------------------------------------------- job plane
    def ledger_for(self, job_id: Optional[bytes]):
        """Get-or-create the ledger for ``job_id`` (None = the root job).
        A swept (dead) job raises: no new work may charge against it."""
        from .job_plane import JobLedger

        jid = job_id or self.job_id.binary()
        with self._lock:
            if jid in self._swept_jobs:
                raise RmtError(f"job {jid.hex()[:8]} is dead (swept)")
            led = self._job_ledgers.get(jid)
            if led is None:
                led = self._job_ledgers[jid] = JobLedger(jid)
                mdefs.jobs_active().set(float(len(self._job_ledgers)))
            return led

    def set_job_quota(self, job_id: bytes, quota: Optional[dict]) -> None:
        """Install (or replace) a job's admission quota. Applies to new
        admissions only — already-held bytes/slots are never clawed back."""
        from .job_plane import JobQuota

        self.ledger_for(job_id).quota = JobQuota.from_dict(quota)

    def register_client_job(self, job_id: bytes, info: Optional[dict] = None,
                            quota: Optional[dict] = None) -> None:
        """A driver (thin client / job_submission subprocess) joined:
        GCS job row + fresh ledger. Re-registering a swept job id fails."""
        self.gcs.register_job(job_id, info or {})
        led = self.ledger_for(job_id)
        if quota:
            from .job_plane import JobQuota

            led.quota = JobQuota.from_dict(quota)

    def job_usage(self, job_id: Optional[bytes] = None) -> dict:
        """Per-job (or all-jobs) usage snapshot for state/CLI surfaces."""
        with self._lock:
            ledgers = ({job_id: self._job_ledgers[job_id]}
                       if job_id is not None
                       and job_id in self._job_ledgers
                       else dict(self._job_ledgers))
        out = {}
        for jid, led in ledgers.items():
            u = led.usage()
            u["directory_rows"] = self.gcs.count_job_rows(jid)
            out[jid.hex()] = u
        return out

    def _admit_job_bytes(self, job_id: Optional[bytes], oid: bytes,
                         nbytes: int, device: bool = False) -> None:
        """Hard byte-quota admission for a put / device pin. Raises
        QuotaExceededError at the call edge; charges the job's ledger on
        success (released again by free_objects)."""
        if job_id is None:
            return  # untagged put: the root job, unlimited
        led = self.ledger_for(job_id)
        try:
            if device:
                led.admit_device(oid, nbytes)
            else:
                led.admit_object(oid, nbytes)
        except QuotaExceededError:
            self._m_quota_rej.inc(tags={
                "resource": "device_bytes" if device else "object_bytes"})
            raise

    def _note_job_demotion(self, oid: bytes) -> None:
        """Device→host demotion: migrate the bytes from the owning job's
        device_bytes to its object_bytes accounting."""
        jid = self.gcs.object_job(oid)
        if jid is None:
            return
        led = self._job_ledgers.get(jid)  # lock-free dict read
        if led is not None:
            led.note_demoted(oid)

    def _device_victim_rank(self, oid: bytes) -> int:
        """Demotion sort key for the device tier (lower demotes first):
        a client job's pins rank at its quota priority, driver-owned
        pins rank last. Called by the store OUTSIDE its lock."""
        jid = self.gcs.object_job(oid)
        if jid is None or jid == self.job_id.binary():
            return 1 << 30
        led = self._job_ledgers.get(jid)  # lock-free dict read
        return led.quota.priority if led is not None else 1

    def _release_job_bytes(self, oids) -> None:
        """free_objects hook: uncharge freed oids from every ledger."""
        with self._lock:
            ledgers = list(self._job_ledgers.values())
        if len(ledgers) <= 1:
            return  # root job only: unlimited, nothing charged
        for led in ledgers:
            led.release_many(oids)

    def _admit_batch(self, specs: List[TaskSpec]) -> List[TaskSpec]:
        """Router-only: cpu_slots throttle + stride-fair interleave over
        one drained submit batch (see job_plane.fair_order)."""
        from .job_plane import fair_order

        ledgers: Dict[bytes, Any] = {}

        def led_of(spec):
            jid = spec.job_id or self.job_id.binary()
            led = ledgers.get(jid)
            if led is None:
                with self._lock:
                    led = self._job_ledgers.get(jid)
                if led is None:
                    # swept mid-flight: let _schedule fail the task via
                    # the root ledger (unlimited, never parks)
                    led = self._job_ledgers[self.job_id.binary()]
                ledgers[jid] = led
            return led

        admitted = []
        for spec in specs:
            led = led_of(spec)
            if spec.task_id in self._cancelled \
                    or led.try_take_slot(spec.task_id):
                admitted.append(spec)
            else:
                led.park(spec)
        return fair_order(admitted, led_of)

    def _release_job_slot(self, spec: TaskSpec,
                          finished: bool = False) -> None:
        """Terminal-path hook for the cpu_slots throttle: return the
        task's slot and queue its job's next parked spec (if any)."""
        jid = spec.job_id
        if jid is None:
            return
        led = self._job_ledgers.get(jid)  # lock-free dict read
        if led is None:
            return
        if finished:
            with led.lock:
                led.tasks_finished += 1
        nxt = led.release_slot(spec.task_id)
        if nxt is not None:
            with self._lock:
                self._submit_q.append(nxt)
                nudge = not self._submit_nudged
                self._submit_nudged = True
            if nudge:
                self._wakeup()

    def _try_leaf_place_or_preempt(self, spec: TaskSpec) -> bool:
        """Leaf placement with priority preemption: when every lease pool
        is dry and the submitting job outranks a job holding leaf work,
        evict one victim and retry. A queued victim frees its credit
        synchronously; a running victim frees it via worker death, so the
        spec falls back to the shared scheduler this round."""
        if self._try_leaf_place(spec):
            return True
        if len(self._job_ledgers) > 1 and self._preempt_leaf_for(spec):
            return self._try_leaf_place(spec)
        return False

    def _preempt_leaf_for(self, spec: TaskSpec) -> bool:
        """Evict one lower-priority leaf task to make room for ``spec``.
        Returns True when a victim was preempted (its credit freed now or
        freeing via worker death). Preemption rides the existing retry
        machinery: the victim's retry budget is refunded, so preemption
        never consumes a retry the application paid for."""
        my_jid = spec.job_id or self.job_id.binary()
        led = self._job_ledgers.get(my_jid)
        my_pri = led.quota.priority if led is not None else 1
        if my_pri <= 1:
            return False  # baseline priority never preempts
        # snapshot victim priorities OUTSIDE the node locks (victim_ok
        # runs under nm._lock, which must never wait on runtime state)
        prio: Dict[bytes, int] = {}
        with self._lock:
            for tid, rec in self.tasks.items():
                jid = rec.spec.job_id or self.job_id.binary()
                if jid == my_jid:
                    continue
                vled = self._job_ledgers.get(jid)
                prio[tid] = vled.quota.priority if vled is not None else 1

        def victim_ok(tid: bytes) -> bool:
            return prio.get(tid, my_pri) < my_pri

        for nm in list(self.nodes.values()):
            res = nm.preempt_leaf(victim_ok)
            if res is None:
                continue
            kind, payload = res
            self._m_job_preempted.inc()
            if kind == "queued":
                # victim never started: free re-queue through the full
                # scheduling pass (credit already returned by the node)
                vspec = payload
                vled = self._job_ledgers.get(vspec.job_id or b"")
                if vled is not None:
                    with vled.lock:
                        vled.preempted_total += 1
                with self._lock:
                    self._pending_schedule.append(vspec)
                return True
            # running victim: refund the retry this eviction will consume,
            # then kill the worker — _on_worker_death releases the leaf
            # credit and _maybe_retry re-queues the task
            tid, handle = payload
            with self._lock:
                rec = self.tasks.get(tid)
                if rec is not None:
                    rec.retries_left += 1
                    vjid = rec.spec.job_id or self.job_id.binary()
                    vled = self._job_ledgers.get(vjid)
                    if vled is not None:
                        with vled.lock:
                            vled.preempted_total += 1
            try:
                handle.proc.terminate()
            except Exception:
                pass
            return True
        return False

    def sweep_job(self, job_id: bytes, trigger: str = "disconnect") -> bool:
        """Job-death sweep: release EVERYTHING the dead job owns — cancel
        its queued/parked/running tasks, kill its actors, drop its
        refcount rows, free its objects (device tier included, so
        rmt_device_bytes_pinned returns to the pre-job level), then
        retire its ledger. Idempotent: every step tolerates re-running,
        and a step that errors (job.sweep fault site) schedules a retry
        via the heartbeat loop without losing the steps that completed.
        Returns True when every step completed."""
        if job_id == self.job_id.binary():
            return True  # the root job dies with shutdown(), not a sweep
        from ..utils import faults

        t0 = time.monotonic()
        ok = True

        def step(fn):
            nonlocal ok
            try:
                act = faults.fire("job.sweep")
                if act is not None:
                    if act.mode == "stall":
                        act.sleep()
                    else:
                        act.raise_()
                fn()
            except Exception:
                ok = False

        with self._lock:
            # close admission first: ledger_for refuses swept jobs, so a
            # racing submit/put cannot re-charge a job being dismantled
            self._swept_jobs.add(job_id)
            led = self._job_ledgers.get(job_id)

        def mark_dead():
            # clean disconnect finishes the job; a stop request or a
            # watchdog-detected death (SIGKILL, lost notification) fails it
            state = {"disconnect": "FINISHED",
                     "stop": "STOPPED"}.get(trigger, "FAILED")
            self.gcs.set_job_state(job_id, state, f"swept ({trigger})")

        step(mark_dead)

        def cancel_tasks():
            dead = RmtError(f"job {job_id.hex()[:8]} died ({trigger})")
            with self._lock:
                specs = [rec.spec for rec in self.tasks.values()
                         if rec.spec.job_id == job_id
                         and rec.state not in ("FINISHED", "FAILED")]
                for s in specs:
                    self._cancelled.add(s.task_id)
                    self._waiting_deps.pop(s.task_id, None)
            ids = {s.task_id for s in specs}
            if led is not None:
                for s in led.drain_parked():
                    if s.task_id not in ids:
                        ids.add(s.task_id)
                        specs.append(s)
                    with self._lock:
                        self._cancelled.add(s.task_id)
            for nm in list(self.nodes.values()):
                # queued-but-undispatched: drop from the node queue and
                # settle any leaf credit the task held
                with nm._lock:
                    queued = [s for s in nm.queue if s.task_id in ids]
                    for s in queued:
                        try:
                            nm.queue.remove(s)
                        except ValueError:
                            pass
                        if s.task_id in nm.leaf_local:
                            nm.leaf_local.discard(s.task_id)
                            nm.leaf_credits += 1
                for tid in ids:
                    # agent-leased leaf: reclaim credit, and have the
                    # agent kill the pool worker running it (only the
                    # agent knows the placement)
                    if nm.finish_leaf(tid) is not None:
                        nm.cancel_leaf(tid)
                # running: kill the worker; _on_worker_death releases its
                # leases and refs, retry lands in _cancelled and fails
                with nm._lock:
                    victims = [h for h in nm.workers.values()
                               if h.actor_id is None
                               and any(t in ids for t in h.inflight)]
                for h in victims:
                    try:
                        h.proc.terminate()
                    except Exception:
                        pass
            for s in specs:
                self._fail_task(s, dead)

        step(cancel_tasks)

        def kill_actors():
            aids = []
            if led is not None:
                with led.lock:
                    aids = list(led.actors)
            for aid in aids:
                try:
                    self.kill_actor(aid, no_restart=True)
                except Exception:
                    pass

        step(kill_actors)

        def free_owned():
            # the job's objects: everything its ledger charged (puts and
            # device pins) plus every directory row tagged with the job
            # (store-resident returns) plus its tasks' return ids. The
            # sweep walks ONLY rows tagged with this job id — a 4-byte
            # prefix collision with another job can never widen it.
            owned = set(led.owned_object_ids()) if led is not None else set()
            owned.update(self.gcs.job_object_keys(job_id))
            with self._lock:
                for rec in self.tasks.values():
                    if rec.spec.job_id == job_id:
                        owned.update(rec.spec.return_ids)
            if not owned:
                return
            # the dead driver's handles ARE the outstanding refs: drop
            # the rows so free_objects sees refcount zero
            for oid in owned:
                sh = self._ref_stripe(oid)
                with sh.lock:
                    sh.refs.pop(oid, None)
            self.free_objects(list(owned))

        step(free_owned)

        if ok:
            # every step completed: retire the ledger (kept across failed
            # attempts so the retry still has the owned-object manifest)
            if led is not None:
                led.swept = True
            with self._lock:
                self._job_ledgers.pop(job_id, None)
                mdefs.jobs_active().set(float(len(self._job_ledgers)))
            self._m_job_sweeps.inc(tags={"trigger": trigger})
            mdefs.job_sweep_seconds().observe(time.monotonic() - t0)
            with self._lock:
                self._sweep_retry.pop(job_id, None)
        else:
            with self._lock:
                self._sweep_retry[job_id] = (
                    time.monotonic() + self.config.job_sweep_retry_s,
                    trigger)
        return ok

    def _pump_sweep_retries(self) -> None:
        """Heartbeat-loop hook: re-run job sweeps that hit an error
        (sweeps are idempotent, so re-running is always safe)."""
        now = time.monotonic()
        with self._lock:
            due = [(j, trig) for j, (t, trig)
                   in self._sweep_retry.items() if t <= now]
            for j, _ in due:
                del self._sweep_retry[j]
        for j, trig in due:
            self.sweep_job(j, trigger=trig)

    # ------------------------------------------------------------ heartbeats
    def _heartbeat_loop(self) -> None:
        interval = self.config.heartbeat_interval_s
        timeout = interval * self.config.num_heartbeats_timeout
        while not self._stop.is_set():
            with self._lock:
                nodes = list(self.nodes.values())
            for nm in nodes:
                if not nm.alive:
                    continue
                if hasattr(nm, "channel_send"):
                    # remote node: liveness = the agent channel accepting
                    # writes (EOF/half-open shows up here or at the
                    # router). The frame acks the last applied pong seq
                    # so the agent's reply carries only changes since
                    # (delta heartbeats — O(changes) ingress per node)
                    if nm.channel_send(nm.ping_frame()):
                        self.gcs.heartbeat(nm.node_id)
                else:
                    self.gcs.heartbeat(nm.node_id)
                    sweep = getattr(nm.store, "sweep_pins", None)
                    if sweep is not None:
                        try:
                            sweep()  # expire ensure_resident pins
                        except Exception:
                            pass
                    gc = getattr(nm.store, "sweep_unsealed", None)
                    if gc is not None:
                        try:
                            gc()  # abort creates leaked by dead fetchers
                        except Exception:
                            pass
            # reap workers that died WITHOUT ever dialing in (killed by
            # remove_node mid-spawn, import crash, OOM at startup): no
            # pipe means no EOF, so without this sweep their dedicated
            # actors hang at PENDING_CREATION forever and callers ride out
            # their full get() timeout (the node agent runs the same sweep
            # in its _reap_loop; the raylet's starting-worker timeout is
            # the reference analog, worker_pool.h:427)
            for nm in nodes:
                with nm._lock:  # nm.workers is guarded by the NODE's lock
                    unborn = [h for h in nm.workers.values()
                              if h.conn is None and not h.death_processed]
                for h in unborn:
                    if h.proc.poll() is not None:
                        self._on_worker_death(h)
            for node_id in self.gcs.check_heartbeats(timeout):
                self.remove_node(node_id)
            self._pump_sweep_retries()  # re-run job sweeps that errored
            try:
                self._refresh_gauges(nodes)
            except Exception:
                pass  # sampling must never kill the heartbeat loop
            try:
                self._health_tick()
            except Exception:
                pass  # health plane must never kill the heartbeat loop
            if self.gcs.durable:
                # directory shard snapshots ride the heartbeat cadence
                # (~10 ticks): cheap enough to repeat, fresh enough that
                # a restarted head knows what the old process held
                self._hb_ticks += 1
                if self._hb_ticks % 10 == 0:
                    try:
                        self.gcs.snapshot_directory()
                    except Exception:
                        pass  # durability is best-effort off the WAL path
            self._stop.wait(interval)

    def _refresh_gauges(self, nodes: Optional[List[NodeManager]] = None
                        ) -> None:
        """Heartbeat-period sample of cluster-level gauges (the
        reference's periodic stats collection): per-node dispatch-queue
        depth and object-store bytes, pending-dependency count,
        device-store bytes, heartbeat age."""
        if nodes is None:
            with self._lock:
                nodes = list(self.nodes.values())
        self.scheduler.publish_load()
        store_g = mdefs.object_store_bytes()
        hb_g = mdefs.worker_heartbeat_age_seconds()
        now_mono = time.monotonic()
        for nm in nodes:
            if not nm.alive:
                continue
            nid = nm.node_id.hex()[:12]
            stat = getattr(nm, "agent_stat", None)
            if stat:
                # remote node: the delta-heartbeat mirror already holds
                # the agent's store bytes — no channel round trip
                store_g.set(float(stat.get("store_used", 0)),
                            tags={"node_id": nid})
            else:
                store = getattr(nm, "store", None)
                if store is not None and hasattr(store, "usage"):
                    try:
                        used = store.usage()[0]
                        store_g.set(float(used), tags={"node_id": nid})
                    except Exception:
                        pass
            info = self.gcs.nodes.get(nm.node_id)
            if info is not None:
                hb_g.set(max(0.0, now_mono - info.last_heartbeat),
                         tags={"node_id": nid})
        with self._lock:
            pending = len(self._waiting_deps)
        mdefs.scheduler_pending_args().set(float(pending))
        mdefs.device_store_bytes().set(float(self.device_store.total_bytes()))
        dstats = self.gcs.directory_stats()
        mdefs.gcs_directory_hot_rows().set(float(dstats["hot"]))
        mdefs.gcs_directory_cold_rows().set(float(dstats["cold"]))

    def _health_tick(self) -> None:
        """Heartbeat-period health pass: snapshot the merged registry
        into the tsdb rings, then run the SLO rules over the new
        history. Both are no-ops under RMT_HEALTH=0 (the store stays
        empty, so every rule expr evaluates to no-data)."""
        from ..utils import tsdb as _tsdb

        if not _tsdb.is_enabled():
            return
        self.tsdb.sample_registry()
        self.health.evaluate()

    def _health_exemplar(self, rule) -> Optional[dict]:
        """Map a firing rule to a {task_id, trace_id} pivot: the most
        recent FAILED task's trace for failure-shaped rules, else the
        most recent traced task — 'when attributable', so None is a
        valid answer on an idle cluster."""
        want_failed = rule.name in ("task-failure-rate",
                                    "worker-exit-rate")
        best = None  # ((is_failed, ts), task_id, trace_ctx)
        with self._lock:
            for tid, rec in self.tasks.items():
                ctx = rec.spec.trace_ctx
                if not ctx:
                    continue
                ts = max(rec.ts.values()) if rec.ts else 0.0
                score = (rec.state == "FAILED", ts)
                if best is None or score > best[0]:
                    best = (score, tid, ctx)
            # history rows: (tid, name, state, num_returns, retries_left,
            # is_actor, ts_map, trace_ctx, rusage), append-ordered —
            # newest matching row wins
            for row in reversed(self.task_history):
                tid, state, ctx = row[0], row[2], row[7]
                if not ctx or (want_failed and state != "FAILED"):
                    continue
                ts = max(row[6].values()) if row[6] else 0.0
                score = (state == "FAILED", ts)
                if best is None or score > best[0]:
                    best = (score, tid, ctx)
                break
        if best is None or (want_failed and not best[0][0]):
            return None
        return {"task_id": best[1].hex(), "trace_id": best[2][0]}

    # --------------------------------------------------------- device objects
    def put_device_object(self, value: Any,
                          job_id: Optional[bytes] = None) -> bytes:
        """Pin a torch.Tensor in THIS process's device store (device-resident
        ObjectRef — SURVEY.md §7 design; see device_store.py)."""
        from .device_store import is_device_array

        if not is_device_array(value):
            raise TypeError(
                "put(..., device=True) requires a torch.Tensor; got "
                f"{type(value).__name__}")
        oid = ObjectID.for_put().binary()
        try:
            nbytes = int(value.nbytes)
        except Exception:  # noqa: BLE001
            nbytes = 0
        # quota BEFORE any registration: an over-quota pin must touch
        # nothing (no directory row, no future, no store state)
        self._admit_job_bytes(job_id, oid, nbytes, device=True)
        with self._lock:
            self._device_locations[oid] = "driver"
            fut = _SlimFuture()
            fut.set_result(True)
            self.futures[oid] = fut
        # directory first, then the pin: a put over budget demotes LRU
        # entries synchronously, and a demoted sibling's tier flip must
        # not race this object's own registration
        self.gcs.add_object_location(oid, self.head_node().node_id,
                                     size=nbytes, tier="hbm", job=job_id)
        self.device_store.put(oid, value)
        return oid

    def reserve_device_put(self, handle: WorkerHandle) -> bytes:
        """Worker-side device put, step 1: allocate the id and register
        the owning worker; the seal message completes it."""
        oid = ObjectID.for_put().binary()
        with self._lock:
            self._device_locations[oid] = handle
            self.futures[oid] = _SlimFuture()  # resolved by device_put_sealed
        return oid

    def seal_device_put(self, oid: bytes, handle: Optional[WorkerHandle] = None,
                        size: Optional[int] = None,
                        mesh: Optional[tuple] = None) -> None:
        if handle is not None:
            # the sealed device copy joins the object directory under
            # its hbm tier tag: locality scoring sees the bytes, the
            # transfer plane does not (get_object_locations filters
            # device tiers), and state.list_objects reports the tier
            self.gcs.add_object_location(oid, handle.node_id, size=size,
                                         tier="hbm")
            if mesh is not None:
                # one fingerprint per worker process: the ICI-route
                # decision compares it against the consumer's mesh
                handle.device_mesh = tuple(mesh)
        with self._lock:
            fut = self.futures.get(oid)
        if fut is not None and not fut.done():
            fut.set_result(True)
        self._on_dep_ready(oid)

    def _ensure_device_materialized(self, oid: bytes,
                                    timeout: float = 120.0) -> bool:
        """Make a device-resident object readable through the normal host
        object plane: the owner copies device→host into its node store on
        demand (the spill tier). Returns False if oid is not a device
        object or its owner is gone."""
        with self._lock:
            loc = self._device_locations.get(oid)
        if loc is None:
            return False
        # wait for the seal (producer may still be storing)
        with self._lock:
            seal = self.futures.get(oid)
        if seal is not None:
            seal.result(timeout=timeout)
        if loc == "driver":
            arr = self.device_store.get(oid)
            if arr is None:
                return False
            self._fire_device_materialize()
            nm = self.head_node()
            if not nm.store.contains(oid):
                try:
                    nm.store.put_serialized(oid, ser.serialize(arr))
                except ValueError:
                    pass  # concurrent reader materialized it first
                self.gcs.add_object_location(oid, nm.node_id)
            return True
        # worker-owned: one materialize request, shared by all waiters
        if not loc.alive():
            return False
        if self.gcs.get_object_locations(oid):
            return True  # already materialized earlier
        if self._device_route(loc) == "ici":
            # producer shares this consumer's mesh: the object could ride
            # a device-to-device collective instead of the host wire.
            # Cross-process device moves need a device route between
            # processes (the port has none: no CUDA IPC), which the in-process
            # transfer plane cannot drive yet — fall through to host
            # materialization, loudly, so the decision point is
            # exercised end-to-end today and becomes a fast path when
            # the collective lands.
            events.emit(
                "DEVICE_ICI_FALLBACK",
                f"same-mesh device object {oid.hex()[:12]} moved over "
                "the host path (no cooperative collective runtime)",
                source="runtime")
        with self._lock:
            fut = self._materialize_futs.get(oid)
            if fut is None:
                fut = _SlimFuture()
                self._materialize_futs[oid] = fut
                send_needed = True
            else:
                send_needed = False
        if send_needed:
            if not self._send(loc, {"type": "materialize_device",
                                    "object_id": oid}):
                with self._lock:
                    self._materialize_futs.pop(oid, None)
                return False
        try:
            fut.result(timeout=timeout)
        except Exception:
            return False
        return True

    def _on_device_materialized(self, handle: WorkerHandle,
                                msg: dict) -> None:
        oid = msg["object_id"]
        if msg.get("error") is None:
            self.gcs.add_object_location(oid, handle.node_id)
        with self._lock:
            fut = self._materialize_futs.pop(oid, None)
        if fut is not None and not fut.done():
            if msg.get("error") is not None:
                fut.set_exception(ser.loads(msg["error"]))
            else:
                fut.set_result(True)

    def _on_device_demoted(self, handle: WorkerHandle, msg: dict) -> None:
        """One-way notice that a worker's device tier demoted an object
        to its node shm store under budget pressure. The directory tier
        flips to shm (host-readable again) and the head stops routing
        device reads at the worker — the normal shm/transfer plane now
        owns the object."""
        oid = msg["object_id"]
        self.gcs.add_object_location(
            oid, handle.node_id, size=msg.get("size"))
        with self._lock:
            if self._device_locations.get(oid) is handle:
                del self._device_locations[oid]
            self._demoted_device.add(oid)
        self._note_job_demotion(oid)  # device quota bytes -> object bytes

    def _on_device_consumed(self, handle: WorkerHandle, msg: dict) -> None:
        """A worker took a device entry for donation (consume=True):
        no copy survives there, so drop the routing and the hbm tag.
        Later gets fall through to any host copy, else lineage."""
        oid = msg["object_id"]
        with self._lock:
            if self._device_locations.get(oid) is handle:
                del self._device_locations[oid]
            self._demoted_device.discard(oid)
        self.gcs.remove_device_location(oid, handle.node_id)

    def _drop_device_location(self, handle: WorkerHandle) -> None:
        """Owner process died: its device objects are gone; gets fall
        through to lineage recovery."""
        with self._lock:
            dead = [oid for oid, loc in self._device_locations.items()
                    if loc is handle]
            for oid in dead:
                del self._device_locations[oid]
                fut = self._materialize_futs.pop(oid, None)
                if fut is not None and not fut.done():
                    fut.set_exception(ObjectLostError(
                        oid.hex(), "device-object owner process died"))
        for oid in dead:
            # drop the directory's hbm tag for the dead process; a host
            # copy materialized earlier (tier flipped to shm) survives
            self.gcs.remove_device_location(oid, handle.node_id)

    @staticmethod
    def _fire_device_materialize() -> None:
        """Injectable fault site on every device<->host movement
        (on-demand materialization and host->device re-promotion)."""
        from ..utils import faults

        act = faults.fire("device.materialize")
        if act is not None:
            if act.mode == "stall":
                act.sleep()
            elif act.mode in ("error", "drop"):
                act.raise_()

    def _device_route(self, loc) -> str:
        """Transfer route for a device object owned by ``loc``:
        'local' (same process — zero-copy / donation), 'ici' (owner
        shares this process's mesh — device-to-device move), or 'host'
        (materialize + v2 striped wire). Decided from the mesh
        fingerprint the owner registered at seal time."""
        if loc == "driver":
            return "local"
        if not self.config.device_ici_transfer:
            return "host"
        from . import transfer as xfer

        if xfer.same_mesh(getattr(loc, "device_mesh", None),
                          xfer.mesh_fingerprint()):
            return "ici"
        return "host"

    def _demote_device_object(self, oid: bytes, arr: Any) -> bool:
        """Device→host demotion (the device store's LRU eviction
        callback): write the serialized value — bf16-downcast when
        configured — through the head node store's create/seal path and
        flip the directory tier to shm; the spill plane takes over below
        shm. Returns False (object stays device-resident) on any IO
        failure."""
        data = ser.serialize_device_demotion(
            arr, self.config.device_demote_precision)
        nm = self.head_node()
        if not nm.store.contains(oid):
            try:
                nm.store.put_serialized(oid, data)
            except ValueError:
                pass  # concurrent reader materialized it first
        self.gcs.add_object_location(oid, nm.node_id,
                                     size=data.total_size)
        with self._lock:
            self._device_locations.pop(oid, None)
            self._demoted_device.add(oid)
        # demoted bytes stop counting against the owner's device quota
        self._note_job_demotion(oid)
        return True

    def _maybe_promote_device(self, oid: bytes, value: Any):
        """Re-promotion on device read: a get() that found host bytes
        for a previously demoted device object re-pins the rehydrated
        array so the NEXT consumer is zero-copy again (LRU re-entry —
        pressure can demote it right back)."""
        with self._lock:
            if oid not in self._demoted_device:
                return value
        if not self.config.device_promote_on_read:
            return value
        from .device_store import is_device_array

        if not is_device_array(value):
            return value
        try:
            self._fire_device_materialize()
        except Exception:  # noqa: BLE001 — injected: skip the promotion
            return value
        with self._lock:
            self._demoted_device.discard(oid)
            self._device_locations[oid] = "driver"
        # the host copy stays resident (and keeps its shm tier tag —
        # flipping it to hbm would hide it from host readers); the
        # re-pinned array just makes the next local read zero-copy
        self.device_store.put(oid, value)
        return value

    def _forget_device_object(self, oid: bytes) -> None:
        """A consume=True get took the pinned buffer for donation: the
        device copy no longer exists anywhere the runtime can hand out."""
        with self._lock:
            self._device_locations.pop(oid, None)
            self._demoted_device.discard(oid)
        self.gcs.remove_device_location(oid, self.head_node().node_id)

    def move_device_object(self, oid: bytes, device) -> bool:
        """Driver-side ICI move: relocate a driver-pinned device object
        onto ``device`` with the jitted device-to-device transfer (the
        same-mesh fast path the bench headlines). Zero-copy readers keep
        working against the moved buffer. False if the object is not
        pinned in this process."""
        arr = self.device_store.get(oid)
        if arr is None:
            return False
        from . import transfer as xfer

        moved = xfer.ici_move(arr, device)
        self.device_store.put(oid, moved)
        return True

    # ------------------------------------------------------------ object api
    def put_object(self, value: Any,
                   job_id: Optional[bytes] = None) -> bytes:
        data = ser.serialize(value)
        oid = ObjectID.for_put().binary()
        # quota first: an over-quota put touches neither store nor WAL
        self._admit_job_bytes(job_id, oid, data.total_size)
        if data.total_size <= self.config.max_direct_call_object_size:
            payload = data.to_bytes()
            with self._lock:
                self.memory_store[oid] = payload
            if self._wal_enabled and len(payload) <= self._wal_max:
                # sealed the moment put() returns: WAL before the caller
                # can observe the id (head-restart durability)
                self.gcs.wal_put_sealed(oid, payload)
        else:
            # release deferred dead objects BEFORE allocating: resident
            # corpses slow the store allocator (free-list walks, eviction
            # pressure) — measured 5x on the 16MB bulk-put path. Only
            # the STORE branch pays this; inline puts never touch the
            # allocator (the pump loop flushes stragglers for them)
            self._flush_deferred_frees()
            nm = self.head_node()
            nm.store.put_serialized(oid, data)
            self.gcs.add_object_location(oid, nm.node_id,
                                         size=data.total_size, job=job_id)
        with self._lock:
            fut = _SlimFuture()
            fut.set_result(True)
            self.futures[oid] = fut
        return oid

    # ------------------------------------------------------------- promises
    def create_promise(self) -> bytes:
        """Pre-allocate an object id whose value an EXTERNAL executor
        delivers later (the cross-language task plane: C++ executors
        return results for ids minted before dispatch). Gets on the id
        park on the unresolved future exactly like a task return; no
        lineage — a lost promise is failed by its broker, not recovered."""
        oid = ObjectID.for_put().binary()
        with self._lock:
            self.futures[oid] = _SlimFuture()
            self._promises.add(oid)
        return oid

    def resolve_promise(self, oid: bytes, value: Any = None,
                        error: Optional[Exception] = None) -> None:
        """Deliver (or fail) a promise created by :meth:`create_promise`."""
        with self._lock:
            if oid not in self._promises:
                return  # promise freed (caller gone): drop the late result
        if error is None:
            data = ser.serialize(value)
            if data.total_size <= self.config.max_direct_call_object_size:
                payload = data.to_bytes()
                with self._lock:
                    self.memory_store[oid] = payload
                if self._wal_enabled and len(payload) <= self._wal_max:
                    # WAL before the future resolves (see put_object)
                    self.gcs.wal_put_sealed(oid, payload)
            else:
                self._flush_deferred_frees()  # see put_object
                nm = self.head_node()
                nm.store.put_serialized(oid, data)
                self.gcs.add_object_location(oid, nm.node_id,
                                             size=data.total_size)
        with self._lock:
            fut = self.futures.get(oid)
            if fut is None:
                fut = self.futures[oid] = _SlimFuture()
        if fut.done():
            return  # double resolve: first delivery wins
        if error is None:
            fut.set_result(True)
        else:
            fut.set_exception(error)
        # a task that took the promise as an ObjectRef argument before it
        # resolved is parked on it: wake it, as a landing task return does
        self._on_dep_ready(oid)

    def put_serialized_arg(self, data: ser.SerializedObject) -> bytes:
        """Promote an oversized call argument to a store object (the
        plasma-promotion path of serialization.py:411 in the reference)."""
        self._flush_deferred_frees()  # see put_object
        oid = ObjectID.for_put().binary()
        nm = self.head_node()
        nm.store.put_serialized(oid, data)
        self.gcs.add_object_location(oid, nm.node_id,
                                     size=data.total_size)
        with self._lock:
            fut = _SlimFuture()
            fut.set_result(True)
            self.futures[oid] = fut
        return oid

    def cancel_task(self, oid: bytes, force: bool = False) -> None:
        self.cancel(oid, force)

    def get_objects(self, oids: List[bytes],
                    timeout: Optional[float] = None,
                    consume: bool = False) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out: Dict[bytes, Any] = {}
        for oid in dict.fromkeys(oids):
            out[oid] = self._get_one(oid, deadline, consume=consume)
        results = []
        for oid in oids:
            v = out[oid]
            if isinstance(v, Exception):
                raise v
            results.append(v)
        return results

    def _get_one(self, oid: bytes, deadline: Optional[float],
                 consume: bool = False):
        # driver-pinned device object: zero-copy return of the live
        # array. consume=True is the last-reader donation path — the
        # store drops its pin and the directory forgets the device copy
        # so the caller holds the sole reference and may update it in place
        # (a later get of the ref is an object-lost error, by contract).
        if consume:
            arr = self.device_store.take(oid)
            if arr is not None:
                self._forget_device_object(oid)
                return arr
        arr = self.device_store.get(oid)
        if arr is not None:
            return arr
        for attempt in range(3):
            with self._lock:
                fut = self.futures.get(oid)
            if fut is not None:
                remaining = None if deadline is None else max(
                    0.0, deadline - time.monotonic())
                try:
                    fut.result(timeout=remaining)
                # _CFTimeoutError is NOT the builtin TimeoutError until
                # Python 3.11 — catch both so 3.10 converts too
                except (TimeoutError, _CFTimeoutError):
                    raise GetTimeoutError(
                        f"get() timed out waiting for {oid.hex()}"
                    )
                except Exception as e:
                    return e
            with self._lock:
                data = self.memory_store.get(oid)
            if data is not None:
                return ser.loads(data)
            value, found = self._read_from_stores(oid)
            if found:
                return self._maybe_promote_device(oid, value)
            # device-resident elsewhere: materialize device→host, re-read
            if self._ensure_device_materialized(oid):
                value, found = self._read_from_stores(oid)
                if found:
                    return value
            # Not in memory, not in any store: lost. Try lineage recovery
            # (ObjectRecoveryManager, object_recovery_manager.h:41).
            try:
                self._recover_object(oid)
            except ObjectLostError as e:
                return e
        return ObjectLostError(oid.hex(), "recovery retries exhausted")

    def _read_from_stores(self, oid: bytes) -> Tuple[Any, bool]:
        from .remote_node import RemoteNodeManager

        locs = self.gcs.get_object_locations(oid)
        # "local" = readable through a direct shm mapping: head-local
        # nodes AND same-host agents (their segment is just another named
        # mapping — reading it is zero-copy, no localization needed)
        local = [l for l in locs
                 if not isinstance(self.nodes.get(l), RemoteNodeManager)
                 or self._same_host_store(self.nodes[l]) is not None]
        remote = [l for l in locs if l not in set(local)]
        # truly-remote-only objects: localize into the head store over the
        # p2p plane first — a driver get used to buffer the WHOLE object
        # in head RAM (b"".join of pulled chunks); fetching into the store
        # keeps it O(chunk), zero-copy on read, spill-managed, and cached
        # for the next get
        for node_id in remote if not local else ():
            nm = self.nodes.get(node_id)
            if nm is None or not nm.alive:
                continue
            addr = getattr(nm, "transfer_addr", None)
            if addr is None:
                continue
            from .transfer import fetch_object

            head = self.head_node()
            err = fetch_object(
                addr[0], addr[1], self._authkey, oid, head.store,
                self.config.object_manager_chunk_size,
                pool=self._xfer_conn_pool,
                stripe_threshold=self.config.transfer_stripe_threshold,
                stripe_count=self.config.transfer_stripe_count,
                alt_sources=lambda: self._holder_addrs(oid),
                retry=self._fetch_policy(),
                verify_checksum=self.config.transfer_verify_checksum,
                stripe_deadline=self.config.transfer_stripe_deadline_s,
                codecs=wire_codec.client_codecs(self.config))
            if err is None:
                self.gcs.add_object_location(oid, head.node_id)
                local = [head.node_id]
                break
            self._prune_stale_location(oid, node_id, err)
        for node_id in local + remote:
            nm = self.nodes.get(node_id)
            if nm is None or not nm.alive:
                continue
            cli = self._store_client_for(node_id)
            view = cli.get(oid)
            if view is None and cli is not getattr(nm, "store", None):
                # a same-host mapping of an agent's store cannot see
                # objects SPILLED inside that agent — the channel proxy
                # can (its read serves the spill file)
                proxy = getattr(nm, "store", None)
                if proxy is not None:
                    view = proxy.get(oid)
                    cli = proxy
            if view is None:
                continue
            # the store refcount taken by get() is held until the last
            # zero-copy view of the value dies (plasma buffer semantics)
            value = ser.deserialize(
                view, on_release=lambda c=cli, o=oid: c.release(o)
            )
            return value, True
        return None, False

    def _recover_object(self, oid: bytes) -> None:
        with self._lock:
            task_id = self.lineage.get(oid)
            rec = self.tasks.get(task_id) if task_id else None
        if rec is None:
            raise ObjectLostError(oid.hex(), "no lineage recorded")
        if rec.spec.is_actor_task:
            # re-running an actor method against mutated actor state is
            # not reconstruction (the reference likewise only rebuilds
            # task lineage; actor results need max_task_retries)
            raise ObjectLostError(
                oid.hex(), "actor task result is not reconstructable")
        spec = rec.spec
        with self._lock:
            # reset return futures so dependents re-wait
            for roid in spec.return_ids:
                fut = self.futures.get(roid)
                if fut is None or fut.done():
                    self.futures[roid] = _SlimFuture()
            rec.state = "RESUBMITTED"
            # re-acquire the arg pins the first completion released: the
            # re-execution (and the completion sweep that follows it)
            # must see the args — and its own result — as referenced
            if rec.args_released:
                rec.args_released = False
                for aoid in self._ref_deps(spec):
                    self._incref(aoid)
        self._resolve_deps_then_schedule(spec)
        for roid in spec.return_ids:
            with self._lock:
                fut = self.futures[roid]
            fut.result(timeout=self.config.worker_lease_timeout_s * 4)

    def wait(self, oids: List[bytes], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True):
        """Event-driven wait: park on the objects' completion futures
        (FIRST_COMPLETED) instead of polling — the 1 ms busy-poll burned a
        core-share and added latency at scale (the reference's WaitManager
        is likewise callback-driven, wait_manager.h). Handles a mix of
        _SlimFuture (every completion broadcasts the shared condition) and
        stdlib Future (placement-group readiness) by parking on the shared
        condition with a short cap whenever a stdlib future is present."""

        def futures_wait(futs, timeout):
            """Returns (done, not_done); empty done ONLY after the full
            timeout elapsed (callers treat that as a timeout)."""
            futs = set(futs)
            end = None if timeout is None else time.monotonic() + timeout
            while True:
                done = {f for f in futs if f.done()}
                if done:
                    return done, futs - done
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return done, futs
                # stdlib futures (PG readiness) don't signal the shared
                # condition — cap the park so they are re-polled
                if any(not isinstance(f, _SlimFuture) for f in futs):
                    left = 0.02 if left is None else min(left, 0.02)
                with _SlimFuture._cond:
                    _SlimFuture._cond.wait_for(
                        lambda: any(f.done() for f in futs), left)

        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[bytes] = []
        pending: List[Tuple[bytes, Optional[Future]]] = []
        with self._lock:
            for oid in oids:
                fut = self.futures.get(oid)
                if (oid in self.memory_store
                        or (fut is not None and fut.done())
                        or (fut is None
                            and self.gcs.get_object_locations(oid))):
                    ready.append(oid)
                else:
                    pending.append((oid, fut))
        while len(ready) < num_returns and pending:
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            futs = {f for _, f in pending if f is not None}
            untracked = len(futs) < len(pending)
            if futs:
                # untracked ids (no owner future) surface only via GCS
                # location updates the futures can't signal — cap the park
                # so they are re-polled even while futures stay pending
                park = remaining
                if untracked:
                    park = 0.05 if remaining is None else min(remaining,
                                                              0.05)
                done, _ = futures_wait(futs, timeout=park)
                if not done and not untracked:
                    break  # timed out
            else:
                if remaining == 0.0:
                    break
                time.sleep(min(0.05, remaining or 0.05))
            still = []
            for oid, fut in pending:
                if (fut is not None and fut.done()) or (
                        fut is None and self.gcs.get_object_locations(oid)):
                    ready.append(oid)
                else:
                    still.append((oid, fut))
            pending = still
            if deadline is not None and time.monotonic() >= deadline:
                break
        return (ready[:num_returns] + ready[num_returns:],
                [oid for oid, _ in pending])

    def future_for(self, ref: ObjectRef) -> Future:
        with self._lock:
            fut = self.futures.get(ref.binary())
            if fut is None:
                fut = _SlimFuture()
                if ref.binary() in self.memory_store or \
                        self.gcs.get_object_locations(ref.binary()):
                    fut.set_result(True)
                self.futures[ref.binary()] = fut
            return fut

    # ------------------------------------------- decentralized ownership
    def _on_owned_put(self, handle: WorkerHandle, msg: dict) -> None:
        """Register a worker-owned put (the worker minted the id and
        wrote its node store itself — creator-owns,
        reference_count.h:39). The head records the location and the
        ownership attribution; the value is freed only by the owner's
        release (guarded against live driver pins)."""
        oid = msg["object_id"]
        self.gcs.add_object_location(oid, handle.node_id,
                                     size=msg.get("size"))
        with self._lock:
            if msg.get("own", True):
                self._worker_owned.setdefault(
                    handle.worker_id.binary(), set()).add(oid)
            fut = self.futures.get(oid)
            if fut is None:
                self.futures[oid] = fut = _SlimFuture()
        if not fut.done():
            fut.set_result(True)
        self._on_dep_ready(oid)

    def _apply_worker_ref_tables(self, handle: WorkerHandle,
                                 borrows, releases, owned_drops) -> None:
        """The borrowed-ref table riding a done reply
        (reference_count.h:139-156): ``borrows`` are refs the worker
        still holds past the task — each takes a head-side pin
        attributed to the worker, outliving the task-duration arg pin;
        ``releases`` are zero-count transitions worker-side — borrow
        pins drop, and NEVER-ESCAPED owned puts (no other process can
        hold the id) free outright; ``owned_drops`` are escaped owned
        ids whose owner dropped its last ref — attribution only, the
        value stays for whoever the id escaped to (bare driver refs are
        invisible to refcounting by design)."""
        wid = handle.worker_id.binary()
        freed: List[bytes] = []
        with self._lock:
            wb = self._worker_borrows.setdefault(wid, set())
            wo = self._worker_owned.get(wid, set())
            # releases BEFORE borrows: one reply can carry both a
            # release and a re-borrow of the same oid (dropped then
            # re-acquired between two completions) — borrow-first would
            # skip the increment ("already borrowed") and the release
            # would then drop the pin while the worker still holds it
            # (wb/wo stay under _lock; the counts take one ref stripe
            # at a time — leaf locks, never two at once)
            for oid in releases or ():
                if oid in wb:
                    wb.discard(oid)
                    self._decref_defer(oid)
                elif oid in wo:
                    wo.discard(oid)
                    if not self._ref_held(oid):
                        # never escaped + owner dropped it + no other
                        # pin: the owned value can go
                        freed.append(oid)
            for oid in owned_drops or ():
                wo.discard(oid)
            for oid in borrows or ():
                if oid not in wb:
                    wb.add(oid)
                    self._incref(oid)
        if freed:
            self.free_objects(freed)

    def _release_worker_refs(self, handle: WorkerHandle) -> None:
        """Worker died: its borrow pins release (the borrower is gone);
        its owned puts keep their values (a driver may hold bare refs —
        owner-death object loss stays out of scope) but lose
        attribution."""
        wid = handle.worker_id.binary()
        with self._lock:
            borrows = self._worker_borrows.pop(wid, None)
            self._worker_owned.pop(wid, None)
            if borrows:
                for oid in borrows:
                    self._decref_defer(oid)

    # ----------------------------------------------------- reference counting
    def _ref_stripe(self, oid: bytes) -> _RefShard:
        return self._ref_shards[hash(oid) % self._ref_shard_n]

    def _ref_stripes_for(self, oids) -> List[_RefShard]:
        """Distinct stripes for a batch of oids, in ascending index
        order — the ONLY sanctioned multi-stripe hold (see __init__)."""
        idxs = sorted({hash(oid) % self._ref_shard_n for oid in oids})
        return [self._ref_shards[i] for i in idxs]

    def _incref(self, oid: bytes) -> None:
        sh = self._ref_stripe(oid)
        with sh.lock:
            sh.refs[oid] += 1

    def _decref(self, oid: bytes) -> bool:
        """Drop one count; True on the zero transition (entry removed,
        NOT deferred — the caller frees synchronously)."""
        sh = self._ref_stripe(oid)
        with sh.lock:
            sh.refs[oid] -= 1
            if sh.refs[oid] > 0:
                return False
            del sh.refs[oid]
            return True

    def _decref_defer(self, oid: bytes) -> int:
        """Drop one count; on the zero transition move the oid into its
        stripe's deferred-free buffer. Returns that buffer's new length
        (0 when the count stayed positive)."""
        sh = self._ref_stripe(oid)
        with sh.lock:
            sh.refs[oid] -= 1
            if sh.refs[oid] > 0:
                return 0
            del sh.refs[oid]
            sh.frees.append(oid)
            return len(sh.frees)

    def _ref_held(self, oid: bytes) -> bool:
        sh = self._ref_stripe(oid)
        with sh.lock:
            return oid in sh.refs

    @property
    def local_refs(self) -> Dict[bytes, int]:
        """Merged snapshot of every stripe's counts (tests/state API —
        NOT the hot path; internal code reads per-stripe)."""
        merged: Dict[bytes, int] = {}
        for sh in self._ref_shards:
            with sh.lock:
                merged.update(sh.refs)
        return merged

    @property
    def _deferred_frees(self) -> List[bytes]:
        """Merged snapshot of every stripe's free buffer (tests only)."""
        out: List[bytes] = []
        for sh in self._ref_shards:
            with sh.lock:
                out.extend(sh.frees)
        return out

    def add_local_ref(self, oid: bytes) -> None:
        self._incref(oid)

    def remove_local_ref(self, oid: bytes) -> None:
        # zero-ref frees batch through per-stripe deferred buffers the
        # ROUTER pump drains: a driver dropping a list of refs (every
        # `del refs` after a bulk get) fires thousands of __del__s
        # back-to-back on the application thread, and the free pass
        # (store deletes + task-record prune cascades) was ~60% of that
        # thread's time in the task hot path. Here we only decrement and
        # buffer; crossing the per-stripe batch threshold nudges the
        # router, which frees between dispatch rounds
        # (_flush_deferred_frees in _pump).
        n = self._decref_defer(oid)
        if n == 0:
            return
        # wake immediately for a DEVICE object (its HBM stays pinned
        # until the flush — latency there is device memory held
        # hostage) and at the per-stripe batch threshold; host-object
        # frees keep the lazy window and drain on the router's next
        # natural wakeup. The _device_locations probe is a lock-free
        # dict read; a stale answer only costs one spurious or
        # slightly-late wakeup.
        if oid in self._device_locations or n >= 16:
            self._wakeup()

    def _take_deferred_frees(self) -> List[bytes]:
        """Drain every stripe's deferral buffer, SKIPPING any oid that
        picked up a live reference since its count hit zero (e.g. a
        cached ref handed out again, a borrowed bare-id re-pinned at
        submission) — freeing those would drop a value a live handle
        still expects. The synchronous pre-batching free could never see
        this because it ran at the zero transition itself. One stripe
        lock at a time; the unlocked emptiness peek is racy but safe
        (a straggler drains on the next flush)."""
        batch: List[bytes] = []
        for sh in self._ref_shards:
            if not sh.frees:
                continue
            with sh.lock:
                batch.extend(oid for oid in sh.frees
                             if oid not in sh.refs)
                sh.frees = []
        return batch

    def _flush_deferred_frees(self) -> None:
        batch = self._take_deferred_frees()
        if batch:
            self.free_objects(batch)

    def _try_prune_record_locked(self, task_id: bytes) -> None:  # rmtcheck: holds=_lock
        """With self._lock held: prune a terminal task's record, futures,
        and lineage edges once nothing can need them again — no live
        handle on any return, no settled-future waiter, and no RETAINED
        downstream record that could demand transitive reconstruction
        (lineage pinning, reference_count.h). Pruning a record releases
        its lineage pins on its OWN args, which can cascade upstream.
        Without this GC the head retains O(all tasks ever) records
        (many_actors.json records head peak memory for this reason)."""
        stack = [task_id]
        while stack:
            tid = stack.pop()
            rec = self.tasks.get(tid)
            if (rec is None or not rec.gc_returns
                    or rec.state not in ("FINISHED", "FAILED")
                    or not rec.args_released):
                continue
            rets = rec.spec.return_ids
            # the returns' stripe locks span the handle check AND the
            # pops: an app-thread add_local_ref (a cached ref handed out
            # again) must not land between "no handle lives" and the
            # future/value drop. Acquired in ascending index order —
            # this path is serialized by _lock, and single-stripe
            # holders never wait on a second lock, so no cycle.
            stripes = self._ref_stripes_for(rets)
            for sh in stripes:
                sh.lock.acquire()
            try:
                if any(r in self._ref_stripe(r).refs for r in rets):
                    continue  # a handle (or a task's arg pin) lives
                if any(self._lineage_dependents.get(r, 0) > 0
                       for r in rets):
                    continue  # a retained downstream record remains
                if any(r in self.futures and not self.futures[r].done()
                       for r in rets):
                    continue  # an unresolved future may have waiters
                for r in rets:
                    self.futures.pop(r, None)
                    self.lineage.pop(r, None)
                    self.memory_store.pop(r, None)
                # raw tuple: this runs once per completed task, and
                # building a keyed dict (plus .hex()) here showed in the
                # completion hot path — the state API renders rows
                # lazily on read
                self.task_history.append(
                    (tid, rec.spec.name, rec.state, rec.spec.num_returns,
                     rec.retries_left, rec.spec.is_actor_task, rec.ts,
                     rec.spec.trace_ctx, rec.rusage))
                del self.tasks[tid]
                for a in self._ref_deps(rec.spec):
                    n = self._lineage_dependents.get(a, 0) - 1
                    if n > 0:
                        self._lineage_dependents[a] = n
                    else:
                        self._lineage_dependents.pop(a, None)
                        # the arg's producer may have been waiting on
                        # us. The arg's stripe may not be held here, so
                        # this is a bare dict read: racy, and only a
                        # cascade OPPORTUNITY is at stake — a pin that
                        # lands concurrently re-checks at the top of the
                        # next iteration under the stripes' locks.
                        ptid = self.lineage.get(a)
                        if ptid is not None \
                                and a not in self._ref_stripe(a).refs:
                            stack.append(ptid)
            finally:
                for sh in stripes:
                    sh.lock.release()

    def free_object(self, oid: bytes) -> None:
        self.free_objects((oid,))

    def free_objects(self, oids) -> None:
        """Drop objects' values everywhere (ray.internal.free analog),
        then try to prune the producing tasks' metadata (see
        _try_prune_record_locked). Batched: completion bursts free many
        zero-ref returns at once, and per-object lock acquisition was a
        measurable slice of the task hot path."""
        if not oids:
            return
        device_local: List[bytes] = []
        device_remote: List[tuple] = []
        with self._lock:
            for oid in oids:
                loc = self._device_locations.pop(oid, None)
                self._demoted_device.discard(oid)
                self.memory_store.pop(oid, None)  # value is dead either way
                task_id = self.lineage.get(oid)
                if task_id is not None:
                    self._try_prune_record_locked(task_id)
                elif oid in self._promises:
                    # freed promise: the caller is gone, so purge even a
                    # PENDING future — a late external resolution must
                    # find nothing and drop its result (resolve_promise
                    # checks _promises), not store an ownerless object
                    self._promises.discard(oid)
                    self.futures.pop(oid, None)
                else:
                    # a put object: no lineage, just the settled future
                    fut = self.futures.get(oid)
                    if fut is not None and fut.done():
                        self.futures.pop(oid, None)
                if loc == "driver":
                    device_local.append(oid)
                elif loc is not None:
                    device_remote.append((loc, oid))
        for oid in device_local:
            self.device_store.delete(oid)
        for loc, oid in device_remote:
            self._send(loc, {"type": "free_device", "object_id": oid})
        # one batched directory pop for the whole burst; inline-return
        # oids (no store copy anywhere) cost nothing here
        for oid, locs in self.gcs.take_objects_locations(oids).items():
            for node_id in locs:
                nm = self.nodes.get(node_id)
                if nm and nm.alive:
                    nm.store.delete(oid)
        if self._wal_enabled:
            # freed oids leave the sealed WAL too, or a restart would
            # resurrect values every live handle already dropped
            self.gcs.wal_del_sealed(oids)
        # job plane: uncharge freed bytes from their owners' quotas
        self._release_job_bytes(oids)

    # ------------------------------------------------------ worker requests
    def _serve_worker_request(self, handle: WorkerHandle, msg: dict) -> None:
        req_id = msg.get("req_id")
        reply: dict = {"type": "reply", "req_id": req_id, "error": None}
        try:
            mtype = msg["type"]
            if mtype == "submit_task":
                reply["return_ids"] = self.submit_task(
                    msg["payload"], adopt_returns=False)
            elif mtype == "submit_actor_task":
                reply["return_ids"] = self.submit_actor_task(
                    msg["payload"], adopt_returns=False)
            elif mtype == "create_actor":
                reply["actor_id"] = self.create_actor(msg["payload"])
            elif mtype == "get_objects":
                reply["values"] = self._serve_get(
                    handle, msg["oids"], inline=msg.get("inline", False))
            elif mtype == "make_room":
                # a worker's direct shm put hit a full store: spill on its
                # node so the retry can allocate (the raylet-spills-for-
                # plasma-creates path, create_request_queue.h:32)
                self._make_room(handle.node_id, int(msg["bytes"]))
            elif mtype == "put_inline":
                oid = ObjectID.for_put().binary()
                with self._lock:
                    self.memory_store[oid] = msg["data"]
                    fut = _SlimFuture()
                    fut.set_result(True)
                    self.futures[oid] = fut
                    if msg.get("own"):
                        # the worker owns this put like a store put: the
                        # owner-release protocol frees/drops it uniformly
                        self._worker_owned.setdefault(
                            handle.worker_id.binary(), set()).add(oid)
                if self._wal_enabled \
                        and len(msg["data"]) <= self._wal_max:
                    # WAL after _lock released, before the reply hands
                    # the id out (see put_object)
                    self.gcs.wal_put_sealed(oid, msg["data"])
                reply["object_id"] = oid
            elif mtype == "device_put":
                reply["object_id"] = self.reserve_device_put(handle)
            elif mtype == "device_put_sealed":
                self.seal_device_put(msg["object_id"], handle,
                                     size=msg.get("size"),
                                     mesh=msg.get("mesh"))
            elif mtype == "wait":
                ready, not_ready = self.wait(
                    msg["oids"], msg["num_returns"], msg["timeout"]
                )
                reply["ready"] = ready
                reply["not_ready"] = not_ready
            elif mtype == "kill_actor":
                self.kill_actor(msg["actor_id"], msg["no_restart"])
            elif mtype == "cancel_task":
                self.cancel(msg["object_id"], msg["force"])
            elif mtype == "actor_info":
                with self._lock:
                    info = self.actors.get(msg["actor_id"])
                reply["exists"] = info is not None
            elif mtype == "create_pg":
                from .placement_group import _manager

                pg = _manager(self).create(
                    msg["bundles"], msg["strategy"], msg.get("name", ""))
                reply["pg_id"] = pg.id
            elif mtype == "pg_state":
                from .placement_group import _manager

                reply["state"] = _manager(self).state(msg["pg_id"])
            elif mtype == "wait_pg":
                from .placement_group import _manager

                reply["created"] = _manager(self).wait_created(
                    msg["pg_id"], msg["timeout"])
            elif mtype == "remove_pg":
                from .placement_group import _manager

                _manager(self).remove(msg["pg_id"])
            elif mtype == "get_named_actor":
                rec = self.gcs.get_named_actor(msg["name"])
                if rec is None:
                    raise ValueError(f"no actor named {msg['name']!r}")
                reply["actor_id"] = rec.actor_id.binary()
            elif mtype == "request_resources":
                from ..autoscaler import request_resources

                request_resources(msg["bundles"])
            elif mtype == "state_query":
                from ..state import api as state_api

                reply["rows"] = state_api.answer(
                    msg["fn"], msg["args"], msg["kwargs"])
            else:
                raise ValueError(f"unknown worker request {mtype}")
        except Exception as e:  # noqa: BLE001
            try:
                reply = {"type": "reply", "req_id": req_id,
                         "error": ser.dumps(e)}
            except Exception:
                reply = {"type": "reply", "req_id": req_id,
                         "error": ser.dumps(RuntimeError(str(e)))}
        if not self._send(handle, reply):
            self._on_worker_death(handle)

    def _serve_get(self, handle: WorkerHandle, oids: List[bytes],
                   inline: bool = False):
        """Make each object available to the requesting worker: inline bytes
        for memory-store values, or ensure presence in the worker's node store
        (transfer / spill-restore / lineage recovery). With ``inline`` the
        envelope bytes are sent back in the reply even for store objects —
        the worker's last-resort path when its direct shm reads keep losing
        the race against the store's spill tier."""
        values: Dict[bytes, tuple] = {}
        need_ensure: List[bytes] = []
        node_id = handle.node_id
        nm = self.nodes[node_id]
        for oid in dict.fromkeys(oids):
            with self._lock:
                fut = self.futures.get(oid)
            if fut is not None and not fut.done():
                fut.result(timeout=3600)
            with self._lock:
                data = self.memory_store.get(oid)
            if data is not None:
                values[oid] = ("v", data)
                continue
            if inline:
                # inline serve needs NO copy on the worker's (possibly full)
                # node: read the bytes from whatever live node has them
                data = self._inline_bytes_anywhere(oid, prefer=node_id)
                if data is None:
                    self._ensure_device_materialized(oid)
                    data = self._inline_bytes_anywhere(oid, prefer=node_id)
                if data is None:
                    self._recover_object(oid)
                    with self._lock:
                        data = self.memory_store.get(oid)
                    if data is None:
                        data = self._inline_bytes_anywhere(oid,
                                                           prefer=node_id)
                if data is None:
                    raise ObjectLostError(
                        oid.hex(), "could not materialize on worker's node")
                values[oid] = ("v", data)
                continue
            if not nm.store.contains(oid):
                try:
                    self._ensure_device_materialized(oid)
                    locs = [l for l in self.gcs.get_object_locations(oid)
                            if l != node_id and self.nodes.get(l)
                            and self.nodes[l].alive]
                    if locs:
                        self._transfer_from(oid, locs, node_id)
                    elif not nm.store.contains(oid):
                        self._recover_object(oid)
                        # recovery may produce an inline value
                        with self._lock:
                            data = self.memory_store.get(oid)
                        if data is not None:
                            values[oid] = ("v", data)
                            continue
                        if not nm.store.contains(oid):
                            locs = [l for l in
                                    self.gcs.get_object_locations(oid)
                                    if self.nodes.get(l)
                                    and self.nodes[l].alive]
                            if not locs:
                                raise ObjectLostError(oid.hex())
                            self._transfer_from(oid, locs, node_id)
                except (ObjectStoreFullError, ObjectLostError):
                    # the worker's node cannot take a copy right now (store
                    # full past the wait budget): serve the bytes inline
                    # from wherever they are instead of failing the get
                    data = self._inline_bytes_anywhere(oid, prefer=node_id)
                    if data is None:
                        raise
                    values[oid] = ("v", data)
                    continue
            need_ensure.append(oid)
        # answering "local" is a promise the worker's DIRECT shm read will
        # hit: restore-from-spill and pin briefly (the worker's store client
        # is shm-only and cannot see the spill tier). Ensures are BATCHED
        # per node — for a remote node each would otherwise be its own
        # blocking agent round-trip, and a multi-object get against a
        # degraded agent could park this request-pool thread for minutes.
        if need_ensure:
            ensured = self._ensure_resident_batch(nm, need_ensure)
            for oid in need_ensure:
                if ensured.get(oid, True):
                    values[oid] = ("local", b"")
                    continue
                # the node's store is too full to restore (capacity held by
                # executing tasks): serve the bytes inline as a last resort
                # before declaring the object lost
                data = self._inline_bytes_anywhere(oid, prefer=node_id)
                if data is None:
                    raise ObjectLostError(
                        oid.hex(), "could not materialize on worker's node")
                values[oid] = ("v", data)
        return [values[oid] for oid in oids]

    def _ensure_resident_batch(self, nm, oids: List[bytes]) -> Dict[bytes, bool]:
        """Restore-and-pin a set of objects on one node's store; one channel
        round-trip for remote nodes (ensure_resident_many), a plain loop for
        the local store."""
        many = getattr(nm.store, "ensure_resident_many", None)
        if many is not None:
            try:
                return many(oids)
            except Exception:  # noqa: BLE001 — degrade to per-oid inline
                return {oid: False for oid in oids}
        ensure = getattr(nm.store, "ensure_resident", None)
        out = {}
        for oid in oids:
            if ensure is None:
                out[oid] = True
                continue
            try:
                out[oid] = ensure(oid)
            except ObjectStoreFullError:
                out[oid] = False  # transiently full: caller serves inline
        return out

    def _inline_bytes_anywhere(self, oid: bytes,
                               prefer: NodeID) -> Optional[bytes]:
        """Envelope bytes from ANY live node holding the object, trying
        ``prefer`` first — no transfer into (and no allocation on) the
        requesting worker's node."""
        order = [prefer] + [l for l in self.gcs.get_object_locations(oid)
                            if l != prefer]
        for node_id in order:
            nm = self.nodes.get(node_id)
            if nm is None or not nm.alive:
                continue
            data = self._inline_bytes_from_store(nm, oid)
            if data is not None:
                return data
        return None

    def _make_room(self, node_id: NodeID, nbytes: int) -> None:
        """Spill a node's store down so ``nbytes`` can allocate (local
        stores spill directly; remote proxies do one agent round trip)."""
        # deferred zero-ref frees may be pinning exactly the space the
        # caller needs (up to 128 objects of any size): release them
        # before resorting to spilling live objects
        self._flush_deferred_frees()
        nm = self.nodes.get(node_id)
        if nm is None:
            return
        make_room = getattr(nm.store, "make_room", None)
        if make_room is not None and not make_room(nbytes):
            events.emit(
                "STORE_FULL",
                f"could not spill {nbytes} bytes on {node_id.hex()[:8]}",
                severity=events.WARNING, source="object_store")

    def _inline_bytes_from_store(self, nm, oid: bytes) -> Optional[bytes]:
        """Envelope bytes from a node's store without forcing shm residency
        (NodeObjectStore.read serves spilled objects from the spill file;
        the remote proxy's get pulls over the channel, which the agent also
        serves residency-free)."""
        reader = getattr(nm.store, "read", None) or nm.store.get
        view = reader(oid)
        if view is None:
            return None
        data = bytes(view)
        if isinstance(view, memoryview):
            nm.store.release(oid)
        return data

    # ---------------------------------------------------------------- cancel
    def cancel(self, oid: bytes, force: bool = False) -> None:
        """Best-effort cancel of a queued (not yet dispatched) task
        (CoreWorker::CancelTask analog; running tasks are only killed with
        force=True, which terminates the worker)."""
        with self._lock:
            task_id = self.lineage.get(oid)
            if task_id is None:
                return
            self._cancelled.add(task_id)
            rec = self.tasks.get(task_id)
        for nm in self.nodes.values():
            with nm._lock:
                for spec in list(nm.queue):
                    if spec.task_id == task_id:
                        nm.queue.remove(spec)
                        self._fail_task(spec, TaskError(
                            spec.name, None, "cancelled"))
                        return
        if force and rec is not None:
            for nm in self.nodes.values():
                for h in list(nm.workers.values()):
                    if task_id in h.inflight:
                        h.proc.terminate()
                        return

    # -------------------------------------------------------------- shutdown
    def _atexit_shutdown(self) -> None:
        try:
            if not self._stop.is_set():
                self.shutdown()
        except Exception:
            pass

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self.gcs.set_job_state(self.job_id.binary(), "FINISHED")
        except Exception:  # noqa: BLE001
            pass
        if self.gcs.durable:
            try:
                self.gcs.snapshot_directory()  # final directory snapshot
            except Exception:  # noqa: BLE001
                pass
        try:
            # detach this cluster's LogStore so later emits in this
            # process buffer for the NEXT cluster instead of landing in
            # a dead store
            from ..utils import structlog as _structlog

            _structlog.attach_store(None)
        except Exception:  # noqa: BLE001
            pass
        try:
            # same for the ProfileStore; the continuous sampler stops
            # with the cluster (a later init restarts it)
            from ..utils import profiler as _profiler

            _profiler.stop_sampler()
            _profiler.attach_store(None)
        except Exception:  # noqa: BLE001
            pass
        try:
            # a config-installed fault plane is scoped to THIS cluster:
            # drop it and its env exports so a later init (or any child
            # spawned after) doesn't inherit the chaos
            from ..utils import faults

            faults.deconfigure()
        except Exception:  # noqa: BLE001
            pass
        self._sender_pool.stop()
        self._wakeup()
        with self._send_cond:
            channels = list(self._send_channels.values())
            self._send_channels.clear()
        for chan in channels:  # retire per-conn sender threads
            with chan.cond:
                chan.dead = True
                chan.cond.notify_all()
        if self._memory_monitor is not None:
            self._memory_monitor.stop()
        if self._node_listener is not None:
            try:
                self._node_listener.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=1.0)
        try:
            os.unlink(self._socket_path)
        except OSError:
            pass
        self._router.join(timeout=2.0)
        self._hb.join(timeout=2.0)
        self._request_pool.shutdown(wait=False, cancel_futures=True)
        self._transfer_pool.shutdown(wait=False, cancel_futures=True)
        # fail every unresolved object future: a pool thread parked in
        # fut.result() with no timeout (a worker's blocking get) would
        # otherwise never wake — and concurrent.futures' atexit hook joins
        # every worker thread ever created, so one sleeper wedges
        # interpreter exit after the last test finishes. Runs AFTER the
        # router/pools stop and LOOPS: a woken pool thread can still
        # insert one more future before it observes _stop (dep callbacks
        # are _stop-guarded, so nothing resubmits work).
        for _ in range(20):
            with self._lock:
                pending_futs = [f for f in self.futures.values()
                                if not f.done()]
            if not pending_futs:
                break
            for f in pending_futs:
                try:
                    f.set_exception(RuntimeError("runtime shut down"))
                except Exception:  # noqa: BLE001
                    pass
            _SlimFuture.broadcast()
            time.sleep(0.05)
        try:
            self._xfer_conn_pool.close()
        except Exception:
            pass
        for srv in self._xfer_servers.values():
            try:
                srv.close()
            except Exception:
                pass
        for nm in self.nodes.values():
            try:
                nm.shutdown(unlink_store=True)
            except Exception:
                pass
        from . import zygote as _zygote

        _zygote.shutdown_global()
        for cli in self._store_clients.values():
            if isinstance(cli, StoreClient):
                try:
                    cli.close()
                except Exception:
                    pass
        for proc in self._agent_procs:
            try:
                proc.wait(timeout=3.0)
            except Exception:
                try:
                    proc.terminate()
                except Exception:
                    pass
        # a SIGKILLed agent (chaos, preemption) cannot unlink its shm
        # store; reclaim any same-host segment whose owning pid is gone
        try:
            from ..native import reap_stale_stores

            reap_stale_stores("rmtA_")
        except Exception:
            pass
        with self._lock:
            self.memory_store.clear()
        try:
            self.gcs.storage.close()
        except Exception:
            pass
        try:
            os.close(self._wakeup_r)
            os.close(self._wakeup_w)
        except OSError:
            pass
        _worker_context.set_runtime(None)
