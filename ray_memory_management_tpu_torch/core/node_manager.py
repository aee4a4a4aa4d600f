"""Node manager: per-node worker pool, dispatch queue, and chip accounting.

The raylet analog (src/ray/raylet/node_manager.h:143) restricted to what a
single-host GPU node needs:
  - WorkerPool semantics from worker_pool.h:104,349,427 — prestart, pooled
    idle workers, dedicated (non-returning) workers for actors;
  - LocalTaskManager dispatch (local_task_manager.cc:99,256): leased tasks
    queue here until an idle worker and node resources are available;
  - GPU assignment: the node tracks its free devices ("chips"), named as
    the driver's own ``CUDA_VISIBLE_DEVICES`` names them, and passes a
    ``CUDA_VISIBLE_DEVICES`` value with each lease — the reference's
    accelerator isolation (_private/utils.py:349-362).

Runs inside the driver process; worker processes are real OS processes
spawned fresh or forked from a zygote that never initialized CUDA, so
children never inherit the driver's CUDA state.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set

from ..config import Config
from ..ids import NodeID, WorkerID
from .object_store import NodeObjectStore
from .resources import CPU, NodeResources, Resources, GPU
from .task_spec import TaskSpec

# shared zero request for placement-group tasks (their resources were
# already deducted at bundle reservation); Resources is immutable-by-
# convention so one instance serves every dispatch round
_EMPTY_REQ = Resources({})


class WorkerHandle:
    __slots__ = ("worker_id", "proc", "conn", "node_id", "ready", "idle",
                 "known_fns", "known_classes", "actor_id", "inflight",
                 "lease_resources", "visible_chips", "pending_msgs",
                 "death_processed", "send_lock", "steal_pending",
                 "re_inflight", "conda_key", "spawned_at",
                 "_alive_checked_at", "device_mesh")

    def __init__(self, worker_id: WorkerID, proc, node_id: NodeID):
        self.worker_id = worker_id
        self.proc = proc  # subprocess.Popen
        self.conn = None  # set when the worker dials back in
        self.node_id = node_id
        self.ready = False
        self.idle = False
        self.death_processed = False
        self.steal_pending = False  # a steal request is in flight
        # serializes task-msg build+enqueue per worker: the fn_blob
        # carried-once decision (known_fns) must stay atomic with the
        # enqueue order now that dispatch sends outside the node lock
        self.send_lock = threading.Lock()
        self.known_fns: Set[bytes] = set()
        self.known_classes: Set[bytes] = set()
        self.actor_id: Optional[bytes] = None  # dedicated actor worker
        # set when this worker's process IS a conda env's python: it only
        # serves tasks carrying the same env key (worker_pool.h:446
        # dedicated runtime-env workers)
        self.conda_key: Optional[str] = None
        self.inflight: Dict[bytes, TaskSpec] = {}  # task_id -> spec
        self.re_inflight = 0  # inflight tasks carrying a runtime_env
        self.lease_resources: Optional[Resources] = None
        self.visible_chips: Optional[List[str]] = None
        self.pending_msgs: List[dict] = []  # queued until registration
        self.spawned_at = 0.0  # set at spawn; boot latency at ready
        self._alive_checked_at = 0.0
        # mesh fingerprint the worker reported with its first device
        # seal: the ICI-route decision compares it with the consumer's
        self.device_mesh: Optional[tuple] = None

    def alive(self) -> bool:
        # proc.poll() is a waitpid syscall; on the dispatch hot path it
        # dominated task throughput. Death is ALSO detected by the router
        # seeing the pipe EOF, so a short-TTL cache here only delays this
        # secondary check, never correctness.
        if self.proc.returncode is not None:
            return False
        import time

        now = time.monotonic()
        if now - self._alive_checked_at < 0.2:
            return True
        self._alive_checked_at = now
        return self.proc.poll() is None


class _PendingProc:
    """Placeholder process for a WorkerHandle registered before its OS
    process exists (start_worker registers first so a fast bootstrapped
    fork can never answer before the bookkeeping is visible)."""

    returncode = None

    def poll(self):
        return None

    def terminate(self) -> None:
        pass

    def kill(self) -> None:
        pass

    def wait(self, timeout=None) -> int:
        return 0


def package_env() -> Dict[str, str]:
    """A copy of this process's environment with PYTHONPATH arranged so
    spawned processes can import this package from any cwd (the checkout is
    the install; there is no pip-installed copy to fall back on)."""
    env = dict(os.environ)
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if pkg_parent not in parts:
        env["PYTHONPATH"] = os.pathsep.join([pkg_parent] + parts)
    return env


def build_worker_env(worker_id_hex: str, node_id_hex: str, store_name: str,
                     socket_path: str, authkey_hex: str,
                     config: Config) -> Dict[str, str]:
    """Environment for a spawned worker process — shared by the local
    worker pool and the remote node agent so the two can never diverge.

    Workers start with ``CUDA_VISIBLE_DEVICES=""`` — they never see the
    driver's cards (the driver's value is deliberately NOT inherited), the
    analog of the JAX package's ``JAX_PLATFORMS=cpu``. A GPU lease sets
    the variable to the leased indices in the worker before user code
    initializes CUDA (worker._apply_chip_lease)."""
    env = package_env()
    env.update({
        "RMT_WORKER_ID": worker_id_hex,
        "RMT_NODE_ID": node_id_hex,
        "RMT_STORE_NAME": store_name,
        "RMT_SOCKET": socket_path,
        "RMT_AUTHKEY": authkey_hex,
        "RMT_INLINE_LIMIT": str(config.max_direct_call_object_size),
        "RMT_LOG_TO_DRIVER": "1" if config.log_to_driver else "0",
        # pipelined done-reply batching (worker _ReplySender adaptive
        # flush window); explicit so local pool and agent spawn agree
        "RMT_REPLY_FLUSH_WINDOW_S": str(config.reply_flush_window_s),
        "RMT_REPLY_FLUSH_MAX": str(config.reply_flush_max),
        "CUDA_VISIBLE_DEVICES": "",
    })
    if env["CUDA_VISIBLE_DEVICES"] == "":
        # CPU workers skip accelerator bootstraps some images run from
        # sitecustomize at interpreter start; dropping the trigger env
        # vars keeps a CPU worker's spawn to the interpreter's own cost.
        for var in config.cpu_worker_env_drop.split(","):
            if var:
                env.pop(var.strip(), None)
    return env


def spawn_worker_process(env: Dict[str, str], config: Config,
                         bootstrap: Optional[dict] = None,
                         on_cold_bootstrap=None,
                         python_exe: Optional[str] = None):
    """Start one worker process: forked from the warm zygote when the
    worker starts without cards (``CUDA_VISIBLE_DEVICES=""``; ms instead
    of a cold interpreter), else — and whenever the zygote is unavailable
    — a fresh ``subprocess.Popen``. The zygote never initializes CUDA,
    so a forked child can still take a GPU lease later.

    ``bootstrap`` is a message the worker should process immediately at
    startup (the dedicated-worker startup token, worker_pool.h:446). The
    fork path hands it to the child in memory; the cold path cannot, so
    ``on_cold_bootstrap`` is invoked BEFORE the process is created — the
    caller queues the message for delivery at registration, race-free
    because the worker cannot register before it exists."""
    if python_exe is None and config.worker_fork_server \
            and env.get("CUDA_VISIBLE_DEVICES") == "":
        from . import zygote

        z = zygote.get_global()
        if z is not None:
            proc = z.spawn(env, bootstrap)
            if proc is not None:
                return proc
    if bootstrap is not None and on_cold_bootstrap is not None:
        on_cold_bootstrap()
    # python_exe: a conda env's interpreter — always a cold spawn (the
    # zygote is the WRONG interpreter); package_env's PYTHONPATH makes
    # this package importable from the foreign python
    return subprocess.Popen(
        [python_exe or sys.executable, "-m",
         "ray_memory_management_tpu_torch.core.worker_main"],
        env=env, close_fds=True,
    )


def visible_devices(n: int) -> List[str]:
    """The ``CUDA_VISIBLE_DEVICES`` entries of a node's ``n`` GPUs. Where
    the driver's own variable names devices, a lease exports those names
    (the reference maps GPU ids through the original list,
    _private/utils.py:349), so a driver pinned to card 3 leases card 3,
    not card 0; else the indices ``0 .. n-1``."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES") or ""
    names = [c.strip() for c in env.split(",") if c.strip()]
    if not names:
        return [str(i) for i in range(n)]
    if n > len(names):
        raise ValueError(
            f"{n} GPUs declared, but CUDA_VISIBLE_DEVICES={env!r} names "
            f"only {len(names)}")
    return names[:n]


class NodeManager:
    def __init__(
        self,
        node_id: NodeID,
        resources: NodeResources,
        store_name: str,
        config: Config,
        on_worker_started: Callable[[WorkerHandle], None],
        socket_path: str = "",
        authkey_hex: str = "",
    ):
        self.socket_path = socket_path
        self.authkey_hex = authkey_hex
        self.node_id = node_id
        self.resources = resources
        self.config = config
        self.store = NodeObjectStore(store_name, config, create=True)
        self.store_name = store_name
        self._on_worker_started = on_worker_started
        # every GPU's device name, leased or free (dist-mode training
        # partitions them, train/backend_executor.py)
        self.gpu_names = tuple(visible_devices(int(resources.total.get(GPU))))
        self.free_chips: List[str] = list(self.gpu_names)
        self._init_pool_state()

    def _init_pool_state(self) -> None:
        """Worker-pool bookkeeping shared with RemoteNodeManager, which
        bypasses ``__init__`` (it has no local store to create). Every
        pool field MUST live here, not in ``__init__``: a field added
        there surfaces as an AttributeError the first time an inherited
        pool method runs against a remote node."""
        self.workers: Dict[WorkerID, WorkerHandle] = {}
        self.idle_workers: deque = deque()
        # pool workers currently holding a lease; pipelining candidates
        # (max_tasks_in_flight_per_worker, the reference's small-task
        # pipelining knob on the direct task transport)
        self.busy_pool: Set[WorkerHandle] = set()
        self.queue: deque = deque()  # TaskSpec leased to this node
        self.starting = 0
        self.alive = True
        self._lock = threading.RLock()
        # dedicated conda-env workers, one warm pool per env key: their
        # process is the env's python, so they never mix with the main
        # pool (worker_pool.h:446 dedicated runtime-env workers)
        self.conda_idle: Dict[str, deque] = {}
        self._conda_starting: Set[str] = set()
        # phase accounting (scale bench): spawn-return -> worker-ready
        self.boot_seconds = 0.0
        self.boot_count = 0
        # leaf-lease pool (decentralized control plane): a bulk credit
        # grant that lets the router place constraint-free leaf tasks on
        # this node WITHOUT the full pick_node/locality pass, and lets a
        # remote node's agent pick the worker itself (the two-level
        # lease protocol the ClusterScheduler docstring reserves;
        # raylet_client.h:398). Credits resolve once per node: the flag,
        # or 2x the node's CPU count; negative disables leaf leasing.
        slots = self.config.leaf_lease_slots
        if slots == 0:
            slots = max(2, int(self.resources.total.get(CPU)) * 2)
        # construction runs outside __init__ (RemoteNodeManager path),
        # so take the lock to honor the annotations lexically
        with self._lock:
            self.leaf_credits = max(0, slots)  # guarded-by: _lock
            # local-mode markers: leaf tasks riding the ordinary
            # dispatch queue, so finish_task knows to return the credit
            self.leaf_local: Set[bytes] = set()  # guarded-by: _lock
            # remote-mode inflight: specs handed to the node's AGENT for
            # agent-local worker placement (lease_exec); drained by the
            # node-death handler exactly like the dispatch queue
            self.leaf_inflight: Dict[bytes, TaskSpec] = {}  # guarded-by: _lock
            # fn ids whose blob already rode a lease_exec to this
            # node's agent (the agent caches blobs; per-node ships-once)
            self.lease_known_fns: Set[bytes] = set()  # guarded-by: _lock

    # -- worker pool ----------------------------------------------------------
    def start_conda_worker(self, conda_spec, conda_key: str) -> None:
        """Spawn one dedicated worker whose process is the conda env's
        python. Env resolution/creation can take minutes (conda env
        create), so it runs on a daemon thread — never on the dispatch
        path; the worker joins ``conda_idle[key]`` at registration and
        the next dispatch round matches it."""
        with self._lock:
            if conda_key in self._conda_starting:
                return
            self._conda_starting.add(conda_key)

        def resolve_and_spawn():
            # _conda_starting holds the key until the worker REGISTERS
            # (cleared in on_worker_ready/remove_worker) so one worker at
            # a time starts per env; on any failure here the key clears
            # and the failure is loud
            handle = None
            try:
                from .. import runtime_env as re_mod

                python_exe = re_mod.conda_python(conda_spec)
                worker_id = WorkerID.from_random()
                env = build_worker_env(
                    worker_id.hex(), self.node_id.hex(), self.store_name,
                    self.socket_path, self.authkey_hex, self.config)
                handle = WorkerHandle(worker_id, _PendingProc(),
                                      self.node_id)
                handle.conda_key = conda_key
                with self._lock:
                    self.workers[worker_id] = handle
                    self.starting += 1
                self._on_worker_started(handle)
                handle.proc = spawn_worker_process(env, self.config,
                                                   python_exe=python_exe)
            except Exception as e:  # noqa: BLE001
                from ..utils import events

                events.emit(
                    "CONDA_ENV_FAILED",
                    f"conda env {conda_spec!r} unavailable: {e!r}; "
                    "tasks requiring it will wait",
                    severity=events.ERROR, source="worker_pool")
                with self._lock:
                    self._conda_starting.discard(conda_key)
                if handle is not None:
                    self.remove_worker(handle)
                return
            if not self.alive:
                try:
                    handle.proc.terminate()
                except Exception:  # noqa: BLE001
                    pass

        threading.Thread(target=resolve_and_spawn, daemon=True,
                         name=f"conda-spawn-{conda_key[:6]}").start()

    def start_worker(self, dedicated: bool = False,
                     bootstrap: Optional[dict] = None,
                     on_handle=None,
                     conda_spec=None) -> WorkerHandle:
        """Spawn one worker process (WorkerPool::StartWorkerProcess analog,
        worker_pool.h:427): a worker that dials back into the runtime's
        Unix socket — the same exec-then-connect handshake the raylet uses
        with its workers (raylet_client.h:236 registration over the raylet
        socket). A ``bootstrap`` message rides the spawn itself when the
        fork path is available (startup token, worker_pool.h:446), else it
        is queued for delivery at registration. ``conda_spec`` makes the
        worker a dedicated conda-env process (cold spawn under the env's
        python; resolution/creation may block the caller — actor creation
        tolerates this the way it tolerates pip installs).

        The handle is registered — and ``on_handle`` (caller bookkeeping
        that must be visible before any reply from the worker) runs —
        BEFORE the process exists: a bootstrapped fork can answer within
        milliseconds, racing any bookkeeping done after this returns."""
        python_exe = None
        if conda_spec is not None:
            from .. import runtime_env as re_mod

            python_exe = re_mod.conda_python(conda_spec)
        worker_id = WorkerID.from_random()
        env = build_worker_env(worker_id.hex(), self.node_id.hex(),
                               self.store_name, self.socket_path,
                               self.authkey_hex, self.config)
        handle = WorkerHandle(worker_id, _PendingProc(), self.node_id)
        if dedicated:
            # claimed for an actor before registration: never enters the
            # idle pool (dedicated workers, worker_pool.h:446)
            handle.actor_id = b"__pending__"
        with self._lock:
            self.workers[worker_id] = handle
            if not dedicated:
                self.starting += 1
        self._on_worker_started(handle)
        if on_handle is not None:
            on_handle(handle)

        def queue_bootstrap():
            # cold spawn: deliver through registration (pending_msgs are
            # flushed when the worker dials in). Runs before the process
            # exists, so the flush cannot have happened yet.
            handle.pending_msgs.append(bootstrap)

        # BEFORE the spawn: a bootstrapped fork can register before this
        # returns, and on_worker_ready skips the boot sample at 0
        handle.spawned_at = time.monotonic()
        handle.proc = spawn_worker_process(env, self.config, bootstrap,
                                           queue_bootstrap,
                                           python_exe=python_exe)
        if not self.alive:
            # remove_node ran while we were spawning: its terminate loop
            # saw only the _PendingProc placeholder, so the real process
            # would outlive its node — kill it; the runtime's unborn-worker
            # sweep then reports the death
            try:
                handle.proc.terminate()
            except Exception:  # noqa: BLE001
                pass
        return handle

    def prestart(self, count: Optional[int] = None) -> None:
        n = self.config.worker_prestart_count if count is None else count
        for _ in range(n):
            if len(self.workers) < self.config.max_workers_per_node:
                self.start_worker()

    def on_worker_ready(self, handle: WorkerHandle) -> None:
        with self._lock:
            handle.ready = True
            if handle.spawned_at:
                self.boot_seconds += time.monotonic() - handle.spawned_at
                self.boot_count += 1
            self.starting = max(0, self.starting - 1)
            if handle.conda_key is not None:
                self._conda_starting.discard(handle.conda_key)
            if handle.actor_id is None:
                handle.idle = True
                if handle.conda_key is not None:
                    self.conda_idle.setdefault(
                        handle.conda_key, deque()).append(handle)
                else:
                    self.idle_workers.append(handle)

    def remove_worker(self, handle: WorkerHandle) -> None:
        with self._lock:
            self.workers.pop(handle.worker_id, None)
            self.busy_pool.discard(handle)
            try:
                self.idle_workers.remove(handle)
            except ValueError:
                pass
            if handle.conda_key is not None:
                self._conda_starting.discard(handle.conda_key)
                try:
                    self.conda_idle.get(handle.conda_key,
                                        deque()).remove(handle)
                except ValueError:
                    pass
            if not handle.ready:
                self.starting = max(0, self.starting - 1)
            if handle.lease_resources is not None:
                self.resources.free(handle.lease_resources)
                handle.lease_resources = None
            if handle.visible_chips:
                self.free_chips.extend(handle.visible_chips)
                handle.visible_chips = None

    # -- dispatch -------------------------------------------------------------
    def submit(self, spec: TaskSpec) -> None:
        # fault plane, control side: an injected dispatch failure models
        # a dropped/late control frame; the runtime's dispatch RetryPolicy
        # (_submit_to_node) is what recovers it
        from ..utils import faults

        act = faults.fire("control.dispatch")
        if act is not None:
            if act.mode == "stall":
                act.sleep()
            else:
                act.raise_()
        with self._lock:
            if not self.alive:
                # a dead node's queue is drained exactly once by its
                # death handler; accepting a spec here would wedge it
                # forever ("not retryable" on THIS node — the dispatcher
                # re-places it on a live one)
                from ..exceptions import NodeDeadError

                raise NodeDeadError(
                    f"node {self.node_id.hex()[:12]} is dead "
                    "(not retryable)")
            self.queue.append(spec)

    def backlog(self) -> int:
        """Tasks leased to this node but not yet executing: the dispatch
        queue plus everything pipelined behind a running task on a worker
        pipe. This — not ``len(queue)`` — is the node's pending-demand
        signal (autoscaler scale-up, scheduler least-queued balancing);
        pipelining would otherwise drain the queue and blind both."""
        with self._lock:
            return len(self.queue) + sum(
                len(h.inflight) - 1
                for h in self.busy_pool if len(h.inflight) > 1
            )

    # -- leaf leases ----------------------------------------------------------
    def submit_leaf(self, spec: TaskSpec, build_msg=None) -> bool:
        """Admit one leaf task against this node's lease-credit pool.

        Local nodes just ride the ordinary dispatch queue (the win is
        skipping the router's pick_node/locality pass, not the queue);
        the credit is returned by finish_task via the leaf_local marker.
        Returns False when the pool is saturated (the caller counts a
        spillback and falls through to the full scheduling path) or the
        node is dead. ``build_msg`` is only used by the remote override.
        """
        with self._lock:
            if not self.alive or self.leaf_credits <= 0:
                return False
            self.leaf_credits -= 1
            self.leaf_local.add(spec.task_id)
            self.queue.append(spec)
        return True

    def flush_leases(self) -> list:
        """Local nodes dispatch leaf tasks straight onto their own queue
        in submit_leaf — there is no grant buffer to flush and nothing
        can fail, so the router's per-pass flush is a no-op here. The
        remote override ships the buffered lease_batch frames and
        returns any specs a dead channel bounced."""
        return []

    def finish_leaf(self, task_id: bytes) -> Optional[TaskSpec]:
        """Settle an agent-placed leaf task (done reply, spillback, or
        worker death): return its credit and hand back the spec. Local
        leaf tasks live in handle.inflight instead, so this returns None
        for them — finish_task settles their credit."""
        with self._lock:
            spec = self.leaf_inflight.pop(task_id, None)
            if spec is not None:
                self.leaf_credits += 1
            return spec

    def cancel_leaf(self, task_id: bytes) -> None:
        """Job sweep: nothing to do locally — a local leaf task is
        either in the dispatch queue (the sweep drops it there) or in a
        worker handle's inflight map (the sweep's victim scan terminates
        that worker). The remote override asks the agent to kill the
        pool worker only IT can name."""

    def release_leaf(self, task_id: bytes) -> None:
        """Return the credit of a LOCAL leaf task whose worker died
        before finish_task could run (the death handler cleared the
        handle's inflight map wholesale)."""
        with self._lock:
            if task_id in self.leaf_local:
                self.leaf_local.discard(task_id)
                self.leaf_credits += 1

    def take_leaf_inflight(self) -> Dict[bytes, TaskSpec]:
        """Node death: drain every agent-placed leaf task for retry
        elsewhere (the lease-revocation half of the dead-flag-then-drain
        ordering — the dead flag is already set, so no new lease_exec
        can land behind this drain)."""
        with self._lock:
            out = dict(self.leaf_inflight)
            self.leaf_inflight.clear()
            self.leaf_credits += len(out)
            return out

    def preempt_leaf(self, victim_ok):
        """Priority preemption over this node's LOCAL leaf pool: evict
        one leaf task for which ``victim_ok(task_id)`` is True (the
        runtime passes a lower-priority-job predicate; it must not block
        — it runs under the node lock).

        Prefers a QUEUED victim — removed from the dispatch queue with
        its credit returned synchronously, zero wasted work; falls back
        to a RUNNING victim whose worker holds nothing else (the caller
        terminates the worker and the ordinary death path returns the
        credit and re-queues the task). Returns ``("queued", spec)``,
        ``("running", (task_id, handle))``, or None."""
        with self._lock:
            if not self.alive:
                return None
            for i, spec in enumerate(self.queue):
                if spec.task_id in self.leaf_local \
                        and victim_ok(spec.task_id):
                    del self.queue[i]
                    self.leaf_local.discard(spec.task_id)
                    self.leaf_credits += 1
                    return ("queued", spec)
            for h in self.workers.values():
                if h.actor_id is not None or len(h.inflight) != 1:
                    continue
                tid = next(iter(h.inflight))
                if tid in self.leaf_local and victim_ok(tid):
                    return ("running", (tid, h))
            return None

    def try_dispatch(
        self, send: Callable[[WorkerHandle, TaskSpec], None]
    ) -> None:
        """Match queued tasks to idle workers + resources; start workers on
        demand (DispatchScheduledTasksToWorkers, local_task_manager.cc:99).

        Two dispatch modes:
          - lease: an idle worker takes the task and its resource request is
            allocated from the node pool;
          - pipeline: when no idle worker/resources are left, a task whose
            request exactly matches a busy pool worker's held lease rides
            that lease, queued on the worker's pipe behind its current task
            (the reference pipelines small tasks onto held leases the same
            way — max_tasks_in_flight_per_worker on the direct transport).
            The worker still executes serially; pipelining only hides the
            owner↔worker turnaround latency.
        """
        to_send: List[tuple] = []
        with self._lock:
            if not self.alive:
                return
            while self.queue:
                spec = self.queue[0]
                # PG tasks draw from their bundle's reservation, which the
                # scheduler already deducted from this node's pool
                req = (_EMPTY_REQ if spec.placement is not None
                       else spec.req)
                handle = None
                lease = False
                conda_spec = (spec.runtime_env or {}).get("conda") \
                    if spec.runtime_env else None
                if conda_spec is not None:
                    # conda tasks only run on dedicated workers whose
                    # process IS the env's python — never the main pool
                    ckey = spec._conda_key
                    if ckey is None:
                        from .. import runtime_env as re_mod

                        ckey = re_mod.conda_env_key(conda_spec)
                        spec._conda_key = ckey
                    if req.fits_in(self.resources.available):
                        pool = self.conda_idle.get(ckey)
                        while pool:
                            cand = pool.popleft()
                            if cand.alive() and cand.ready:
                                handle = cand
                                lease = True
                                break
                    if handle is None:
                        # spawn ONLY when no warm worker exists for this
                        # env (a resource wait with a warm worker must
                        # not breed processes); resolution/creation runs
                        # off-thread and the worker joins conda_idle at
                        # registration (one in flight per key — the
                        # _conda_starting guard clears at ready/death)
                        if not self.conda_idle.get(ckey):
                            self.start_conda_worker(conda_spec, ckey)
                        break  # head-of-line: wait for the env worker
                elif req.fits_in(self.resources.available):
                    while self.idle_workers:
                        cand = self.idle_workers.popleft()
                        if cand.alive() and cand.ready:
                            handle = cand
                            lease = True
                            break
                    if handle is None:
                        self._start_workers_for_backlog(req)
                if handle is None:
                    handle = self._pick_pipeline_worker(spec, req)
                    if handle is None:
                        break  # head-of-line: wait for a lease to free
                self.queue.popleft()
                handle.idle = False
                handle.inflight[spec.task_id] = spec
                if spec.runtime_env:
                    handle.re_inflight += 1
                if lease:
                    self.resources.allocate(req)
                    handle.lease_resources = req
                    n_chips = int(req.get(GPU))
                    if n_chips > 0:
                        handle.visible_chips = [
                            self.free_chips.pop() for _ in range(n_chips)
                        ]
                    if handle.actor_id is None:
                        self.busy_pool.add(handle)
                to_send.append((handle, spec))
        # sends happen outside the node lock: a slow pipe write must not
        # block completions (finish_task) or other dispatchers
        for handle, spec in to_send:
            send(handle, spec)

    def pick_steal_victim(self) -> Optional[WorkerHandle]:
        """When a worker sits idle with an empty queue while another's pipe
        carries pipelined backlog, steal it back (the reference's direct-
        transport work stealing): the victim returns its not-yet-started
        tasks and the owner re-dispatches them to the idle capacity.
        Returns the most-backlogged eligible worker, marking it
        steal_pending (cleared when its 'stolen' reply lands)."""
        with self._lock:
            if self.queue or not any(
                    h.idle and h.ready for h in self.idle_workers):
                return None
            best = None
            for cand in self.busy_pool:
                # the lease-fits check keeps stealing productive: a stolen
                # task can only land on the idle worker if a lease of the
                # same shape is available — otherwise it would just
                # re-pipeline onto a busy worker (steal/re-pipeline churn)
                if (len(cand.inflight) > 1 and not cand.steal_pending
                        and cand.alive()
                        and cand.lease_resources is not None
                        and cand.lease_resources.fits_in(
                            self.resources.available)):
                    if best is None or len(cand.inflight) > \
                            len(best.inflight):
                        best = cand
            if best is not None:
                best.steal_pending = True
            return best

    def return_stolen(self, handle: WorkerHandle, task_ids) -> tuple:
        """Take stolen tasks back from ``handle``: re-queue their specs at
        the FRONT (they were dispatched first) and release the worker's
        lease if its pipeline drained. Returns (the specs, whether they
        were re-queued here): a dead node's queue was drained once by its
        death handler, so there the caller must place them elsewhere."""
        specs = []
        with self._lock:
            handle.steal_pending = False
            for tid in task_ids:
                spec = handle.inflight.pop(tid, None)
                if spec is not None:
                    specs.append(spec)
                    if spec.runtime_env:
                        handle.re_inflight -= 1
                    # the blob-carrying dispatch may itself be stolen, so
                    # this worker can no longer be assumed to know the fn
                    handle.known_fns.discard(spec.fn_id)
            queued = self.alive
            if queued:
                for spec in reversed(specs):
                    self.queue.appendleft(spec)
            if not handle.inflight and handle.lease_resources is not None:
                self.resources.free(handle.lease_resources)
                handle.lease_resources = None
                if handle.visible_chips:
                    self.free_chips.extend(handle.visible_chips)
                    handle.visible_chips = None
                self.busy_pool.discard(handle)
                if handle.actor_id is None and handle.alive():
                    handle.idle = True
                    self.idle_workers.appendleft(handle)
        return specs, queued

    def _start_workers_for_backlog(self, req: Resources) -> None:
        """Start enough workers to cover the queued backlog, bounded by the
        resource slots the node could actually lease (the reference
        prestarts workers per dispatch round the same way,
        worker_pool.h:349 PrestartWorkers)."""
        can_start = self.config.max_workers_per_node - len(self.workers)
        if can_start <= self.starting:
            return
        # how many copies of `req` fit in what's still available (pure
        # arithmetic: this runs on every dispatch round with an empty idle
        # pool, so no trial-allocation loop)
        slots = 64
        avail = self.resources.available
        for name, amount in req.to_dict().items():
            if amount > 0:
                slots = min(slots, int(avail.get(name) / amount))
        want = min(len(self.queue), slots, can_start) - self.starting
        for _ in range(max(0, want)):
            self.start_worker()

    def _pick_pipeline_worker(
        self, spec: TaskSpec, req: Resources
    ) -> Optional[WorkerHandle]:
        """A busy pool worker whose held lease matches ``req`` exactly and
        whose pipe backlog is under the pipelining depth.

        runtime_env tasks never pipeline (in either direction): applying an
        env mutates process-wide state (os.environ, cwd, sys.path), which is
        only safe while the worker executes strictly serially — and a
        blocked task can grow a second executor thread (_TaskDispatcher)."""
        depth = self.config.max_tasks_in_flight_per_worker
        # only small tasks pipeline (the reference's pipelining likewise
        # targets the high-rate small-task path): a request over 1 CPU
        # signals heavy work, where serializing behind a busy worker loses
        # more than the owner round trip costs — those wait for a lease
        # (or for the autoscaler, which sees them via backlog())
        if (depth <= 1 or spec.placement is not None or req.get(GPU) > 0
                or req.get(CPU) > 1.0 or spec.runtime_env):
            return None
        best = None
        best_depth = depth
        for cand in self.busy_pool:
            # steal_pending workers are off-limits: a dispatch racing the
            # in-flight steal could omit a fn_blob the steal is about to
            # take back (known_fns is only reconciled at the stolen reply)
            if (len(cand.inflight) < best_depth
                    and cand.lease_resources == req
                    and cand.ready and cand.alive()
                    and not cand.steal_pending
                    and cand.re_inflight == 0):
                best = cand
                best_depth = len(cand.inflight)
        return best

    def finish_task(self, handle: WorkerHandle, task_id: bytes) -> None:
        """Release the task; free the lease and return the worker to the
        pool once its pipeline drains."""
        with self._lock:
            spec = handle.inflight.pop(task_id, None)
            if spec is not None and spec.runtime_env:
                handle.re_inflight -= 1
            if task_id in self.leaf_local:
                # local-mode leaf task: its lease credit frees with it
                self.leaf_local.discard(task_id)
                self.leaf_credits += 1
            if handle.inflight:
                return  # pipelined tasks still riding this lease
            if handle.lease_resources is not None:
                self.resources.free(handle.lease_resources)
                handle.lease_resources = None
            if handle.visible_chips:
                self.free_chips.extend(handle.visible_chips)
                handle.visible_chips = None
            self.busy_pool.discard(handle)
            if handle.actor_id is None and handle.alive():
                handle.idle = True
                if handle.conda_key is not None:
                    # back to its env's warm dedicated pool
                    self.conda_idle.setdefault(
                        handle.conda_key, deque()).appendleft(handle)
                    return
                # LIFO: reuse the hottest worker — on small tasks this keeps
                # one process warm (caches, branch state) and lets dispatch
                # batches coalesce on its pipe instead of round-robining
                # wakeups across the whole pool
                self.idle_workers.appendleft(handle)

    def dedicate_to_actor(self, handle: WorkerHandle, actor_id: bytes,
                          req: Resources, chips: Optional[List[str]]) -> None:
        """Convert a pooled worker into a dedicated actor worker; the lease
        lasts for the actor's lifetime (dedicated workers, worker_pool.h:446)."""
        with self._lock:
            handle.actor_id = actor_id
            handle.idle = False
            self.busy_pool.discard(handle)
            try:
                self.idle_workers.remove(handle)
            except ValueError:
                pass
            self.resources.allocate(req)
            handle.lease_resources = req
            handle.visible_chips = chips

    def take_chips(self, n: int) -> Optional[List[str]]:
        with self._lock:
            if len(self.free_chips) < n:
                return None
            return [self.free_chips.pop() for _ in range(n)]

    def shutdown(self, unlink_store: bool = True) -> None:
        with self._lock:
            self.alive = False
            workers = list(self.workers.values())
        for h in workers:
            if h.conn is not None:
                try:
                    h.conn.send({"type": "shutdown"})
                except (OSError, BrokenPipeError):
                    pass
        for h in workers:
            try:
                h.proc.wait(timeout=1.0)
            except subprocess.TimeoutExpired:
                h.proc.terminate()
            if h.conn is not None:
                try:
                    h.conn.close()
                except OSError:
                    pass
        self.store.close(unlink=unlink_store)
