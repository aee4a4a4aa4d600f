"""Worker process: executes tasks and hosts actors.

The analog of the reference's worker side of CoreWorker (task execution path
src/ray/core_worker/core_worker.cc:2181 → python/ray/_raylet.pyx:850,533) plus
the worker main loop (_raylet.pyx:1226 run_task_loop). Differences driven by
the single-host process model:

  - Transport is a same-host pipe to the driver-side node manager, not gRPC;
    args/returns ride the shared-memory store exactly like plasma.
  - The worker doubles as the reference's "IO worker" and nested-call client:
    tasks running here may call ``remote()``/``get()``/``put()``, which are
    proxied over the pipe to the owner runtime (the reference gives every
    worker a full CoreWorker; centralizing ownership in the driver is a
    single-host simplification, revisited for multi-host in the DCN plane).
  - Accelerator isolation: an exec message may carry ``visible_chips``; the
    worker exports them as ``CUDA_VISIBLE_DEVICES`` before user code
    initializes CUDA — the reference's per-task CUDA_VISIBLE_DEVICES
    (_raylet.pyx:563).

Concurrency: the main thread is a pure receive loop. Normal tasks and each
actor run on their own serial executor (max_concurrency>1 widens the actor's
pool — concurrency groups, reference concurrency_group_manager.h); ``async
def`` actor methods run on a per-actor asyncio loop thread (fiber.h analog).
"""

from __future__ import annotations

import asyncio
import inspect
import os
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from .. import serialization as ser
from ..utils import faults, profiler, structlog, tracing
from .object_store import StoreClient

log = structlog.get_logger(__name__)

# Actor classes preloaded by the ZYGOTE before forking (zygote.serve):
# every forked child inherits the loaded class via COW and skips its own
# cloudpickle.loads — the dominant per-child Python cost in an actor
# burst after the fork itself. Keyed by cls_id; plain dict (the zygote
# populates it pre-fork; children only read).
PRELOADED_CLASSES: Dict[bytes, Any] = {}


_m_executed = None


def _inc_executed() -> None:
    """Worker-side tasks-executed counter; lazily bound so the instrument
    registers in the WORKER's registry (its deltas merge into the head
    via the flush channel)."""
    global _m_executed
    if _m_executed is None:
        from . import metrics_defs as mdefs

        _m_executed = mdefs.worker_tasks_executed()
    _m_executed.inc()


class _ReplySender:
    """Reply writer owned by one persistent drain thread (the mirror of the
    runtime's _sender_enqueue): every enqueued reply is coalesced with
    whatever else accumulated into one ``{"type": "batch"}`` frame — one
    pickle + ONE pipe write for N completions. Each write to the driver
    pipe wakes the driver process (two context switches on a loaded host),
    so the executor thread never writes inline; it keeps executing while
    this thread drains."""

    def __init__(self, conn):
        self._conn = conn
        self._send_lock = threading.Lock()
        self._cond = threading.Condition()
        self._q: deque = deque()  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cond
        self._urgent = False  # an enqueued frame must not wait out the window  # guarded-by: _cond
        # adaptive flush window: after the first reply of a burst the
        # drain thread lingers briefly for stragglers, so N back-to-back
        # completions cost ONE pickle + ONE pipe write (flushing early
        # at the size cap). Workers receive explicit RMT_* env vars, not
        # the driver Config — see NodeManager.build_worker_env.
        try:
            self._window_s = float(
                os.environ.get("RMT_REPLY_FLUSH_WINDOW_S", "0.001"))
        except ValueError:
            self._window_s = 0.001
        try:
            self._flush_max = int(
                os.environ.get("RMT_REPLY_FLUSH_MAX", "32"))
        except ValueError:
            self._flush_max = 32

    def send(self, msg: dict, urgent: bool = False) -> None:
        """Enqueue one reply. ``urgent`` frames (owner round trips the
        executor parks on, the registration hello) flush the queue
        immediately instead of riding out the coalescing window."""
        with self._cond:
            self._q.append(msg)
            if urgent:
                self._urgent = True
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name="reply-sender")
                self._thread.start()
            self._cond.notify()

    def _write(self, payload: dict) -> bool:
        try:
            with self._send_lock:
                self._conn.send(payload)
            return True
        except (OSError, BrokenPipeError, ValueError):
            return False

    def send_now(self, msg: dict) -> bool:
        """Synchronous write, bypassing the drain thread — the exit-flush
        path, where os._exit follows immediately and a queued message
        would die with the process."""
        return self._write(msg)

    def flush_queued(self) -> None:
        """Synchronously deliver whatever the drain thread hasn't picked
        up yet (exit path: a done reply enqueued microseconds before
        shutdown must not lose the race with os._exit, and must reach
        the head BEFORE the final log/profile flush frame). Popping
        under _cond means each message is written exactly once whether
        this or the drain thread claims it."""
        with self._cond:
            msgs = list(self._q)
            self._q.clear()
        if msgs:
            self._write(msgs[0] if len(msgs) == 1 else
                        {"type": "batch", "msgs": msgs})

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while not self._q:
                    self._cond.wait()
                if (self._window_s > 0 and not self._urgent
                        and len(self._q) < self._flush_max):
                    # linger for the burst's stragglers; wait() drops
                    # _cond so executor threads keep enqueueing, and an
                    # urgent send (or the size cap) ends the window early
                    deadline = time.monotonic() + self._window_s
                    while (not self._urgent
                           and len(self._q) < self._flush_max):
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                msgs = list(self._q)
                self._q.clear()
                self._urgent = False
            payload = msgs[0] if len(msgs) == 1 else {
                "type": "batch", "msgs": msgs}
            if not self._write(payload):
                return


class _TaskDispatcher:
    """Serial plain-task executor that grows one thread whenever the
    running task parks in an owner round trip (nested get/wait).

    Pipelined dispatch queues several tasks on this worker's pipe; if the
    executing task blocks on a dependency produced by a task queued BEHIND
    it, a fixed single thread would deadlock. The reference's semantics are
    that a worker blocked in ray.get releases its slot and other work
    proceeds; here that means: keep exactly one runnable executor thread,
    spawning a new one when the current one blocks (bounded by the
    pipelining depth, since only queued tasks trigger growth)."""

    def __init__(self):
        self._q: deque = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._threads = 0   # live executor threads  # guarded-by: _cond
        self._blocked = 0   # parked in an owner wait (proxy request)  # guarded-by: _cond
        self._waiting = 0   # idle, parked on the queue  # guarded-by: _cond
        self._resuming = 0  # returned from an owner wait, parked for turn  # guarded-by: _cond
        self._is_exec = threading.local()

    def _runnable(self) -> int:
        return self._threads - self._blocked - self._waiting - self._resuming

    def submit(self, fn, msg) -> None:
        with self._cond:
            self._q.append((fn, msg))
            if self._waiting:
                self._cond.notify_all()
            elif self._runnable() < 1:
                self._spawn()

    def _spawn(self) -> None:  # rmtcheck: holds=_cond
        self._threads += 1
        threading.Thread(target=self._loop, daemon=True,
                         name="task-exec").start()

    def _loop(self) -> None:
        self._is_exec.flag = True
        while True:
            with self._cond:
                self._waiting += 1
                self._cond.notify_all()  # runnable dropped: a resumer may go
                while True:
                    # claim work only while holding the sole runnable slot
                    if self._q and self._runnable() == 0:
                        break
                    if not self._q and self._waiting > 1:
                        # one parked thread is enough; surplus threads
                        # (grown while a task blocked) retire here
                        self._waiting -= 1
                        self._threads -= 1
                        return
                    self._cond.wait()
                self._waiting -= 1
                fn, msg = self._q.popleft()
            fn(msg)

    def steal(self) -> list:
        """Remove and return every not-yet-started plain-task message
        (work stealing: the owner re-dispatches these to an idle worker —
        the reference's direct-transport steal protocol). Tasks already
        executing are untouched; only queued ``exec`` frames move."""
        with self._cond:
            kept, stolen = deque(), []
            while self._q:
                fn, msg = self._q.popleft()
                if isinstance(msg, dict) and msg.get("type") == "exec":
                    stolen.append(msg)
                else:
                    kept.append((fn, msg))
            self._q = kept
        return stolen

    def enter_blocked(self) -> None:
        """The calling executor thread is about to park in an owner wait."""
        if not getattr(self._is_exec, "flag", False):
            return
        with self._cond:
            self._blocked += 1
            self._cond.notify_all()  # runnable dropped: queue may proceed
            if self._q and self._runnable() < 1 and not self._waiting:
                self._spawn()

    def exit_blocked(self) -> None:
        """Owner wait finished. Tasks execute strictly serially in a worker
        (process-wide state: cwd, env, native libs); if another executor
        thread took the runnable slot while we were blocked, park here
        until it blocks, finishes, or retires."""
        if not getattr(self._is_exec, "flag", False):
            return
        with self._cond:
            self._blocked -= 1
            # after the decrement this thread itself counts as runnable;
            # park only while some OTHER thread holds the slot too
            while self._runnable() > 1:
                self._resuming += 1
                self._cond.wait()
                self._resuming -= 1


class WorkerRuntimeProxy:
    """Driver-runtime facade available to user code running in this worker.

    Implements submit/get/put/wait by round-tripping requests to the owner
    over the worker pipe; the driver's router thread services them.
    """

    def __init__(self, worker: "Worker"):
        self._worker = worker
        self._pending: Dict[int, Any] = {}  # guarded-by: _lock
        self._events: Dict[int, threading.Event] = {}  # guarded-by: _lock
        self._req_counter = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        # worker-side reference counting (the decentralization seed of
        # the reference's per-worker ReferenceCounter,
        # reference_count.h:39-61): this worker counts its OWN refs —
        # objects it put (it is the owner) and refs it deserialized
        # (borrows). Borrows still alive at task completion ship to the
        # head in the done reply's borrowed-ref table (the head converts
        # the task-duration arg pin into a worker-attributed pin);
        # zero-count transitions buffer into ``releases`` riding the
        # next done reply — no dedicated round trips in either
        # direction.
        # RLock: __del__ can fire inside any of these methods (a gc pass
        # collecting a ref cycle) and re-enter remove_local_ref
        self._ref_lock = threading.RLock()
        self._ref_counts: Dict[bytes, int] = {}  # guarded-by: _ref_lock
        self._owned: set = set()      # oids this worker put (owner)  # guarded-by: _ref_lock
        self._escaped: set = set()    # owned ids pickled OUT of this worker  # guarded-by: _ref_lock
        self._reported: set = set()   # borrows pinned head-side  # guarded-by: _ref_lock
        self._release_buf: List[bytes] = []  # guarded-by: _ref_lock
        self._owned_drop_buf: List[bytes] = []  # guarded-by: _ref_lock
        self.head_round_trips = 0  # observability: blocking owner RTs

    @property
    def inline_limit(self) -> int:
        return self._worker.inline_limit

    # -- worker-side reference counting ---------------------------------------
    def add_local_ref(self, oid: bytes) -> None:
        with self._ref_lock:
            self._ref_counts[oid] = self._ref_counts.get(oid, 0) + 1

    def mark_escaped(self, oid: bytes) -> None:
        """Called from ObjectRef.__reduce__ (serialize observer): the id
        left this process in a return/arg/put, so another process may
        hold it — the owner's release may only drop attribution, never
        free the value."""
        with self._ref_lock:
            if oid in self._owned:
                self._escaped.add(oid)

    def remove_local_ref(self, oid: bytes) -> None:
        with self._ref_lock:
            n = self._ref_counts.get(oid, 0) - 1
            if n > 0:
                self._ref_counts[oid] = n
                return
            self._ref_counts.pop(oid, None)
            owned = oid in self._owned
            reported = oid in self._reported
            self._owned.discard(oid)
            self._reported.discard(oid)
            if owned and oid in self._escaped:
                # the id is out in the world: the head only drops the
                # ownership attribution
                self._escaped.discard(oid)
                self._owned_drop_buf.append(oid)
            elif owned or reported:
                # the head holds freeable/pinned state: queue the release
                # (riding the next done reply — see ref_tables)
                self._release_buf.append(oid)

    def ref_tables(self) -> dict:
        """Borrow/release tables to piggyback on a done reply: new
        borrows (live deserialized refs not yet pinned head-side),
        buffered zero-count releases, and escaped-owned attribution
        drops. Called at completion-build time AFTER the frame's locals
        are dropped — the tables ride the reply, costing zero extra pipe
        writes."""
        out: dict = {}
        with self._ref_lock:
            borrows = [oid for oid, n in self._ref_counts.items()
                       if n > 0 and oid not in self._owned
                       and oid not in self._reported]
            if borrows:
                self._reported.update(borrows)
                out["borrows"] = borrows
            if self._release_buf:
                out["releases"] = self._release_buf
                self._release_buf = []
            if self._owned_drop_buf:
                out["owned_drops"] = self._owned_drop_buf
                self._owned_drop_buf = []
        return out

    def _request(self, msg: dict, timeout: Optional[float] = None):
        with self._lock:
            self._req_counter += 1
            req_id = self._req_counter
            ev = threading.Event()
            self._events[req_id] = ev
        msg["req_id"] = req_id
        self.head_round_trips += 1
        # urgent: this thread is about to PARK on the reply — every
        # microsecond the request sits in the coalescing window is pure
        # added round-trip latency
        self._worker.sender.send(msg, urgent=True)
        # an owner round trip can block on dependencies this worker itself
        # has queued — let the pipeline keep draining while we park
        dispatcher = self._worker.task_dispatcher
        dispatcher.enter_blocked()
        try:
            ok = ev.wait(timeout if timeout is not None else 3600.0)
        finally:
            dispatcher.exit_blocked()
        if not ok:
            raise TimeoutError(f"worker request {msg['type']} timed out")
        with self._lock:
            reply = self._pending.pop(req_id)
            self._events.pop(req_id, None)
        if reply.get("error") is not None:
            raise ser.loads(reply["error"])
        return reply

    def deliver(self, reply: dict) -> None:
        req_id = reply["req_id"]
        with self._lock:
            self._pending[req_id] = reply
            ev = self._events.get(req_id)
        if ev:
            ev.set()

    # -- API used by core.api when running inside a worker --------------------
    @staticmethod
    def _attach_trace_parent(payload: dict) -> dict:
        """A nested submit carries the EXECUTING task's trace context as
        its parent: the head minting the child spec chains its span onto
        it, which is what makes fan-out inside a task body one causal
        tree instead of a forest of fresh traces."""
        ctx = tracing.get_current()
        if ctx is not None and "trace_parent" not in payload:
            payload["trace_parent"] = ctx
        return payload

    def submit_task(self, payload: dict) -> List[bytes]:
        reply = self._request({"type": "submit_task",
                               "payload": self._attach_trace_parent(payload)})
        return reply["return_ids"]

    def submit_actor_task(self, payload: dict) -> List[bytes]:
        reply = self._request({"type": "submit_actor_task",
                               "payload": self._attach_trace_parent(payload)})
        return reply["return_ids"]

    def create_actor(self, payload: dict) -> bytes:
        reply = self._request({"type": "create_actor", "payload": payload})
        return reply["actor_id"]

    def get_objects(self, oids: List[bytes], timeout: Optional[float] = None,
                    consume: bool = False):
        """Resolve objects: local store first, else ask the owner (which
        transfers/restores/replies inline for memory-store values).
        ``consume=True`` TAKES device entries pinned in this process (the
        last-reader donation path) instead of reading them zero-copy."""
        out: Dict[bytes, Any] = {}
        missing: List[bytes] = []
        for oid in set(oids):
            if consume:
                arr = self._worker.device_store.take(oid)
                if arr is not None:
                    # one-way: the head drops its device routing for the
                    # oid (the buffer is being donated; no copy survives)
                    self._worker.sender.send(
                        {"type": "device_consumed", "object_id": oid})
                    out[oid] = arr
                    continue
            # device objects pinned in THIS process come back zero-copy
            arr = self._worker.device_store.get(oid)
            if arr is not None:
                out[oid] = arr
                continue
            view = self._worker.store.get(oid)
            if view is not None:
                out[oid] = self._maybe_repromote(
                    oid, self._worker.decode_value(view, pin=oid))
            else:
                missing.append(oid)
        attempt = 0
        while missing:
            req = {"type": "get_objects", "oids": missing}
            if attempt >= 3:
                # the owner's residency promise keeps getting reclaimed
                # under store pressure: ask for the bytes inline instead of
                # racing the spill tier again
                req["inline"] = True
            reply = self._request(req, timeout=timeout)
            still: List[bytes] = []
            for oid, enc in zip(missing, reply["values"]):
                if enc[0] == "v":
                    out[oid] = ser.loads(enc[1])
                else:  # now present in the local store
                    view = self._worker.store.get(oid)
                    if view is None:
                        # the owner's residency pin can be reclaimed under
                        # store pressure before our read lands — re-request
                        # (the owner restores again) instead of failing
                        still.append(oid)
                        continue
                    out[oid] = self._worker.decode_value(view, pin=oid)
            missing = still
            if missing:
                attempt += 1
                if attempt >= 8:
                    raise RuntimeError(
                        f"owner reported {missing[0].hex()} local but the "
                        f"store read kept missing after {attempt} attempts"
                    )
                time.sleep(0.05 * attempt)
        return [out[oid] for oid in oids]

    def _maybe_repromote(self, oid: bytes, value: Any):
        """Re-promotion on next device read: an object THIS worker
        demoted under budget pressure comes back as a live tensor
        (the demotion envelope rehydrates in decode) — re-pin it so
        subsequent local reads are zero-copy again. Movement back into
        the device tier carries the device.materialize fault site; an injected
        error skips the re-pin (the host copy still serves the read)."""
        from ..config import global_config
        from .device_store import is_device_array

        worker = self._worker
        if oid not in worker._demoted_device:
            return value
        if not global_config().device_promote_on_read \
                or not is_device_array(value):
            worker._demoted_device.discard(oid)
            return value
        act = faults.fire("device.materialize")
        if act is not None:
            if act.mode == "stall":
                act.sleep()
            else:
                return value  # injected error/drop: serve the host copy
        worker._demoted_device.discard(oid)
        worker.device_store.put(oid, value)
        return value

    def _direct_store_put(self, data, own: bool) -> bytes:
        """Shared body of the decentralized put paths: mint the id in
        THIS worker, write straight into the node's shm store (asking
        the head to make room once on pressure), and register via a
        ONE-WAY ``owned_put`` frame — zero blocking round trips
        (previously two: reserve_put + put_sealed). Pipe FIFO + the
        head's inline handling guarantee the registration lands before
        any later message referencing the id. Small values and
        full-store degradation go through ``put_inline`` (owner memory);
        with ``own`` those also register in the owned table so the
        owner-release protocol applies uniformly."""
        from ..ids import ObjectID
        from ..native import ShmStoreFullError

        if data.total_size <= self._worker.inline_limit:
            reply = self._request(
                {"type": "put_inline", "data": data.to_bytes(),
                 "own": own})
            oid = reply["object_id"]
            if own:
                with self._ref_lock:
                    self._owned.add(oid)
            return oid
        oid = ObjectID.for_put().binary()
        stored = False
        for attempt in range(2):
            try:
                self._worker.store.put_serialized(oid, data)
                stored = True
                break
            except ShmStoreFullError:
                if attempt == 0:
                    try:
                        self._request({"type": "make_room",
                                       "bytes": data.total_size},
                                      timeout=60)
                    except Exception:  # noqa: BLE001 — fall through
                        break
        if not stored:
            # node store full past spilling: owner-memory inline put is
            # the last resort (same degradation as oversized returns)
            reply = self._request(
                {"type": "put_inline", "data": data.to_bytes(),
                 "own": own})
            oid = reply["object_id"]
            if own:
                with self._ref_lock:
                    self._owned.add(oid)
            return oid
        if own:
            with self._ref_lock:
                self._owned.add(oid)
        self._worker.sender.send({"type": "owned_put", "object_id": oid,
                                  "own": own, "size": data.total_size})
        return oid

    def put_object(self, value: Any) -> bytes:
        """Store a value with THIS WORKER as the owner — the
        ownership-decentralization seed (reference_count.h:39 'the
        worker that creates the ObjectRef owns it')."""
        return self._direct_store_put(ser.serialize(value), own=True)

    def put_device_object(self, value: Any) -> bytes:
        """Pin a torch.Tensor in this worker's device store; two-phase with
        the owner (reserve, store locally, seal) so a get racing the put
        waits for the seal instead of missing the object."""
        from .device_store import is_device_array

        if not is_device_array(value):
            raise TypeError(
                "put(..., device=True) requires a torch.Tensor; got "
                f"{type(value).__name__}")
        from . import transfer as xfer

        reply = self._request({"type": "device_put"})
        oid = reply["object_id"]
        try:
            nbytes = int(value.nbytes)
        except Exception:  # noqa: BLE001
            nbytes = 0
        self._worker.device_store.put(oid, value)
        # the seal carries size (locality scoring sees device bytes) and
        # the producer's mesh fingerprint (the head's device-vs-host
        # route input)
        self._request({"type": "device_put_sealed", "object_id": oid,
                       "size": nbytes, "mesh": xfer.mesh_fingerprint()})
        return oid

    def put_serialized_arg(self, data) -> bytes:
        """Big nested-task args: same zero-round-trip direct store write
        as put_object, but with ``own: False`` — no ObjectRef ever wraps
        these ids (the task spec holds them), so the head keeps plain
        location state without owner attribution."""
        return self._direct_store_put(data, own=False)

    def wait(self, oids: List[bytes], num_returns: int, timeout, fetch_local):
        reply = self._request({
            "type": "wait", "oids": oids, "num_returns": num_returns,
            "timeout": timeout,
        }, timeout=None if timeout is None else timeout + 5)
        return reply["ready"], reply["not_ready"]

    def kill_actor(self, actor_id: bytes, no_restart: bool) -> None:
        self._request({"type": "kill_actor", "actor_id": actor_id,
                       "no_restart": no_restart})

    def cancel_task(self, oid: bytes, force: bool) -> None:
        self._request({"type": "cancel_task", "object_id": oid,
                       "force": force})

    def actor_method_spec(self, actor_id: bytes):
        reply = self._request({"type": "actor_info", "actor_id": actor_id})
        return reply

    def get_named_actor(self, name: str) -> bytes:
        reply = self._request({"type": "get_named_actor", "name": name})
        return reply["actor_id"]

    def request_resources(self, bundles) -> None:
        """Pin the head autoscaler's demand floor
        (``autoscaler.request_resources``)."""
        self._request({"type": "request_resources", "bundles": bundles})

    def state_query(self, fn: str, args: tuple, kwargs: dict):
        """One state API call answered by the head (``state.api``)."""
        return self._request({"type": "state_query", "fn": fn,
                              "args": args, "kwargs": kwargs})["rows"]

    # placement groups proxy to the driver-side manager so nested libraries
    # (a Trainer running inside a Tune trial actor) can gang-schedule — the
    # reference supports the same nesting through its GCS PG manager
    def create_placement_group(self, bundles, strategy, name="") -> bytes:
        reply = self._request({"type": "create_pg", "bundles": bundles,
                               "strategy": strategy, "name": name})
        return reply["pg_id"]

    def placement_group_state(self, pg_id: bytes):
        return self._request({"type": "pg_state", "pg_id": pg_id})["state"]

    def wait_placement_group(self, pg_id: bytes, timeout: float) -> bool:
        # blocks server-side on the request pool (like nested get/wait) —
        # one round-trip instead of a poll loop
        reply = self._request({"type": "wait_pg", "pg_id": pg_id,
                               "timeout": timeout}, timeout=timeout + 30)
        return reply["created"]

    def remove_placement_group(self, pg_id: bytes) -> None:
        self._request({"type": "remove_pg", "pg_id": pg_id})


class _ActorState:
    def __init__(self, instance, max_concurrency: int):
        self.instance = instance
        self.max_concurrency = max_concurrency
        self.executor = ThreadPoolExecutor(
            max_workers=max_concurrency, thread_name_prefix="actor"
        )
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.loop_thread: Optional[threading.Thread] = None
        # Bounds concurrent coroutines to max_concurrency (the reference
        # caps async actors the same way; threads bound only sync methods).
        self.async_sem: Optional[asyncio.Semaphore] = None
        self._loop_lock = threading.Lock()

    def ensure_loop(self) -> asyncio.AbstractEventLoop:
        # called from executor threads concurrently; exactly one loop/actor
        with self._loop_lock:
            if self.loop is None:
                self.loop = asyncio.new_event_loop()
                self.async_sem = asyncio.Semaphore(self.max_concurrency)
                self.loop_thread = threading.Thread(
                    target=self.loop.run_forever, daemon=True,
                    name="actor-asyncio"
                )
                self.loop_thread.start()
            return self.loop


class Worker:
    def __init__(self, conn, worker_id: bytes, node_id: bytes,
                 store_name: str, inline_limit: int):
        from ..config import global_config
        from .device_store import DeviceObjectStore, resolve_capacity

        self.conn = conn
        self.worker_id = worker_id
        self.node_id = node_id
        self.store = StoreClient(store_name)
        # workers see the env-driven config (RMT_* vars travel through the
        # pool spawn), so capacity/precision knobs apply per-process
        self.device_store = DeviceObjectStore(
            capacity_bytes=resolve_capacity(global_config()),
            on_demote=self._demote_device_object)
        # oids this process demoted (re-promotion candidates on read);
        # benign races only — a miss just skips one re-pin
        self._demoted_device: set = set()
        self.inline_limit = inline_limit
        self.sender = _ReplySender(conn)
        self.proxy = WorkerRuntimeProxy(self)
        self.functions: Dict[bytes, Any] = {}
        self.classes: Dict[bytes, Any] = {}
        self.actors: Dict[bytes, _ActorState] = {}
        self.task_dispatcher = _TaskDispatcher()
        self._shutdown = threading.Event()

    # -- value encoding -------------------------------------------------------
    def decode_value(self, view: memoryview, pin: Optional[bytes] = None):
        """Deserialize from a store view. The view stays referenced by any
        zero-copy numpy arrays; we release our store ref only after the task
        completes (args are pinned for the task's duration, as the raylet pins
        task args — local_task_manager.cc:388)."""
        return ser.deserialize(view)

    def decode_args(self, args, kwargs):
        pinned: List[bytes] = []

        def decode(enc):
            kind, payload = enc
            if kind == "v":
                return ser.loads(payload)
            view = self.store.get(payload)
            if view is None:
                # Not local (spilled elsewhere / other node): owner will fix.
                value = self.proxy.get_objects([payload])[0]
                return value
            pinned.append(payload)
            return ser.deserialize(view)

        pos = [decode(a) for a in args]
        kw = {k: decode(v) for k, v in kwargs.items()}
        return pos, kw, pinned

    def encode_returns(self, values: List[Any], return_ids: List[bytes]):
        """Small returns inline in the reply (owner memory store); big ones go
        straight to shm (core_worker.cc:892 PutInLocalPlasmaStore analog).

        A full store is the owner's problem, not a task failure: the worker
        asks the owner to make room (the owner spills the node's store — a
        plasma create triggering raylet spilling, create_request_queue.h:32)
        and retries; if the store STILL cannot take it, the value ships
        inline in the reply as the last resort."""
        from ..native import ShmStoreFullError

        encoded = []
        for value, oid in zip(values, return_ids):
            data = ser.serialize(value)
            if data.total_size <= self.inline_limit:
                encoded.append((oid, "v", data.to_bytes()))
                continue
            stored = False
            for attempt in range(2):
                try:
                    self.store.put_serialized(oid, data)
                    stored = True
                    break
                except ShmStoreFullError:
                    if attempt == 0:
                        try:
                            self.proxy._request(
                                {"type": "make_room",
                                 "bytes": data.total_size}, timeout=60)
                        except Exception:  # noqa: BLE001 — fall through
                            break
            if stored:
                encoded.append((oid, "store", data.total_size))
            else:
                # visible degradation: the value bypasses the object store
                # and lands in owner memory — if this repeats, the store is
                # undersized for the workload
                from ..utils import events

                events.emit(
                    "RETURN_INLINED",
                    f"store full even after spilling; shipping a "
                    f"{data.total_size}-byte return inline",
                    severity=events.WARNING, source="core_worker")
                log.warning("node store full; return of %s bytes "
                            "shipped inline", data.total_size)
                encoded.append((oid, "v", data.to_bytes()))
        return encoded

    # -- execution ------------------------------------------------------------
    @staticmethod
    def _apply_chip_lease(msg: dict) -> None:
        """Export the leased devices before user code initializes CUDA —
        per-task CUDA_VISIBLE_DEVICES (_raylet.pyx:563). The pool starts
        workers with ``CUDA_VISIBLE_DEVICES=""``; a GPU lease replaces it
        with the leased indices. CUDA reads the variable once, when it
        initializes, so nothing on a worker's start-up path may
        initialize it."""
        chips = msg.get("visible_chips")
        if chips is not None:
            os.environ["CUDA_VISIBLE_DEVICES"] = chips

    def _resolve_function(self, msg) -> Any:
        fn_id = msg["fn_id"]
        fn = self.functions.get(fn_id)
        if fn is None:
            blob = msg.get("fn_blob")
            if blob is None:
                raise RuntimeError(f"function {fn_id.hex()} not registered")
            import cloudpickle

            fn = cloudpickle.loads(blob)
            self.functions[fn_id] = fn
        return fn

    def exec_task(self, msg: dict) -> None:
        task_id = msg["task_id"]
        pinned: List[bytes] = []
        args = kwargs = result = returns = None
        t0 = time.time()
        # install the task's trace context for the duration of the call:
        # the exec span lands on the submitting trace, and any nested
        # .remote() inside the task body chains onto it (the proxy reads
        # the current context when it attaches trace_parent)
        trace_ctx = tracing.from_wire(msg.get("trace_ctx"))
        trace_tok = tracing.set_current(trace_ctx)
        # log records emitted by the task body (print, logging, package
        # logger) attribute to this task via the same ContextVar pattern
        log_tok = structlog.set_task_context(task_id.hex())
        # the stack sampler reads task identity through a per-thread-ident
        # map (ContextVars are invisible across threads); register it at
        # the same boundary, and bracket execution with rusage snapshots
        prof_tok = profiler.set_task_context(
            task_id.hex(), trace_ctx[0] if trace_ctx else None)
        ru0 = profiler.task_rusage_begin(self.device_store)
        try:
            self._apply_chip_lease(msg)
            fn = self._resolve_function(msg)
            # fault site: an injected error rides the normal app-error
            # path, so recovery is the task-retry machinery itself
            act = faults.fire("worker.exec")
            if act is not None:
                if act.mode == "stall":
                    act.sleep()
                else:
                    act.raise_()
            args, kwargs, pinned = self.decode_args(msg["args"], msg["kwargs"])
            env = msg.get("runtime_env")
            if env:
                from ..runtime_env import applied as _env_applied

                with _env_applied(env):
                    result = fn(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            returns = self._split_returns(result, msg["return_ids"])
            reply = {
                "type": "done", "task_id": task_id,
                "returns": self.encode_returns(returns, msg["return_ids"]),
                "error": None,
            }
        except BaseException as e:  # noqa: BLE001 — errors travel to the owner
            reply = {
                "type": "done", "task_id": task_id, "returns": [],
                "error": self._encode_error(msg.get("name", "task"), e),
            }
        finally:
            tracing.reset(trace_tok)
            structlog.reset_task_context(log_tok)
            profiler.reset_task_context(prof_tok)
            # resource deltas ride the reply like tstamps; computed here,
            # before the frame's refs drop, so peak_rss sees the task's
            # working set
            reply["rusage"] = profiler.task_rusage_end(
                ru0, self.device_store)
            for oid in pinned:
                self.store.release(oid)
        # drop the frame's refs BEFORE computing the borrow table: only
        # refs the USER retained (actor/global state) count as borrows —
        # args/result dying with the call must not ping-pong pin/release
        # through the head every task
        args = kwargs = result = returns = None  # noqa: F841
        reply["profile"] = self._profile_batch(
            f"task::{msg.get('name', 'task')}", t0,
            trace=trace_ctx, task_id=task_id)
        # the task's buffered log records ride ITS done reply: the head
        # ingests them before resolving the completion future, so a
        # task's last line is queryable the moment get() returns
        lgs = structlog.drain_records()
        if lgs:
            reply["logs"] = lgs
        # same contract for stack samples: the head ingests them before
        # resolving the future, so the burner's frames are queryable
        # through get_profile the moment get() returns
        smp = profiler.drain_samples()
        if smp:
            reply["samples"] = smp
        # worker-side lifecycle stamps ride the reply; the owner merges
        # them into the task's transition record (task_events analog)
        reply["tstamps"] = {"RUNNING": t0, "WORKER_DONE": time.time()}
        _inc_executed()
        # borrowed-ref table + buffered releases ride the done reply
        # (reference_count.h:139-156: the borrowed-ref table ships back
        # on task completion) — zero extra pipe writes
        reply.update(self.proxy.ref_tables())
        self.sender.send(reply)

    def _profile_batch(self, span_name: str, t0: float,
                       trace=None, task_id=None) -> List[dict]:
        """Record this task's execution span and flush buffered user
        profile() events — the worker→GCS ProfileEvent batch path
        (src/ray/core_worker/profiling.h:30) riding the done reply.
        ``trace`` carries the task's (trace_id, span_id, parent) so the
        exec slice joins the head-side lifecycle slices' flow group."""
        from ..utils import timeline

        timeline.record_event(
            span_name, "task", t0, time.time(),
            pid=f"worker:{self.worker_id.hex()[:8]}",
            extra={"task_id": task_id.hex()} if task_id else None,
            trace=trace,
        )
        # amortized: most replies carry no profile; every ~64th (or 1s)
        # carries the batch — stragglers ship via _profile_flush_loop
        return timeline.drain_events_if_due()

    @staticmethod
    def _split_returns(result, return_ids):
        n = len(return_ids)
        if n == 1:
            return [result]
        if not isinstance(result, (tuple, list)) or len(result) != n:
            raise ValueError(
                f"task declared num_returns={n} but returned {type(result)}"
            )
        return list(result)

    @staticmethod
    def _encode_error(name: str, e: BaseException) -> bytes:
        from ..exceptions import TaskError

        if isinstance(e, TaskError):  # propagate the original site
            return ser.dumps(e)
        tb = "".join(traceback.format_exception(e))
        try:
            return ser.dumps(TaskError(name, e, tb))
        except Exception:
            return ser.dumps(TaskError(name, None, tb))

    def materialize_device(self, msg: dict) -> None:
        """Owner-side device→host copy on demand: serialize the pinned
        array into this node's shm store so remote readers ride the
        normal object plane (device_store.py design)."""
        oid = msg["object_id"]
        try:
            act = faults.fire("device.materialize")
            if act is not None:
                if act.mode == "stall":
                    act.sleep()
                else:
                    act.raise_()
            arr = self.device_store.get(oid)
            if arr is None:
                raise KeyError(
                    f"device object {oid.hex()} not pinned in this worker")
            self.store.put_serialized(oid, ser.serialize(arr))
            reply = {"type": "device_materialized", "object_id": oid,
                     "error": None}
        except BaseException as e:  # noqa: BLE001
            reply = {"type": "device_materialized", "object_id": oid,
                     "error": self._encode_error("materialize_device", e)}
        self.sender.send(reply)

    def _demote_device_object(self, oid: bytes, arr: Any) -> bool:
        """Budget-pressure demotion callback (device_store.on_demote):
        device → this node's shm tier, optionally bf16-downcast. Runs on
        whichever thread overfilled the store; a full shm store defers
        the eviction (return False — the entry stays device-resident)."""
        from ..config import global_config
        from ..native import ShmStoreFullError
        from ..serialization import serialize_device_demotion

        data = serialize_device_demotion(
            arr, global_config().device_demote_precision)
        try:
            self.store.put_serialized(oid, data)
        except ShmStoreFullError:
            return False
        self._demoted_device.add(oid)
        # one-way notice: the head flips the directory tier to shm and
        # stops routing device reads here (pipe FIFO orders it before any
        # later frame referencing the oid)
        self.sender.send({"type": "device_demoted", "object_id": oid,
                          "size": data.total_size})
        return True

    def create_actor(self, msg: dict) -> None:
        actor_id = msg["actor_id"]
        try:
            self._apply_chip_lease(msg)
            cls_id = msg["cls_id"]
            cls = self.classes.get(cls_id) or PRELOADED_CLASSES.get(cls_id)
            if cls is None:
                blob = msg.get("cls_blob")
                if blob is None:  # stripped blob + no preload: a bug
                    raise RuntimeError(
                        f"class {cls_id.hex()} neither preloaded nor "
                        "shipped with the create")
                import cloudpickle

                cls = cloudpickle.loads(blob)
            self.classes[cls_id] = cls
            args, kwargs, pinned = self.decode_args(msg["args"], msg["kwargs"])
            # actors own their dedicated worker process: the env applies
            # for the process lifetime (async + concurrent methods see it
            # with no per-call save/restore races)
            from ..runtime_env import apply_permanent

            apply_permanent(msg.get("runtime_env"))
            instance = cls(*args, **kwargs)
            for oid in pinned:
                self.store.release(oid)
            state = _ActorState(instance, msg.get("max_concurrency", 1))
            self.actors[actor_id] = state
            reply = {"type": "actor_created", "actor_id": actor_id,
                     "error": None}
        except BaseException as e:  # noqa: BLE001
            reply = {"type": "actor_created", "actor_id": actor_id,
                     "error": self._encode_error(msg.get("name", "actor"), e)}
        self.sender.send(reply)

    def exec_actor_task(self, msg: dict) -> None:
        task_id = msg["task_id"]
        state = self.actors.get(msg["actor_id"])
        if state is None:
            self.sender.send({
                "type": "done", "task_id": task_id, "returns": [],
                "error": self._encode_error(
                    msg.get("name", "actor-task"),
                    RuntimeError("actor not found on worker"),
                ),
            })
            return
        method = getattr(state.instance, msg["method"], None)
        if method is None:
            self.sender.send({
                "type": "done", "task_id": task_id, "returns": [],
                "error": self._encode_error(
                    msg["method"], AttributeError(msg["method"])),
            })
            return
        pinned: List[bytes] = []
        t0 = time.time()
        trace_ctx = tracing.from_wire(msg.get("trace_ctx"))
        trace_tok = tracing.set_current(trace_ctx)
        log_tok = structlog.set_task_context(task_id.hex(),
                                            msg["actor_id"].hex())
        prof_tok = profiler.set_task_context(
            task_id.hex(), trace_ctx[0] if trace_ctx else None)
        ru0 = profiler.task_rusage_begin(self.device_store)
        try:
            args, kwargs, pinned = self.decode_args(msg["args"], msg["kwargs"])
            if inspect.iscoroutinefunction(method):
                # Async methods run as coroutines on the actor's loop and do
                # NOT hold this executor thread while awaiting (fiber.h
                # semantics: max_concurrency bounds threads for sync methods,
                # while any number of coroutines may be parked on awaits —
                # e.g. many blocked queue getters). The done callback (on the
                # loop thread) sends the reply and releases pinned args.
                loop = state.ensure_loop()

                async def _bounded(m=method, a=args, kw=kwargs, s=state,
                                   tc=trace_ctx, tid=task_id,
                                   aid=msg["actor_id"]):
                    # run_coroutine_threadsafe does NOT inherit this
                    # dispatcher thread's contextvars — the trace context
                    # (and the log plane's task context) must be installed
                    # INSIDE the coroutine for nested submits awaited by
                    # the method body to chain
                    tok = tracing.set_current(tc)
                    ltok = structlog.set_task_context(tid.hex(), aid.hex())
                    # the loop thread runs this coroutine — register the
                    # task identity there so samples taken mid-await
                    # attribute correctly (per-thread map, see exec_task)
                    ptok = profiler.set_task_context(
                        tid.hex(), tc[0] if tc else None)
                    try:
                        async with s.async_sem:
                            return await m(*a, **kw)
                    finally:
                        tracing.reset(tok)
                        structlog.reset_task_context(ltok)
                        profiler.reset_task_context(ptok)

                fut = asyncio.run_coroutine_threadsafe(_bounded(), loop)
                fut.add_done_callback(
                    lambda f, p=pinned: self._finish_actor_task(
                        msg, t0, p, f, ru0)
                )
                return
            result = method(*args, **kwargs)
            returns = self._split_returns(result, msg["return_ids"])
            reply = {
                "type": "done", "task_id": task_id,
                "returns": self.encode_returns(returns, msg["return_ids"]),
                "error": None,
            }
        except BaseException as e:  # noqa: BLE001
            reply = {"type": "done", "task_id": task_id, "returns": [],
                     "error": self._encode_error(msg["method"], e)}
        finally:
            tracing.reset(trace_tok)
            structlog.reset_task_context(log_tok)
            profiler.reset_task_context(prof_tok)
        reply["rusage"] = profiler.task_rusage_end(ru0, self.device_store)
        for oid in pinned:
            self.store.release(oid)
        # only refs retained in actor/user state survive this drop and
        # count as borrows (see exec_task)
        args = kwargs = result = returns = None  # noqa: F841
        reply["profile"] = self._profile_batch(
            f"actor::{msg.get('name', msg['method'])}", t0,
            trace=trace_ctx, task_id=task_id)
        lgs = structlog.drain_records()
        if lgs:
            reply["logs"] = lgs
        smp = profiler.drain_samples()
        if smp:
            reply["samples"] = smp
        reply["tstamps"] = {"RUNNING": t0, "WORKER_DONE": time.time()}
        _inc_executed()
        reply.update(self.proxy.ref_tables())  # borrows/releases ride along
        self.sender.send(reply)

    def _finish_actor_task(self, msg: dict, t0: float, pinned: List[bytes],
                           fut, ru0: Optional[dict] = None) -> None:
        """Completion callback for async actor methods (runs on the actor's
        loop thread when the coroutine finishes)."""
        task_id = msg["task_id"]
        try:
            result = fut.result()
            returns = self._split_returns(result, msg["return_ids"])
            reply = {
                "type": "done", "task_id": task_id,
                "returns": self.encode_returns(returns, msg["return_ids"]),
                "error": None,
            }
        except BaseException as e:  # noqa: BLE001
            reply = {"type": "done", "task_id": task_id, "returns": [],
                     "error": self._encode_error(msg["method"], e)}
        finally:
            for oid in pinned:
                self.store.release(oid)
        # drop before the borrow table — including the Future's stored
        # result, which would otherwise keep returned refs alive and
        # falsely report them as borrows (released only at the NEXT
        # done, or never on an idle actor)
        result = returns = None  # noqa: F841
        try:
            fut._result = None
        except AttributeError:
            pass
        fut = None  # noqa: F841
        reply["profile"] = self._profile_batch(
            f"actor::{msg.get('name', msg['method'])}", t0,
            trace=tracing.from_wire(msg.get("trace_ctx")), task_id=task_id)
        lgs = structlog.drain_records()
        if lgs:
            reply["logs"] = lgs
        smp = profiler.drain_samples()
        if smp:
            reply["samples"] = smp
        reply["tstamps"] = {"RUNNING": t0, "WORKER_DONE": time.time()}
        if ru0 is not None:
            # begin was snapped on the dispatcher thread, end runs here on
            # the loop thread — task_rusage_end detects the mismatch and
            # falls back to the process CPU clock
            reply["rusage"] = profiler.task_rusage_end(
                ru0, self.device_store)
        _inc_executed()
        reply.update(self.proxy.ref_tables())  # borrows/releases ride along
        self.sender.send(reply)

    # -- log streaming --------------------------------------------------------
    def start_output_capture(self) -> None:
        """Redirect this process's stdout/stderr (fd level, so native writes
        are caught too) into an in-band pipe whose drain thread ships chunks
        to the owner as ``log`` frames. The driver prints them prefixed with
        the worker identity — the log-monitor-tails-to-driver behavior of
        the reference (services.py:1126), collapsed onto the worker pipe
        (which also carries them through the node-agent tunnel, so REMOTE
        workers' prints reach the driver the same way)."""
        import sys

        r, w = os.pipe()
        os.dup2(w, 1)
        os.dup2(w, 2)
        os.close(w)
        # line buffering so a task's print() ships before the task blocks
        sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
        sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)

        def drain() -> None:
            while True:
                try:
                    chunk = os.read(r, 65536)
                except OSError:
                    return
                if not chunk:
                    return
                self.sender.send({"type": "log", "data": chunk})

        threading.Thread(target=drain, daemon=True,
                         name="log-capture").start()

    # -- main loop ------------------------------------------------------------
    def _flush_frame(self, spans: List[dict]) -> Optional[dict]:
        """Build one combined flush frame: straggler timeline spans plus
        this process's buffered events, log records and metric-series
        deltas (the agent→head aggregation ride-along). None when
        nothing moved."""
        from ..utils import events as _events
        from ..utils import metrics as _metrics

        evs = _events.drain_events()
        lgs = structlog.drain_records()
        try:
            series = _metrics.snapshot_deltas()
        except Exception:  # noqa: BLE001 — never block the flush on stats
            series = []
        try:
            smp = profiler.drain_samples()
        except Exception:  # noqa: BLE001 — never block the flush on stats
            smp = []
        if not (spans or evs or lgs or series or smp):
            return None
        frame: dict = {"type": "profile", "profile": spans or []}
        if evs:
            frame["events"] = evs
        if lgs:
            frame["logs"] = lgs
        if series:
            frame["series"] = series
        if smp:
            frame["samples"] = smp
        return frame

    def _profile_flush_loop(self) -> None:
        """Straggler profile spans: the done-reply path batches spans
        (drain_events_if_due), so an idle worker could sit on a tail of
        undelivered spans forever — this 1 s ticker ships them as a
        standalone frame (with piggybacked events + metric deltas).
        No-op (no send, no wakeups) while empty."""
        from ..utils import timeline

        while not self._shutdown.is_set():
            self._shutdown.wait(1.0)
            evs = timeline.drain_events_if_due(min_batch=1,
                                               max_age_s=1.0)
            frame = self._flush_frame(evs)
            if frame:
                self.sender.send(frame)

    def _final_flush(self) -> None:
        """Unconditional exit flush: spans/events/metric deltas buffered
        since the last ticker tick would die with os._exit — drain
        everything and write SYNCHRONOUSLY (the sender's drain thread may
        never be scheduled again). Failures are moot: if the pipe is
        already closed the head has moved on."""
        try:
            # queued done replies first: their attached log batches must
            # land before (and never lose the os._exit race to) the
            # trailing flush frame
            self.sender.flush_queued()
        except Exception:  # noqa: BLE001 — exiting anyway
            pass
        try:
            from ..utils import timeline

            spans = timeline.drain_events_if_due(min_batch=1, max_age_s=0.0)
            frame = self._flush_frame(spans)
            if frame:
                self.sender.send_now(frame)
        except Exception:  # noqa: BLE001 — exiting anyway
            pass

    def run(self) -> None:
        from .. import _worker_context

        _worker_context.set_proxy(self.proxy)
        if os.environ.get("RMT_LOG_TO_DRIVER") == "1":
            self.start_output_capture()
        # structured capture layers OVER the raw fd capture: the tee
        # writes through to the pipe (driver live tail unchanged) while
        # minting attributed records for the head LogStore
        structlog.configure(node_id=self.node_id.hex(), role="worker")
        structlog.install_worker_capture()
        # continuous low-hz stack sampling for the profiling plane; the
        # drained samples ride the same flush frames as spans/logs
        profiler.configure(node_id=self.node_id.hex(), role="worker")
        profiler.start_sampler()
        threading.Thread(target=self._profile_flush_loop, daemon=True,
                         name="profile-flush").start()
        # registration doubles as the ready signal (exec-then-connect
        # handshake; the runtime binds this connection to our WorkerHandle)
        self.sender.send({"type": "ready", "worker_id": self.worker_id,
                          "node_id": self.node_id, "pid": os.getpid()},
                         urgent=True)
        # a bootstrap message (the reference's dedicated-worker startup
        # token carrying the assigned actor, worker_pool.h:446) was handed
        # to us AT SPAWN — process it without waiting for the owner's
        # registration round trip. Ordering is safe: the owner sends actor
        # tasks only after our actor_ready reply.
        boot = getattr(self, "bootstrap_msg", None)
        if boot is not None:
            self.bootstrap_msg = None
            self._dispatch(boot)
        while not self._shutdown.is_set():
            try:
                msg = self.conn.recv()
            except (EOFError, OSError):
                break
            # batch frames come from the runtime's sender thread, which
            # coalesces back-to-back dispatches into one pickle+write
            msgs = msg["msgs"] if msg["type"] == "batch" else (msg,)
            for m in msgs:
                self._dispatch(m)
        self._final_flush()
        os._exit(0)  # skip atexit: the store mapping may hold live views

    def _dispatch(self, msg: dict) -> None:
        mtype = msg["type"]
        if mtype == "exec":
            self.task_dispatcher.submit(self.exec_task, msg)
        elif mtype == "exec_actor":
            state = self.actors.get(msg["actor_id"])
            if state is not None:
                state.executor.submit(self.exec_actor_task, msg)
            else:
                self.task_dispatcher.submit(self.exec_actor_task, msg)
        elif mtype == "create_actor":
            self.task_dispatcher.submit(self.create_actor, msg)
        elif mtype == "reply":
            self.proxy.deliver(msg)
        elif mtype == "materialize_device":
            # own thread: queuing behind a long task on task_executor
            # would stall remote readers of a live pinned object
            threading.Thread(
                target=self.materialize_device, args=(msg,),
                daemon=True, name="materialize-device").start()
        elif mtype == "steal":
            stolen = self.task_dispatcher.steal()
            # urgent: an idle worker elsewhere is waiting on this handback
            self.sender.send({
                "type": "stolen",
                "task_ids": [m["task_id"] for m in stolen],
            }, urgent=True)
        elif mtype == "free_device":
            self.device_store.delete(msg["object_id"])
            self._demoted_device.discard(msg["object_id"])
        elif mtype == "ping":
            self.sender.send({"type": "pong"})
        elif mtype == "shutdown":
            self._shutdown.set()


def worker_entry(conn, worker_id: bytes, node_id: bytes, store_name: str,
                 inline_limit: int, env: Optional[dict] = None) -> None:
    """Entry point run in the spawned worker process (worker_pool starts us —
    the WorkerPool::StartWorkerProcess analog, worker_pool.h:427)."""
    if env:
        os.environ.update(env)
    Worker(conn, worker_id, node_id, store_name, inline_limit).run()
