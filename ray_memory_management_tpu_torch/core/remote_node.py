"""Head-side proxy for a remote node joined through a node agent.

``RemoteNodeManager`` subclasses ``NodeManager`` so every head-side code
path — scheduling, lease accounting, dispatch, actor lifecycle, worker
death — treats remote nodes exactly like local ones. What differs is the
mechanics a kernel boundary forces:

  - workers are spawned by the agent (``start_worker`` sends a frame
    instead of fork/exec; the handle's ``proc`` is a :class:`RemoteProc`);
  - worker pipes are tunneled: the handle's ``conn`` is a
    :class:`VirtualConn` whose ``send`` wraps the payload in a
    ``wsend`` frame on the agent channel, and inbound worker frames are
    unwrapped by the runtime's router (``wmsg``);
  - the object store is remote: :class:`RemoteStoreProxy` implements the
    read side by streaming chunks over the channel (the reference's
    chunked object-manager pull, object_manager.proto:63-67) and the
    write side by streaming a push (ObjectManager::Push analog).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..config import Config
from ..ids import NodeID, WorkerID
from ..utils.retry import RetryPolicy
from .node_manager import NodeManager, WorkerHandle
from .resources import NodeResources


class VirtualConn:
    """Stand-in for a worker's pipe: sends ride the agent channel."""

    __slots__ = ("wid", "node")

    def __init__(self, wid: bytes, node: "RemoteNodeManager"):
        self.wid = wid
        self.node = node

    def send(self, payload: dict) -> None:
        self.node.channel_send({"type": "wsend", "wid": self.wid,
                                "msg": payload})

    def close(self) -> None:
        pass


class RemoteProc:
    """Popen-shaped liveness facade for a worker living on another host.
    Death is learned from the agent (``wdeath``) rather than waitpid."""

    __slots__ = ("returncode", "_node", "_wid")

    def __init__(self, node: "RemoteNodeManager", wid: bytes):
        self.returncode: Optional[int] = None
        self._node = node
        self._wid = wid

    def poll(self):
        return self.returncode

    def terminate(self) -> None:
        self._node.channel_send({"type": "kill_worker", "wid": self._wid})

    def kill(self) -> None:
        self.terminate()


class RemoteStoreProxy:
    """The store surface the runtime needs for a node it cannot mmap.

    ``contains`` answers from the head's object directory (GCS locations —
    the head is the owner of record, so directory state is authoritative);
    ``get`` pulls the object's bytes over the channel; pushes stream
    create/chunk/seal frames and wait for the agent's ack.
    """

    def __init__(self, node: "RemoteNodeManager"):
        self._node = node

    def contains(self, object_id: bytes) -> bool:
        gcs = self._node.gcs
        return (gcs is not None
                and self._node.node_id in gcs.get_object_locations(object_id))

    def get(self, object_id: bytes):
        data = self._node.pull_object(object_id)
        return None if data is None else memoryview(data)

    def release(self, object_id: bytes) -> None:
        pass  # pulled bytes are owned by the head-side caller

    def ensure_resident(self, object_id: bytes) -> bool:
        """Restore-and-pin on the agent so a remote worker's direct shm
        read cannot race the agent's spill tier."""
        return self._node.ensure_object(object_id)

    def ensure_resident_many(self, object_ids) -> Dict[bytes, bool]:
        """Batched restore-and-pin: ONE channel round-trip for N objects
        (a per-object ensure against a degraded agent would serialize N
        blocking waits on the caller's thread)."""
        return self._node.ensure_objects(list(object_ids))

    def make_room(self, nbytes: int) -> bool:
        """Ask the agent to spill so a worker's direct put can allocate."""
        return self._node.request_spill(nbytes)

    def delete(self, object_id: bytes) -> None:
        self._node.channel_send({"type": "obj_free", "oid": object_id})

    def put_serialized(self, object_id: bytes, serialized) -> None:
        buf = bytearray(serialized.total_size)
        serialized.write_into(memoryview(buf))
        ok, err = self._node.push_object(object_id, memoryview(buf))
        if not ok:
            # raising keeps callers from registering a GCS location for an
            # object the agent never landed
            from ..exceptions import ObjectStoreFullError

            raise ObjectStoreFullError(
                f"push of {object_id.hex()[:8]} to "
                f"{self._node.hostname} failed ({err})")

    def usage(self):
        return (0, 0)


class RemoteNodeManager(NodeManager):
    def __init__(self, node_id: NodeID, resources: NodeResources,
                 config: Config, on_worker_started, channel,
                 gcs=None, hostname: str = "?",
                 gpu_names: Optional[List[str]] = None):
        # NodeManager.__init__ would create a local shm store; bypass it and
        # wire the remote-facing fields directly.
        self.socket_path = ""
        self.authkey_hex = ""
        self.node_id = node_id
        self.resources = resources
        self.config = config
        self.store = RemoteStoreProxy(self)
        self.store_name = f"remote:{hostname}"
        self._on_worker_started = on_worker_started
        self._init_pool_state()
        from .resources import GPU

        # the agent's GPUs as ITS CUDA_VISIBLE_DEVICES names them (the
        # agent reports node_manager.visible_devices from its own
        # process): a lease exports a card the agent was given, never a
        # raw index into the head's view of the host
        total_chips = int(resources.total.get(GPU))
        names = [str(c) for c in (gpu_names or [])]
        if len(names) != total_chips:
            raise ValueError(
                f"node {hostname} declares {total_chips} GPUs but reports "
                f"{len(names)} device names ({names})")
        self.gpu_names = tuple(names)
        self.free_chips: List[str] = names

        self.channel = channel
        self.gcs = gcs
        self.hostname = hostname
        self.agent_pid: Optional[int] = None  # pid on the agent's host
        # (host, port) of the agent's TransferServer, set by its
        # transfer_ready frame; None until then (fallback: channel push)
        self.transfer_addr: Optional[tuple] = None
        # the agent's shm store name (same transfer_ready frame): when the
        # agent shares this host, its store can be mapped directly
        self.remote_store_name: Optional[str] = None
        self._channel_lock = threading.Lock()
        self._req_counter = 0
        self._pending: Dict[int, dict] = {}       # req -> accumulating state
        self._pending_lock = threading.Lock()
        # serializes pushes so two transfer threads never interleave
        # create/chunk/seal frames for the same object at the agent
        self._push_lock = threading.Lock()
        # delta-heartbeat state, head side: seq of the last pong whose
        # delta we APPLIED (acked on the next ping so the agent knows
        # which base to delta against), the merged status mirror those
        # deltas build, and the resync latch a sequence gap raises so
        # the next ping requests full state
        self.hb_seq = 0  # guarded-by: _lock
        self.hb_resync = False  # guarded-by: _lock
        self.agent_stat: Dict[str, Any] = {}  # guarded-by: _lock
        # leaf-lease grant buffer: submit_leaf queues built frames here
        # and the router's per-pass flush ships ONE lease_batch frame
        # per node (leaf_lease_batch caps a single frame) instead of one
        # lease_exec per task
        self._lease_buf: List[dict] = []  # guarded-by: _lock

    # ---------------------------------------------------------------- channel
    def channel_send(self, msg: dict) -> bool:
        try:
            with self._channel_lock:
                self.channel.send(msg)
            return True
        except (OSError, BrokenPipeError, ValueError):
            return False

    def _new_req(self) -> int:
        with self._pending_lock:
            self._req_counter += 1
            req = self._req_counter
            self._pending[req] = {"event": threading.Event(), "chunks": [],
                                  "error": None}
            return req

    # -------------------------------------------------------------- transfers
    def pull_object(self, object_id: bytes,
                    timeout: float = 120.0) -> Optional[bytes]:
        """Chunked pull over the channel (PullManager analog,
        pull_manager.h:47, collapsed to one in-order stream)."""
        if not self.alive:
            return None
        req = self._new_req()
        with self._pending_lock:
            state = self._pending.get(req)
        if state is None or not self.channel_send(
                {"type": "obj_pull", "oid": object_id, "req": req}):
            with self._pending_lock:
                self._pending.pop(req, None)
            return None
        if not state["event"].wait(timeout):
            with self._pending_lock:
                self._pending.pop(req, None)
            return None
        with self._pending_lock:
            self._pending.pop(req, None)
        if state["error"]:
            return None
        return b"".join(state["chunks"])

    def push_object(self, object_id: bytes, view: memoryview,
                    timeout: float = 120.0):
        """Chunked push (ObjectManager::Push analog); returns
        ``(ok, last_error)``. A push the agent nacks as retryable —
        payload-budget backpressure from its admission control, or a
        transiently-full store (readers still draining) — is retried
        here with backoff for up to ``push_pressure_retry_s``: the
        caller holds a read ref on the source copy the whole time, so
        pressure delays the transfer but can never lose the object."""
        policy = RetryPolicy(
            max_attempts=10_000,  # bounded by the deadline, not attempts
            base_backoff_s=0.2, max_backoff_s=1.0,
            deadline_s=self.config.push_pressure_retry_s,
            retryable=lambda e: "retryable" in str(e), plane="push")
        attempt = 0
        while True:
            ok, err = self._push_object_once(object_id, view, timeout)
            if ok or not self.alive:
                return ok, err
            if not policy.is_retryable(err or ""):
                return False, err
            if not policy.backoff(attempt):
                return False, err
            attempt += 1

    def _push_object_once(self, object_id: bytes, view: memoryview,
                          timeout: float):
        """One push attempt; returns (ok, error_string)."""
        if not self.alive:
            return False, "node dead"
        with self._push_lock:
            # a concurrent transfer may have landed this object already
            if self.gcs is not None and self.node_id in \
                    self.gcs.get_object_locations(object_id):
                return True, None
            req = self._new_req()
            with self._pending_lock:
                state = self._pending.get(req)
            if state is None:
                return False, "shutting down"
            chunk = self.config.object_manager_chunk_size
            # req rides the obj_push frame so the agent can nack an
            # over-budget push IMMEDIATELY; the early ack sets our event
            # and the chunk loop aborts instead of streaming the whole
            # payload through the channel just to be discarded
            ok = self.channel_send({"type": "obj_push", "oid": object_id,
                                    "size": view.nbytes, "req": req})
            for off in range(0, view.nbytes, chunk):
                if not ok or state["event"].is_set():
                    break
                end = min(off + chunk, view.nbytes)
                ok = self.channel_send({
                    "type": "obj_chunk", "oid": object_id, "off": off,
                    "data": bytes(view[off:end]),
                })
            ok = ok and self.channel_send(
                {"type": "obj_seal", "oid": object_id, "req": req})
            if not ok:
                with self._pending_lock:
                    self._pending.pop(req, None)
                return False, "channel send failed"
        # ack wait OUTSIDE _push_lock: the lock only exists to keep the
        # push/chunk/seal frame sequence unfragmented on the channel —
        # holding it across a (up to 120s) ack wait convoys every other
        # push to this node behind one slow store
        if not state["event"].wait(timeout):
            with self._pending_lock:
                self._pending.pop(req, None)
            return False, "timeout"
        with self._pending_lock:
            self._pending.pop(req, None)
        return state["error"] is None, state["error"]

    def ensure_object(self, object_id: bytes, timeout: float = 60.0) -> bool:
        """Ask the agent to make the object shm-resident (restoring from its
        spill tier) and pin it briefly (node_agent obj_ensure)."""
        res = self.ensure_objects([object_id], timeout=timeout)
        return res.get(object_id, False)

    def ensure_objects(self, object_ids, timeout: float = 60.0
                       ) -> Dict[bytes, bool]:
        """Batched obj_ensure: one frame + one ack for N objects."""
        if not self.alive or not object_ids:
            return {oid: False for oid in object_ids}
        req = self._new_req()
        with self._pending_lock:
            state = self._pending.get(req)
        if state is None or not self.channel_send(
                {"type": "obj_ensure", "oids": list(object_ids),
                 "req": req}):
            with self._pending_lock:
                self._pending.pop(req, None)
            return {oid: False for oid in object_ids}
        ok = state["event"].wait(timeout)
        with self._pending_lock:
            self._pending.pop(req, None)
        if not ok or state["error"] is not None:
            return {oid: False for oid in object_ids}
        failed = set(state.get("failed") or ())
        return {oid: oid not in failed for oid in object_ids}

    def fetch_from_peer(self, oid: bytes, host: str, port: int,
                        timeout: float = 120.0,
                        src_store: Optional[str] = None,
                        alts: Optional[list] = None,
                        trace=None) -> Optional[str]:
        """Tell the agent to pull ``oid`` straight from a peer's transfer
        server (host "" = the head). ``src_store`` names the source's shm
        segment when the peer shares the agent's host — the agent then
        maps it and memcpys instead of speaking TCP. ``alts`` lists other
        live holders' transfer addresses (head-resolved) so the agent can
        fail a stalled pull over mid-stripe. ``trace`` is the trace
        context of the task the pull serves; it rides the fetch frame and
        the agent's wire requests so serve spans land on the task's
        causal chain. Returns None on success, else an error string.
        Payload bytes never touch the head or this channel."""
        if not self.alive:
            return "node dead"
        req = self._new_req()
        msg = {"type": "obj_fetch", "oid": oid, "host": host,
               "port": port, "req": req}
        if src_store:
            msg["src_store"] = src_store
        if alts:
            msg["alts"] = list(alts)
        if trace:
            msg["trace"] = tuple(trace)
        with self._pending_lock:
            state = self._pending.get(req)
        if state is None or not self.channel_send(msg):
            with self._pending_lock:
                self._pending.pop(req, None)
            return "channel send failed"
        ok = state["event"].wait(timeout)
        with self._pending_lock:
            self._pending.pop(req, None)
        if not ok:
            return "fetch timed out"
        return state["error"]

    def request_spill(self, nbytes: int, timeout: float = 60.0) -> bool:
        """One obj_spill round trip (the make_room path)."""
        if not self.alive:
            return False
        req = self._new_req()
        with self._pending_lock:
            state = self._pending.get(req)
        if state is None or not self.channel_send(
                {"type": "obj_spill", "bytes": int(nbytes), "req": req}):
            with self._pending_lock:
                self._pending.pop(req, None)
            return False
        ok = state["event"].wait(timeout)
        with self._pending_lock:
            self._pending.pop(req, None)
        return ok and state["error"] is None

    def on_channel_reply(self, msg: dict) -> None:
        """push_ack / pull_data / ensure_ack / fetch_ack / spill_ack frames
        routed here by the runtime router."""
        req = msg.get("req")
        with self._pending_lock:
            state = self._pending.get(req)
        if state is None:
            return
        if msg["type"] in ("push_ack", "ensure_ack", "fetch_ack",
                           "spill_ack"):
            state["error"] = msg.get("error")
            state["failed"] = msg.get("failed")
            state["event"].set()
            return
        if msg.get("error"):
            state["error"] = msg["error"]
            state["event"].set()
            return
        state["chunks"].append(msg["data"])
        if msg.get("eof"):
            state["event"].set()

    # ------------------------------------------------------------- leaf leases
    def submit_leaf(self, spec, build_msg=None) -> bool:
        """Agent-local leaf placement: spend a lease credit and ship the
        fully-built exec frame to the node's AGENT, which picks the
        worker itself (lease_exec). The head's only per-task work is the
        frame build — no pick_node, no dispatch queue, no try_dispatch
        round. The agent answers lease_spill when its pool is saturated
        (credit returned via finish_leaf, task re-enters the router) and
        lease_dead when the chosen worker dies mid-task."""
        if build_msg is None:
            return False
        with self._lock:
            if not self.alive or self.leaf_credits <= 0:
                return False
            self.leaf_credits -= 1
            self.leaf_inflight[spec.task_id] = spec
        msg = build_msg(self, spec)
        # grants BUFFER instead of shipping one frame per task: the
        # router flushes once per scheduling pass (flush_leases), so a
        # pass that places N leaf tasks on this node costs one
        # lease_batch frame, not N lease_exec frames — the per-node
        # ingress term the pod bench measures. A flush-time send failure
        # rolls the credits back there; a death between buffer and flush
        # reroutes through take_leaf_inflight like any in-flight lease.
        with self._lock:
            if not self.alive:
                self.leaf_credits += 1
                self.leaf_inflight.pop(spec.task_id, None)
                return False
            self._lease_buf.append({"task_id": spec.task_id, "msg": msg})
        return True

    def flush_leases(self) -> list:
        """Ship every buffered leaf grant: lease_batch frames of up to
        leaf_lease_batch entries each; a lone grant keeps the scalar
        lease_exec frame (wire-identical to pre-batching traffic at low
        rates). On a send failure the unsent grants' credits roll back
        and their specs return to the caller for rerouting (the router
        rides them through _pending_schedule, like a lease_spill)."""
        with self._lock:
            if not self._lease_buf:
                return []
            buf, self._lease_buf = self._lease_buf, []
        cap = max(1, int(getattr(self.config, "leaf_lease_batch", 64) or 1))
        failed: list = []
        i = 0
        while i < len(buf):
            chunk = buf[i:i + cap]
            i += cap
            if len(chunk) == 1:
                ok = self.channel_send({"type": "lease_exec",
                                        "task_id": chunk[0]["task_id"],
                                        "msg": chunk[0]["msg"]})
            else:
                ok = self.channel_send({"type": "lease_batch",
                                        "tasks": chunk})
                if ok:
                    from . import metrics_defs as mdefs

                    mdefs.leaf_lease_batches().inc()
            if not ok:
                with self._lock:
                    for entry in chunk + buf[i:]:
                        self.leaf_credits += 1
                        spec = self.leaf_inflight.pop(entry["task_id"],
                                                      None)
                        if spec is not None:
                            failed.append(spec)
                break
        return failed

    def lease_buffered(self) -> int:
        with self._lock:
            return len(self._lease_buf)

    # ---------------------------------------------------------- heartbeats
    def ping_frame(self) -> dict:
        """The head half of the delta-heartbeat pair: ack the last pong
        seq whose delta we applied (the agent deltas against exactly
        that base) and carry the resync latch when a gap lost it."""
        with self._lock:
            frame = {"type": "ping", "ack": self.hb_seq}
            if self.hb_resync:
                frame["resync"] = True
        return frame

    def on_pong_delta(self, msg: dict) -> None:
        """Apply one pong's delta-compressed control state. An in-order
        seq keeps the merged status mirror exact and applies held-row
        deltas (dadd/ddel) to the object directory; a full snapshot
        (dfull) replaces the mirror and reconciles the node's directory
        rows; a gap raises the resync latch — deltas built on a base we
        lost are DISCARDED, never guessed at — and is counted."""
        seq = msg.get("seq")
        if seq is None:
            return  # pre-delta pong: nothing to track
        full = bool(msg.get("dfull"))
        accept = False
        resync_now = False
        with self._lock:
            if full or seq == self.hb_seq + 1:
                accept = True
                self.hb_seq = seq
                if full:
                    self.agent_stat = dict(msg.get("stat") or {})
                    self.hb_resync = False
                elif msg.get("stat"):
                    self.agent_stat.update(msg["stat"])
            elif not self.hb_resync:
                self.hb_resync = True
                resync_now = True
        if resync_now:
            from . import metrics_defs as mdefs

            mdefs.heartbeat_resyncs().inc()
            return
        if not accept or self.gcs is None:
            return
        dadd = msg.get("dadd")
        ddel = msg.get("ddel")
        if full:
            if dadd is None:
                return  # status-only resync: no row assertion to apply
            held = {oid: size for oid, size in dadd}
            for oid, size in held.items():
                self.gcs.add_object_location(oid, self.node_id,
                                             size=size or None)
            self.gcs.reconcile_node_rows(self.node_id, held)
        else:
            for oid, size in dadd or ():
                self.gcs.add_object_location(oid, self.node_id,
                                             size=size or None)
            for oid in ddel or ():
                self.gcs.remove_object_location(oid, self.node_id)

    def cancel_leaf(self, task_id: bytes) -> None:
        """Job sweep: a leased task of a dead job may be RUNNING on a
        pool worker only the AGENT can name (the head never learned the
        placement — that was the point of the lease). Ask the agent to
        kill that worker; the resulting wdeath/lease_dead frames settle
        accounting through the normal death path, and the retry lands in
        _cancelled and fails. Best-effort: a dead channel means the node
        sweep already reclaimed everything."""
        self.channel_send({"type": "lease_cancel", "task_id": task_id})

    # ------------------------------------------------------------ worker pool
    def start_conda_worker(self, conda_spec, conda_key: str) -> None:
        """Remote flavor of the dedicated conda-env worker: the env is
        HOST-local, so the AGENT resolves/creates it and spawns under its
        python (the head only registers the handle). Overrides the base,
        which would Popen on the head's host against this node's
        nonexistent local socket."""
        with self._lock:
            if conda_key in self._conda_starting:
                return
            self._conda_starting.add(conda_key)
        worker_id = WorkerID.from_random()
        handle = WorkerHandle(worker_id,
                              RemoteProc(self, worker_id.binary()),
                              self.node_id)
        handle.conda_key = conda_key
        with self._lock:
            self.workers[worker_id] = handle
            self.starting += 1
        self._on_worker_started(handle)
        if not self.channel_send({
                "type": "start_worker", "wid_hex": worker_id.hex(),
                "dedicated": False, "env": {}, "conda": conda_spec}):
            with self._lock:
                self._conda_starting.discard(conda_key)
            self.remove_worker(handle)

    def start_worker(self, dedicated: bool = False,
                     bootstrap: Optional[dict] = None,
                     on_handle=None,
                     conda_spec=None) -> WorkerHandle:
        # mirror NodeManager: register the handle and run the caller's
        # bookkeeping BEFORE the spawn frame leaves — a bootstrapped fork
        # on the agent can answer before this function returns
        worker_id = WorkerID.from_random()
        handle = WorkerHandle(worker_id, RemoteProc(self, worker_id.binary()),
                              self.node_id)
        if dedicated:
            handle.actor_id = b"__pending__"
        with self._lock:
            self.workers[worker_id] = handle
            if not dedicated:
                self.starting += 1
        self._on_worker_started(handle)
        if on_handle is not None:
            on_handle(handle)
        msg = {
            "type": "start_worker",
            "wid_hex": worker_id.hex(),
            "dedicated": dedicated,
            "env": {},
        }
        if bootstrap is not None:
            # the agent delivers it: in-memory via its zygote fork, or on
            # the worker's dial-in if it had to cold-spawn
            msg["bootstrap"] = bootstrap
        if conda_spec is not None:
            # conda envs are HOST-local: the agent resolves/creates the
            # env on its own machine and spawns under its python
            msg["conda"] = conda_spec
        # BEFORE the frame leaves: a bootstrapped fork on the agent can
        # register before channel_send returns, and on_worker_ready skips
        # the boot sample when spawned_at is still 0
        handle.spawned_at = time.monotonic()
        self.channel_send(msg)
        return handle

    def worker_by_wid(self, wid: bytes) -> Optional[WorkerHandle]:
        with self._lock:
            return self.workers.get(WorkerID(wid))

    def _abort_pending(self, reason: str) -> None:
        """Wake every transfer blocked on this channel with an error."""
        with self._pending_lock:
            for state in self._pending.values():
                state["error"] = reason
                state["event"].set()
            self._pending.clear()

    def mark_dead(self) -> None:
        self.alive = False
        self._abort_pending("node died")
        for h in self.workers.values():
            if isinstance(h.proc, RemoteProc):
                h.proc.returncode = 1

    def shutdown(self, unlink_store: bool = True) -> None:
        self.channel_send({"type": "shutdown"})
        self.alive = False
        # in-flight pulls/pushes will never get replies once the channel
        # closes; waking them here keeps driver shutdown from parking a
        # transfer thread for its full timeout
        self._abort_pending("node shut down")
        try:
            self.channel.close()
        except Exception:
            pass
