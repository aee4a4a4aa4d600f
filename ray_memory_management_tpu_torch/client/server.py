"""Cluster-side server for thin clients.

The reference's client server + proxier (util/client/server/{server,
proxier,dataservicer}.py) collapsed to one in-driver service: each client
connection gets a handler thread; requests reuse the same operations the
worker-request path serves, with object values inlined over the wire.

Every connection is a JOB (the GcsJobManager model, gcs_job_manager.h:28):
it registers in the GCS job table on connect, its created resources are
tracked, and on disconnect everything non-detached it created — actors,
placement groups, put objects — is reclaimed and the job row flips to
FINISHED. This is the multi-driver isolation story: two clients sharing a
cluster cannot leak resources into each other's lifetime.
"""

from __future__ import annotations

import threading
from collections import deque
from multiprocessing import AuthenticationError
from multiprocessing.connection import Listener
from typing import Any, Dict, Optional

from .. import _worker_context
from .. import serialization as ser
from ..ids import JobID


class _JobState:
    """Per-connection resource ledger, reclaimed on disconnect."""

    __slots__ = ("job_id", "actors", "pgs", "puts", "refs", "mu", "closed",
                 "proto_verified", "cpp_executors", "conn_alive")

    def __init__(self, job_id: bytes):
        self.job_id = job_id
        # flipped by _serve_conn's exit; a job with conn_alive False that
        # was never reclaimed (dropped disconnect notification — the
        # job.detach fault site) is an ORPHAN the watchdog sweeps
        self.conn_alive = True
        # set by the first successful versioned ping; every other verb is
        # refused until then, so a frontend cannot skip the handshake and
        # speak unversioned (the node-registration and transfer planes
        # already check every handshake — this closes the client plane)
        self.proto_verified = False
        self.actors: set = set()
        self.pgs: set = set()
        self.puts: set = set()
        # live ObjectRef objects for call_named returns: holding them
        # keeps the driver-side refcount pinning the return values until
        # the frontend disconnects (a non-Python frontend has no
        # distributed-refcount participation of its own)
        self.refs: list = []
        self.cpp_executors: set = set()  # executor ids this conn registered
        self.mu = threading.Lock()
        self.closed = False  # set by _reclaim_job; late tracks reclaim
        # inline instead of landing in an already-drained ledger


# Named-function registry for non-Python frontends (the C++ client,
# native/client/): compute stays registered cluster-side in Python, and a
# frontend drives it by name with bytes in / bytes out — the reference's
# cross-language boundary likewise moves opaque buffers between language
# frontends rather than pickled object graphs (its msgpack XLANG format).
_named_functions: Dict[str, dict] = {}


def register_named_function(name: str, fn, **default_opts) -> None:
    """Expose ``fn`` to non-Python frontends as ``name``. The function
    receives the frontend's raw ``bytes`` args and should return bytes
    (rich returns remain fetchable from Python clients). The remote
    wrapper is built once here and cached per options-set: rebuilding it
    per call would mint a fresh function id each time, growing every
    worker's function cache and re-shipping the pickled function per
    call."""
    _named_functions[name] = {"fn": fn, "defaults": default_opts,
                              "remote_cache": {}}


def unregister_named_function(name: str) -> None:
    _named_functions.pop(name, None)


# --------------------------------------------------------- C++ task plane
# Worker-side C++ story: an EXECUTOR process (native/client Executor,
# built on librmtclient) registers the names of functions it implements
# in C++, long-polls for tasks, and returns result bytes. Python (or any
# frontend) calls them via api.cpp_function(name).remote(...) and gets
# ordinary ObjectRefs — results deliver through runtime promises. The
# reference's counterpart is its C++ worker runtime executing
# RAY_REMOTE-registered functions (cpp/include/ray/api.h ray::Task;
# cross-language calls move opaque buffers the same way).


class _CppExecutor:
    """One connected C++ executor: registered function names, a pending
    queue, and the inflight table (for failing tasks on executor death)."""

    __slots__ = ("ex_id", "functions", "queue", "cond", "inflight",
                 "closed")

    def __init__(self, ex_id: bytes, functions):
        self.ex_id = ex_id
        self.functions = set(functions)
        self.queue: deque = deque()
        self.cond = threading.Condition()
        self.inflight: Dict[str, dict] = {}
        self.closed = False


_cpp_lock = threading.Lock()
_cpp_executors: Dict[bytes, _CppExecutor] = {}


def cpp_function_names() -> list:
    with _cpp_lock:
        names: set = set()
        for ex in _cpp_executors.values():
            if not ex.closed:
                names |= ex.functions
    return sorted(names)


def submit_cpp_task(name: str, args, num_returns: int = 1,
                    adopt: bool = False) -> list:
    """Dispatch a task to the least-loaded C++ executor serving ``name``;
    returns promise object ids (resolved when the executor replies).
    ``adopt=True`` pre-registers one local ref per return for an
    in-process caller's ObjectRef to adopt (the submit_task contract)."""
    rt = _worker_context.get_runtime()
    if rt is None:
        raise RuntimeError("no runtime: init() the cluster first")
    with _cpp_lock:
        candidates = [ex for ex in _cpp_executors.values()
                      if not ex.closed and name in ex.functions]
    if not candidates:
        raise RuntimeError(
            f"no C++ executor serves {name!r}: start one (it registers "
            "its functions over the client protocol) and retry")
    ex = min(candidates, key=lambda e: len(e.queue) + len(e.inflight))
    return_ids = [rt.create_promise() for _ in range(num_returns)]
    if adopt:
        for oid in return_ids:
            rt.add_local_ref(oid)
    task = {
        "task_id": return_ids[0].hex(),
        "name": name,
        "args": [bytes(a) for a in args],
        "return_ids": [o.hex() for o in return_ids],
    }
    with ex.cond:
        if not ex.closed:
            ex.queue.append(task)
            ex.cond.notify()
            return return_ids
    # raced its disconnect: unwind the promises we just minted (their
    # futures and adopt refs would otherwise leak) and fail fast
    if adopt:
        for oid in return_ids:
            rt.remove_local_ref(oid)  # zero -> deferred free purges it
    else:
        rt.free_objects(return_ids)
    raise RuntimeError(f"C++ executor for {name!r} disconnected")


def _cpp_next_task(ex: _CppExecutor, timeout: float) -> Optional[dict]:
    with ex.cond:
        if not ex.queue:
            ex.cond.wait(timeout)
        if not ex.queue:
            return None
        task = ex.queue.popleft()
        ex.inflight[task["task_id"]] = task
        return task


def _cpp_finish_task(rt, ex: _CppExecutor, task_id: str,
                     results, error: Optional[str]) -> None:
    with ex.cond:
        task = ex.inflight.pop(task_id, None)
    if task is None:
        return  # unknown/duplicate completion
    return_ids = [bytes.fromhex(h) for h in task["return_ids"]]
    if error is None and len(results or ()) != len(return_ids):
        error = (f"C++ executor returned {len(results or ())} results "
                 f"for {len(return_ids)} return ids")
    if error is not None:
        from ..exceptions import TaskError

        exc = TaskError(task["name"], RuntimeError(error))
        for oid in return_ids:
            rt.resolve_promise(oid, error=exc)
        return
    try:
        for oid, data in zip(return_ids, results):
            rt.resolve_promise(oid, value=bytes(data))
    except Exception as e:  # noqa: BLE001 — e.g. store full storing a
        # large result: the task is already out of inflight, so the
        # executor-death failsafe can never reach these promises — fail
        # them HERE or the caller's get blocks forever
        from ..exceptions import TaskError

        exc = TaskError(task["name"], e)
        for oid in return_ids:
            rt.resolve_promise(oid, error=exc)
        raise


def _cpp_close_executor(rt, ex_id: bytes) -> None:
    """Executor disconnected: fail everything it held, deregister it."""
    with _cpp_lock:
        ex = _cpp_executors.pop(ex_id, None)
    if ex is None:
        return
    from ..exceptions import TaskError

    with ex.cond:
        ex.closed = True
        orphans = list(ex.queue) + list(ex.inflight.values())
        ex.queue.clear()
        ex.inflight.clear()
    for task in orphans:
        exc = TaskError(task["name"],
                        RuntimeError("C++ executor disconnected"))
        for h in task["return_ids"]:
            rt.resolve_promise(bytes.fromhex(h), error=exc)


class ClusterServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 authkey: bytes = b"rmt-client"):
        rt = _worker_context.get_runtime()
        if rt is None:
            raise RuntimeError("start the cluster first (init()), then "
                               "serve it to clients")
        self._rt = rt
        self._authkey = authkey
        self._listener = Listener((host, port), family="AF_INET",
                                  authkey=authkey)
        self.address = self._listener.address  # (host, bound_port)
        self._stop = threading.Event()
        self._conns_lock = threading.Lock()
        self._conns: set = set()
        # live per-connection job states, keyed by job id: the watchdog
        # scans these for orphans (conn gone, reclaim never ran)
        self._job_states: Dict[bytes, _JobState] = {}  # guarded-by: _conns_lock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rmt-client-accept")
        self._accept_thread.start()
        self._watchdog_thread = None
        interval = float(getattr(rt.config, "job_watchdog_interval_s", 0))
        if interval > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, args=(interval,),
                daemon=True, name="rmt-job-watchdog")
            self._watchdog_thread.start()

    @property
    def port(self) -> int:
        return self.address[1]

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                if self._stop.is_set():
                    return
                continue
            except AuthenticationError:
                # a wrong client authkey raises INSIDE accept()'s
                # handshake; letting it unwind would kill this thread
                # and brick the server for every future client. Only
                # this exception — anything else should surface.
                continue
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="rmt-client-conn").start()

    def _serve_conn(self, conn) -> None:
        send_lock = threading.Lock()
        job = _JobState(JobID.from_random().binary())
        self._rt.register_client_job(job.job_id, {"type": "client"})
        with self._conns_lock:
            self._job_states[job.job_id] = job
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                threading.Thread(
                    target=self._handle, args=(conn, send_lock, msg, job),
                    daemon=True).start()
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            job.conn_alive = False
            # job.detach fault site: the driver's disconnect notification
            # can be lost (head-side thread dies before cleanup, network
            # partition at exit). drop/error = the notification vanishes —
            # reclaim is skipped HERE and the orphaned job must be found
            # and swept by the watchdog instead.
            from ..utils import faults

            act = faults.fire("job.detach")
            if act is not None:
                if act.mode == "stall":
                    act.sleep()
                elif act.mode in ("error", "drop"):
                    return  # orphan: the watchdog sweeps it
            with self._conns_lock:
                self._job_states.pop(job.job_id, None)
            self._reclaim_job(job, trigger="disconnect")

    def _watchdog_loop(self, interval: float) -> None:
        """Find jobs whose connection died but whose disconnect
        notification was dropped (job.detach), and sweep them — driver
        death must never leak a job, whatever happened to the notice."""
        while not self._stop.wait(interval):
            with self._conns_lock:
                orphans = [j for j in self._job_states.values()
                           if not j.conn_alive]
                for j in orphans:
                    self._job_states.pop(j.job_id, None)
            for j in orphans:
                try:
                    self._reclaim_job(j, trigger="watchdog")
                except Exception:  # noqa: BLE001 — the watchdog survives
                    pass

    def _reclaim_job(self, job: _JobState,
                     trigger: str = "disconnect") -> None:
        """Disconnect cleanup: kill the job's non-detached actors, remove
        its placement groups, free its put objects, then run the
        runtime's job-death sweep (ownership GC over everything the job
        id tagged: directory rows, refcounts, device pins, quota ledger)
        — the reference kills a driver's leases and actors on driver
        death the same way (gcs_job_manager.h:28 MarkJobFinished)."""
        rt = self._rt
        with job.mu:
            job.closed = True
            actors, pgs, puts = list(job.actors), list(job.pgs), \
                list(job.puts)
            executors = list(job.cpp_executors)
            job.actors.clear()
            job.pgs.clear()
            job.puts.clear()
            job.cpp_executors.clear()
            job.refs.clear()  # drop call_named returns: refcount frees them
        for ex_id in executors:
            # fail its queued/inflight tasks, then deregister it
            _cpp_close_executor(rt, ex_id)
        for aid in actors:
            self._reclaim_one("actors", aid)
        for pg_id in pgs:
            self._reclaim_one("pgs", pg_id)
        try:
            rt.free_objects(puts)
        except Exception:  # noqa: BLE001
            pass
        try:
            rt.sweep_job(job.job_id, trigger=trigger)
        except Exception:  # noqa: BLE001 — sweep retries ride heartbeats
            pass

    def _reclaim_one(self, kind: str, value) -> None:
        rt = self._rt
        try:
            if kind == "actors":
                info = rt.actors.get(value)
                if info is not None and not info.spec.detached:
                    rt.kill_actor(value, no_restart=True)
            elif kind == "pgs":
                from ..core.placement_group import _manager

                _manager(rt).remove(value)
            elif kind == "puts":
                rt.free_objects([value])
        except Exception:  # noqa: BLE001 — reclaim is best-effort
            pass

    def _handle(self, conn, send_lock, msg: Dict[str, Any],
                job: _JobState) -> None:
        reply: Dict[str, Any] = {"req_id": msg.get("req_id"), "error": None}
        rt = self._rt

        def track(kind: str, value) -> None:
            with job.mu:
                if not job.closed:
                    getattr(job, kind).add(value)
                    return
            # the client vanished mid-request and reclaim already ran:
            # this straggler resource would leak forever — reclaim it now
            self._reclaim_one(kind, value)

        try:
            mtype = msg["type"]
            if mtype != "ping" and not job.proto_verified:
                raise ValueError(
                    f"request {mtype!r} before the wire-protocol "
                    "handshake: clients must ping (with their proto "
                    "version) first")
            if mtype == "submit_task":
                # the server stamps ownership — a client cannot submit
                # under another job's id (quota/sweep isolation boundary)
                msg["payload"]["job_id"] = job.job_id
                reply["return_ids"] = rt.submit_task(
                    msg["payload"], adopt_returns=False)
            elif mtype == "submit_actor_task":
                msg["payload"]["job_id"] = job.job_id
                reply["return_ids"] = rt.submit_actor_task(
                    msg["payload"], adopt_returns=False)
            elif mtype == "create_actor":
                msg["payload"]["job_id"] = job.job_id
                reply["actor_id"] = rt.create_actor(msg["payload"])
                track("actors", reply["actor_id"])
            elif mtype == "get_objects":
                values = rt.get_objects(msg["oids"], msg.get("timeout"))
                reply["values"] = [ser.dumps(v) for v in values]
            elif mtype == "put":
                reply["object_id"] = rt.put_object(
                    ser.loads(msg["data"]), job_id=job.job_id)
                track("puts", reply["object_id"])
            elif mtype == "put_device":
                reply["object_id"] = rt.put_device_object(
                    ser.loads(msg["data"]), job_id=job.job_id)
                track("puts", reply["object_id"])
            elif mtype == "set_quota":
                # self-service quota (trusted clients); job_submission
                # installs submit-time quotas through the same runtime call
                rt.set_job_quota(job.job_id, msg.get("quota") or {})
            elif mtype == "job_usage":
                reply["usage"] = rt.job_usage(job.job_id)
                reply["job_id"] = job.job_id
            elif mtype == "wait":
                ready, not_ready = rt.wait(
                    msg["oids"], msg["num_returns"], msg["timeout"])
                reply["ready"], reply["not_ready"] = ready, not_ready
            elif mtype == "kill_actor":
                rt.kill_actor(msg["actor_id"], msg["no_restart"])
            elif mtype == "cancel_task":
                rt.cancel(msg["object_id"], msg["force"])
            elif mtype == "get_named_actor":
                rec = rt.gcs.get_named_actor(msg["name"])
                if rec is None:
                    raise ValueError(f"no actor named {msg['name']!r}")
                reply["actor_id"] = rec.actor_id.binary()
            elif mtype == "cluster_resources":
                reply["resources"] = rt.scheduler.cluster_resources()
            elif mtype == "request_resources":
                from ..autoscaler import request_resources

                request_resources(msg["bundles"])
            elif mtype == "state_query":
                from ..state import api as state_api

                reply["rows"] = state_api.answer(
                    msg["fn"], msg["args"], msg["kwargs"])
            elif mtype == "create_pg":
                from ..core.placement_group import _manager

                pg = _manager(rt).create(
                    msg["bundles"], msg["strategy"], msg.get("name", ""))
                reply["pg_id"] = pg.id
                track("pgs", pg.id)
            elif mtype == "pg_state":
                from ..core.placement_group import _manager

                reply["state"] = _manager(rt).state(msg["pg_id"])
            elif mtype == "wait_pg":
                from ..core.placement_group import _manager

                reply["created"] = _manager(rt).wait_created(
                    msg["pg_id"], msg["timeout"])
            elif mtype == "remove_pg":
                from ..core.placement_group import _manager

                _manager(rt).remove(msg["pg_id"])
            elif mtype == "list_named":
                reply["names"] = sorted(_named_functions)
            elif mtype == "call_named":
                from .. import api

                name = msg["name"]
                if name not in _named_functions:
                    raise KeyError(
                        f"no function registered as {name!r}; the cluster "
                        "side must call register_named_function first")
                entry = _named_functions[name]
                opts = {**entry["defaults"], **(msg.get("opts") or {})}
                # repr-keyed: option values may be dicts (resources={...})
                # which are unhashable; a repr collision is impossible for
                # these plain-literal option sets and a repr MISS is just
                # a cache rebuild
                key = repr(sorted(opts.items()))
                rf = entry["remote_cache"].get(key)
                if rf is None:
                    rf = api.remote(entry["fn"])
                    if opts:
                        rf = rf.options(**opts)
                    entry["remote_cache"][key] = rf
                refs = rf.remote(*[bytes(a) for a in msg.get("args", [])])
                refs = list(refs) if isinstance(refs, (list, tuple)) \
                    else [refs]
                with job.mu:
                    if not job.closed:
                        job.refs.extend(refs)
                reply["return_ids"] = [r.binary() for r in refs]
            elif mtype == "free_refs":
                # steady-state release for long-lived frontends: drop the
                # pinned call_named returns / put_bytes objects for these
                # ids so the store does not grow monotonically
                ids = {bytes(o) for o in msg["oids"]}
                with job.mu:
                    job.refs = [r for r in job.refs
                                if r.binary() not in ids]
                    puts = [o for o in ids if o in job.puts]
                    for o in puts:
                        job.puts.discard(o)
                if puts:
                    rt.free_objects(puts)
            elif mtype == "put_bytes":
                # raw-buffer puts for non-Python frontends: the value IS
                # the bytes (no pickle envelope crosses the wire)
                oid = rt.put_object(bytes(msg["data"]), job_id=job.job_id)
                track("puts", oid)
                reply["object_id"] = oid
            elif mtype == "get_bytes":
                values = rt.get_objects(msg["oids"], msg.get("timeout"))
                out = []
                for v in values:
                    if isinstance(v, (bytes, bytearray, memoryview)):
                        out.append(bytes(v))
                    else:
                        raise TypeError(
                            "get_bytes fetched a non-bytes value of type "
                            f"{type(v).__name__}; rich values need a "
                            "Python client")
                reply["values"] = out
            elif mtype == "register_cpp_executor":
                import os as _os

                ex_id = _os.urandom(16)
                ex = _CppExecutor(ex_id, [str(n) for n in msg["functions"]])
                with _cpp_lock:
                    _cpp_executors[ex_id] = ex
                with job.mu:
                    if not job.closed:
                        job.cpp_executors.add(ex_id)
                        ex_id_ok = True
                    else:
                        ex_id_ok = False
                if not ex_id_ok:  # conn died mid-register: deregister
                    _cpp_close_executor(rt, ex_id)
                    raise OSError("connection closed during registration")
                reply["executor_id"] = ex_id
            elif mtype == "next_cpp_task":
                with _cpp_lock:
                    ex = _cpp_executors.get(bytes(msg["executor_id"]))
                if ex is None:
                    raise KeyError("unknown executor id")
                timeout = min(float(msg.get("timeout", 10.0)), 60.0)
                reply["task"] = _cpp_next_task(ex, timeout)
            elif mtype == "cpp_task_done":
                with _cpp_lock:
                    ex = _cpp_executors.get(bytes(msg["executor_id"]))
                if ex is None:
                    raise KeyError("unknown executor id")
                _cpp_finish_task(rt, ex, str(msg["task_id"]),
                                 msg.get("results"), msg.get("err"))
            elif mtype == "call_cpp":
                oids = submit_cpp_task(
                    str(msg["name"]), msg.get("args", []),
                    int(msg.get("num_returns", 1)))
                for oid in oids:
                    # promise returns pin like puts: freed when this
                    # frontend disconnects (or frees them explicitly)
                    track("puts", oid)
                reply["return_ids"] = oids
            elif mtype == "list_cpp":
                reply["names"] = cpp_function_names()
            elif mtype == "ping":
                from ..config import WIRE_PROTOCOL_VERSION

                # strict: a MISSING proto is a pre-versioning peer, the
                # exact population the check exists to refuse
                proto = msg.get("proto")
                if proto != WIRE_PROTOCOL_VERSION:
                    raise ValueError(
                        "wire protocol mismatch: server speaks "
                        f"v{WIRE_PROTOCOL_VERSION}, client spoke "
                        f"v{proto} — upgrade the older side")
                job.proto_verified = True
                if msg.get("submission_id"):
                    rt.gcs.tag_job(job.job_id,
                                   submission_id=msg["submission_id"])
                reply["pong"] = True
            else:
                raise ValueError(f"unknown client request {mtype!r}")
        except Exception as e:  # noqa: BLE001 — surfaces client-side
            try:
                reply = {"req_id": msg.get("req_id"), "error": ser.dumps(e)}
            except Exception:
                reply = {"req_id": msg.get("req_id"),
                         "error": ser.dumps(RuntimeError(str(e)))}
        try:
            with send_lock:
                conn.send(reply)
        except (OSError, BrokenPipeError):
            pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # close live client connections so their pending requests fail
        # fast instead of hanging out the full request timeout
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
