"""Node agent: the per-host daemon of the multi-host plane.

The raylet-process analog (the reference runs one raylet per node,
src/ray/raylet/main.cc, joined to the head over gRPC — node registration
src/ray/gcs/gcs_server/gcs_node_manager.h:36, object transfer
src/ray/object_manager/object_manager.h:114). Run on each additional host:

    python -m ray_memory_management_tpu_torch.core.node_agent \
        --address HEAD_HOST:PORT --authkey HEX [--num-cpus N] [--num-gpus N]

Design: one authenticated TCP channel to the head carries EVERYTHING —
worker-connection tunneling, task dispatch, chunked object push/pull, and
liveness. The agent owns the host-local pieces a kernel boundary forces:
the shared-memory object store and the worker process pool. All ownership,
scheduling, and object-directory state stays at the head (centralized
ownership is this runtime's single-driver simplification; the tunnel keeps
every existing head-side code path — dispatch, nested worker requests,
actor lifecycles — working unchanged for remote workers).

Channel frames, head -> agent:
    start_worker {wid, dedicated, env}     spawn a worker process
    wsend       {wid, msg}                 deliver msg to worker wid
    lease_exec  {task_id, msg}             leaf task: agent picks the worker
    kill_worker {wid}                      terminate a worker process
    obj_push    {oid, size}                begin receiving an object
    obj_chunk   {oid, off, data}           one chunk of it
    obj_seal    {oid, req}                 seal; reply push_ack
    obj_pull    {oid, req}                 stream the object back
    obj_free    {oid}                      drop from the local store
    ping                                   liveness probe
    shutdown                               stop workers, close store, exit

agent -> head:
    register_node {...}                    hello (first frame)
    wmsg        {wid, msg}                 tunneled worker message
    wdeath      {wid}                      worker pipe EOF
    lease_spill {task_id}                  leaf pool saturated: head reroutes
    lease_dead  {task_id}                  leased task's worker died
    lease_cancel {task_id}                 job sweep: kill the pool worker
                                           running a dead job's leased task
    push_ack    {req, error}               object landed (or failed)
    pull_data   {req, off, data, eof, error}
    pong
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
from collections import deque
from typing import Any, Dict, Optional

from ..config import Config
from ..utils import faults
from ..utils.retry import RetryPolicy
from . import codec as wire_codec
from .object_store import NodeObjectStore


def _reap_stale_agent_stores() -> None:
    """A SIGKILLed agent cannot unlink its shm store; reclaim segments whose
    owning pid (embedded in the name) is gone. Runs at agent start so a
    crash-looping host converges instead of filling /dev/shm."""
    from ..native import reap_stale_stores

    reap_stale_stores("rmtA_")


class NodeAgent:
    def __init__(self, head_host: str, head_port: int, authkey: bytes,
                 num_cpus: int, num_gpus: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None):
        from multiprocessing.connection import Client, Listener

        from .node_manager import visible_devices

        # this host's GPUs as the AGENT's CUDA_VISIBLE_DEVICES names them,
        # read before dialing the head: an agent declaring more GPUs than
        # its variable names raises here and never joins. Reads the
        # variable only — the agent never imports torch nor initializes
        # CUDA (its zygote forks every worker, and a CUDA context in a
        # zygote breaks each fork).
        gpu_names = visible_devices(num_gpus)
        self.channel = Client((head_host, head_port), authkey=authkey)
        self._cluster_authkey = authkey
        self._channel_lock = threading.Lock()
        # this host's reachable IP on the route to the head, and the head's
        # IP as we see it — peers dial us at the former; obj_fetch frames
        # with host="" mean "fetch from the head" and resolve to the latter
        self._my_ip = "127.0.0.1"
        self._head_ip = head_host
        try:
            sock = socket.socket(fileno=os.dup(self.channel.fileno()))
            self._my_ip = sock.getsockname()[0]
            self._head_ip = sock.getpeername()[0]
            sock.close()
        except OSError:
            pass
        from ..config import WIRE_PROTOCOL_VERSION

        self._send({
            "type": "register_node",
            "proto": WIRE_PROTOCOL_VERSION,
            "num_cpus": num_cpus,
            "num_gpus": num_gpus,
            "visible_devices": gpu_names,
            "resources": resources or {},
            "labels": labels or {},
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
        })
        hello = self.channel.recv()
        if hello.get("type") != "registered":
            raise RuntimeError(f"head rejected registration: {hello}")
        self.node_id: bytes = hello["node_id"]
        self.config = Config(**hello["config"])
        self.inline_limit = self.config.max_direct_call_object_size
        # adopt the cluster's fault-injection plane (same seed/spec the
        # head exported) so a chaos run is replayable across every host
        faults.configure_from(self.config)
        # agent-process records (transfer serves, spill IO) join the log
        # plane stamped with this node's identity; they ship to the head
        # on the ping/pong piggyback like events and spans
        from ..utils import structlog as _structlog

        _structlog.configure(node_id=self.node_id.hex(), role="agent")
        _structlog.install_logging_capture()
        # continuous stack sampling of the agent process (transfer serves,
        # spill IO); samples ship on the ping/pong piggyback below
        from ..utils import profiler as _profiler

        _profiler.configure(node_id=self.node_id.hex(), role="agent")
        _profiler.start_sampler()

        _reap_stale_agent_stores()
        self.store_name = f"/rmtA_{os.getpid()}_{os.urandom(4).hex()}"
        self.store = NodeObjectStore(self.store_name, self.config,
                                     create=True)
        self._push_bufs: Dict[bytes, memoryview] = {}

        # peer-to-peer object plane: serve this store to other nodes and
        # pull directly from theirs — payload bytes never transit the head
        # (transfer.py; the reference's object-manager peer pulls,
        # object_manager.h:114)
        from concurrent.futures import ThreadPoolExecutor

        from .transfer import (
            ConnectionPool, TransferServer, fetch_object as _fetch_object,
        )

        self._fetch_object = _fetch_object
        self._shm_peers: Dict[str, Any] = {}  # same-host peer store maps
        self.transfer_server = TransferServer(
            self.store, authkey, self.config.object_manager_chunk_size,
            max_conns=self.config.transfer_max_conns,
            idle_timeout=self.config.transfer_idle_timeout_s,
            compress_min_bytes=self.config.transfer_compress_min_bytes)
        # authenticated peer connections reused across pulls
        self._xfer_conn_pool = ConnectionPool(
            max_idle_per_peer=self.config.transfer_pool_size)
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="agent-fetch")
        self._send({
            "type": "transfer_ready",
            "host": self._my_ip,
            "port": self.transfer_server.port,
            # same-host peers (other agents, the head) map this shm store
            # directly instead of pulling over TCP — the named segment IS
            # the shared-memory object plane on one host
            "store_name": self.store_name,
        })

        # permission-trusted worker socket, like the head's (0600 file;
        # no HMAC challenge — two round trips saved per worker connect)
        self._socket_path = f"/tmp/rmtA_{os.getpid()}_{os.urandom(4).hex()}.sock"
        self._listener = Listener(self._socket_path, family="AF_UNIX")
        os.chmod(self._socket_path, 0o600)
        self._workers: Dict[bytes, Any] = {}        # wid -> conn  # guarded-by: _lock
        self._worker_procs: Dict[bytes, Any] = {}   # wid -> Popen  # guarded-by: _lock
        self._pending_bootstrap: Dict[bytes, dict] = {}  # cold-spawn tokens  # guarded-by: _lock
        self._worker_send_locks: Dict[bytes, threading.Lock] = {}  # guarded-by: _lock
        # agent-local leaf scheduling (lease_exec): the head grants this
        # node lease credits in bulk; each lease_exec frame carries a
        # fully-built exec msg and THIS process picks the least-loaded
        # connected pool worker — the decentralized-control-plane half of
        # the two-level lease protocol (raylet_client.h:398). Dedicated
        # (actor / conda) workers never take leased tasks.
        self._lease_dedicated: set = set()          # wid  # guarded-by: _lock
        self._lease_inflight: Dict[bytes, int] = {}  # wid -> depth  # guarded-by: _lock
        self._lease_task_wid: Dict[bytes, bytes] = {}  # task -> wid  # guarded-by: _lock
        self._lease_known: Dict[bytes, set] = {}    # wid -> fn ids  # guarded-by: _lock
        # fn blobs ship once per NODE (head-side lease_known_fns); the
        # agent re-attaches from this cache per WORKER as needed
        self._lease_fn_blobs: Dict[bytes, bytes] = {}  # guarded-by: _lock
        # delta-compressed heartbeats: each pong carries a sequence
        # number and only the status keys (and held-row deltas, for
        # agents that own rows — see _dir_report) that changed since the
        # last pong we SENT; the head applies them in seq order and asks
        # for full state via the ping's resync flag when it detects a
        # gap. Committed only after a successful send so the delta base
        # is exactly the stream the head holds. Recv-loop-private: the
        # ping handler is the only reader and writer, so no lock guards
        # these.
        self._hb_seq = 0
        self._hb_stat_sent: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # The object plane runs on its OWN thread: a push/ensure into a
        # full store waits (bounded) for capacity, and that wait must never
        # starve liveness pings, task dispatch (wsend), or the obj_free
        # frames that drain capacity. FIFO per-frame ordering within the
        # plane (push -> chunk -> seal) is preserved by the single queue.
        self._obj_q: deque = deque()  # guarded-by: _obj_cond
        self._obj_q_bytes = 0  # payload bytes admitted (accounted at push)  # guarded-by: _obj_cond
        # cap on queued payload so a blocked store never buffers an entire
        # multi-GB transfer backlog in agent RAM. The recv loop must NEVER
        # park on this: while parked it stops reading ping and obj_free —
        # obj_free is exactly what frees store capacity so the plane can
        # drain, and a filled TCP buffer blocks head-side channel_send,
        # stalling the head's serial heartbeat loop for EVERY node. Instead
        # a push whose declared size would exceed the budget is nacked
        # (push_ack error) and its chunks discarded as they arrive; the
        # head-side push_object returns False and the caller retries or
        # routes elsewhere (the reference's PullManager bounds in-flight
        # bytes by admission the same way, pull_manager.h:47).
        self._obj_q_limit = max(64 << 20,
                                4 * self.config.object_manager_chunk_size)
        self._push_acct: Dict[bytes, int] = {}  # oid -> unaccounted bytes  # guarded-by: _obj_cond
        # push-lifecycle markers are mutated from BOTH the recv thread
        # (admission/nack) and the object-plane thread (full store,
        # seal): their mutex is _free_mu, which already serializes the
        # free-vs-push decisions they feed. Lock order: _obj_cond may
        # nest _free_mu inside it, never the reverse.
        self._dropped_pushes: Dict[bytes, bool] = {}  # oid -> nack pending  # guarded-by: _free_mu
        # pushes whose create hit a transiently-full store: _obj_seal acks
        # these "retryable" so the head backs off and re-pushes while its
        # source read ref keeps the object live (admission control, never
        # object loss — pull_manager.h:47 / create_request_queue.h:32)
        self._full_pushes: Dict[bytes, bool] = {}  # guarded-by: _free_mu
        self._obj_cond = threading.Condition()
        # frees that arrived while a push of the same object was still
        # queued/mid-flight: consumed by _obj_push/_obj_seal so the freed
        # object is not resurrected by the late-landing push. _free_mu makes
        # the free's contains-or-mark and the seal's mark-or-seal decisions
        # atomic against each other (recv thread vs object-plane thread);
        # dict (insertion-ordered) so overflow evicts the STALEST marker
        self._freed_while_pushing: Dict[bytes, bool] = {}  # guarded-by: _free_mu
        self._free_mu = threading.Lock()
        # warm the fork server while the node is idle: the first actor
        # burst should never pay the zygote's preload
        if self.config.worker_fork_server:
            from . import zygote as _zygote

            threading.Thread(target=_zygote.get_global, daemon=True,
                             name="agent-zygote-warm").start()
        threading.Thread(target=self._obj_plane_loop, daemon=True,
                         name="agent-objplane").start()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="agent-accept").start()
        threading.Thread(target=self._reap_loop, daemon=True,
                         name="agent-reaper").start()

    # ---------------------------------------------------------------- channel
    def _send(self, msg: dict) -> None:
        with self._channel_lock:
            self.channel.send(msg)

    # ---------------------------------------------------------------- workers
    def _accept_loop(self) -> None:
        """Local workers dial in exactly as they would dial a head-local
        runtime (worker_main.py is unchanged); their frames are tunneled."""
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
            # coalesces ready + actor_ready into one batch frame: forward
            # the trailing replies as separate wmsg frames after the ready
            trailing = []
            if msg.get("type") == "batch" and msg["msgs"]:
                trailing = msg["msgs"][1:]
                msg = msg["msgs"][0]
            if msg.get("type") != "ready":
                conn.close()
                continue
            wid = msg["worker_id"]
            with self._lock:
                self._workers[wid] = conn
                self._worker_send_locks[wid] = threading.Lock()
                boot = self._pending_bootstrap.pop(wid, None)
            if boot is not None:
                # cold-spawned worker with a held startup token: deliver
                # it now, before the head even learns the worker is up
                try:
                    conn.send(boot)
                except (OSError, BrokenPipeError):
                    pass  # reader thread will report wdeath
            self._send({"type": "wmsg", "wid": wid, "msg": msg})
            for m in trailing:
                self._send({"type": "wmsg", "wid": wid, "msg": m})
            threading.Thread(target=self._worker_reader, args=(wid, conn),
                             daemon=True, name="agent-wreader").start()

    def _worker_reader(self, wid: bytes, conn) -> None:
        while not self._stop.is_set():
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            self._lease_note_reply(wid, msg)
            try:
                self._send({"type": "wmsg", "wid": wid, "msg": msg})
            except (OSError, BrokenPipeError):
                return  # channel gone: the process is shutting down
        with self._lock:
            self._workers.pop(wid, None)
            self._worker_send_locks.pop(wid, None)
            # leased tasks bound to this worker die with it: the head
            # retries them (lease_dead), exactly like its own
            # worker-death inflight sweep for queue-dispatched tasks
            dead_leases = [tid for tid, w in self._lease_task_wid.items()
                           if w == wid]
            for tid in dead_leases:
                self._lease_task_wid.pop(tid, None)
            self._lease_inflight.pop(wid, None)
            self._lease_known.pop(wid, None)
            self._lease_dedicated.discard(wid)
        for tid in dead_leases:
            try:
                self._send({"type": "lease_dead", "task_id": tid})
            except (OSError, BrokenPipeError):
                break
        try:
            self._send({"type": "wdeath", "wid": wid})
        except (OSError, BrokenPipeError):
            pass

    def _start_worker(self, msg: dict) -> None:
        from .node_manager import build_worker_env, spawn_worker_process

        wid_hex = msg["wid_hex"]
        wid = bytes.fromhex(wid_hex)
        if msg.get("dedicated") or msg.get("conda") is not None:
            # actor / conda workers never take leased leaf tasks
            with self._lock:
                self._lease_dedicated.add(wid)
        env = build_worker_env(wid_hex, self.node_id.hex(), self.store_name,
                               self._socket_path, "",
                               self.config)
        env.update(msg.get("env") or {})
        bootstrap = msg.get("bootstrap")
        conda_spec = msg.get("conda")

        def queue_bootstrap():
            # cold spawn: hold the token and deliver it when the worker
            # dials in (the _accept_loop checks this map). Runs before
            # the process exists, so the dial-in cannot have happened.
            with self._lock:
                self._pending_bootstrap[wid] = bootstrap

        def spawn(python_exe=None):
            proc = spawn_worker_process(env, self.config, bootstrap,
                                        queue_bootstrap,
                                        python_exe=python_exe)
            with self._lock:
                self._worker_procs[wid] = proc

        if conda_spec is None:
            spawn()
            return

        def resolve_and_spawn():
            # conda resolution/creation can take minutes: never on the
            # recv loop. On failure the head must LEARN the worker died —
            # no process ever exists, so the reap loop can't see it: send
            # the wdeath explicitly (the event says why).
            try:
                from .. import runtime_env as re_mod

                spawn(python_exe=re_mod.conda_python(conda_spec))
            except Exception as e:  # noqa: BLE001
                from ..utils import events

                events.emit(
                    "CONDA_ENV_FAILED",
                    f"conda env {conda_spec!r} unavailable on "
                    f"{self.node_id.hex()[:8]}: {e!r}",
                    severity=events.ERROR, source="node_agent")
                try:
                    self._send({"type": "wdeath", "wid": wid})
                except (OSError, BrokenPipeError):
                    pass

        threading.Thread(target=resolve_and_spawn, daemon=True,
                         name=f"conda-spawn-{wid_hex[:6]}").start()

    # ------------------------------------------------------------ leaf leases
    def _lease_exec(self, msg: dict) -> None:
        """Place one leased leaf task on a local pool worker — the
        agent-local scheduling decision. Saturation (every eligible
        worker at the pipelining depth) spills the task back to the head
        router (lease_spill), which reroutes it through the full
        scheduling path; a vanished worker is reported as lease_dead so
        the head can retry. Runs on the channel recv loop and never
        parks: the decision is a dict scan under _lock."""
        task_id = msg["task_id"]
        inner = msg["msg"]
        fn_id = inner.get("fn_id")
        blob = inner.pop("fn_blob", None)
        depth = max(1, self.config.max_tasks_in_flight_per_worker)
        attach = False
        with self._lock:
            if blob is not None and fn_id is not None:
                self._lease_fn_blobs[fn_id] = blob
            best = None
            best_n = depth
            for wid in self._workers:
                if wid in self._lease_dedicated:
                    continue
                n = self._lease_inflight.get(wid, 0)
                if n < best_n:
                    best, best_n = wid, n
                    if n == 0:
                        break
            if best is not None:
                conn = self._workers.get(best)
                lock = self._worker_send_locks.get(best)
                known = self._lease_known.setdefault(best, set())
                if fn_id is not None and fn_id not in known:
                    blob = self._lease_fn_blobs.get(fn_id)
                    if blob is None:
                        best = None  # blob never arrived: cannot run here
                    else:
                        known.add(fn_id)
                        attach = True
                if best is not None:
                    self._lease_inflight[best] = best_n + 1
                    self._lease_task_wid[task_id] = best
        if best is None:
            try:
                self._send({"type": "lease_spill", "task_id": task_id})
            except (OSError, BrokenPipeError):
                pass
            return
        if attach:
            inner = dict(inner)
            inner["fn_blob"] = blob
        try:
            with lock:
                conn.send(inner)
        except (OSError, BrokenPipeError, ValueError):
            # the pick raced the worker's death: unbind and tell the head
            # (its retry path reruns the task elsewhere). The reader's EOF
            # sweep may race this — finish_leaf at the head is idempotent.
            with self._lock:
                self._lease_task_wid.pop(task_id, None)
                n = self._lease_inflight.get(best, 0)
                if n > 0:
                    self._lease_inflight[best] = n - 1
            try:
                self._send({"type": "lease_dead", "task_id": task_id})
            except (OSError, BrokenPipeError):
                pass

    def _lease_note_reply(self, wid: bytes, msg: dict) -> None:
        """Settle lease depth accounting from a tunneled worker reply
        (done frames, possibly inside a batch)."""
        t = msg.get("type")
        if t == "batch":
            for m in msg["msgs"]:
                self._lease_note_reply(wid, m)
            return
        if t == "done":
            with self._lock:
                if self._lease_task_wid.pop(msg.get("task_id"),
                                            None) is not None:
                    n = self._lease_inflight.get(wid, 0)
                    if n > 0:
                        self._lease_inflight[wid] = n - 1

    def _reap_loop(self) -> None:
        """Detect workers that die WITHOUT ever dialing in (import error,
        OOM at startup): no pipe means no EOF, so without this the head
        would count them as starting forever. Also reaps the zombies."""
        import time as _time

        while not self._stop.is_set():
            _time.sleep(1.0)
            try:
                self.store.sweep_pins()  # expire obj_ensure residency pins
            except Exception:
                pass
            try:
                # abort creates left unsealed past the deadline (a peer
                # that died mid-push leaks the reservation otherwise)
                self.store.sweep_unsealed()
            except Exception:
                pass
            with self._lock:
                dead = [(wid, p) for wid, p in self._worker_procs.items()
                        if p.poll() is not None]
                for wid, _ in dead:
                    self._worker_procs.pop(wid, None)
                    # a worker that died before dialing in never collected
                    # its startup token; drop it or it leaks (cls blobs
                    # are multi-KB and actor churn is unbounded)
                    self._pending_bootstrap.pop(wid, None)
                connected = set(self._workers)
            for wid, _ in dead:
                if wid not in connected:
                    try:
                        self._send({"type": "wdeath", "wid": wid})
                    except (OSError, BrokenPipeError):
                        return

    # ----------------------------------------------------------- object plane
    def _obj_push(self, msg: dict) -> None:
        oid = msg["oid"]
        if oid in self._freed_while_pushing:
            return  # freed before this push landed: don't resurrect it
        if oid in self._push_bufs:
            return  # an identical push is mid-flight; let it finish
        from ..exceptions import ObjectStoreFullError

        try:
            # SHORT create budget: a pressured push nacks retryable fast
            # (the head backs off and retries, holding its read ref)
            # instead of parking the shared object-plane thread for the
            # whole full-store wait
            self._push_bufs[oid] = self.store.create(oid, msg["size"],
                                                     timeout_s=1.0)
        except ValueError:
            pass  # already sealed in the store: ignore this push's chunks
        except ObjectStoreFullError:
            # nack NOW as well (the push frame carries req): the head's
            # chunk loop aborts on the early ack instead of streaming the
            # whole payload per retry; mark the push dropped so the recv
            # thread discards the chunks already in flight. The seal may
            # already be queued on this plane — _full_pushes answers it
            # retryable too (the head ignores the duplicate ack: its
            # request state was popped by the first one).
            with self._free_mu:
                while len(self._full_pushes) > 4096:
                    self._full_pushes.pop(next(iter(self._full_pushes)))
                self._full_pushes[oid] = True  # _obj_seal acks retryable
                self._dropped_pushes[oid] = True
            try:
                self._send({
                    "type": "push_ack", "req": msg["req"],
                    "error": "receiver store full (retryable)"})
            except (OSError, BrokenPipeError):
                pass
        except Exception:  # noqa: BLE001 — store full even after waiting:
            pass  # drop the chunks; _obj_seal acks the push with an error

    def _obj_chunk(self, msg: dict) -> None:
        buf = self._push_bufs.get(msg["oid"])
        if buf is not None:
            off = msg["off"]
            data = msg["data"]
            buf[off:off + len(data)] = data

    def _obj_seal(self, msg: dict) -> None:
        oid = msg["oid"]
        err = None
        # the mark-or-seal decision is atomic against the recv thread's
        # contains-or-mark in obj_free: without the mutex a free landing
        # between our marker check and store.seal() would resurrect the
        # freed object with no future delete ever coming. The freed path
        # also runs UNDER the mutex and deletes the unsealed create
        # directly (delete() aborts unsealed entries, shmstore.cpp:379):
        # seal-then-delete would briefly publish the freed object as live,
        # and a concurrent reader ref in that window — or a failed delete —
        # would resurrect it with no future delete ever coming.
        with self._free_mu:
            freed = self._freed_while_pushing.pop(oid, None) is not None
            if freed:
                self._full_pushes.pop(oid, None)
                buf = self._push_bufs.pop(oid, None)
                if buf is not None:
                    del buf
                    try:
                        self.store.delete(oid)
                    except Exception:
                        pass
                err = "object freed during push"
            elif oid in self._push_bufs:
                del self._push_bufs[oid]
                self._full_pushes.pop(oid, None)
                try:
                    self.store.seal(oid)
                except Exception as e:  # noqa: BLE001
                    err = repr(e)
            elif self._full_pushes.pop(oid, None) is not None \
                    and not self.store.contains(oid):
                # transiently-full store refused the create: tell the head
                # to back off and retry (its read ref keeps the source copy
                # live) — pressure is slowness, never loss
                err = "receiver store full (retryable)"
            elif not self.store.contains(oid):
                # this push's create was refused and nobody else sealed it:
                # acking success would poison the head's object directory
                err = "push raced an incomplete object"
        self._send({"type": "push_ack", "req": msg["req"], "error": err})

    def _obj_pull(self, msg: dict) -> None:
        oid, req = msg["oid"], msg["req"]
        try:
            # read() serves spilled objects straight from the spill file —
            # a pull must never force an allocation in a full store
            view = self.store.read(oid)
        except Exception as e:  # noqa: BLE001
            view = None
            err = repr(e)
        else:
            err = "object not in store"
        if view is None:
            self._send({"type": "pull_data", "req": req, "off": 0,
                        "data": b"", "eof": True, "error": err})
            return
        try:
            chunk = self.config.object_manager_chunk_size
            n = len(view) if isinstance(view, bytes) else view.nbytes
            if n == 0:
                self._send({"type": "pull_data", "req": req, "off": 0,
                            "data": b"", "eof": True, "error": None})
                return
            for off in range(0, n, chunk):
                end = min(off + chunk, n)
                self._send({
                    "type": "pull_data", "req": req, "off": off,
                    "data": bytes(view[off:end]), "eof": end >= n,
                    "error": None,
                })
        finally:
            if isinstance(view, memoryview):
                self.store.release(oid)

    def _obj_fetch(self, msg: dict) -> None:
        """Pull an object DIRECTLY from a peer's transfer server into this
        store (receiver-driven transfer; host "" = the head). When the
        head marked the source as same-host ("src_store"), map the
        source's shm segment and memcpy — no TCP, no chunk protocol —
        falling back to the server pull if the object isn't shm-resident
        there (spilled) or the mapping fails. Runs on the fetch pool so a
        slow source never blocks the object plane or the channel loop."""
        host = msg["host"] or self._head_ip
        port, oid, req = msg["port"], msg["oid"], msg["req"]
        src_store = msg.get("src_store")
        trace = msg.get("trace")
        # alternate live holders (head-resolved) for mid-pull failover;
        # host "" means the head itself, as with the primary source
        alts = [(h or self._head_ip, p) for h, p in msg.get("alts") or ()]

        def run():
            err = None
            if src_store:
                err = self._fetch_same_host(src_store, oid)
            if src_store is None or err is not None:
                try:
                    err = self._fetch_object(
                        host, port, self._cluster_authkey, oid, self.store,
                        self.config.object_manager_chunk_size,
                        pool=self._xfer_conn_pool,
                        stripe_threshold=self.config.transfer_stripe_threshold,
                        stripe_count=self.config.transfer_stripe_count,
                        alt_sources=(lambda: alts) if alts else None,
                        retry=RetryPolicy(
                            max_attempts=self.config.transfer_retry_attempts,
                            base_backoff_s=self.config.transfer_retry_backoff_s,
                            plane="transfer"),
                        verify_checksum=self.config.transfer_verify_checksum,
                        stripe_deadline=self.config.transfer_stripe_deadline_s,
                        trace=trace,
                        codecs=wire_codec.client_codecs(self.config))
                except Exception as e:  # noqa: BLE001
                    err = repr(e)
            try:
                self._send({"type": "fetch_ack", "req": req, "error": err})
            except (OSError, BrokenPipeError):
                pass

        self._fetch_pool.submit(run)

    def _fetch_same_host(self, store_name: str, oid: bytes) -> Optional[str]:
        """shm-to-shm copy from a same-host peer's segment. Returns None
        on success, else a reason string (caller falls back to the TCP
        pull — e.g. the object is spilled inside the source process,
        invisible through its segment)."""
        try:
            cli = self._shm_peers.get(store_name)
            if cli is None:
                from .object_store import StoreClient

                cli = StoreClient(store_name)
                self._shm_peers[store_name] = cli
            view = cli.get(oid)  # shared-segment reader ref (plasma-style)
            if view is None:
                return "not shm-resident at source"
            from .transfer import create_or_wait

            try:
                buf, race_err = create_or_wait(self.store, oid, view.nbytes)
                if buf is None:
                    return race_err  # None: racing copy became readable
                try:
                    try:
                        buf[:] = view
                    finally:
                        del buf  # drop the mapping before seal/abort
                    self.store.seal(oid)
                except BaseException:
                    # abort the unsealed create so retries can re-allocate
                    try:
                        self.store.delete(oid)
                    except Exception:  # noqa: BLE001
                        pass
                    raise
                return None
            finally:
                cli.release(oid)
        except Exception as e:  # noqa: BLE001
            return repr(e)

    def _obj_spill(self, msg: dict) -> None:
        """Head-requested spill: a worker's direct shm put needs room (the
        raylet-spills-for-plasma-creates path; policy lives in
        NodeObjectStore.make_room, shared with the head's local stores)."""
        try:
            self.store.make_room(int(msg["bytes"]))
            err = None
        except Exception as e:  # noqa: BLE001
            err = repr(e)
        self._send({"type": "spill_ack", "req": msg["req"], "error": err})

    def _obj_ensure(self, msg: dict) -> None:
        """Restore the object(s) into shm (if spilled) and pin briefly so
        the requesting worker's direct shm read cannot race a re-spill
        (head-side _serve_get answers "local" only after this ack). Accepts
        a batch ("oids") — one frame + one ack for a whole get request."""
        oids = msg.get("oids")
        if oids is None:
            oids = [msg["oid"]]
        failed = []
        for oid in oids:
            try:
                if not self.store.ensure_resident(oid):
                    failed.append(oid)
            except Exception:  # noqa: BLE001 — full store etc: per-oid fail
                failed.append(oid)
        self._send({"type": "ensure_ack", "req": msg["req"], "error": None,
                    "failed": failed})

    def _obj_plane_loop(self) -> None:
        handlers = {
            "obj_push": self._obj_push,
            "obj_chunk": self._obj_chunk,
            "obj_seal": self._obj_seal,
            "obj_pull": self._obj_pull,
            "obj_ensure": self._obj_ensure,
            "obj_spill": self._obj_spill,
        }
        while not self._stop.is_set():
            with self._obj_cond:
                while not self._obj_q:
                    self._obj_cond.wait(timeout=1.0)
                    if self._stop.is_set():
                        return
                msg = self._obj_q.popleft()
                if msg["type"] == "obj_chunk":
                    rem = self._push_acct.get(msg["oid"])
                    if rem is not None:
                        dec = min(len(msg["data"]), rem)
                        self._push_acct[msg["oid"]] = rem - dec
                        self._obj_q_bytes -= dec
                elif msg["type"] == "obj_seal":
                    # release whatever the chunks didn't cover (a push that
                    # errored mid-stream must not leak admitted bytes)
                    self._obj_q_bytes -= self._push_acct.pop(msg["oid"], 0)
            try:
                handlers[msg["type"]](msg)
            except Exception:  # noqa: BLE001 — one bad frame must not
                pass  # take down the whole object plane

    # ------------------------------------------------------------------- main
    def run(self) -> None:
        try:
            self._run_loop()
        finally:
            self._shutdown()

    def _hb_status(self) -> Dict[str, Any]:
        """O(1) agent status snapshot for the pong delta stream (store
        bytes, lease depth, worker count). The head mirrors the merged
        dict per node, so steady-state pongs usually carry NO status at
        all — only the keys that moved since the last acked pong."""
        used = cap = 0
        try:
            u = self.store.usage()
            used, cap = int(u[0]), int(u[1])
        except Exception:  # noqa: BLE001 — status must never kill a pong
            pass
        with self._lock:
            depth = sum(self._lease_inflight.values())
            workers = len(self._workers)
        return {"store_used": used, "store_cap": cap,
                "spilled": self.store.spilled_count(),
                "lease_depth": depth, "workers": workers}

    def _dir_report(self, full: bool):
        """Held-row delta report ``(dadd, ddel)`` for agents that OWN
        directory rows, or None. The real agent returns None: its rows
        are maintained authoritatively by the head's done/free paths,
        so re-asserting them every pong would burn exactly the ingress
        the delta plane exists to avoid. The simulated agent plane
        (utils/sim_agent.py) overrides this to drive pod-scale row
        churn through the same wire frames."""
        return None

    def _run_loop(self) -> None:
        while True:
            try:
                msg = self.channel.recv()
            except (EOFError, OSError):
                return  # head gone: shut down this node
            t = msg["type"]
            if t == "wsend":
                wid = msg["wid"]
                with self._lock:
                    conn = self._workers.get(wid)
                    lock = self._worker_send_locks.get(wid)
                    if msg["msg"].get("type") == "create_actor":
                        # a pooled worker converted into an actor worker
                        # (dedicate_to_actor): stop leasing onto it
                        self._lease_dedicated.add(wid)
                if conn is not None and lock is not None:
                    try:
                        with lock:
                            conn.send(msg["msg"])
                    except (OSError, BrokenPipeError, ValueError):
                        pass  # reader thread will report wdeath
            elif t == "lease_exec":
                self._lease_exec(msg)
            elif t == "lease_batch":
                # per-node coalesced leaf grants (head-side flush_leases):
                # one frame carries a scheduling pass's worth of leases;
                # each entry takes the same worker-pick path as a lone
                # lease_exec, spilling/failing individually
                for sub in msg["tasks"]:
                    self._lease_exec(sub)
            elif t == "start_worker":
                self._start_worker(msg)
            elif t == "kill_worker":
                proc = self._worker_procs.get(msg["wid"])
                if proc is not None:
                    try:
                        proc.terminate()
                    except Exception:
                        pass
            elif t == "lease_cancel":
                # job sweep: a leased task of a dead job may be RUNNING
                # on a pool worker only this agent can name — kill that
                # worker; wdeath/lease_dead settle the accounting and
                # the head fails the (cancelled) retry
                with self._lock:
                    wid = self._lease_task_wid.get(msg["task_id"])
                    proc = (self._worker_procs.get(wid)
                            if wid is not None else None)
                if proc is not None:
                    try:
                        proc.terminate()
                    except Exception:
                        pass
            elif t == "obj_fetch":
                self._obj_fetch(msg)  # non-blocking: pool submit
            elif t == "obj_push":
                # admission control, never parking: admit the push if its
                # declared size fits the payload budget, else nack it and
                # discard its chunks as they stream past (the recv loop
                # must keep reading ping/obj_free — see _obj_q_limit)
                oid = msg["oid"]
                with self._obj_cond:
                    dup = oid in self._push_acct
                    # an idle plane always admits, whatever the size —
                    # otherwise a single object larger than the budget
                    # could never transfer at all; with bytes already
                    # queued the backlog is bounded at limit + one object
                    over = (not dup and self._obj_q_bytes > 0
                            and self._obj_q_bytes + msg["size"]
                            > self._obj_q_limit)
                    if not over:
                        # a stale dropped-marker from an earlier nacked
                        # attempt must not swallow this admitted push's
                        # chunks (and leak its admitted bytes forever)
                        with self._free_mu:
                            self._dropped_pushes.pop(oid, None)
                        if not dup:
                            self._push_acct[oid] = msg["size"]
                            self._obj_q_bytes += msg["size"]
                        self._obj_q.append(msg)
                        self._obj_cond.notify()
                if over:
                    with self._free_mu:
                        while len(self._dropped_pushes) > 4096:
                            self._dropped_pushes.pop(
                                next(iter(self._dropped_pushes)))
                        self._dropped_pushes[oid] = True
                    # nack NOW (the push frame carries req): the head's
                    # chunk loop aborts on the early ack instead of
                    # streaming the whole payload just to be discarded
                    try:
                        self._send({
                            "type": "push_ack", "req": msg["req"],
                            "error": "push dropped: object plane over "
                                     "budget (retryable)"})
                    except (OSError, BrokenPipeError):
                        pass
            elif t == "obj_chunk" and msg["oid"] in self._dropped_pushes:
                pass  # chunk of a nacked push: discard without queueing
            elif t == "obj_seal" and msg["oid"] in self._dropped_pushes:
                # the nack already went out with the obj_push's req; the
                # seal of a dropped push just clears the marker — and
                # releases the payload-budget bytes if this push was
                # ADMITTED before being dropped (the full-store early
                # nack drops mid-stream: without this the admitted bytes
                # leak and the plane budget shrinks permanently)
                with self._free_mu:
                    self._dropped_pushes.pop(msg["oid"], None)
                with self._obj_cond:
                    self._obj_q_bytes -= self._push_acct.pop(msg["oid"], 0)
            elif t in ("obj_chunk", "obj_seal", "obj_pull",
                       "obj_ensure", "obj_spill"):
                with self._obj_cond:
                    self._obj_q.append(msg)
                    self._obj_cond.notify()
            elif t == "obj_free":
                oid = msg["oid"]
                try:
                    with self._free_mu:
                        if self.store.contains(oid):
                            self.store.delete(oid)
                        else:
                            # a push of this object may still be queued on
                            # the object plane; mark it so the late-landing
                            # push does not resurrect a freed object
                            while len(self._freed_while_pushing) > 4096:
                                self._freed_while_pushing.pop(
                                    next(iter(self._freed_while_pushing)))
                            self._freed_while_pushing[oid] = True
                except Exception:
                    pass
            elif t == "ping":
                from ..utils import events as _events
                from ..utils import profiler as _profiler
                from ..utils import structlog as _structlog
                from ..utils import timeline as _timeline

                evs = _events.drain_events(node_id=self.node_id.hex())
                # timeline spans recorded in THIS process (transfer
                # serves, spill IO) ship on the keepalive reply — the
                # agent analog of the worker's profile piggyback; without
                # it agent-side spans never reach the head's dump
                prof = _timeline.drain_events_if_due(min_batch=1)
                lgs = _structlog.drain_records()
                smp = _profiler.drain_samples()
                pong: Dict[str, Any] = {"type": "pong"}
                if evs:
                    pong["events"] = evs
                if prof:
                    pong["profile"] = prof
                if lgs:
                    pong["logs"] = lgs
                if smp:
                    pong["samples"] = smp
                # delta-compressed control state: ship only the status
                # keys that changed since the last pong we sent. The
                # pings are pipelined — the head's ack naturally lags a
                # round trip behind our committed seq, so a stale ack is
                # NOT a desync signal (treating it as one degenerates to
                # full pongs under load). The head detects real gaps
                # itself (seq != hb_seq+1) and raises the explicit
                # resync flag, which is the only full-state trigger.
                stat = self._hb_status()
                seq = self._hb_seq + 1
                pong["seq"] = seq
                full = bool(msg.get("resync"))
                if full:
                    pong["stat"] = stat
                    pong["dfull"] = True
                else:
                    delta = {k: v for k, v in stat.items()
                             if self._hb_stat_sent.get(k) != v}
                    if delta:
                        pong["stat"] = delta
                rep = self._dir_report(full)
                if rep is not None:
                    dadd, ddel = rep
                    if dadd or full:
                        pong["dadd"] = dadd
                    if ddel:
                        pong["ddel"] = ddel
                try:
                    self._send(pong)
                except (OSError, BrokenPipeError):
                    if evs:
                        _events.ingest(evs)  # retry on next ping
                    if prof:
                        _timeline.ingest_events(prof)
                    if lgs:
                        _structlog.reingest(lgs)
                    if smp:
                        _profiler.reingest(smp)
                    return
                # commit AFTER the successful send: a failed send means
                # the head never saw seq, its next ack still names the
                # old epoch, and the delta base stays exact
                self._hb_seq = seq
                self._hb_stat_sent = stat
            elif t == "shutdown":
                return

    def _shutdown(self) -> None:
        self._stop.set()
        try:
            self.transfer_server.close()
        except Exception:
            pass
        try:
            self._xfer_conn_pool.close()
        except Exception:
            pass
        self._fetch_pool.shutdown(wait=False)
        for proc in list(self._worker_procs.values()):
            try:
                proc.terminate()
            except Exception:
                pass
        from . import zygote as _zygote

        _zygote.shutdown_global()
        try:
            self._listener.close()
        except Exception:
            pass
        try:
            os.unlink(self._socket_path)
        except OSError:
            pass
        self.store.close(unlink=True)
        try:
            self.channel.close()
        except Exception:
            pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="rmt node agent")
    p.add_argument("--address", required=True,
                   help="head node listener, HOST:PORT")
    p.add_argument("--authkey", required=True, help="hex cluster authkey")
    p.add_argument("--num-cpus", type=int, default=4)
    p.add_argument("--num-gpus", type=int, default=0)
    args = p.parse_args(argv)
    host, port = args.address.rsplit(":", 1)
    try:
        agent = NodeAgent(host, int(port), bytes.fromhex(args.authkey),
                          num_cpus=args.num_cpus, num_gpus=args.num_gpus)
    except ValueError as e:
        # --num-gpus beyond what CUDA_VISIBLE_DEVICES names
        # rmtcheck: disable=log-discipline — the agent's exit message
        print(f"node agent: {e}", file=sys.stderr)
        return 2
    agent.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
