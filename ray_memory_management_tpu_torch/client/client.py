"""Client-side backend: the full core API over a TCP channel.

The reference's thin client (util/client/worker.py:81) re-implements the
worker API surface against the proxy; here ``ClientBackend`` implements
the same backend interface the public api module routes through
(submit/get/put/wait/actors), so after ``connect()`` every ``rmt.*``
call transparently proxies to the remote cluster.
"""

from __future__ import annotations

import os
import threading
from multiprocessing.connection import Client as _MpClient
from typing import Any, Dict, List, Optional, Tuple

from .. import _worker_context
from .. import serialization as ser


class ClientBackend:
    def __init__(self, host: str, port: int,
                 authkey: bytes = b"rmt-client"):
        self._conn = _MpClient((host, port), family="AF_INET",
                               authkey=authkey)
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Any] = {}
        self._events: Dict[int, threading.Event] = {}
        self._counter = 0
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True, name="rmt-client-recv")
        self._recv_thread.start()
        self.inline_limit = 100 * 1024  # parity with driver-side encoding
        from ..config import WIRE_PROTOCOL_VERSION

        # fail fast on a bad address AND on a version-skewed server (the
        # server raises a mismatch error back through this request); a
        # submitted job's driver tags its head-side job row with its
        # submission id (job_submission sets RMT_SUBMISSION_ID)
        self._request({"type": "ping", "proto": WIRE_PROTOCOL_VERSION,
                       "submission_id":
                           os.environ.get("RMT_SUBMISSION_ID")})

    # -- transport ------------------------------------------------------------
    def _recv_loop(self) -> None:
        while not self._closed.is_set():
            try:
                reply = self._conn.recv()
            except (EOFError, OSError):
                self._closed.set()
                with self._lock:
                    events = list(self._events.values())
                for ev in events:
                    ev.set()
                return
            req_id = reply.get("req_id")
            with self._lock:
                ev = self._events.get(req_id)
                if ev is not None:  # drop late replies to timed-out reqs
                    self._pending[req_id] = reply
            if ev:
                ev.set()

    def _request(self, msg: Dict[str, Any],
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        if self._closed.is_set():
            raise ConnectionError("client connection lost")
        with self._lock:
            self._counter += 1
            req_id = self._counter
            ev = threading.Event()
            self._events[req_id] = ev
        msg["req_id"] = req_id
        with self._send_lock:
            self._conn.send(msg)
        if not ev.wait(timeout if timeout is not None else 3600.0):
            with self._lock:
                self._events.pop(req_id, None)
                self._pending.pop(req_id, None)
            raise TimeoutError(f"client request {msg['type']} timed out")
        with self._lock:
            reply = self._pending.pop(req_id, None)
            self._events.pop(req_id, None)
        if reply is None:
            raise ConnectionError("client connection lost mid-request")
        if reply.get("error") is not None:
            raise ser.loads(reply["error"])
        return reply

    # -- backend interface (mirrors WorkerRuntimeProxy) -----------------------
    def submit_task(self, payload: dict) -> List[bytes]:
        return self._request({"type": "submit_task",
                              "payload": payload})["return_ids"]

    def submit_actor_task(self, payload: dict) -> List[bytes]:
        return self._request({"type": "submit_actor_task",
                              "payload": payload})["return_ids"]

    def create_actor(self, payload: dict) -> bytes:
        return self._request({"type": "create_actor",
                              "payload": payload})["actor_id"]

    def get_objects(self, oids: List[bytes],
                    timeout: Optional[float] = None) -> List[Any]:
        reply = self._request(
            {"type": "get_objects", "oids": oids, "timeout": timeout},
            timeout=None if timeout is None else timeout + 30)
        return [ser.loads(v) for v in reply["values"]]

    def put_object(self, value: Any) -> bytes:
        return self._request(
            {"type": "put", "data": ser.dumps(value)})["object_id"]

    def put_serialized_arg(self, data) -> bytes:
        return self._request(
            {"type": "put", "data": data.to_bytes()})["object_id"]

    def put_device_object(self, value: Any) -> bytes:
        # a thin client has no cluster-side device; the server pins the
        # rebuilt array in the driver's device store
        return self._request(
            {"type": "put_device", "data": ser.dumps(value)})["object_id"]

    def wait(self, oids, num_returns, timeout,
             fetch_local=True) -> Tuple[List[bytes], List[bytes]]:
        reply = self._request(
            {"type": "wait", "oids": oids, "num_returns": num_returns,
             "timeout": timeout},
            timeout=None if timeout is None else timeout + 30)
        return reply["ready"], reply["not_ready"]

    def kill_actor(self, actor_id: bytes, no_restart: bool) -> None:
        self._request({"type": "kill_actor", "actor_id": actor_id,
                       "no_restart": no_restart})

    def cancel_task(self, oid: bytes, force: bool) -> None:
        self._request({"type": "cancel_task", "object_id": oid,
                       "force": force})

    def get_named_actor(self, name: str) -> bytes:
        return self._request({"type": "get_named_actor",
                              "name": name})["actor_id"]

    def cluster_resources(self) -> Dict[str, float]:
        return self._request({"type": "cluster_resources"})["resources"]

    def request_resources(self, bundles) -> None:
        """Pin the head autoscaler's demand floor
        (``autoscaler.request_resources``)."""
        self._request({"type": "request_resources", "bundles": bundles})

    def state_query(self, fn: str, args: tuple, kwargs: dict):
        """One state API call answered by the head (``state.api``)."""
        return self._request({"type": "state_query", "fn": fn,
                              "args": args, "kwargs": kwargs})["rows"]

    # placement groups proxy like the worker proxy does, so gang-scheduling
    # libraries work from thin clients too
    def create_placement_group(self, bundles, strategy, name="") -> bytes:
        return self._request({"type": "create_pg", "bundles": bundles,
                              "strategy": strategy, "name": name})["pg_id"]

    def placement_group_state(self, pg_id: bytes):
        return self._request({"type": "pg_state", "pg_id": pg_id})["state"]

    def wait_placement_group(self, pg_id: bytes, timeout: float) -> bool:
        return self._request({"type": "wait_pg", "pg_id": pg_id,
                              "timeout": timeout},
                             timeout=timeout + 30)["created"]

    def remove_placement_group(self, pg_id: bytes) -> None:
        self._request({"type": "remove_pg", "pg_id": pg_id})

    # -- job plane ------------------------------------------------------------
    def set_quota(self, cpu_slots: int = 0, object_bytes: int = 0,
                  device_bytes: int = 0, priority: int = 1) -> None:
        """Install this connection's job quota (0 = unlimited). Byte
        quotas reject over-limit puts/pins with QuotaExceededError;
        cpu_slots backpressures task admission; priority weights the
        router's fair share and gates leaf-lease preemption."""
        self._request({"type": "set_quota", "quota": {
            "cpu_slots": cpu_slots, "object_bytes": object_bytes,
            "device_bytes": device_bytes, "priority": priority}})

    def job_usage(self) -> dict:
        """This connection's live quota usage (bytes, slots, counters)."""
        return self._request({"type": "job_usage"})["usage"]

    def close(self) -> None:
        self._closed.set()
        try:
            self._conn.close()
        except OSError:
            pass


_client: Optional[ClientBackend] = None


def connect(address: str, authkey: bytes = b"rmt-client") -> ClientBackend:
    """Connect this process to a served cluster, e.g.
    ``connect("127.0.0.1:10001")``. After this, ``rmt.remote/get/put``
    route through the client (the ray://... init analog)."""
    global _client
    host, _, port = address.partition(":")
    backend = ClientBackend(host or "127.0.0.1", int(port), authkey)
    _worker_context.set_proxy(backend)
    _client = backend
    return backend


def disconnect() -> None:
    global _client
    if _client is not None:
        _client.close()
        _client = None
    _worker_context.set_proxy(None)
