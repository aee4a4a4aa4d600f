"""Simulated agent plane: protocol-faithful lightweight node agents.

A :class:`SimNodeAgent` lets ONE host drive pod-scale memberships
(64-256 nodes) and millions of directory rows through the genuine head
code paths.  It dials the head's node listener over the real
authenticated channel and speaks the real wire frames — register_node
hello, prestart ``start_worker``/ready, ``lease_exec``/``lease_batch``,
delta-compressed pongs — but spawns no worker processes and maps no shm
store.  Leaf tasks execute INLINE on the recv thread (cloudpickle fn
cache, inline args only) and settle through the real ``done`` path, so
scheduler, lease-credit, and directory accounting on the head are
exercised exactly as by a real node.

Synthetic directory rows are the load generator for the memory-bounded
directory: the bench mutates a per-agent row dict and the agent ships
only the changes on each pong (``dadd``/``ddel``), full-state on resync
— the same commit-on-send-success protocol as the real agent, so the
head's ingress is O(changes) regardless of how many rows a node holds.

What is NOT simulated: the p2p object transfer plane.  A sim agent
never sends ``transfer_ready``, so the head uses the channel-push
fallback; pushes land in a plain dict and pulls answer from it.
"""

from __future__ import annotations

import os
import threading
from multiprocessing.connection import Client
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from .. import serialization as ser
from ..config import WIRE_PROTOCOL_VERSION


class SimNodeAgent:
    """One simulated node: real channel, real frames, no processes."""

    def __init__(self, address: Tuple[str, int], authkey: bytes, *,
                 num_cpus: int = 2, num_gpus: int = 0,
                 resources: Optional[dict] = None,
                 labels: Optional[dict] = None,
                 name: str = "sim"):
        self.address = tuple(address)
        self.authkey = authkey
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus
        self.resources = dict(resources or {})
        self.labels = {"sim": "1", "sim-name": name}
        self.labels.update(labels or {})
        self.node_id: bytes = b""
        self.config: dict = {}
        self.channel = None
        self._thread: Optional[threading.Thread] = None
        self._send_lock = threading.Lock()
        self._mu = threading.Lock()  # guards rows + counters (bench thread)
        self._closed = threading.Event()
        # worker facade: wids the head prestarted and bound (ready sent)
        self._wids: List[bytes] = []
        self._rr = 0  # round-robin index for done replies
        # leaf fn cache, keyed by fn_id (mirrors worker._resolve_function)
        self._fns: Dict[bytes, Any] = {}
        # channel-push fallback object store (oid -> bytes)
        self._objs: Dict[bytes, bytearray] = {}
        # ---- synthetic directory rows -------------------------------
        # _rows is the node's current truth (bench mutates it under _mu);
        # _rows_acked is what the head knows as of the last pong whose
        # send succeeded.  Each pong ships only the diff.
        self._rows: Dict[bytes, int] = {}
        self._rows_acked: Dict[bytes, int] = {}
        self._row_ctr = 0
        # ---- delta heartbeat state (recv-loop private) --------------
        self._hb_seq = 0
        self._stat_sent: Dict[str, Any] = {}
        self._force_gap = False  # test hook: skip a seq to provoke resync
        # ---- observability ------------------------------------------
        self.pongs_full = 0
        self.pongs_delta = 0
        self.rows_shipped = 0  # cumulative dadd+ddel entries sent
        self.tasks_run = 0
        self.errors: List[str] = []

    # ------------------------------------------------------------ lifecycle
    def connect(self) -> "SimNodeAgent":
        """Dial the head, handshake synchronously, start the recv loop.
        The head's prestart ``start_worker`` frames queue in the socket
        buffer until the loop comes up — same as a slow real agent."""
        self.channel = Client(self.address, authkey=self.authkey)
        self.channel.send({
            "type": "register_node",
            "proto": WIRE_PROTOCOL_VERSION,
            "num_cpus": self.num_cpus,
            "num_gpus": self.num_gpus,
            # a simulated node runs no worker processes, so its device
            # names are synthetic
            "visible_devices": [str(i) for i in range(self.num_gpus)],
            "resources": self.resources,
            "labels": self.labels,
            "hostname": f"sim-{os.getpid()}",
            "pid": os.getpid(),
        })
        hello = self.channel.recv()
        if hello.get("type") != "registered":
            raise RuntimeError(f"head rejected sim registration: {hello}")
        self.node_id = hello["node_id"]
        self.config = hello["config"]
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"sim-agent-{self.node_id.hex()[:6]}")
        self._thread.start()
        return self

    def close(self) -> None:
        self.begin_close()
        self.join_closed()

    def begin_close(self) -> None:
        """Signal shutdown and close the channel WITHOUT waiting for the
        recv thread. A thread blocked in recv() only wakes on the next
        inbound frame (typically the head's ~0.5s ping), so closing a
        big fleet one agent at a time serializes those waits —
        close_sim_agents() begins them all first so they overlap."""
        self._closed.set()
        try:
            if self.channel is not None:
                self.channel.close()
        except OSError:
            pass

    def join_closed(self) -> None:
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------ bench API
    def add_rows(self, count: int, size: int = 64) -> None:
        """Assert ``count`` new synthetic object rows held by this node.
        They reach the head incrementally via pong deltas."""
        with self._mu:
            for _ in range(count):
                self._row_ctr += 1
                oid = (self.node_id[:8]
                       + self._row_ctr.to_bytes(8, "big")
                       + os.urandom(4))
                self._rows[oid] = size

    def drop_rows(self, count: int) -> int:
        """Retract up to ``count`` rows (oldest first); returns how many."""
        with self._mu:
            victims = list(self._rows.keys())[:count]
            for oid in victims:
                del self._rows[oid]
            return len(victims)

    def churn_rows(self, count: int, size: int = 64) -> None:
        """Replace ``count`` rows: a steady-state workload whose pong
        delta is 2*count entries no matter how many rows are held."""
        self.drop_rows(count)
        self.add_rows(count, size)

    def row_count(self) -> int:
        with self._mu:
            return len(self._rows)

    def force_gap(self) -> None:
        """Test hook: silently burn one pong seq so the head sees a gap
        on the next pong and latches a resync."""
        with self._mu:
            self._force_gap = True

    # ------------------------------------------------------------ recv loop
    def _run(self) -> None:
        try:
            while not self._closed.is_set():
                try:
                    msg = self.channel.recv()
                except (EOFError, OSError, TypeError, ValueError):
                    # TypeError/ValueError: close() from another thread
                    # tears the conn down mid-recv
                    return
                try:
                    self._dispatch(msg)
                except Exception as e:  # keep the loop alive: record it
                    with self._mu:
                        self.errors.append(repr(e))
        finally:
            try:
                self.channel.close()
            except OSError:
                pass

    def _send(self, frame: dict) -> None:
        with self._send_lock:
            self.channel.send(frame)

    def _dispatch(self, msg: dict) -> None:
        t = msg.get("type")
        if t == "ping":
            self._pong(msg)
        elif t == "start_worker":
            wid = bytes.fromhex(msg["wid_hex"])
            self._wids.append(wid)
            self._send({"type": "wmsg", "wid": wid,
                        "msg": {"type": "ready", "worker_id": wid}})
        elif t == "wsend":
            inner = msg["msg"]
            # the head's sender queue coalesces worker frames into
            # {"type": "batch", "msgs": [...]} — unwrap like a worker does
            inners = inner["msgs"] if inner.get("type") == "batch" \
                else (inner,)
            for sub in inners:
                if sub.get("type") == "exec":
                    self._exec(sub, msg["wid"])
        elif t == "lease_exec":
            self._lease(msg)
        elif t == "lease_batch":
            for sub in msg["tasks"]:
                self._lease(sub)
        elif t == "obj_push":
            self._objs[msg["oid"]] = bytearray(msg.get("size", 0))
        elif t == "obj_chunk":
            buf = self._objs.get(msg["oid"])
            if buf is not None:
                off, data = msg["off"], msg["data"]
                buf[off:off + len(data)] = data
        elif t == "obj_seal":
            self._send({"type": "push_ack", "req": msg["req"], "error": None})
        elif t == "obj_pull":
            buf = self._objs.get(msg["oid"])
            if buf is None:
                self._send({"type": "pull_data", "req": msg["req"], "off": 0,
                            "error": "sim: object not held"})
            else:
                self._send({"type": "pull_data", "req": msg["req"], "off": 0,
                            "data": bytes(buf), "eof": True})
        elif t == "obj_ensure":
            failed = [o for o in msg.get("oids", ()) if o not in self._objs]
            self._send({"type": "ensure_ack", "req": msg["req"],
                        "failed": failed})
        elif t == "obj_fetch":
            self._send({"type": "fetch_ack", "req": msg["req"],
                        "error": "sim: no transfer plane"})
        elif t == "obj_spill":
            self._send({"type": "spill_ack", "req": msg["req"]})
        elif t == "obj_free":
            self._objs.pop(msg.get("oid"), None)
        elif t == "shutdown":
            self._closed.set()
            raise EOFError
        # unknown frames are ignored: sim agents only need the subset
        # of the protocol the bench exercises

    # ------------------------------------------------------------ heartbeat
    def _pong(self, msg: dict) -> None:
        """Delta pong — same seq/commit protocol as the real agent, plus
        the synthetic row report the real agent leaves to the head."""
        with self._mu:
            if self._force_gap:
                self._hb_seq += 1  # the head never sees this seq
                self._force_gap = False
            rows = dict(self._rows)
        stat = {
            "store_used": 0,
            "store_cap": 1 << 30,
            "spilled": 0,
            "lease_depth": 0,
            "workers": len(self._wids),
        }
        seq = self._hb_seq + 1
        pong: dict = {"type": "pong", "seq": seq}
        # full state ONLY on the head's explicit resync flag — the ack
        # lags a round trip behind under pipelined pings, so an ack
        # mismatch is normal, not a desync (see node_agent.py)
        full = bool(msg.get("resync"))
        shipped = 0
        if full:
            pong["stat"] = stat
            pong["dfull"] = True
            pong["dadd"] = [[oid, sz] for oid, sz in rows.items()]
            shipped = len(rows)
        else:
            delta = {k: v for k, v in stat.items()
                     if self._stat_sent.get(k) != v}
            if delta:
                pong["stat"] = delta
            dadd = [[oid, sz] for oid, sz in rows.items()
                    if self._rows_acked.get(oid) != sz]
            ddel = [oid for oid in self._rows_acked if oid not in rows]
            if dadd:
                pong["dadd"] = dadd
            if ddel:
                pong["ddel"] = ddel
            shipped = len(dadd) + len(ddel)
        try:
            self._send(pong)
        except (OSError, ValueError):
            return  # channel gone; seq not committed, next pong resends
        self._hb_seq = seq
        self._stat_sent = stat
        with self._mu:
            self._rows_acked = rows
            self.rows_shipped += shipped
            if full:
                self.pongs_full += 1
            else:
                self.pongs_delta += 1

    # ------------------------------------------------------------ leaf exec
    def _lease(self, msg: dict) -> None:
        inner = msg["msg"]
        blob = inner.pop("fn_blob", None)
        if blob is not None and inner.get("fn_id") is not None:
            self._fns.setdefault(inner["fn_id"], cloudpickle.loads(blob))
        self._exec(inner, self._pick_wid())

    def _pick_wid(self) -> bytes:
        self._rr += 1
        return self._wids[self._rr % len(self._wids)]

    def _exec(self, inner: dict, wid: bytes) -> None:
        """Run one task inline and settle it through the real done path."""
        task_id = inner["task_id"]
        done: dict = {"type": "done", "task_id": task_id,
                      "returns": [], "error": None}
        try:
            fn = self._fns.get(inner.get("fn_id"))
            if fn is None and inner.get("fn_blob") is not None:
                fn = cloudpickle.loads(inner["fn_blob"])
                self._fns[inner["fn_id"]] = fn
            if fn is None:
                raise RuntimeError("sim: unknown fn_id and no fn_blob")
            args = [self._arg(a) for a in inner.get("args", ())]
            kwargs = {k: self._arg(v)
                      for k, v in (inner.get("kwargs") or {}).items()}
            result = fn(*args, **kwargs)
            rids = inner.get("return_ids") or []
            values = [result] if len(rids) <= 1 else list(result)
            done["returns"] = [
                (rid, "v", ser.serialize(v).to_bytes())
                for rid, v in zip(rids, values)]
            with self._mu:
                self.tasks_run += 1
        except Exception as e:
            try:
                done["error"] = ser.dumps(e)
            except Exception:
                done["error"] = ser.dumps(RuntimeError(repr(e)))
        self._send({"type": "wmsg", "wid": wid, "msg": done})

    @staticmethod
    def _arg(a):
        # inline values only: sim nodes hold no store, so a by-reference
        # arg means the bench misconfigured its task payloads
        if isinstance(a, (tuple, list)) and len(a) == 2 and a[0] == "v":
            return ser.loads(a[1])
        raise RuntimeError("sim agents take inline args only")


def close_sim_agents(agents: List[SimNodeAgent]) -> None:
    """Close a whole fleet in ~one heartbeat interval: begin every
    close first (set flag + close channel), THEN join the recv threads.
    Sequential per-agent close() serializes the recv-wakeup waits and
    costs ~0.2s x fleet size."""
    for a in agents:
        a.begin_close()
    for a in agents:
        a.join_closed()


def spawn_sim_agents(rt, n: int, *, num_cpus: int = 2,
                     name: str = "sim") -> List[SimNodeAgent]:
    """Connect ``n`` SimNodeAgents against a live runtime's node
    listener and wait until the head has registered all of them."""
    import time as _time

    addr = rt.node_listener_address
    agents = [SimNodeAgent(addr, rt._authkey, num_cpus=num_cpus,
                           name=f"{name}-{i}").connect() for i in range(n)]
    deadline = _time.monotonic() + 60
    want = {a.node_id for a in agents}
    while _time.monotonic() < deadline:
        have = {info.node_id.binary() for info in rt.gcs.nodes.values()
                if info.alive}
        if want <= have:
            break
        _time.sleep(0.05)
    else:
        missing = len(want - have)
        raise TimeoutError(
            f"{missing}/{len(agents)} sim agents never registered")
    return agents
