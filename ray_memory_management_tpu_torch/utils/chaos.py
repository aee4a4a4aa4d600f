"""Chaos/fault-injection harness: kill or stall nodes at random under load.

The reference's NodeKillerActor (python/ray/_private/test_utils.py:1089-1207,
wired into chaos release tests by release/nightly_tests/setup_chaos.py) kills
random raylets on an interval while a workload runs, asserting the workload
survives via retries + lineage reconstruction. This is the same tool for this
runtime's two node planes:

  - in-process nodes: ``Runtime.remove_node`` (graceful-crash analog);
  - node-agent processes: SIGKILL the agent, exercising channel-EOF death
    detection exactly like a host loss, or SIGSTOP/SIGCONT it (``stall``)
    for the gray failure a dead-or-slow detector must NOT treat as death
    until the heartbeat deadline actually expires.

Complementary to :mod:`.faults`, which injects PARTIAL faults (a corrupt
stripe, a flaky spill write) inside a live process; this module removes or
freezes whole nodes. Soak tests run both at once.

Use as a context manager so the chaos thread can never outlive the test::

    with NodeKiller(rt, interval_s=0.5, max_kills=2, kill_mode="stall"):
        run_workload()
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from . import events


class NodeKiller:
    """Periodically kills (or stalls) a random non-head node while running.

    kill_mode:
      - "remove": graceful in-process node removal (workers terminated,
        store dropped) — works for every node type;
      - "sigkill": for remote agent nodes only, kill -9 the agent process
        (no goodbye; the head must detect the death from channel EOF);
      - "stall": for remote agent nodes only, SIGSTOP the agent for
        ``stall_s`` seconds then SIGCONT — the node is alive but
        unresponsive, the classic gray failure. ``stop()`` resumes any
        agent still frozen, so a test that exits early cannot leak a
        stopped process.
    """

    def __init__(self, runtime, interval_s: float = 1.0,
                 max_kills: int = 1, kill_mode: str = "remove",
                 stall_s: float = 3.0,
                 rng: Optional[random.Random] = None):
        if kill_mode not in ("remove", "sigkill", "stall"):
            raise ValueError(f"unknown kill_mode {kill_mode!r}")
        self._rt = runtime
        self.interval_s = interval_s
        self.max_kills = max_kills
        self.kill_mode = kill_mode
        self.stall_s = stall_s
        self.kills: list = []   # NodeIDs killed
        self.stalls: list = []  # NodeIDs stalled (also appended to kills)
        self._stalled_pids: list = []  # pids still SIGSTOPped
        self._rng = rng or random.Random(0xC4A05)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "NodeKiller":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-killer")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # resume any agent left frozen (early test exit mid-stall)
        self._resume_stalled()

    def __enter__(self) -> "NodeKiller":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the chaos loop -------------------------------------------------------
    def _victims(self):
        rt = self._rt
        head = rt.head_node().node_id
        out = []
        for node_id, nm in list(rt.nodes.items()):
            if node_id == head or not nm.alive:
                continue
            if self.kill_mode in ("sigkill", "stall"):
                from ..core.remote_node import RemoteNodeManager

                if not isinstance(nm, RemoteNodeManager):
                    continue
            out.append(node_id)
        return out

    def kill_one(self) -> Optional[object]:
        """Kill (or stall) one random eligible node now; returns its
        NodeID or None when no node is eligible."""
        victims = self._victims()
        if not victims:
            return None
        node_id = self._rng.choice(victims)
        if self.kill_mode == "sigkill":
            self._sigkill_agent(node_id)
        elif self.kill_mode == "stall":
            self._stall_agent(node_id)
            self.stalls.append(node_id)
        else:
            self._rt.remove_node(node_id)
        self.kills.append(node_id)
        self._emit(node_id)
        return node_id

    def _emit(self, node_id) -> None:
        """Every chaos action is a cluster event: a soak-test log must
        show WHEN the harness struck, interleaved with the runtime's own
        failure detection, or the recovery timeline is unreadable."""
        try:
            verb = ("stalled" if self.kill_mode == "stall" else "killed")
            label = ("CHAOS_NODE_STALLED" if self.kill_mode == "stall"
                     else "CHAOS_NODE_KILLED")
            nid = node_id.hex() if isinstance(node_id, bytes) else str(node_id)
            events.emit(label,
                        f"chaos harness {verb} node {nid[:12]} "
                        f"(mode={self.kill_mode})",
                        severity=events.WARNING, source="chaos",
                        node_id=nid, mode=self.kill_mode)
        except Exception:  # noqa: BLE001 — observability never fails chaos
            pass

    def _agent_pid(self, node_id) -> int:
        """The agent pid for EXACTLY the chosen node (it arrives in the
        registration hello and is recorded on the head-side
        RemoteNodeManager). Only meaningful for same-host agents — a
        chaos harness for true remote hosts signals over ssh instead."""
        pid = self._rt.nodes[node_id].agent_pid
        if pid is None:
            raise RuntimeError(f"node {node_id} has no recorded agent pid")
        return pid

    def _sigkill_agent(self, node_id) -> None:
        import os
        import signal

        try:
            os.kill(self._agent_pid(node_id), signal.SIGKILL)
        except ProcessLookupError:
            pass

    def _stall_agent(self, node_id) -> None:
        """SIGSTOP the agent now; SIGCONT it after ``stall_s`` from a
        timer thread (the chaos loop keeps scheduling other strikes
        meanwhile). The pid stays in ``_stalled_pids`` until resumed so
        ``stop()`` can clean up a frozen agent."""
        import os
        import signal

        pid = self._agent_pid(node_id)
        try:
            os.kill(pid, signal.SIGSTOP)
        except ProcessLookupError:
            return
        self._stalled_pids.append(pid)

        def resume():
            time.sleep(self.stall_s)
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
            try:
                self._stalled_pids.remove(pid)
            except ValueError:
                pass

        threading.Thread(target=resume, daemon=True,
                         name="node-killer-resume").start()

    def _resume_stalled(self) -> None:
        import os
        import signal

        for pid in list(self._stalled_pids):
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
            try:
                self._stalled_pids.remove(pid)
            except ValueError:
                pass

    def _loop(self) -> None:
        while not self._stop.is_set() and len(self.kills) < self.max_kills:
            if self._stop.wait(self.interval_s):
                return
            self.kill_one()
