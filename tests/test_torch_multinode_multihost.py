"""Multi-host plane: node agents in separate OS processes joined over TCP.

The agent process shares NOTHING with the head but the authenticated TCP
channel — no shm store, no Unix socket, no memory. These tests cover the
reference's multi-node behaviors (cluster boot python/ray/_private/node.py:1046,
chunked object push/pull src/ray/object_manager/object_manager.h:114, node
death + lineage reconstruction object_recovery_manager.h:41) on that plane.

The PyTorch port's copy of ``tests/test_multihost.py``: the same cases
run against ``ray_memory_management_tpu_torch``.
"""

import time

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.core.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def head_and_agent():
    """Head with local CPUs plus one remote agent node."""
    rt = rmt.init(num_cpus=2)
    remote_id = rt.add_remote_node_process(num_cpus=2)
    yield rt, remote_id
    rmt.shutdown()


def test_task_runs_on_remote_node(head_and_agent):
    rt, remote_id = head_and_agent

    @rmt.remote(max_retries=0)
    def whoami():
        import os

        return os.environ["RMT_NODE_ID"]

    ref = whoami.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=remote_id, soft=False)
    ).remote()
    assert rmt.get(ref, timeout=120) == remote_id.hex()


def test_cross_node_object_transfer(head_and_agent):
    rt, remote_id = head_and_agent
    head_id = rt.head_node().node_id

    @rmt.remote(max_retries=0)
    def produce():
        return np.arange(1_000_000, dtype=np.float32)  # 4 MB -> store

    @rmt.remote(max_retries=0)
    def consume(arr):
        return float(arr.sum())

    # produce on the head, consume on the remote node: the 4 MB argument
    # must ride the chunked push plane into the agent's store
    ref = produce.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=head_id, soft=False)
    ).remote()
    out = consume.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=remote_id, soft=False)
    ).remote(ref)
    expected = float(np.arange(1_000_000, dtype=np.float32).sum())
    assert rmt.get(out, timeout=120) == expected


def test_driver_pulls_remote_object(head_and_agent):
    rt, remote_id = head_and_agent

    @rmt.remote(max_retries=0)
    def produce():
        return np.full(500_000, 3.0, dtype=np.float32)  # 2 MB -> store

    ref = produce.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=remote_id, soft=False)
    ).remote()
    arr = rmt.get(ref, timeout=120)  # chunked pull through the channel
    assert arr.shape == (500_000,) and float(arr[0]) == 3.0


def test_remote_node_death_triggers_lineage_recovery(head_and_agent):
    rt, remote_id = head_and_agent

    @rmt.remote  # default retries: recovery resubmits through the same path
    def produce():
        return np.full(400_000, 7.0, dtype=np.float32)

    ref = produce.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=remote_id, soft=True)
    ).remote()
    assert float(rmt.get(ref, timeout=120)[0]) == 7.0

    # kill the agent PROCESS (not a graceful shutdown): channel EOF must
    # mark the node dead and lineage reconstruction must re-execute the
    # producing task on the surviving head node
    rt._agent_procs[0].kill()
    deadline = time.time() + 30
    while time.time() < deadline:
        nm = rt.nodes.get(remote_id)
        if nm is not None and not nm.alive:
            break
        time.sleep(0.1)
    assert not rt.nodes[remote_id].alive, "agent death not detected"

    arr = rmt.get(ref, timeout=120)
    assert float(arr[0]) == 7.0 and arr.shape == (400_000,)


def test_agent_to_agent_direct_transfer():
    """An object produced on agent A and consumed on agent B moves over the
    p2p transfer plane: the head's channel push/pull must never carry the
    payload (both legacy paths are broken for the duration to prove it)."""
    from ray_memory_management_tpu_torch.core.remote_node import RemoteNodeManager

    rt = rmt.init(num_cpus=2)
    try:
        node_a = rt.add_remote_node_process(num_cpus=2)
        node_b = rt.add_remote_node_process(num_cpus=2)
        # wait for both agents' transfer servers to announce themselves
        deadline = time.time() + 20
        while time.time() < deadline and not all(
                getattr(rt.nodes[n], "transfer_addr", None)
                for n in (node_a, node_b)):
            time.sleep(0.1)
        assert rt.nodes[node_a].transfer_addr, "agent A transfer server"
        assert rt.nodes[node_b].transfer_addr, "agent B transfer server"

        calls = []

        def tracking_pull(self, object_id, timeout=120.0):
            calls.append(("pull", object_id))
            raise AssertionError("legacy channel pull used for payload")

        def tracking_push(self, object_id, view, timeout=120.0):
            calls.append(("push", object_id))
            raise AssertionError("legacy channel push used for payload")

        orig_pull = RemoteNodeManager.pull_object
        orig_push = RemoteNodeManager.push_object
        RemoteNodeManager.pull_object = tracking_pull
        RemoteNodeManager.push_object = tracking_push
        try:
            @rmt.remote(max_retries=0)
            def produce():
                return np.full(1_500_000, 5.0, dtype=np.float32)  # 6 MB

            @rmt.remote(max_retries=0)
            def consume(arr):
                return float(arr.sum())

            ref = produce.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_a, soft=False)).remote()
            out = consume.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_b, soft=False)).remote(ref)
            assert rmt.get(out, timeout=120) == 1_500_000 * 5.0
            assert not calls, f"head touched the payload: {calls}"
        finally:
            RemoteNodeManager.pull_object = orig_pull
            RemoteNodeManager.push_object = orig_push
    finally:
        rmt.shutdown()


def test_dispatch_stays_responsive_during_big_transfer():
    """Task dispatch frames must not queue behind a large object transfer:
    the payload rides a dedicated peer connection, not the agent channel."""
    rt = rmt.init(num_cpus=2)
    try:
        node_a = rt.add_remote_node_process(num_cpus=2)
        node_b = rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(max_retries=0)
        def produce():
            return np.ones(16_000_000, dtype=np.float32)  # 64 MB

        @rmt.remote(max_retries=0)
        def consume(arr):
            return float(arr[0])

        @rmt.remote(max_retries=0)
        def ping():
            return "pong"

        big_ref = produce.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=node_a, soft=False)).remote()
        rmt.wait([big_ref], timeout=120)
        # start the big A->B transfer, then immediately drive small tasks
        # to B over the same agent channel
        out = consume.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=node_b, soft=False)).remote(big_ref)
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            assert rmt.get(ping.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_b, soft=False)).remote(),
                timeout=120) == "pong"
            lat.append(time.perf_counter() - t0)
        assert rmt.get(out, timeout=120) == 1.0
        # generous bound for a loaded CI box; the old single-channel path
        # would serialize the full 64 MB ahead of the ping dispatch
        assert min(lat) < 2.0, f"dispatch latencies during transfer: {lat}"
    finally:
        rmt.shutdown()


class TestAnyHolderServes:
    """Broadcast fan-out properties: every node holding a copy is a valid
    transfer source (object_manager.h:114 — any holder serves), and
    same-host peers move objects shm-to-shm."""

    def test_replica_serves_after_producer_death(self):
        """A serves its object to B; A dies; C must still get the object
        — from B's copy, the only one left (the 'B can serve A's object
        to C' contract, without which a broadcast collapses back onto the
        producer)."""
        rt = rmt.init(num_cpus=2)
        try:
            a = rt.add_remote_node_process(num_cpus=2)
            b = rt.add_remote_node_process(num_cpus=2)
            c = rt.add_remote_node_process(num_cpus=2)

            @rmt.remote(max_retries=0)
            def produce():
                return np.full(2_000_000, 7.0, np.float32)  # 8 MB

            @rmt.remote(max_retries=0)
            def touch(arr):
                return float(arr[0])

            ref = produce.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=a, soft=False)).remote()
            # B pulls a copy (and registers as a holder)
            assert rmt.get(touch.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=b, soft=False)).remote(ref), timeout=300) == 7.0
            assert b in rt.gcs.get_object_locations(ref.binary())

            rt.remove_node(a)  # producer gone; B holds the only copy
            assert rmt.get(touch.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=c, soft=False)).remote(ref), timeout=300) == 7.0
        finally:
            rmt.shutdown()

    def test_broadcast_sources_spread_over_holders(self):
        """Concurrent pulls of one object must not all serialize on the
        original producer: the head picks the least-loaded holder, so as
        copies land they become sources for the stragglers."""
        rt = rmt.init(num_cpus=2, object_store_memory=1 << 30)
        try:
            agents = [rt.add_remote_node_process(num_cpus=2)
                      for _ in range(4)]

            @rmt.remote(max_retries=0)
            def touch(arr):
                return float(arr[0])

            blob = np.full(16_000_000, 3.0, np.float32)  # 64 MB
            ref = rmt.put(blob)
            outs = [touch.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=nid, soft=False)).remote(ref)
                for nid in agents]
            assert rmt.get(outs, timeout=600) == [3.0] * 4
            # every agent ended up a registered holder
            locs = rt.gcs.get_object_locations(ref.binary())
            assert all(nid in locs for nid in agents)
        finally:
            rmt.shutdown()

    def test_same_host_agent_store_mapped_directly(self):
        """The head reads a same-host agent's store through a direct shm
        mapping (StoreClient), not the channel proxy — the mechanism
        behind same-host broadcast bandwidth."""
        from ray_memory_management_tpu_torch.core.object_store import StoreClient

        rt = rmt.init(num_cpus=2)
        try:
            a = rt.add_remote_node_process(num_cpus=2)

            @rmt.remote(max_retries=0)
            def produce():
                return np.arange(500_000, dtype=np.float32)  # 2 MB

            ref = produce.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=a, soft=False)).remote()
            arr = rmt.get(ref, timeout=300)
            assert float(arr.sum()) == float(np.arange(500_000,
                                                       dtype=np.float32).sum())
            cli = rt._store_clients.get(a)
            assert isinstance(cli, StoreClient), type(cli)
        finally:
            rmt.shutdown()


class TestWireVersioning:
    """Every cross-process schema carries config.WIRE_PROTOCOL_VERSION;
    a version-skewed peer is refused at the handshake with both versions
    named (the reference versions its protobuf schemas the same way)."""

    def test_node_registration_rejects_mismatch(self):
        from multiprocessing.connection import Client

        rt = rmt.init(num_cpus=2)
        try:
            host, port = rt.node_listener_address
            conn = Client((host, port), authkey=rt._authkey)
            conn.send({"type": "register_node", "proto": 999,
                       "num_cpus": 1, "hostname": "skewed", "pid": 1})
            reply = conn.recv()
            assert reply["type"] == "error"
            assert "protocol mismatch" in reply["error"]
            assert "v999" in reply["error"]
            conn.close()
            # and a CURRENT-version agent still registers fine
            nid = rt.add_remote_node_process(num_cpus=1)
            assert nid in rt.nodes
        finally:
            rmt.shutdown()

    def test_client_ping_rejects_mismatch(self):
        from multiprocessing.connection import Client

        from ray_memory_management_tpu_torch import serialization as ser
        from ray_memory_management_tpu_torch.client.client import ClientBackend
        from ray_memory_management_tpu_torch.client.server import ClusterServer

        rt = rmt.init(num_cpus=2)
        server = None
        try:
            server = ClusterServer()
            host, port = server.address
            # a skewed client, simulated on the raw wire (both sides of an
            # in-process patch would see the same module attribute)
            conn = Client((host, port), family="AF_INET",
                          authkey=b"rmt-client")
            conn.send({"type": "ping", "proto": 998, "req_id": 1})
            reply = conn.recv()
            assert "error" in reply
            err = ser.loads(reply["error"])
            assert "protocol mismatch" in str(err)
            assert "v998" in str(err)
            conn.close()
            # current version connects (ClientBackend pings on init)
            backend = ClientBackend(host, port)
            backend.close()
        finally:
            if server is not None:
                server.close()
            rmt.shutdown()
