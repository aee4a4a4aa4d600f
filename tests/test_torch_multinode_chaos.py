"""Chaos tests: workloads survive random node kills (the reference's chaos
release tests, release/nightly_tests/chaos_test/test_chaos_basic.py +
NodeKillerActor, _private/test_utils.py:1089).

The PyTorch port's copy of ``tests/test_chaos.py``: the same cases run
against ``ray_memory_management_tpu_torch``.
"""

import zlib

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.utils import events
from ray_memory_management_tpu_torch.utils.chaos import NodeKiller


def test_workload_survives_random_node_kill():
    """SPREAD a store-object workload over 3 nodes, kill a random non-head
    node mid-flight; retries + lineage reconstruction must deliver every
    result."""
    rt = rmt.init(num_cpus=2, num_nodes=3)
    try:
        @rmt.remote(scheduling_strategy="SPREAD")
        def produce(i):
            import time

            time.sleep(0.2)
            return np.full(200_000, float(i), np.float64)  # store object

        # sleeps sized so the workload is still in flight when the killer
        # fires (worker spawns got fast enough that a short workload could
        # drain before a longer interval)
        refs = [produce.remote(i) for i in range(36)]
        killer = NodeKiller(rt, interval_s=0.3, max_kills=1).start()
        try:
            arrs = rmt.get(refs, timeout=300)
        finally:
            killer.stop()
        assert killer.kills, "chaos harness never fired"
        for i, a in enumerate(arrs):
            assert float(a[0]) == float(i) and a.shape == (200_000,)
    finally:
        rmt.shutdown()


def test_chaos_sigkill_remote_agent():
    """SIGKILL a node-agent PROCESS under load: channel EOF must mark the
    node dead and the workload must recover on surviving nodes."""
    rt = rmt.init(num_cpus=2)
    try:
        rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(scheduling_strategy="SPREAD")
        def produce(i):
            import time

            time.sleep(0.05)
            return np.full(100_000, float(i), np.float64)

        refs = [produce.remote(i) for i in range(16)]
        killer = NodeKiller(rt, interval_s=0.5, max_kills=1,
                            kill_mode="sigkill").start()
        try:
            arrs = rmt.get(refs, timeout=300)
        finally:
            killer.stop()
        assert killer.kills, "chaos harness never fired"
        for i, a in enumerate(arrs):
            assert float(a[0]) == float(i)
    finally:
        rmt.shutdown()


@pytest.mark.chaos
def test_chaos_stall_is_gray_failure_not_death():
    """SIGSTOP an agent mid-workload (NodeKiller as a context manager):
    the frozen node delays its tasks but must NOT be declared dead —
    after SIGCONT the workload completes and the node is still alive."""
    rt = rmt.init(num_cpus=2)
    try:
        rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(scheduling_strategy="SPREAD")
        def produce(i):
            import time

            time.sleep(0.2)
            return i * 3

        refs = [produce.remote(i) for i in range(12)]
        with NodeKiller(rt, interval_s=0.2, max_kills=1,
                        kill_mode="stall", stall_s=1.0) as killer:
            out = rmt.get(refs, timeout=120)
        assert killer.stalls, "chaos harness never stalled a node"
        assert out == [i * 3 for i in range(12)]
        # gray failure, not death: the stall was under the heartbeat
        # deadline, so the node must still be alive and schedulable
        assert rt.nodes[killer.stalls[0]].alive
        assert events.list_events({"label": "CHAOS_NODE_STALLED"})
    finally:
        rmt.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_soak_broadcast_and_striped_pulls_converge():
    """Soak: node removal + agent stall while a 16 MB broadcast argument
    fans out and SPREAD producers return 16 MB arrays the driver pulls
    cross-node (striped). Every get must converge and every payload must
    be byte-exact — zero corruption under chaos."""
    from ray_memory_management_tpu_torch.config import Config

    cfg = Config(transfer_stripe_count=4)
    rt = rmt.init(num_cpus=2, num_nodes=3, _config=cfg)
    try:
        rt.add_remote_node_process(num_cpus=2)
        rt.add_remote_node_process(num_cpus=2)

        base = bytes(range(256)) * (64 << 10)  # 16 MB broadcast arg
        want_crc = zlib.crc32(base)
        bref = rmt.put(base)
        size = 12 << 20  # above the 8 MB stripe threshold

        @rmt.remote(scheduling_strategy="SPREAD", max_retries=8,
                    retry_exceptions=True)
        def produce(b, want, i):
            import time
            import zlib as z

            # the broadcast copy this node received must be byte-exact
            assert z.crc32(b) == want
            time.sleep(0.1)
            return bytes([i & 0xFF]) * size

        refs = [produce.remote(bref, want_crc, i) for i in range(24)]
        with NodeKiller(rt, interval_s=0.4, max_kills=1,
                        kill_mode="remove") as k1, \
                NodeKiller(rt, interval_s=0.7, max_kills=1,
                           kill_mode="stall", stall_s=2.0) as k2:
            blobs = rmt.get(refs, timeout=600)
        assert k1.kills or k2.kills, "chaos harness never fired"
        for i, blob in enumerate(blobs):
            assert len(blob) == size
            # zero corrupted payloads, byte-exact across chaos
            assert zlib.crc32(bytes(blob)) == \
                zlib.crc32(bytes([i & 0xFF]) * size)
        assert events.list_events({"label": "CHAOS_NODE_KILLED"}) or \
            events.list_events({"label": "CHAOS_NODE_STALLED"})
    finally:
        rmt.shutdown()
