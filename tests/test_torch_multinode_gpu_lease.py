"""GPU leases on an agent node map through the AGENT's own
``CUDA_VISIBLE_DEVICES``.

The JAX package's head gives a node agent ``free_chips =
list(range(total))`` (``core/remote_node.py:145-148``): raw indices,
never mapped through the agent's own visible-device list, so an agent
started on cards "5,2" would lease index 0. The port's agent reports
``node_manager.visible_devices(num_gpus)`` from its own process when it
registers, and the head leases those names. Nothing here makes a CUDA
call: the cards are names in an environment variable.
"""

import os
import subprocess
import sys
import time
from multiprocessing.connection import Client

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import serialization as ser
from ray_memory_management_tpu_torch.config import (
    WIRE_PROTOCOL_VERSION, Config)
from ray_memory_management_tpu_torch.core.resources import (
    NodeResources, task_resources)
from ray_memory_management_tpu_torch.ids import NodeID
from _port_fixtures import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lease(barrier_dir=None, parties=2):
    """Report the lease and the worker's node. With ``barrier_dir``,
    first wait (up to 60 s) until ``parties`` tasks hold their leases at
    once, each marking itself with a file there."""
    if barrier_dir is not None:
        open(os.path.join(barrier_dir, str(os.getpid())), "w").close()
        deadline = time.time() + 60
        while len(os.listdir(barrier_dir)) < parties:
            if time.time() > deadline:
                raise TimeoutError("the leases were never held together")
            time.sleep(0.01)
    return os.environ["CUDA_VISIBLE_DEVICES"], os.environ["RMT_NODE_ID"]


def _tensor_device(t):
    return t.device.type


class _ShippedCuda:
    """Pickles as a CUDA tensor, as one sent from a process with a card
    would (this build of torch has no CUDA)."""

    def __reduce__(self):
        return (ser._rebuild_tensor,
                (np.arange(6, dtype=np.float32), "float32", "cuda"))


@pytest.fixture
def agent_on_cards_5_2(monkeypatch):
    """A head without GPUs and one agent process whose environment names
    cards "5,2" (the agent inherits the driver's environment)."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rt = rmt.init(num_cpus=2, num_gpus=0)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,2")
    try:
        node = rt.add_remote_node_process(num_cpus=2, num_gpus=2)
        yield rt, node
    finally:
        rmt.shutdown()


def test_the_reference_leases_raw_indices():
    """The fault the port repairs, shown on the JAX package: whatever the
    agent was given, its head-side node leases indices 0 .. n-1."""
    from ray_memory_management_tpu.config import Config as RefConfig
    from ray_memory_management_tpu.core.remote_node import (
        RemoteNodeManager as RefRemote)
    from ray_memory_management_tpu.core.resources import (
        NodeResources as RefNodeResources, task_resources as ref_resources)
    from ray_memory_management_tpu.ids import NodeID as RefNodeID

    nm = RefRemote(RefNodeID.from_random(),
                   RefNodeResources(ref_resources(num_cpus=2, num_tpus=2)),
                   RefConfig(), on_worker_started=lambda h: None,
                   channel=None)
    assert nm.free_chips == [0, 1]


def test_remote_node_leases_the_names_the_agent_reports():
    from ray_memory_management_tpu_torch.core.remote_node import (
        RemoteNodeManager)

    res = NodeResources(task_resources(num_cpus=2, num_gpus=2))
    nm = RemoteNodeManager(NodeID.from_random(), res, Config(),
                           on_worker_started=lambda h: None, channel=None,
                           gpu_names=["5", "2"])
    assert sorted(nm.free_chips) == ["2", "5"]
    with pytest.raises(ValueError, match="reports 1 device names"):
        RemoteNodeManager(NodeID.from_random(), res, Config(),
                          on_worker_started=lambda h: None, channel=None,
                          gpu_names=["5"])


def test_two_leases_on_the_agent_are_its_own_cards(agent_on_cards_5_2,
                                                    tmp_path):
    rt, node = agent_on_cards_5_2
    assert rmt.cluster_resources()["GPU"] == 2
    assert rt.nodes[node].resources.total.get("GPU") == 2
    assert rt.head_node().resources.total.get("GPU") == 0
    leased = rmt.remote(_lease).options(num_gpus=1)
    # the two tasks hold their leases at the same time (a barrier)
    outs = rmt.get([leased.remote(str(tmp_path)) for _ in range(2)],
                   timeout=120)
    (a, na), (b, nb) = outs
    assert na == nb == node.hex()          # both on the agent
    assert sorted([a, b]) == ["2", "5"]    # never "0" or "1"


def test_cuda_tensor_on_an_agent_worker_without_cuda_raises(
        agent_on_cards_5_2):
    """A leased agent worker whose CUDA sees no card raises on a CUDA
    tensor (``serialization._consumer_cuda_device``), as on the head;
    an unleased one, run first, rebuilds it on the CPU."""
    rt, node = agent_on_cards_5_2
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    on_agent = NodeAffinitySchedulingStrategy(node_id=node, soft=False)
    plain = rmt.remote(_tensor_device).options(scheduling_strategy=on_agent)
    assert rmt.get(plain.remote(_ShippedCuda()), timeout=120) == "cpu"
    leased = rmt.remote(_tensor_device).options(num_gpus=1)
    with pytest.raises(Exception, match="CUDA sees no device"):
        rmt.get(leased.remote(_ShippedCuda()), timeout=120)


def test_agent_with_more_gpus_than_names_fails_to_join(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rt = rmt.init(num_cpus=2, num_gpus=0)
    try:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,2")
        with pytest.raises(RuntimeError, match="before joining"):
            rt.add_remote_node_process(num_cpus=1, num_gpus=3, timeout=60)
        host, port = rt.node_listener_address
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m",
             "ray_memory_management_tpu_torch.core.node_agent",
             "--address", f"{host}:{port}", "--authkey", rt._authkey.hex(),
             "--num-cpus", "1", "--num-gpus", "3"],
            env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2
        assert ("3 GPUs declared, but CUDA_VISIBLE_DEVICES='5,2' names "
                "only 2") in proc.stderr
        assert rmt.cluster_resources().get("GPU", 0) == 0
    finally:
        rmt.shutdown()


def test_head_refuses_an_agent_that_names_too_few_cards():
    """A registration whose device names do not cover its GPUs (an agent
    of another build, say) is refused with the reason."""
    rt = rmt.init(num_cpus=1, num_gpus=0)
    try:
        conn = Client(rt.node_listener_address, authkey=rt._authkey)
        conn.send({"type": "register_node", "proto": WIRE_PROTOCOL_VERSION,
                   "num_cpus": 1, "num_gpus": 2, "visible_devices": ["7"],
                   "hostname": "h", "pid": os.getpid()})
        reply = conn.recv()
        conn.close()
        assert reply["type"] == "error"
        assert "declares 2 GPUs but reports 1 device names" in reply["error"]
        assert rmt.cluster_resources().get("GPU", 0) == 0
    finally:
        rmt.shutdown()


def test_agent_start_up_imports_no_torch():
    """The agent's start-up path reads CUDA_VISIBLE_DEVICES only: its
    zygote forks every worker, and a CUDA context in a zygote breaks
    each fork."""
    code = ("import sys\n"
            "import ray_memory_management_tpu_torch.core.node_agent as a\n"
            "from ray_memory_management_tpu_torch.core import node_manager\n"
            "node_manager.visible_devices(2)\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  CUDA_VISIBLE_DEVICES="5,2"),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_agent_workers_start_without_cards(agent_on_cards_5_2):
    """An agent's pool workers take build_worker_env from the port's
    node_manager: CUDA_VISIBLE_DEVICES="" until a lease, whatever the
    agent's own variable names."""
    rt, node = agent_on_cards_5_2
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    probe = rmt.remote(_lease).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=node, soft=False))
    visible, where = rmt.get(probe.remote(), timeout=120)
    assert where == node.hex() and visible == ""
