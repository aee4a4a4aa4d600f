"""One multi-node driver program, run against the JAX package and against
the port in turn: the results must be equal, value for value, and every
task and actor must run on the same kind of node in both.

The program starts a head and one node-agent process, pins a task to the
agent (``NodeAffinitySchedulingStrategy``) on a numpy array the driver
put, keeps an actor on the agent, kills the agent process, and reads the
task's result again, which lineage reconstruction rebuilds on the head.
"""

import functools
import hashlib
import importlib
import time

import numpy as np
import pytest
from _port_fixtures import one_intra_op_thread  # noqa: F401

PACKAGES = {"jax": "ray_memory_management_tpu",
            "torch": "ray_memory_management_tpu_torch"}


def _digest(value) -> tuple:
    a = np.asarray(value)
    return (str(a.dtype), a.shape, hashlib.sha256(a.tobytes()).hexdigest())


@functools.lru_cache(maxsize=None)
def _program(kind: str) -> dict:
    rmt = importlib.import_module(PACKAGES[kind])
    strategies = importlib.import_module(
        PACKAGES[kind] + ".core.scheduling_strategies")
    rng = np.random.default_rng(0)
    values = rng.standard_normal(400_000).astype(np.float32)

    rt = rmt.init(num_cpus=2)
    try:
        agent = rt.add_remote_node_process(num_cpus=2)
        where = {rt.head_node().node_id.hex(): "head", agent.hex(): "agent"}
        on_agent = strategies.NodeAffinitySchedulingStrategy(
            node_id=agent, soft=True)

        @rmt.remote
        def scale(x, k):
            import os

            # large enough to live in the producing node's store
            return np.asarray(x) * k + 1, os.environ["RMT_NODE_ID"]

        @rmt.remote
        class Tally:
            def __init__(self, start):
                self.n = start

            def add(self, x):
                import os

                self.n += float(np.asarray(x, dtype=np.float64).sum())
                return self.n, os.environ["RMT_NODE_ID"]

        out = {}
        x = rmt.put(values)
        ref = scale.options(scheduling_strategy=on_agent).remote(x, 3.0)
        arr, node = rmt.get(ref, timeout=120)
        out["task"] = (_digest(arr), where[node])

        tally = Tally.options(scheduling_strategy=on_agent).remote(1.5)
        t1 = rmt.get(tally.add.remote(x), timeout=120)
        t2 = rmt.get(tally.add.remote(values[:10]), timeout=120)
        out["actor"] = [(round(n, 3), where[w]) for n, w in (t1, t2)]

        rt._agent_procs[0].kill()
        deadline = time.time() + 30
        while time.time() < deadline and rt.nodes[agent].alive:
            time.sleep(0.1)
        out["agent_dead"] = not rt.nodes[agent].alive
        del arr
        arr, node = rmt.get(ref, timeout=120)
        out["reconstructed"] = (_digest(arr), where[node])
        try:
            rmt.get(tally.add.remote(values[:10]), timeout=60)
            out["actor_after_death"] = "answered"
        except Exception as e:  # noqa: BLE001 — the type is the result
            out["actor_after_death"] = type(e).__name__
        return out
    finally:
        rmt.shutdown()


@pytest.mark.parametrize("key", ["task", "actor", "agent_dead",
                                 "reconstructed", "actor_after_death"])
def test_multinode_program_matches_the_jax_package(key):
    assert _program("torch")[key] == _program("jax")[key]


def test_placement_and_recovery():
    """What the two runs agreed on is the intended behaviour: the task
    and the actor ran on the agent, and the result came back after the
    agent's death, rebuilt on the head."""
    out = _program("torch")
    assert out["task"][1] == "agent"
    assert [w for _, w in out["actor"]] == ["agent", "agent"]
    assert out["agent_dead"]
    assert out["reconstructed"] == (out["task"][0], "head")
    assert out["actor_after_death"] == "ActorDiedError"
