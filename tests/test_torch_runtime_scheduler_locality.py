"""Scheduler policy interplay: hybrid pack-then-spread, SPREAD,
NodeAffinity hard/soft, and the soft locality score over argument bytes.

Direct unit tests of ClusterScheduler.pick_node — no runtime, no workers:
nodes are registered straight into a GCS and locality maps are handed in
the way the router's batched scheduling pass builds them. The invariants
the locality score must never break: hard NodeAffinity wins, infeasible
nodes are never picked, saturation spills back, SPREAD stays anti-affine.

The PyTorch port's copy of ``tests/test_scheduler_locality.py``: the
same cases run against ``ray_memory_management_tpu_torch``.
"""

import pytest

from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core.gcs import GCS
from ray_memory_management_tpu_torch.core.resources import (
    NodeResources,
    Resources,
)
from ray_memory_management_tpu_torch.core.scheduler import ClusterScheduler
from ray_memory_management_tpu_torch.core.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    SPREAD,
)
from ray_memory_management_tpu_torch.ids import NodeID

MB = 1 << 20


def make_cluster(cpu_per_node=(4, 4, 4), load_fn=None, **cfg):
    """GCS + scheduler over N virtual nodes; returns (sched, [node_ids])."""
    gcs = GCS()
    nids = []
    for i, cpus in enumerate(cpu_per_node):
        nid = NodeID.from_random()
        gcs.register_node(nid, NodeResources(Resources({"CPU": cpus})),
                          store_name=f"store{i}")
        nids.append(nid)
    config = Config(**cfg)
    return ClusterScheduler(gcs, config, load_fn=load_fn), nids


def req(cpus=1.0):
    return Resources({"CPU": cpus})


# ---------------------------------------------------------------- pre-locality


def test_hybrid_packs_then_spreads():
    sched, nids = make_cluster(scheduler_spread_threshold=0.5)
    # empty cluster: pack onto the lowest-index node
    first = sched.pick_node(req())
    assert first == nids[0]
    sched.allocate(first, req(3))  # node0 now at 75% > threshold
    second = sched.pick_node(req())
    assert second in nids[1:]  # spread: least-utilized, not node0


def test_spread_prefers_least_utilized():
    sched, nids = make_cluster()
    sched.allocate(nids[0], req(3))
    sched.allocate(nids[1], req(2))
    assert sched.pick_node(req(), strategy=SPREAD) == nids[2]


def test_node_affinity_hard_pins_and_raises():
    sched, nids = make_cluster()
    strat = NodeAffinitySchedulingStrategy(node_id=nids[2], soft=False)
    assert sched.pick_node(req(), strategy=strat) == nids[2]
    # infeasible on the pinned node -> hard affinity raises
    with pytest.raises(ValueError):
        sched.pick_node(req(64), strategy=strat)


def test_node_affinity_soft_falls_through():
    sched, nids = make_cluster(cpu_per_node=(4, 4, 64))
    strat = NodeAffinitySchedulingStrategy(node_id=nids[0], soft=True)
    # request no single-CPU node can ever host: soft affinity falls
    # through to the default policy, which finds the big node
    assert sched.pick_node(req(32), strategy=strat) == nids[2]


def test_infeasible_raises():
    sched, _ = make_cluster()
    with pytest.raises(ValueError):
        sched.pick_node(req(128))


# -------------------------------------------------------------- locality score


def test_locality_prefers_biggest_holder():
    sched, nids = make_cluster()
    locality = {nids[1]: 8 * MB, nids[2]: 2 * MB}
    # hybrid alone would pack onto node0; the holder of most arg bytes wins
    assert sched.pick_node(req(), locality=locality) == nids[1]


def test_locality_below_gate_is_ignored():
    sched, nids = make_cluster(locality_min_bytes=1 * MB)
    locality = {nids[2]: 64 * 1024}  # tiny args: cheaper to move than
    assert sched.pick_node(req(), locality=locality) == nids[0]  # to chase


def test_locality_weight_zero_disables():
    sched, nids = make_cluster(scheduler_locality_weight=0.0)
    locality = {nids[2]: 512 * MB}
    assert sched.pick_node(req(), locality=locality) == nids[0]


def test_locality_never_overrides_hard_affinity():
    sched, nids = make_cluster()
    strat = NodeAffinitySchedulingStrategy(node_id=nids[0], soft=False)
    locality = {nids[2]: 512 * MB}
    assert sched.pick_node(req(), strategy=strat,
                           locality=locality) == nids[0]


def test_locality_never_picks_infeasible_node():
    sched, nids = make_cluster(cpu_per_node=(8, 1, 8))
    # all the bytes sit on a node that can NEVER host a 4-CPU task
    locality = {nids[1]: 512 * MB}
    chosen = sched.pick_node(req(4), locality=locality)
    assert chosen != nids[1]


def test_saturated_holder_spills_back():
    sched, nids = make_cluster()
    sched.allocate(nids[1], req(4))  # holder at capacity: cannot fit
    locality = {nids[1]: 64 * MB}
    chosen = sched.pick_node(req(), locality=locality)
    assert chosen != nids[1]


def test_busy_holder_loses_to_idle_peer_on_queue_depth():
    depth = {}
    sched, nids = make_cluster(load_fn=lambda nid: depth.get(nid, 0))
    sched.allocate(nids[1], req(3.5))  # holder near-full and backlogged
    depth[nids[1]] = 100
    locality = {nids[1]: 4 * MB}
    # weighted score: bytes term (<= weight 1.0) loses to utilization
    # 0.875 + queue penalty ~0.96 — the transfer is cheaper than the wait
    assert sched.pick_node(req(), locality=locality) != nids[1]


def test_spread_ignores_locality():
    sched, nids = make_cluster()
    locality = {nids[0]: 512 * MB}
    sched.allocate(nids[0], req(1))
    # SPREAD is explicit anti-affinity: least-utilized wins regardless
    assert sched.pick_node(req(), strategy=SPREAD,
                           locality=locality) != nids[0]


def test_locality_counters_account_hits_misses_and_bytes():
    sched, nids = make_cluster()
    hits0 = sched._m_loc_hits.get()
    misses0 = sched._m_loc_misses.get()
    bytes0 = sched._m_loc_bytes.get()

    chosen = sched.pick_node(req(), locality={nids[1]: 8 * MB})
    assert chosen == nids[1]
    assert sched._m_loc_hits.get() == hits0 + 1
    assert sched._m_loc_bytes.get() == bytes0 + 8 * MB

    # hard affinity forces placement off the holder: a locality miss
    strat = NodeAffinitySchedulingStrategy(node_id=nids[0], soft=False)
    sched.pick_node(req(), strategy=strat, locality={nids[2]: 8 * MB})
    assert sched._m_loc_misses.get() == misses0 + 1
