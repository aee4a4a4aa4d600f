"""Pod-scale control plane: memory-bounded directory,
delta-compressed heartbeats, leaf-lease batching, and the simulated
agent plane that drives them all through the real head code paths.

Unit layer: hot/cold spill + fault-in is bit-exact against an unbounded
control directory. Integration layer: SimNodeAgents speak the real wire
protocol — registration, lease_batch execution, pong deltas carrying
directory rows, gap -> resync convergence.

The PyTorch port's copy of ``tests/test_pod_scale.py``: the same cases
run against ``ray_memory_management_tpu_torch``.
"""

import os
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from ray_memory_management_tpu_torch.core.gcs import (
    GCS, resolve_directory_shards,
)
from ray_memory_management_tpu_torch.core.gcs_storage import InMemoryGcsStorage
from ray_memory_management_tpu_torch.ids import NodeID
from ray_memory_management_tpu_torch.utils.sim_agent import (
    SimNodeAgent, close_sim_agents, spawn_sim_agents,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401


# --- memory-bounded directory: bit-exact spill/fault round trip --------------

def _mk_oids(n, tag=b"pod"):
    return [tag + i.to_bytes(4, "big") + bytes(16 - len(tag) - 4)
            for i in range(n)]


def test_shard_resolution_clamps():
    cpus = os.cpu_count() or 4
    assert resolve_directory_shards(0) == max(4, min(64, cpus))
    assert resolve_directory_shards(0, max_shards=8) == max(4, min(8, cpus))
    assert resolve_directory_shards(12) == 12  # explicit counts win


def test_cold_spill_then_locate_is_bit_exact():
    """Every locate against the bounded directory must answer exactly
    what an UNBOUNDED control directory answers — spilling and faulting
    are invisible to readers (sizes, holder sets, tier maps)."""
    control = GCS(InMemoryGcsStorage(), directory_shards=4)
    bounded = GCS(InMemoryGcsStorage(), directory_shards=4,
                  hot_max_rows=64, cold_s=0.0)
    nodes = [NodeID(bytes([i]) * 16) for i in range(3)]
    oids = _mk_oids(2000)
    for i, oid in enumerate(oids):
        for g in (control, bounded):
            g.add_object_location(oid, nodes[i % 3], size=100 + i)
            if i % 5 == 0:
                g.add_object_location(oid, nodes[(i + 1) % 3],
                                      size=100 + i, tier="hbm")
    stats = bounded.directory_stats()
    assert stats["cold"] > 0, "cap never engaged"
    assert stats["hot"] <= 4 * 16 + 4 * 64  # per-shard cap + spill slack
    want = control.locate_objects(oids)
    got = bounded.locate_objects(oids)
    assert set(want) == set(got)
    for oid in want:
        ws, wh, wt = want[oid]
        gs, gh, gt = got[oid]
        assert (ws, set(wh), wt) == (gs, set(gh), gt), oid.hex()
    # a full sweep faulted rows in; the cap must still hold after it
    assert bounded.directory_stats()["hot"] <= 4 * 16 + 4 * 64
    assert mdefs.gcs_directory_faults().get() > 0
    assert sorted(bounded.directory_keys()) == sorted(control.directory_keys())


def test_cold_rows_survive_node_scrub_and_reconcile():
    """drop_node_objects must scrub holders inside COLD batches, and
    reconcile_node_rows must drop hot rows a full resync no longer
    asserts."""
    g = GCS(InMemoryGcsStorage(), directory_shards=4,
            hot_max_rows=64, cold_s=0.0)
    a, b = NodeID(b"a" * 16), NodeID(b"b" * 16)
    oids = _mk_oids(1000)
    for oid in oids:
        g.add_object_location(oid, a, size=8)
    for oid in oids[:100]:
        g.add_object_location(oid, b, size=8)
    assert g.directory_stats()["cold"] > 0
    g.drop_node_objects(a)
    located = g.locate_objects(oids)
    assert set(located) == set(oids[:100])  # b-held rows only
    assert all(a not in locs for _, locs, _ in located.values())
    # resync reconciliation: b now asserts only half its rows. Every row
    # naming b outside the held set drops — hot immediately, cold via an
    # in-place batch scrub (else a later fault-in would resurrect stale
    # holders) — and held rows are NEVER touched.
    held = {oid: 8 for oid in oids[:50]}
    g.reconcile_node_rows(b, held)
    assert set(g.locate_objects(oids[:50])) == set(oids[:50])
    located = g.locate_objects(oids)  # faults every surviving row hot
    stale = [oid for oid, (_, locs, _) in located.items()
             if b in locs and oid not in held]
    assert stale == []
    assert set(located) == set(oids[:50])


def test_job_tagged_rows_stay_hot():
    """Job-death sweeps walk rows by tag and must never fault the cold
    tier in: job-tagged rows are pinned RAM-resident."""
    g = GCS(InMemoryGcsStorage(), directory_shards=4,
            hot_max_rows=64, cold_s=0.0)
    n = NodeID(b"j" * 16)
    job = b"job0"
    tagged = _mk_oids(100, tag=b"tag")
    for oid in tagged:
        g.add_object_location(oid, n, size=8, job=job)
    for oid in _mk_oids(1000):
        g.add_object_location(oid, n, size=8)
    assert g.directory_stats()["cold"] > 0
    for sh in g._shards:
        with sh.lock:
            assert not (set(tagged) & set(sh.cold))


# --- sim agent plane ---------------------------------------------------------

@pytest.fixture
def sim_cluster():
    rt = rmt.init(num_cpus=2, object_store_memory=1 << 27)
    agents = spawn_sim_agents(rt, 4, num_cpus=2)
    yield rt, agents
    close_sim_agents(agents)
    rmt.shutdown()


def test_sim_agents_register_and_run_leaf_tasks(sim_cluster):
    """Sim nodes join through the real handshake and execute real leaf
    tasks inline, settling through the genuine done path."""
    rt, agents = sim_cluster
    assert len(rt.gcs.nodes) == 5  # local node + 4 sims

    @rmt.remote(max_retries=0)
    def add(x, y):
        return x + y

    vals = rmt.get([add.remote(i, i) for i in range(200)], timeout=120)
    assert vals == [2 * i for i in range(200)]
    assert sum(a.tasks_run for a in agents) > 0, \
        "no task ever routed to the sim plane"
    assert not [e for a in agents for e in a.errors]


def test_lease_batches_coalesce_on_the_wire(sim_cluster):
    """A burst of leaf tasks must ship as lease_batch frames (O(1) frame
    per node per pump pass), not one lease_exec per task."""
    rt, agents = sim_cluster
    before = mdefs.leaf_lease_batches().get()

    @rmt.remote(max_retries=0)
    def noop():
        return 1

    assert sum(rmt.get([noop.remote() for _ in range(300)],
                       timeout=120)) == 300
    assert mdefs.leaf_lease_batches().get() > before


def test_pong_deltas_carry_rows_and_converge(sim_cluster):
    """Synthetic rows asserted agent-side arrive via pong deltas; churn
    ships O(changes); a forced seq gap resyncs via one full pong with no
    lost holder updates."""
    rt, agents = sim_cluster
    for a in agents:
        a.add_rows(250)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if rt.gcs.directory_stats()["hot"] >= 1000:
            break
        time.sleep(0.1)
    assert rt.gcs.directory_stats()["hot"] >= 1000
    assert sum(a.pongs_full for a in agents) == 0, \
        "steady-state ingress regressed to full pongs"

    # churn: the delta plane ships ~2x the churned count, not the table
    shipped = sum(a.rows_shipped for a in agents)
    for a in agents:
        a.churn_rows(10)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if sum(a.rows_shipped for a in agents) >= shipped + 80:
            break
        time.sleep(0.1)
    churn_shipped = sum(a.rows_shipped for a in agents) - shipped
    assert 80 <= churn_shipped <= 200, churn_shipped

    # gap: agent 0 burns a seq; the head must latch a resync, the agent
    # answers with full state, and the directory still matches exactly
    resyncs = mdefs.heartbeat_resyncs().get()
    agents[0].force_gap()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if agents[0].pongs_full > 0:
            break
        time.sleep(0.1)
    assert agents[0].pongs_full > 0
    assert mdefs.heartbeat_resyncs().get() > resyncs
    time.sleep(1.0)  # let the full pong land and reconcile
    held = set()
    with agents[0]._mu:
        held = set(agents[0]._rows)
    nid = NodeID(agents[0].node_id)
    located = rt.gcs.locate_objects(list(held))
    assert set(located) == held
    assert all(nid in locs for _, locs, _ in located.values())
