"""Placement group tests (reference: python/ray/tests/test_placement_group*.py).

The PyTorch port's copy of ``tests/test_placement_group.py``: the same
cases run against ``ray_memory_management_tpu_torch``, with its own
fixtures (the shared conftest starts the JAX package's runtime).
"""

import os

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.utils import (
    PlacementGroupSchedulingStrategy,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def rmt_start_cluster():
    """3-node virtual cluster, 4 CPUs each."""
    rt = rmt.init(num_cpus=4, num_nodes=3)
    yield rt
    rmt.shutdown()


def test_pg_create_ready(rmt_start_cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert rmt.get(pg.ready(), timeout=30) is True
    assert pg.wait(10)
    table = placement_group_table()
    assert any(v["state"] == "CREATED" for v in table.values())


def test_pg_strict_spread_places_on_distinct_nodes(rmt_start_cluster):
    rt = rmt_start_cluster
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.wait(30)
    state = rt.pg_manager._groups[pg.id]
    nodes = {b.node_id for b in state.bundles}
    assert len(nodes) == 3


def test_pg_strict_pack_one_node(rmt_start_cluster):
    rt = rmt_start_cluster
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_PACK")
    assert pg.wait(30)
    state = rt.pg_manager._groups[pg.id]
    assert len({b.node_id for b in state.bundles}) == 1


def test_task_in_pg_bundle(rmt_start_cluster):
    rt = rmt_start_cluster
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.wait(30)
    state = rt.pg_manager._groups[pg.id]

    @rmt.remote
    def whereami():
        return os.environ["RMT_NODE_ID"]

    for idx in (0, 1):
        t = whereami.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=idx
            )
        )
        assert rmt.get(t.remote(), timeout=60) == state.bundles[idx].node_id.hex()


def test_actor_in_pg(rmt_start_cluster):
    rt = rmt_start_cluster
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(30)

    @rmt.remote
    class Who:
        def where(self):
            return os.environ["RMT_NODE_ID"]

    a = Who.options(num_cpus=1, placement_group=pg,
                    placement_group_bundle_index=0).remote()
    node_hex = rmt.get(a.where.remote(), timeout=60)
    state = rt.pg_manager._groups[pg.id]
    assert node_hex == state.bundles[0].node_id.hex()


def test_pg_reserves_resources(rmt_start_cluster):
    before = rmt.available_resources().get("CPU", 0)
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(30)
    after = rmt.available_resources().get("CPU", 0)
    assert after == before - 2
    remove_placement_group(pg)
    restored = rmt.available_resources().get("CPU", 0)
    assert restored == before


def test_pg_infeasible_stays_pending(rmt_start_cluster):
    pg = placement_group([{"CPU": 100}], strategy="PACK")
    assert not pg.wait(0.5)
    table = placement_group_table()
    assert table[pg.id.hex()]["state"] == "PENDING"
    remove_placement_group(pg)


def test_empty_bundle_rejected(rmt_start_cluster):
    with pytest.raises(rmt.RmtError):
        placement_group([{}], strategy="PACK")
