"""Tier-affine replica placement (ROADMAP C4), held in the port.

A deployment with a ``placement_hint`` (the hex id of, say, its shipped
weights) should start its replica on the node that holds that object,
a device copy before a host copy. The serve controller reads the holders
with ``state.list_objects`` from inside its worker. The JAX package's
controller cannot: its state API needs the runtime, which a worker does
not hold, so the lookup raises and placement falls back to "default";
it also ranks on a ``tier`` key where the rows' own field is ``where``,
and it pins the replica to the holder's hex id, which never equals the
scheduler's ``NodeID`` (soft affinity then places it anywhere). The
port's state API answers in a worker through the worker's channel to the
head, the controller ranks ``where == "device"`` first and pins the
holder's ``NodeID``.

The same program runs through both packages: two nodes, the hinted
object held only on the second. The port's replica lands there and
``rmt_serve_replica_placements_total{mode="tier_affine"}`` counts it;
the JAX package's counts ``mode="default"`` only.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_memory_management_tpu as jrmt
import ray_memory_management_tpu_torch as rmt


def _placements(mdefs):
    """{mode: count} of the placement counter in this (head) process."""
    out = {}
    for tags, v in mdefs.serve_replica_placements().series().items():
        mode = dict(tags).get("mode")
        out[mode] = out.get(mode, 0.0) + v
    return out


def _run_program(pkg, serve, mdefs, rt, second, device_copy):
    """On a runtime of two nodes: an actor on the second puts the hinted
    object there (in its device tier when ``device_copy``, else its shm
    store); a hinted one-replica deployment reports the node its replica
    runs on. Returns (the replica's node hex id, placement counts added
    by this program)."""
    from importlib import import_module

    strategies = import_module(
        f"{pkg.__name__}.core.scheduling_strategies")

    class Holder:
        def pin(self, on_device):
            if on_device:
                import torch as _torch

                self.ref = pkg.put(_torch.ones(1 << 16), device=True)
            else:
                import numpy as _np

                self.ref = pkg.put(_np.ones(1 << 16))  # 512 KiB: shm
            return self.ref.hex()

    holder = pkg.remote(Holder).options(
        num_cpus=0,
        scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
            second, soft=False)).remote()
    hint = pkg.get(holder.pin.remote(device_copy), timeout=120)

    class WhereAmI:
        def __call__(self, _request=None):
            import os as _os

            return _os.environ["RMT_NODE_ID"]

    before = _placements(mdefs)
    serve.start(http_port=None)
    try:
        handle = serve.run(serve.deployment(
            WhereAmI, name="where", placement_hint=hint).bind())
        home = pkg.get(handle.remote(None), timeout=120)
        # the controller's worker ships its counter deltas on the
        # flush tick: wait for the placement to reach the head
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            added = {m: v - before.get(m, 0.0)
                     for m, v in _placements(mdefs).items()
                     if v - before.get(m, 0.0) > 0}
            if added:
                break
            time.sleep(0.2)
    finally:
        serve.shutdown()
        pkg.kill(holder)
    return home, added


@pytest.fixture(scope="module")
def two_nodes():
    """One port runtime of two nodes for the module's port cases."""
    rt = rmt.init(num_cpus=2)
    try:
        yield rt, rt.add_node({"num_cpus": 2})
    finally:
        rmt.shutdown()


@pytest.mark.parametrize("device_copy", [True, False],
                         ids=["device-copy", "host-copy"])
def test_port_places_the_replica_on_the_holder(two_nodes, device_copy):
    from ray_memory_management_tpu_torch import serve
    from ray_memory_management_tpu_torch.core import metrics_defs as mdefs

    rt, second = two_nodes
    home, added = _run_program(rmt, serve, mdefs, rt, second, device_copy)
    assert home == second.hex()
    assert added == {"tier_affine": 1.0}, added


def test_jax_package_controller_still_falls_back_to_default():
    from ray_memory_management_tpu import serve
    from ray_memory_management_tpu.core import metrics_defs as mdefs

    rt = jrmt.init(num_cpus=2)
    try:
        _home, added = _run_program(jrmt, serve, mdefs, rt,
                                    rt.add_node({"num_cpus": 2}), False)
    finally:
        jrmt.shutdown()
    assert added == {"default": 1.0}, added


def test_device_copy_ranks_before_a_host_copy():
    from ray_memory_management_tpu_torch.serve.controller import (
        rank_holders,
    )

    rows = [
        {"object_id": "ab", "where": "store", "node_id": "host-node"},
        {"object_id": "ab", "where": "memory_store", "node_id": None},
        {"object_id": "ab", "where": "device", "node_id": "card-node"},
        {"object_id": "ab", "where": "spilled", "node_id": "disk-node"},
    ]
    assert [r["node_id"] for r in rank_holders(rows)] == [
        "card-node", "host-node", "disk-node"]


def test_state_api_answers_inside_a_worker(two_nodes):
    """The channel the controller uses: a task's ``list_objects`` and
    ``list_nodes`` equal the driver's."""
    from ray_memory_management_tpu_torch import state

    ref = rmt.put(np.arange(1 << 16, dtype=np.float64))

    @rmt.remote
    def look(hex_id):
        from ray_memory_management_tpu_torch import state as st

        return (st.list_objects(filters=[("object_id", "=", hex_id)]),
                st.list_nodes())

    rows, nodes = rmt.get(look.remote(ref.hex()), timeout=120)
    assert rows == state.list_objects(
        filters=[("object_id", "=", ref.hex())])
    assert rows and rows[0]["where"] == "store"
    assert nodes == state.list_nodes() and len(nodes) == 2


def test_worker_demand_reaches_the_head_autoscaler(two_nodes):
    """``request_resources`` from a worker (the serve controller's
    ``_pin_demand``) lands in the head's demand set."""
    from ray_memory_management_tpu_torch.autoscaler import (
        request_resources, requested_bundles,
    )

    @rmt.remote
    def ask():
        from ray_memory_management_tpu_torch.autoscaler import (
            request_resources as _req,
        )

        _req([{"GPU": 1.0}] * 2)
        return os.getpid()

    try:
        assert rmt.get(ask.remote(), timeout=120) != os.getpid()
        assert requested_bundles() == [{"GPU": 1.0}] * 2
    finally:
        request_resources([])


def test_device_copy_is_listed_as_device(two_nodes):
    """``list_objects`` reports a device-tier copy as ``where="device"``
    on the node of the worker that pinned it."""
    from ray_memory_management_tpu_torch import state

    class Pin:
        def pin(self):
            self.ref = rmt.put(torch.ones(1024), device=True)
            return self.ref.hex(), os.environ["RMT_NODE_ID"]

    actor = rmt.remote(Pin).options(num_cpus=0).remote()
    hex_id, node = rmt.get(actor.pin.remote(), timeout=120)
    rows = state.list_objects(filters=[("object_id", "=", hex_id)])
    assert [(r["where"], r["node_id"]) for r in rows] == [("device", node)]
    rmt.kill(actor)
