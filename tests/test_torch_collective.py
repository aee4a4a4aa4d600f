"""Collective layer tests: the dist backend on a gloo world of spawned
CPU ranks, the object-plane backend across real actor processes.

The PyTorch port's copy of ``tests/test_collective.py``. The JAX
package's mesh tests run every rank as one shard of a stacked array in
one process over 8 virtual devices; in the port one process is one rank,
so each mesh test sends a rank function to a live world of 4 processes
(``utils.local_world.LocalWorld``) and checks rank r's result where the
original checks row r. Counters are per process, so rank functions
report their own counter deltas. Tensors stand where the originals use
numpy arrays.
"""

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import collective as col
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld
from _port_fixtures import one_intra_op_thread  # noqa: F401

WORLD = 4


@pytest.fixture
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


# ---------------------------------------------------------------- dist / mesh
@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD) as w:
        yield w


def _mesh(rank, world, precision=None):
    return col.MeshCollectives(precision=precision)


def _quant_count(op: str, precision: str) -> float:
    from ray_memory_management_tpu_torch.core import metrics_defs as mdefs

    return mdefs.collective_quantized_ops().get(
        tags={"op": op, "precision": precision})


def _allreduce_full(rank, world):
    return _mesh(rank, world).allreduce(torch.full((4,), float(rank)))


def test_mesh_allreduce(world):
    outs = world.run(_allreduce_full)
    expect = torch.full((4,), float(sum(range(WORLD))))
    for out in outs:
        torch.testing.assert_close(out, expect)


def _allreduce_max(rank, world):
    return _mesh(rank, world).allreduce(torch.full((3,), float(rank)),
                                        col.ReduceOp.MAX)


def test_mesh_allreduce_max(world):
    out = world.run(_allreduce_max)
    torch.testing.assert_close(out[0], torch.full((3,), WORLD - 1.0))


def _reducescatter(rank, world):
    return _mesh(rank, world).reducescatter(
        torch.arange(world * 2, dtype=torch.float32) + rank)


def test_mesh_reducescatter(world):
    outs = world.run(_reducescatter)
    stacked = torch.stack([torch.arange(WORLD * 2, dtype=torch.float32) + i
                           for i in range(WORLD)])
    total = stacked.sum(dim=0)
    # rank r holds slice r of the elementwise sum
    for r in range(WORLD):
        torch.testing.assert_close(outs[r], total[r * 2:(r + 1) * 2])


def _allgather(rank, world):
    return _mesh(rank, world).allgather(torch.full((2,), float(rank)))


def test_mesh_allgather(world):
    stacked = torch.stack([torch.full((2,), float(i)) for i in range(WORLD)])
    for out in world.run(_allgather):
        torch.testing.assert_close(out, stacked)


def _broadcast(rank, world):
    return _mesh(rank, world).broadcast(torch.full((2,), float(rank)),
                                        root=3)


def test_mesh_broadcast(world):
    for out in world.run(_broadcast):
        torch.testing.assert_close(out, torch.full((2,), 3.0))


def _reduce_rooted(rank, world, root, op):
    return _mesh(rank, world).reduce(torch.full((4,), float(rank)),
                                     root_rank=root, op=op)


def test_mesh_reduce_rooted(world):
    """reduce is ROOTED (collective.py:311 semantics): only root's result
    holds the reduction; other ranks get their input back."""
    outs = world.run(_reduce_rooted, 2, col.ReduceOp.SUM)
    torch.testing.assert_close(outs[2],
                               torch.full((4,), float(sum(range(WORLD)))))
    for r in range(WORLD):
        if r != 2:
            torch.testing.assert_close(outs[r], torch.full((4,), float(r)))


def test_mesh_reduce_rooted_max(world):
    outs = world.run(_reduce_rooted, 0, col.ReduceOp.MAX)
    torch.testing.assert_close(outs[0], torch.full((4,), WORLD - 1.0))
    torch.testing.assert_close(outs[1], torch.full((4,), 1.0))


def _ppermute_ring(rank, world):
    perm = [(i, (i + 1) % world) for i in range(world)]
    return _mesh(rank, world).ppermute(torch.full((2,), float(rank)), perm)


def test_mesh_ppermute_ring(world):
    outs = world.run(_ppermute_ring)
    for r in range(WORLD):
        torch.testing.assert_close(outs[r],
                                   torch.full((2,), float((r - 1) % WORLD)))


def _barrier(rank, world):
    _mesh(rank, world).barrier()
    return True


def test_mesh_barrier(world):
    assert all(world.run(_barrier))  # must simply not hang


def _init_group_xla(rank, world):
    g = col.init_collective_group(world, rank, backend="xla",
                                  group_name="xla_t")
    seen = (col.is_group_initialized("xla_t"),
            col.get_collective_group_size("xla_t"), col.get_rank("xla_t"),
            type(g).__name__)
    col.destroy_collective_group("xla_t")
    return seen + (col.is_group_initialized("xla_t"),)


def test_init_collective_group_xla(world):
    """``xla`` is an alias of the dist backend: the group joins this
    process's torch.distributed world."""
    outs = world.run(_init_group_xla)
    for rank, out in enumerate(outs):
        assert out == (True, WORLD, rank, "MeshCollectives", False)


# ----------------------------------------------------------- objstore backend
@rmt.remote(max_concurrency=2)
class Rank(col.CollectiveGroupMixin):
    def __init__(self, rank, world):
        self.rank = rank
        self.world = world

    def do_allreduce(self, value):
        return col.allreduce(torch.full((4,), float(value)),
                             group_name="grp")

    def do_broadcast(self, value):
        return col.broadcast(torch.full((2,), float(value)), 0, "grp")

    def do_reducescatter(self, base):
        return col.reducescatter(
            torch.arange(self.world * 2, dtype=torch.float32) + base, "grp")

    def do_allreduce_q(self, value, precision):
        return col.allreduce(torch.full((4,), value) + 0.1,
                             group_name="grp", precision=precision)

    def do_sendrecv(self, value):
        if self.rank == 0:
            col.send(torch.full((2,), float(value)), 1, "grp")
            return None
        return col.recv(0, "grp")

    def do_barrier(self):
        col.barrier("grp")
        return True


@pytest.fixture
def rank_actors(rmt_start_regular):
    world = 3
    actors = [Rank.remote(i, world) for i in range(world)]
    col.create_collective_group(
        actors, world, list(range(world)), backend="objstore",
        group_name="grp",
    )
    return actors


def test_objstore_allreduce(rank_actors):
    outs = rmt.get([a.do_allreduce.remote(i + 1)
                    for i, a in enumerate(rank_actors)], timeout=120)
    for out in outs:
        torch.testing.assert_close(out, torch.full((4,), 6.0))


def test_objstore_broadcast(rank_actors):
    outs = rmt.get([a.do_broadcast.remote(i * 10)
                    for i, a in enumerate(rank_actors)], timeout=120)
    for out in outs:
        torch.testing.assert_close(out, torch.zeros(2))


def test_objstore_sendrecv(rank_actors):
    r0, r1 = rank_actors[0], rank_actors[1]
    out = rmt.get([r0.do_sendrecv.remote(5.0), r1.do_sendrecv.remote(0.0)],
                  timeout=120)
    torch.testing.assert_close(out[1], torch.full((2,), 5.0))


def test_objstore_barrier(rank_actors):
    assert all(rmt.get([a.do_barrier.remote() for a in rank_actors],
                       timeout=120))


def test_objstore_reducescatter(rank_actors):
    world = len(rank_actors)
    outs = rmt.get([a.do_reducescatter.remote(0.0) for a in rank_actors],
                   timeout=120)
    total = torch.arange(world * 2, dtype=torch.float32) * world
    chunks = torch.tensor_split(total, world, dim=0)
    for rank, out in enumerate(outs):
        torch.testing.assert_close(out, chunks[rank])


def _product(rank, world):
    t = torch.tensor([rank - 2.0, 1.0, 0.0])
    return _mesh(rank, world).allreduce(t, col.ReduceOp.PRODUCT)


def test_mesh_allreduce_product_with_zeros_and_negatives(world):
    outs = world.run(_product)
    expect = torch.stack([torch.tensor([i - 2.0, 1.0, 0.0])
                          for i in range(WORLD)]).prod(dim=0)
    for out in outs:
        torch.testing.assert_close(out, expect, rtol=1e-5, atol=0)


# ------------------------------------------------------- quantized precision
def _rows(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))


def _allreduce_q(rank, world, stacked, precision):
    before = _quant_count("allreduce", precision)
    out = _mesh(rank, world).allreduce(stacked[rank], precision=precision)
    return out, _quant_count("allreduce", precision) - before


@pytest.mark.parametrize("precision,tol", [("bf16", 2.0 ** -7),
                                           ("int8", 0.75 / 127.0)])
def test_mesh_allreduce_quantized_accuracy(world, precision, tol):
    """Sub-f32 allreduce: quantize-before-wire, f32 accumulation — the
    result must stay within the precision's error envelope (relative to
    the input absmax) and bump the quantized-ops counter."""
    stacked = _rows(21, (WORLD, 512))
    exact = stacked.sum(dim=0)
    absmax = float(stacked.abs().max())
    for out, counted in world.run(_allreduce_q, stacked, precision):
        assert counted == 1
        torch.testing.assert_close(out, exact, rtol=0,
                                   atol=WORLD * absmax * tol)


def _f32_exact(rank, world, stacked):
    g = _mesh(rank, world)
    before = _quant_count("allreduce", "f32")
    default = g.allreduce(stacked[rank])
    explicit = g.allreduce(stacked[rank], precision="f32")
    return default, explicit, _quant_count("allreduce", "f32") - before


def test_mesh_allreduce_f32_stays_bit_exact(world):
    stacked = _rows(22, (WORLD, 256))
    for default, explicit, counted in world.run(_f32_exact, stacked):
        assert torch.equal(default, explicit)  # the same program, bit-exact
        assert counted == 0  # f32 never counted


def _rs_q(rank, world, stacked):
    return _mesh(rank, world).reducescatter(stacked[rank], precision="int8")


def test_mesh_reducescatter_quantized(world):
    stacked = _rows(23, (WORLD, WORLD * 4))
    total = stacked.sum(dim=0)
    absmax = float(stacked.abs().max())
    outs = world.run(_rs_q, stacked)
    for r in range(WORLD):
        torch.testing.assert_close(outs[r], total[r * 4:(r + 1) * 4],
                                   rtol=0, atol=WORLD * absmax * 0.75 / 127.0)


def test_precision_precedence_chain():
    """per-call > group default > config.collective_precision > f32."""
    from ray_memory_management_tpu_torch.config import (
        Config, global_config, set_global_config,
    )

    assert col.resolve_precision("int8", "bf16") == "int8"
    assert col.resolve_precision(None, "bf16") == "bf16"
    prev = global_config()
    try:
        set_global_config(Config(collective_precision="int8"))
        assert col.resolve_precision(None, None) == "int8"
    finally:
        set_global_config(prev)
    assert col.resolve_precision(None, None) == "f32"
    with pytest.raises(ValueError):
        col.resolve_precision("fp4", None)


def _group_default(rank, world):
    g = _mesh(rank, world, precision="bf16")
    t = torch.full((4,), rank + 0.5)
    before = _quant_count("allreduce", "bf16")
    out = g.allreduce(t)
    after_default = _quant_count("allreduce", "bf16") - before
    exact = g.allreduce(t, precision="f32")
    return out, exact, after_default, \
        _quant_count("allreduce", "bf16") - before


def test_mesh_group_default_precision(world):
    """A group-level default applies when the call names none; a per-call
    precision= always wins over it."""
    expect = torch.full((4,), sum(i + 0.5 for i in range(WORLD)))
    out, exact, after_default, after_f32 = world.run(_group_default)[0]
    assert after_default == 1
    torch.testing.assert_close(out, expect, rtol=1e-2, atol=0)
    torch.testing.assert_close(exact, expect)
    assert after_f32 == 1  # the f32 call won


def test_objstore_allreduce_quantized(rank_actors):
    """The objstore backend carries the QUANTIZED payload across the
    object plane; dequantize+accumulate stays f32 on every rank."""
    outs = rmt.get([a.do_allreduce_q.remote(float(i + 1), "int8")
                    for i, a in enumerate(rank_actors)], timeout=120)
    expect = torch.full((4,), 1.1 + 2.1 + 3.1)
    for out in outs:
        torch.testing.assert_close(out, expect, rtol=0, atol=0.1)
