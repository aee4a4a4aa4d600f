"""The port's dist collectives against the JAX package's, row by row.

The same inputs, drawn with numpy from a seed, go through the JAX
package's ``MeshCollectives`` over 4 CPU devices (one process, rank i
is row i of a stacked array) and through the port's ``MeshCollectives``
on a gloo world of 4 spawned ranks (rank i holds row i). Rank i's result
must equal row i of the JAX result: f32 to 1e-6 relative (exactly, on
integer-valued data), bf16 and int8 within the JAX test's envelopes
(world x absmax x 2^-7 and world x absmax x 0.75/127,
``tests/test_collective.py:222-223``), both against the JAX result and
against the exact reduction.
"""

import jax
import numpy as np
import pytest
import torch

from ray_memory_management_tpu.collective.mesh_group import (
    MeshCollectives as JaxMeshCollectives,
)
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld

WORLD = 4
N = 512
TOL = {"bf16": 2.0 ** -7, "int8": 0.75 / 127.0}
REDUCTIONS = [(op, red, p) for op in ("allreduce", "reducescatter", "reduce")
              for red in ("sum", "max", "min", "product")
              for p in ("f32", "bf16", "int8")
              if op == "allreduce" or red in ("sum", "max")]
MOVES = [("allgather", None, "f32"), ("broadcast", None, "f32"),
         ("ppermute", None, "f32"), ("send_recv", None, "f32")]
CASES = REDUCTIONS + MOVES
ROOT = 1
PERM = [(i, (i + 1) % WORLD) for i in range(WORLD)]


def _inputs():
    rng = np.random.default_rng(7)
    return {
        "normal": rng.standard_normal((WORLD, N)).astype(np.float32),
        # exact in f32 whatever the order of the sums
        "integer": rng.integers(-50, 50, (WORLD, N)).astype(np.float32),
    }


def _port_call(g, op, red, p, t):
    if op == "allreduce":
        return g.allreduce(t, red, precision=p)
    if op == "reducescatter":
        return g.reducescatter(t, red, precision=p)
    if op == "reduce":
        return g.reduce(t, ROOT, red, precision=p)
    if op == "allgather":
        return g.allgather(t)
    if op == "broadcast":
        return g.broadcast(t, root=ROOT)
    if op == "ppermute":
        return g.ppermute(t, PERM)
    return g.send_recv(t, 0, WORLD - 1)


def _port_battery(rank, world, inputs, cases):
    from ray_memory_management_tpu_torch.collective import MeshCollectives

    g = MeshCollectives()
    t = torch.from_numpy(inputs["normal"][rank])
    out = {case: _port_call(g, *case, t).numpy() for case in cases}
    out["integer"] = g.allreduce(
        torch.from_numpy(inputs["integer"][rank])).numpy()
    return out


@pytest.fixture(scope="module")
def port_results():
    inputs = _inputs()
    with LocalWorld(WORLD) as world:
        return inputs, world.run(_port_battery, inputs, CASES)


@pytest.fixture(scope="module")
def jax_group():
    return JaxMeshCollectives(jax.devices("cpu")[:WORLD])


def _jax_call(g, op, red, p, stacked):
    if op == "allreduce":
        return g.allreduce(stacked, red, precision=p)
    if op == "reducescatter":
        return g.reducescatter(stacked, red, precision=p)
    if op == "reduce":
        return g.reduce(stacked, ROOT, red, precision=p)
    if op == "allgather":
        return g.allgather(stacked)
    if op == "broadcast":
        return g.broadcast(stacked, root=ROOT)
    if op == "ppermute":
        return g.ppermute(stacked, PERM)
    return g.send_recv(stacked, 0, WORLD - 1)


def _exact(op, red, stacked):
    reducer = {"sum": np.sum, "max": np.max, "min": np.min,
               "product": np.prod}[red]
    full = reducer(stacked.astype(np.float64), axis=0)
    n = stacked.shape[1] // WORLD
    if op == "allreduce":
        return np.stack([full] * WORLD)
    if op == "reducescatter":
        return np.stack([full[r * n:(r + 1) * n] for r in range(WORLD)])
    rows = [full if r == ROOT else stacked[r] for r in range(WORLD)]
    return np.stack(rows)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c if x))
def test_collective_matches_jax_row_by_row(port_results, jax_group, case):
    inputs, ranks = port_results
    op, red, p = case
    stacked = inputs["normal"]
    want = np.asarray(_jax_call(jax_group, op, red, p, stacked))
    if op == "allgather":
        want = np.stack([want] * WORLD)  # every rank holds the stack
    got = np.stack([ranks[r][case] for r in range(WORLD)])
    assert got.shape == want.shape, (got.shape, want.shape)
    if p == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
        return
    # a quantized reduction of normal data: the JAX envelope around
    # both the JAX result and the exact one
    span = red == "product" and WORLD * float(
        np.abs(stacked).max()) ** (WORLD - 1) or WORLD
    atol = span * float(np.abs(stacked).max()) * TOL[p]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got, _exact(op, red, stacked), rtol=0,
                               atol=atol)


def test_f32_allreduce_exact_on_integer_data(port_results, jax_group):
    inputs, ranks = port_results
    want = np.asarray(jax_group.allreduce(inputs["integer"]))
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["integer"], want[r])
    np.testing.assert_array_equal(want[0], inputs["integer"].sum(axis=0))


def test_int8_blocks_match_the_jax_quantizer():
    """The port's block quantizer is the JAX ``_dequant_stack`` math:
    the same int8 codes and scales for a padded, multi-block input."""
    import jax.numpy as jnp

    from ray_memory_management_tpu_torch.collective.mesh_group import (
        quantize_blocks,
    )

    x = np.random.default_rng(3).standard_normal(700).astype(np.float32)
    x[256:512] = 0.0  # an all-zero block keeps scale 0 and codes 0
    q, scale = quantize_blocks(torch.from_numpy(x))
    flat = jnp.asarray(x)
    padded = jnp.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)
    jscale = jnp.max(jnp.abs(padded), axis=1, keepdims=True) / 127.0
    safe = jnp.where(jscale == 0.0, 1.0, jscale)
    jq = jnp.clip(jnp.round(padded / safe), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
