"""The port's parallel library against the JAX package's, strategy by
strategy.

- Placements: the port's ``param_pspecs`` on a DeviceMesh gives, leaf by
  leaf, the DTensor placements of the JAX ``param_pspecs``'
  PartitionSpecs (``Shard(d)`` on the mesh dim that tensor dim d names,
  ``Replicate()`` elsewhere), for the ``test`` preset and every strategy;
  the expert-parallel rules (``test-moe``, ``ep``/``ep+tp``) give the
  JAX specs too, though ep trains only with the MoE port.
- Training: 4 Adam(1e-3) steps of the ``test`` preset in fp32 from the
  JAX package's initial weights (carried across by ``models/convert.py``)
  on a gloo world of 4 ranks (dp 4, fsdp 4, tp 4, fsdp 2 x tp 2) against
  the JAX ``make_train_step`` over a ``cpu_mesh`` with the same axes:
  each step's loss to 1e-4 relative. The same holds (dp 4, fsdp 4) when
  each rank passes only its own rows of the global batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.parallel import (
    cpu_mesh, make_train_step, param_pspecs, shard_pytree,
)
from ray_memory_management_tpu_torch.parallel.sharding import param_specs
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld

WORLD = 4
STRATEGIES = [
    ("dp", {"dp": 4}),
    ("fsdp", {"fsdp": 4}),
    ("tp", {"tp": 4}),
    ("fsdp+tp", {"fsdp": 2, "tp": 2}),
]
STEPS = 4


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                              cfg.vocab_size)
    batch = {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}
    as_np = jax.tree.map(np.asarray, params)
    return cfg, params, batch, as_np, jax.tree.map(np.asarray, batch)


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD) as w:
        yield w


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _jax_spec(spec, ndim):
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(e if not isinstance(e, tuple) or len(e) != 1 else e[0]
                 for e in entries)


def _placements_of(spec, names):
    """The DTensor placements a JAX spec stands for on a mesh whose dims
    are ``names`` (written here independently of the port's own
    conversion)."""
    out = []
    for name in names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(f"S({dims[0]})" if dims else "R")
    return tuple(out)


def _port_placements(rank, world, params_np, strategy, axes):
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax,
    )
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, param_pspecs,
    )

    params = params_from_jax(params_np, device="cpu")
    mesh = cpu_mesh(axes)
    specs = param_pspecs(params, mesh, strategy)

    def show(p):
        return f"S({p.dim})" if p.is_shard() else "R"

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return tuple(show(p) for p in node)

    return tuple(mesh.mesh_dim_names), walk(specs)


@pytest.mark.parametrize("strategy,axes", STRATEGIES)
def test_placements_match_jax_partition_specs(setup, world, strategy,
                                              axes):
    _, params, _, params_np, _ = setup
    jspecs = param_pspecs(params, cpu_mesh(axes), strategy)
    names, port = world.run(_port_placements, params_np, strategy, axes)[0]
    want = dict(_leaves(jspecs))
    got = dict(_leaves(port))
    assert set(got) == set(want)
    shapes = dict(_leaves(params_np))
    for path, spec in want.items():
        expect = _placements_of(_jax_spec(spec, shapes[path].ndim), names)
        assert got[path] == expect, (path, spec, got[path])


@pytest.mark.parametrize("strategy,axes", [
    ("ep", {"dp": 2, "ep": 4}), ("ep+tp", {"ep": 2, "tp": 4}),
    ("fsdp+tp", {"fsdp": 2, "tp": 4})])
def test_expert_parallel_specs_match_jax(strategy, axes):
    """The MoE rules (expert dim over ep, Megatron tp within each expert)
    are ported with the table: their specs equal the JAX ones for the
    ``test-moe`` preset, whose shapes the port takes from the JAX tree."""
    cfg = jgpt.PRESETS["test-moe"]
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    jspecs = dict(_leaves(param_pspecs(params, cpu_mesh(axes), strategy)))
    port = dict(_leaves(param_specs(jax.tree.map(np.asarray, params), axes,
                                    strategy)))
    shapes = dict(_leaves(params))
    assert set(port) == set(jspecs)
    for path, spec in jspecs.items():
        assert port[path] == _jax_spec(spec, shapes[path].ndim), path


def _port_losses(rank, world, params_np, batch_np, strategy, axes,
                 own_rows=False):
    import dataclasses

    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax,
    )
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, make_train_step, param_pspecs, shard_pytree,
    )

    cfg = dataclasses.replace(gpt.PRESETS["test"], dtype=torch.float32)
    params = params_from_jax(params_np, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    mesh = cpu_mesh(axes)
    if own_rows:
        # this rank's rows only, as a data-parallel loop holds them
        from torch.distributed.tensor import DTensor

        from ray_memory_management_tpu_torch.parallel import batch_pspec

        rows = len(batch["tokens"]) // world
        batch = {k: DTensor.from_local(v[rank * rows:(rank + 1) * rows],
                                       mesh, batch_pspec(mesh))
                 for k, v in batch.items()}
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, strategy))
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    step = make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg), opt, mesh)
    return [float(step(sp, batch)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_losses(setup):
    """The JAX step's losses for a strategy, computed once per module:
    the own-rows cases reuse the strategy cases' runs."""
    runs = {}

    def losses(strategy, axes):
        if strategy not in runs:
            runs[strategy] = _jax_losses(setup, strategy, axes)
        return runs[strategy]
    return losses


def _jax_losses(setup, strategy, axes):
    cfg, params, batch, _, _ = setup
    mesh = cpu_mesh(axes)
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, strategy),
                      copy=True)
    opt = optax.adam(1e-3)
    step = make_train_step(lambda p, b: jgpt.loss_fn(p, b, cfg), opt, mesh)
    want, p, s = [], sp, opt.init(sp)
    for _ in range(STEPS):
        p, s, loss = step(p, s, batch)
        want.append(float(loss))
    return want


@pytest.mark.parametrize("strategy,axes", STRATEGIES)
def test_strategy_losses_match_jax(setup, jax_losses, world, strategy,
                                   axes):
    want = jax_losses(strategy, axes)
    ranks = world.run(_port_losses, setup[3], setup[4], strategy, axes)
    for got in ranks:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert want[-1] < want[0]


@pytest.mark.parametrize("strategy,axes", STRATEGIES[:2])
def test_own_rows_match_jax_on_the_global_batch(setup, jax_losses, world,
                                                strategy, axes):
    """Each rank passes only its own rows (a DTensor over the data axis):
    the losses are the JAX step's on the concatenated global batch."""
    want = jax_losses(strategy, axes)
    ranks = world.run(_port_losses, setup[3], setup[4], strategy, axes,
                      True)
    for got in ranks:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
