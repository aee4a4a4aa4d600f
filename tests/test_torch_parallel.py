"""Parallelism tests: DP/FSDP/TP training on a gloo world of 4 CPU ranks.

The PyTorch port's copy of ``tests/test_parallel.py``'s strategy cases
(``test_strategy_trains`` for each strategy, ``test_strategies_agree``,
``test_tp_param_sharding_applied``). The JAX package's meshes take 8 (4
for tp) virtual devices of one process; the port's DeviceMesh takes one
process per rank, so each case runs on a live world of 4 spawned ranks
(``utils.local_world.LocalWorld``) with the strategies' meshes at 4
ranks: dp 4, fsdp 4, tp 4 and fsdp 2 x tp 2. Ring attention, the
pipeline, expert parallelism and the graft entry points wait for the
port of sequence, expert and pipeline parallelism.
"""

import pytest

from ray_memory_management_tpu_torch.utils.local_world import LocalWorld

WORLD = 4
STRATEGIES = [
    ("dp", {"dp": 4}),
    ("fsdp", {"fsdp": 4}),
    ("tp", {"tp": 4}),
    ("fsdp+tp", {"fsdp": 2, "tp": 2}),
]


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD) as w:
        yield w


def _setup():
    import torch

    from ray_memory_management_tpu_torch.models import gpt

    cfg = gpt.PRESETS["test"]
    gen = torch.Generator().manual_seed(0)
    params = gpt.init_params(cfg, gen, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    return cfg, params, batch


def _train(rank, world, strategy, axes, steps):
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, make_train_step, param_pspecs, shard_pytree,
    )

    cfg, params, batch = _setup()
    mesh = cpu_mesh(axes)
    specs = param_pspecs(params, mesh, strategy)
    sp = shard_pytree(params, mesh, specs)
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    step = make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg), opt, mesh)
    return [float(step(sp, batch)) for _ in range(steps)]


@pytest.mark.parametrize("strategy,axes", STRATEGIES)
def test_strategy_trains(world, strategy, axes):
    losses = world.run(_train, strategy, axes, 4)
    assert all(r == losses[0] for r in losses)  # every rank, one loss
    losses = losses[0]
    assert losses[-1] < losses[0], f"{strategy}: {losses}"


def test_strategies_agree(world):
    """One step of dp and tp must produce (numerically) the same loss."""
    results = {}
    for strategy, axes in [("dp", {"dp": 4}), ("tp", {"tp": 4})]:
        results[strategy] = world.run(_train, strategy, axes, 1)[0][0]
    assert abs(results["dp"] - results["tp"]) < 5e-2, results


def _train_own_batch(rank, world, strategy, axes):
    """One step where each rank passes a batch of its own."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, make_train_step, param_pspecs, shard_pytree,
    )

    cfg, params, batch = _setup()
    batch = {k: (v + rank) % cfg.vocab_size for k, v in batch.items()}
    mesh = cpu_mesh(axes)
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, strategy))
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    step = make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg), opt, mesh)
    try:
        step(sp, batch)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("strategy,axes", [("dp", {"dp": 4}),
                                           ("fsdp", {"fsdp": 4})])
def test_different_batches_raise(world, strategy, axes):
    """The step takes the global batch: a rank whose full batch differs
    from the others' is refused on every rank, not cut to rank 0's."""
    for msg in world.run(_train_own_batch, strategy, axes):
        assert msg is not None and "different batches" in msg


def _tp_shard_shape(rank, world):
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, param_pspecs, shard_pytree,
    )

    _, params, _ = _setup()
    mesh = cpu_mesh({"tp": 4})
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, "tp"))
    wq = sp["layers"]["wq"]
    return tuple(wq.to_local().shape), tuple(wq.shape)


def test_tp_param_sharding_applied(world):
    for local, full in world.run(_tp_shard_shape):
        # column-parallel wq: output dim sharded 4-ways
        assert local[-1] == full[-1] // 4
        assert local[:-1] == full[:-1]

