"""PyTorch port vs JAX package: the vision models' data-parallel train
steps, on a gloo world of 4 spawned ranks (one ``LocalWorld``, 120 s
deadline a call), on the CPU.

Under ``jit`` the JAX ResNet step over a dp-sharded batch has the
semantics of the unsharded program, so its BatchNorm statistics are those
of the GLOBAL batch. The port's ``make_resnet_train_step(model, opt,
mesh)`` must give the same: each rank runs its rows with the statistics'
sums all-reduced over dp. From the flax weights in fp32, two SGD(0.1,
momentum 0.9) steps on a batch of 8 over dp 4: the losses to 1e-5
relative and the new running statistics to 1e-4 of each array's largest
value, against ``make_resnet_train_step(..., mesh)`` on the conftest's CPU
devices; per-rank statistics (DDP's) would differ from them. The same
over two data axes, dp 2 x fsdp 2, where the JAX steps shard the batch
over both (``batch_pspec``) and keep the parameters replicated. Copied
from ``tests/test_models.py``: ``TestViT::test_dp_sharded_step``, whose
loss is also held against the JAX step's, and over dp 2 x fsdp 2 too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_memory_management_tpu.models import resnet as jresnet
from ray_memory_management_tpu.models import vit as jvit
from ray_memory_management_tpu.parallel import cpu_mesh
from ray_memory_management_tpu_torch.models.convert import (
    resnet_state_from_flax,
)
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld
from _port_fixtures import one_intra_op_thread  # noqa: F401

WORLD = 4
STEPS = 2
DP = {"dp": WORLD}
DP_FSDP = {"dp": 2, "fsdp": 2}


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD, timeout_s=120) as w:
        yield w


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, 8)}


def _port_resnet(rank, world, state, batch_np, axes):
    """``STEPS`` steps over a mesh of ``axes`` (dp 4, or dp 2 x fsdp 2,
    whose rank r holds the batch's r-th quarter too) of the fp32
    resnet18_like from ``state``: (losses, the new statistics, this
    rank's rows' own statistics)."""
    import copy

    import torch

    from ray_memory_management_tpu_torch.models import resnet
    from ray_memory_management_tpu_torch.parallel import cpu_mesh

    model = resnet.ResNet((1, 1, 1, 1), 10, torch.float32)
    model.load_state_dict(state, strict=True)
    batch = {"image": torch.from_numpy(batch_np["image"]).permute(
        0, 3, 1, 2).contiguous(),
        "label": torch.from_numpy(batch_np["label"])}
    alone = copy.deepcopy(model)
    rows = {k: v.chunk(world)[rank] for k, v in batch.items()}
    _, own = resnet.resnet_loss_fn(alone, rows)
    mesh = cpu_mesh(axes)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = resnet.make_resnet_train_step(model, opt, mesh)
    losses = [float(step(batch)) for _ in range(STEPS)]
    stats = {k: v.numpy() for k, v in resnet.batch_stats(model).items()}
    return losses, stats, {k: v.numpy() for k, v in own.items()}


def test_resnet_dp_step_takes_global_batch_statistics(world):
    _resnet_takes_global_batch_statistics(world, DP)


def test_resnet_dp_fsdp_step_takes_global_batch_statistics(world):
    """Over dp 2 x fsdp 2 the statistics are summed over both axes: still
    the global batch's."""
    _resnet_takes_global_batch_statistics(world, DP_FSDP)


def _resnet_takes_global_batch_statistics(world, axes):
    model = jresnet.ResNet((1, 1, 1, 1), 10, jnp.float32)
    params, stats = jax.jit(lambda key: jresnet.init_resnet(
        model, key, (32, 32, 3)))(jax.random.PRNGKey(0))
    state = resnet_state_from_flax(jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, stats))
    batch = _batch(0)
    mesh = cpu_mesh(axes)
    opt = optax.sgd(0.1, momentum=0.9)
    step = jresnet.make_resnet_train_step(model, opt, mesh)
    p, s, o = params, stats, opt.init(params)
    want_losses = []
    for _ in range(STEPS):
        p, s, o, loss = step(p, s, o, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        want_losses.append(float(loss))
    want = resnet_state_from_flax({}, jax.tree.map(np.asarray, s))
    whole = _first_step_stats(state, batch)
    for losses, got, own in world.run(_port_resnet, state, batch, axes):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        assert set(got) == set(want)
        for name, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(got[name], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        # one rank's rows alone give other statistics than the whole
        # batch: the step's, held above, are the global batch's, not the
        # per-rank ones DDP would keep
        assert max(np.abs(own[k] - whole[k]).max() for k in whole) > 1e-2


def _first_step_stats(state, batch_np):
    """The running statistics after one training forward over the whole
    batch, on one process."""
    import torch

    from ray_memory_management_tpu_torch.models import resnet

    model = resnet.ResNet((1, 1, 1, 1), 10, torch.float32)
    model.load_state_dict(state, strict=True)
    image = torch.from_numpy(batch_np["image"]).permute(0, 3, 1, 2)
    _, stats = resnet.resnet_loss_fn(
        model, {"image": image.contiguous(),
                "label": torch.from_numpy(batch_np["label"])})
    return {k: v.numpy() for k, v in stats.items()}


def _port_vit_dp(rank, world, state, batch_np, axes):
    import torch

    from ray_memory_management_tpu_torch.models import vit
    from ray_memory_management_tpu_torch.parallel import cpu_mesh

    cfg = dataclasses.replace(vit.PRESETS["vit-tiny-test"],
                              dtype=torch.float32)
    model = vit.ViT(cfg)
    model.load_state_dict(state, strict=True)
    mesh = cpu_mesh(axes)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = vit.make_vit_train_step(model, opt, mesh=mesh)
    batch = {"image": torch.from_numpy(batch_np["image"]).permute(
        0, 3, 1, 2).contiguous(),
        "label": torch.from_numpy(batch_np["label"])}
    return float(step(batch))


class TestViT:
    def test_dp_sharded_step(self, world):
        """The train step runs dp-sharded over 4 ranks with the global
        batch cut into each rank's rows (the resnet path's data-parallel
        recipe); its loss is the JAX mesh step's."""
        _vit_sharded_step(world, DP)

    def test_dp_fsdp_sharded_step(self, world):
        """The same over dp 2 x fsdp 2: the batch over both data axes."""
        _vit_sharded_step(world, DP_FSDP)


def _vit_sharded_step(world, axes):
    from ray_memory_management_tpu_torch.models.convert import (
        vit_state_from_flax,
    )

    cfg = dataclasses.replace(jvit.PRESETS["vit-tiny-test"],
                              dtype=jnp.float32)
    model = jvit.ViT(cfg)
    params = jax.jit(lambda key: jvit.init_vit(cfg, key)[1])(
        jax.random.PRNGKey(0))
    state = vit_state_from_flax(jax.tree.map(np.asarray, params))
    batch = _batch(3)
    mesh = cpu_mesh(axes)
    opt = optax.adam(1e-3)
    _, _, want = jvit.make_vit_train_step(model, opt, mesh=mesh)(
        params, opt.init(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    for loss in world.run(_port_vit_dp, state, batch, axes):
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, float(want), rtol=1e-5)
