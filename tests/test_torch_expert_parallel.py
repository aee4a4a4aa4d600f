"""PyTorch port vs JAX package: expert parallelism (the MoE FFN's expert
weights sharded over an ``ep`` mesh axis), on the CPU.

The port runs on a gloo world of 4 spawned ranks (one ``LocalWorld`` for
the file, 120 s deadline a call): expert weights are each rank's local
shard of the ep axis, every other leaf replicated, and ``ops/moe.py``
sums the partial expert outputs over ep. The JAX side runs the same
axes on the conftest's CPU devices (GSPMD's all-to-alls). From the JAX
``test-moe`` weights in fp32 (dispatch groups of 32 tokens, so that no
group straddles two data ranks' rows: the port raises on such a group,
since it routes each rank's rows on their own): every rank's losses over
3 Adam(1e-3) steps to 1e-4 relative, and its first-step gradients (the
ep shards gathered) to 1e-4 of each leaf's largest value, against
``jax.grad`` on the JAX mesh.

Copied from ``tests/test_parallel.py::TestExpertParallel``: param
sharding, ep matches replicated, ep trains, dispatch memory bounded (the
JAX cases' dp 2 x ep 4 mesh becomes ep 4 or dp 2 x ep 2 on 4 ranks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.parallel import (
    cpu_mesh,
    make_train_step,
    param_pspecs,
    shard_pytree,
)
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld

WORLD = 4
STEPS = 3
GROUP = 32  # tokens per dispatch group: 4 groups on each dp rank's rows
MESHES = [{"ep": 4}, {"dp": 2, "ep": 2}]


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD, timeout_s=120) as w:
        yield w


@pytest.fixture(scope="module")
def moe_setup():
    cfg = dataclasses.replace(jgpt.PRESETS["test-moe"], dtype=jnp.float32,
                              attention="ref", expert_group_size=GROUP)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                              cfg.vocab_size)
    batch = {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}
    return (cfg, params, batch, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, batch))


def _port_ep(rank, world, params_np, batch_np, axes, steps, fp32=True,
             group=GROUP):
    """``steps`` Adam(1e-3) steps of test-moe through ``make_train_step``
    on a mesh of ``axes``, the expert weights sharded over ep: (losses,
    the first step's gradients with the ep shards gathered, the local
    w1 shape, the replicated loss of the start)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax, params_to_numpy,
    )
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, make_train_step, param_pspecs, shard_pytree,
    )

    cfg = dataclasses.replace(gpt.PRESETS["test-moe"], attention="ref",
                              expert_group_size=group)
    if fp32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = params_from_jax(params_np, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    with torch.no_grad():
        replicated = float(gpt.loss_fn(params, batch, cfg))
    mesh = cpu_mesh(axes)
    specs = param_pspecs(params, mesh, "ep")
    sp = shard_pytree(params, mesh, specs)
    local_w1 = tuple(sp["layers"]["w1"].shape)
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    step = make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg, mesh), opt,
                           mesh)
    losses = [float(step(sp, batch))]
    group = mesh.get_group("ep")

    def full_grad(node, full):
        if isinstance(node, dict):
            return {k: full_grad(v, full[k]) for k, v in node.items()}
        g = node.grad.detach()
        if g.shape != full.shape:  # an ep shard: gather the experts
            parts = [torch.empty_like(g)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, g.contiguous(), group=group)
            g = torch.cat(parts, dim=1)
        return g.clone()

    first = params_to_numpy(full_grad(sp, params))
    losses += [float(step(sp, batch)) for _ in range(steps - 1)]
    return losses, first, local_w1, replicated


def _jax_ep(setup, axes):
    cfg, params, batch, _, _ = setup
    mesh = cpu_mesh(axes)
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, "ep"),
                      copy=True)
    grads = jax.jit(jax.grad(
        lambda p: jgpt.loss_fn(p, batch, cfg, mesh)))(sp)
    opt = optax.adam(1e-3)
    step = make_train_step(lambda p, b: jgpt.loss_fn(p, b, cfg, mesh), opt,
                           mesh)
    losses, p, s = [], sp, opt.init(sp)
    for _ in range(STEPS):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return losses, grads


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("axes", MESHES, ids=["ep4", "dp2xep2"])
def test_ep_losses_and_gradients_match_jax(moe_setup, world, axes):
    want_losses, want_grads = _jax_ep(moe_setup, axes)
    want = dict(_leaves(want_grads))
    for losses, grads, _, _ in world.run(_port_ep, moe_setup[3],
                                         moe_setup[4], axes, STEPS):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=0)
        got = dict(_leaves(grads))
        assert set(got) == set(want)
        for path, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=path)
    assert want_losses[-1] < want_losses[0]


# -------------------------- copies of tests/test_parallel.py (ep cases)
class TestExpertParallel:
    def test_ep_param_sharding(self, moe_setup, world):
        from ray_memory_management_tpu_torch.parallel.sharding import (
            param_specs,
        )

        cfg, params, _, params_np, batch_np = moe_setup
        specs = param_specs(params_np, {"ep": 4}, "ep")
        assert specs["layers"]["w1"] == (None, "ep", None, None)
        assert specs["layers"]["w2"] == (None, "ep", None, None)
        # expert dim 4 really is split over the 4 ep ranks
        for _, _, local_w1, _ in world.run(_port_ep, params_np, batch_np,
                                           {"ep": 4}, 1):
            assert local_w1[1] == 1
            assert local_w1 == (2, 1, 64, cfg.ff_dim)

    def test_ep_matches_replicated(self, moe_setup, world):
        """The ep-sharded loss equals the replicated loss (same math,
        different layout), in the preset's bf16."""
        _, _, _, params_np, batch_np = moe_setup
        for losses, _, _, replicated in world.run(
                _port_ep, params_np, batch_np, {"ep": 4}, 1, False):
            np.testing.assert_allclose(losses[0], replicated, rtol=2e-2)

    def test_ep_trains(self, moe_setup, world):
        _, _, _, params_np, batch_np = moe_setup
        for losses, _, _, _ in world.run(_port_ep, params_np, batch_np,
                                         {"dp": 2, "ep": 2}, 4, False):
            assert losses[-1] < losses[0], losses

    def test_a_group_across_data_ranks_raises(self, moe_setup, world):
        """The preset's 256-token groups over 8 x 16 tokens make one group
        of 128, which dp 2 would split between two ranks: refused."""
        _, _, _, params_np, batch_np = moe_setup
        with pytest.raises(RuntimeError, match="straddles"):
            world.run(_port_ep, params_np, batch_np, {"dp": 2, "ep": 2}, 1,
                      True, 256)

    def test_moe_dispatch_memory_bounded(self):
        """The GShard group dimension bounds dispatch capacity by
        tokens per group, not total tokens."""
        from ray_memory_management_tpu_torch.models import gpt
        from ray_memory_management_tpu_torch.ops import moe

        cfg = gpt.PRESETS["test-moe"]
        g = moe._group_size(8192, cfg.expert_group_size)
        assert g <= cfg.expert_group_size
        C = moe.capacity(g, cfg.n_experts, cfg.expert_top_k,
                         cfg.expert_capacity_factor)
        assert C <= moe.capacity(cfg.expert_group_size, cfg.n_experts,
                                 cfg.expert_top_k,
                                 cfg.expert_capacity_factor)
