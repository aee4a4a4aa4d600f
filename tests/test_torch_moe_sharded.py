"""PyTorch port vs JAX package: the MoE FFN under every sharding of its
expert weights that the JAX ``param_pspecs`` gives besides ep and dp, on
the CPU.

The JAX package runs its one ``moe_ffn`` under GSPMD whatever the specs:
fsdp shards of the expert weights, Megatron tp within each expert, ep x
tp, fsdp x ep, and the batch over dp and fsdp at once. The port runs the
same layouts on a gloo world of 4 spawned ranks (one ``LocalWorld`` for
the file, 120 s deadline a call): the DTensor weights' fsdp shards are
gathered for use, the tp and ep shards stay local and their partial
outputs are summed (``ops/moe.py``). Each mesh is held against the JAX
mesh of the same axes and strategy, from the JAX ``test-moe`` weights in
fp32 (dispatch groups of 32 tokens, so that no group straddles two data
ranks' rows): every rank's losses over 3 Adam(1e-3) steps to 1e-4
relative, and its first-step gradients (shards gathered) to 1e-4 of each
leaf's largest value, against ``jax.grad`` on the JAX mesh; the
tolerances of ``tests/test_torch_expert_parallel.py``.
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
from _port_fixtures import one_intra_op_thread  # noqa: F401

WORLD = 4
STEPS = 3
GROUP = 32  # tokens per dispatch group: 2 groups on each of 4 data ranks
# (mesh axes, strategy): the JAX param_pspecs rule both sides shard by
LAYOUTS = [
    ({"fsdp": 4}, "fsdp"),
    ({"tp": 4}, "tp"),
    ({"fsdp": 2, "tp": 2}, "fsdp+tp"),
    ({"ep": 2, "tp": 2}, "ep+tp"),
    ({"fsdp": 2, "ep": 2}, "fsdp+ep"),
    ({"dp": 2, "fsdp": 2}, "dp+fsdp"),
]


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


def _port_sharded(rank, world, params_np, batch_np, axes, strategy, steps):
    """``steps`` Adam(1e-3) steps of fp32 test-moe through
    ``make_train_step`` on a mesh of ``axes`` sharded by ``strategy``:
    (losses, the first step's gradients gathered whole, the local w1
    shape)."""
    import dataclasses

    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax, params_to_numpy,
    )
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, make_train_step, param_pspecs, shard_pytree,
    )

    cfg = dataclasses.replace(gpt.PRESETS["test-moe"], attention="ref",
                              expert_group_size=32, dtype=torch.float32)
    params = params_from_jax(params_np, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    mesh = cpu_mesh(axes)
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, strategy))
    w1 = sp["layers"]["w1"]
    local_w1 = tuple(getattr(w1, "_local_tensor", w1).shape)
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    step = make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg, mesh), opt,
                           mesh)
    losses = [float(step(sp, batch))]

    def full_grad(node):
        if isinstance(node, dict):
            return {k: full_grad(v) for k, v in node.items()}
        g = node.grad
        return (g.full_tensor() if hasattr(g, "full_tensor") else g).clone()

    first = params_to_numpy(full_grad(sp))
    losses += [float(step(sp, batch)) for _ in range(steps - 1)]
    return losses, first, local_w1


def _jax_sharded(setup, axes, strategy):
    cfg, params, batch, _, _ = setup
    mesh = cpu_mesh(axes)
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, strategy),
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


def _local_w1(cfg, axes, strategy):
    """[L, E, D, F] of w1 cut as the JAX spec cuts it."""
    from ray_memory_management_tpu_torch.parallel.sharding import (
        param_specs,
    )

    shape = (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.ff_dim)
    spec = param_specs({"layers": {"w1": np.zeros(shape)}}, axes,
                       strategy)["layers"]["w1"]
    return tuple(n // (axes[a] if a else 1) for n, a in zip(shape, spec))


@pytest.mark.parametrize("axes,strategy", LAYOUTS,
                         ids=[s for _, s in LAYOUTS])
def test_sharded_moe_losses_and_gradients_match_jax(moe_setup, world, axes,
                                                    strategy):
    want_losses, want_grads = _jax_sharded(moe_setup, axes, strategy)
    want = dict(_leaves(want_grads))
    for losses, grads, local_w1 in world.run(
            _port_sharded, moe_setup[3], moe_setup[4], axes, strategy,
            STEPS):
        # the expert weights really are cut as the JAX specs cut them
        assert local_w1 == _local_w1(moe_setup[0], axes, strategy)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=0)
        got = dict(_leaves(grads))
        assert set(got) == set(want)
        for path, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=path)
    assert want_losses[-1] < want_losses[0]
