"""PyTorch port vs JAX package: sequence parallelism beside a data axis
(dp 2 x sp 2), with ring and with Ulysses attention, on the CPU.

The JAX dry run trains a dp x sp ring-attention step
(``__graft_entry__.py`` ``_dryrun_seq_parallel``): the batch splits over
dp, and within each data shard the sequence over sp. The port's ring and
Ulysses take their group from the mesh's sp axis, and
``make_train_step`` averages the gradients and the loss over dp alone.
The port runs on a gloo world of 4 spawned ranks (one ``LocalWorld``,
120 s deadline a call); the JAX side ``loss_fn(..., mesh, sp_axis="sp")``
on a dp 2 x sp 2 mesh of the conftest's CPU devices. From the JAX
``test`` weights in fp32: every rank's losses over 3 Adam(1e-3) steps to
1e-4 relative, and its first-step gradients to 1e-4 of each leaf's
largest value (the tolerances of ``tests/test_torch_ring_attention.py``'s
sp 4 case).
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
AXES = {"dp": 2, "sp": 2}
STEPS = 3


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD, timeout_s=120) as w:
        yield w


@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0,
                              cfg.vocab_size)
    batch = {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}
    return (cfg, params, batch, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, batch))


def _port_dp_sp(rank, world, params_np, batch_np, mode, steps):
    """``steps`` Adam(1e-3) steps of the test preset (fp32) through
    ``make_train_step`` on a dp 2 x sp 2 mesh: (losses, the first step's
    gradients, the rows this rank trained on)."""
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

    cfg = dataclasses.replace(gpt.PRESETS["test"], dtype=torch.float32,
                              attention=mode)
    params = params_from_jax(params_np, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    mesh = cpu_mesh({"dp": 2, "sp": 2})
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, "dp"))
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    rows = []

    def loss_fn(p, b):
        rows.append(int(b["tokens"].shape[0]))
        return gpt.loss_fn(p, b, cfg, mesh, "sp")

    step = make_train_step(loss_fn, opt, mesh)
    losses = [float(step(sp, batch))]

    def grads(node):
        if isinstance(node, dict):
            return {k: grads(v) for k, v in node.items()}
        return node.grad.detach().clone()

    first = params_to_numpy(grads(sp))
    losses += [float(step(sp, batch)) for _ in range(steps - 1)]
    return losses, first, rows


def _jax_dp_sp(lm, mode):
    cfg, params, batch, _, _ = lm
    cfg = dataclasses.replace(cfg, attention=mode)
    mesh = cpu_mesh(AXES)
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, "dp"),
                      copy=True)
    grads = jax.jit(jax.grad(
        lambda p: jgpt.loss_fn(p, batch, cfg, mesh, "sp")))(sp)
    opt = optax.adam(1e-3)
    step = make_train_step(
        lambda p, b: jgpt.loss_fn(p, b, cfg, mesh, "sp"), opt, mesh)
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


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_dp_sp_training_matches_jax(lm, world, mode):
    """Each rank trains its data shard's 2 rows, its sp group splitting
    the sequence; the losses and gradients are the JAX mesh's."""
    want_losses, want_grads = _jax_dp_sp(lm, mode)
    want = dict(_leaves(want_grads))
    for losses, grads, rows in world.run(_port_dp_sp, lm[3], lm[4], mode,
                                         STEPS):
        assert rows == [2] * STEPS
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=0)
        got = dict(_leaves(grads))
        assert set(got) == set(want)
        for path, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=path)
    assert want_losses[-1] < want_losses[0]
