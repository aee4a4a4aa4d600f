"""PyTorch port vs JAX package: ring and Ulysses attention
(``ops/ring_attention.py``) and sequence-parallel training, on the CPU.

The port runs on a gloo world of 4 spawned ranks (one ``LocalWorld`` for
the file, 120 s deadline a call); the JAX side on the conftest's CPU
devices. The same numpy-seeded fp32 inputs go to both. Tolerances:
outputs to 2e-5 (the JAX test's bound, ``tests/test_ops.py``), gradients
to 1e-4 of each tensor's largest value; the LM's losses to 1e-4 relative
and its gradients to 1e-4 of each leaf's largest value.

Copied from ``tests/test_ops.py``: the ring (causal and not), Ulysses and
long-sequence cases, at sp 4 (the JAX cases take sp 8 and 4); from
``tests/test_parallel.py``: ``test_ring_attention_training``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.ops import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from ray_memory_management_tpu.parallel import (
    cpu_mesh,
    make_train_step,
    param_pspecs,
    shard_pytree,
)
from ray_memory_management_tpu_torch.ops.ring_attention import ring_schedule
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld
from _port_fixtures import one_intra_op_thread  # noqa: F401

WORLD = 4
STEPS = 3


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD, timeout_s=120) as w:
        yield w


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    B, H, S, D = 2, 4, 128, 32
    return tuple(rng.normal(size=(B, H, S, D)).astype(np.float32)
                 for _ in range(3))


def _jmesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("sp",))


def _port_attention(rank, world, q, k, v, mode, causal, grads):
    """The port's sp attention of whole q, k, v on every rank: (o, and
    the gradients of sum(o^2) if ``grads``)."""
    import torch

    from ray_memory_management_tpu_torch.ops import (
        ring_attention, ulysses_attention,
    )
    from ray_memory_management_tpu_torch.parallel import cpu_mesh

    mesh = cpu_mesh({"sp": world})
    fn = ring_attention if mode == "ring" else ulysses_attention
    t = [torch.from_numpy(x).requires_grad_(grads) for x in (q, k, v)]
    o = fn(*t, mesh, causal=causal)
    if not grads:
        return o.detach().numpy(), None
    (o ** 2).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in t]


# ------------------------------------------- copies of tests/test_ops.py
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention(qkv, world, causal):
    q, k, v = qkv
    ref = reference_attention(*map(jnp.asarray, qkv), causal=causal)
    for out, _ in world.run(_port_attention, q, k, v, "ring", causal,
                            False):
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)


def test_ulysses_attention(qkv, world):
    # ulysses shards heads: the axis size must divide H (=4)
    q, k, v = qkv
    ref = reference_attention(*map(jnp.asarray, qkv), causal=True)
    for out, _ in world.run(_port_attention, q, k, v, "ulysses", True,
                            False):
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)


def test_ring_attention_long_sequence(world):
    # sequence 4x longer than a single shard; cross-shard causal masking
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(1, 2, 512, 16)).astype(np.float32)
               for _ in range(3))
    ref = reference_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    for out, _ in world.run(_port_attention, q, k, v, "ring", True, False):
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)


# --------------------------------------------------------- parity cases
def _close_by_scale(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp4_output_and_gradients_match_jax(qkv, world, mode, causal):
    """At sp 4, the port's output equals the JAX function's on a 4-device
    mesh, and the gradients of sum(o^2) equal ``jax.grad`` of it."""
    q, k, v = qkv
    fn = ring_attention if mode == "ring" else ulysses_attention
    mesh = _jmesh(WORLD)

    def attend(q, k, v):
        return fn(q, k, v, mesh, causal=causal)

    args = tuple(map(jnp.asarray, qkv))
    want_o = jax.jit(attend)(*args)
    want_g = jax.jit(jax.grad(lambda *a: (attend(*a) ** 2).sum(),
                              argnums=(0, 1, 2)))(*args)
    for out, grads in world.run(_port_attention, q, k, v, mode, causal,
                                True):
        np.testing.assert_allclose(out, np.asarray(want_o), atol=2e-5)
        for name, g, w in zip("qkv", grads, want_g):
            _close_by_scale(g, w, 1e-4, f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_schedule_in_one_process_matches_jax(qkv, causal):
    """The ring's per-chunk schedule without P2P (what ``chip_smoke.py``
    holds on the card): output and gradients equal the JAX reference's
    over the whole sequence."""
    q, k, v = qkv
    do = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    flat = [torch.from_numpy(x.reshape(-1, *x.shape[2:]))
            for x in (q, k, v, do)]
    o, dq, dk, dv = ring_schedule(*flat, ring=WORLD, causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o, vjp = jax.vjp(
        lambda a, b, c: reference_attention(a, b, c, causal=causal),
        jq, jk, jv)
    want = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.reshape(q.shape).numpy(),
                               np.asarray(want_o), atol=2e-5)
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        _close_by_scale(g.reshape(q.shape).numpy(), w, 1e-4, f"d{name}")


# -------------------------------------------- sequence-parallel training
@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                              cfg.vocab_size)
    batch = {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}
    return (cfg, params, batch, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, batch))


def _port_sp_training(rank, world, params_np, batch_np, mode, steps):
    """``steps`` Adam(1e-3) steps of the test preset (fp32) through
    ``make_train_step`` on an sp mesh of the world: (losses, the first
    step's gradients)."""
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
    mesh = cpu_mesh({"sp": world})
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, "sp"))
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    step = make_train_step(
        lambda p, b: gpt.loss_fn(p, b, cfg, mesh, "sp"), opt, mesh)
    losses = [float(step(sp, batch))]

    def grads(node):
        if isinstance(node, dict):
            return {k: grads(v) for k, v in node.items()}
        return node.grad.detach().clone()

    first = params_to_numpy(grads(sp))
    losses += [float(step(sp, batch)) for _ in range(steps - 1)]
    return losses, first


def _jax_sp(lm, mode):
    cfg, params, batch, _, _ = lm
    cfg = dataclasses.replace(cfg, attention=mode)
    mesh = cpu_mesh({"sp": WORLD})
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
def test_sp4_training_losses_and_gradients_match_jax(lm, world, mode):
    """sp 4: every rank's losses over 3 Adam steps equal the JAX step's on
    a 4-device sp mesh, and its first-step gradients (each rank's whole
    gradient, counted once) equal ``jax.grad`` on that mesh."""
    want_losses, want_grads = _jax_sp(lm, mode)
    want = dict(_leaves(want_grads))
    for losses, grads in world.run(_port_sp_training, lm[3], lm[4], mode,
                                   STEPS):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=0)
        got = dict(_leaves(grads))
        assert set(got) == set(want)
        for path, w in want.items():
            _close_by_scale(got[path], w, 1e-4, path)
    assert want_losses[-1] < want_losses[0]


def test_ring_attention_training(lm, world):
    """Sequence-parallel (ring attention) end-to-end gradient step: the
    sp 4 loss is the plain-attention loss (the JAX test's 5e-2)."""
    cfg, params, batch, _, _ = lm
    ref = float(jgpt.loss_fn(params, batch,
                             dataclasses.replace(cfg, attention="ref")))
    for losses, _ in world.run(_port_sp_training, lm[3], lm[4], "ring", 1):
        assert abs(losses[0] - ref) < 5e-2, (losses[0], ref)
