"""PyTorch port vs JAX package: training the GPT TransformerLM.

JAX ``init_params(PRNGKey(0))`` on the ``test`` preset with fp32 compute
(MHA, and GQA with two kv heads) crosses into the port through numpy and
``params_from_jax``; the same numpy-seeded batch then goes through both
packages on the CPU, where the port's attention takes its plain forward
and plain backward through the autograd glue. Tolerances:

- loss: ``rtol=atol=1e-4`` (fp32, as tests/test_torch_gpt.py holds the
  logits);
- every gradient leaf against ``jax.grad(loss_fn)``: ``atol=2e-6``
  plus ``rtol=1e-4`` (fp32 sums over up to 24 keys and 512 logits taken
  in another order; the largest gradient entries are about 0.3 and the
  largest difference about 2.5e-7, so the bound leaves a factor of 8);
- one AdamW update from the same numpy params and grads against
  ``optax.adamw(3e-4)``: ``atol=1e-6`` (the update is lr-sized, 3e-4;
  the two differ by fp32 rounding of the same formula).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu_torch.models import gpt as tgpt
from ray_memory_management_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from ray_memory_management_tpu_torch.ops.flash_attention import (
    launch_counts,
    reset_launch_count,
)
from ray_memory_management_tpu_torch.utils import gpu_bench

LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


def _configs(kv_heads):
    jcfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32,
                               n_kv_heads=kv_heads)
    tcfg = dataclasses.replace(tgpt.PRESETS["test"], dtype=torch.float32,
                               n_kv_heads=kv_heads)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg


def _port_params(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    for t in tgpt.param_leaves(params):
        t.requires_grad_(True)
    return params


def _batch(shape=(2, 24), seed=1, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, size=shape)
    return ({"tokens": jnp.asarray(toks),
             "targets": jnp.asarray(np.roll(toks, -1, axis=1))},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(np.roll(toks, -1, axis=1))})


def _leaves_with_paths(jtree):
    return jax.tree_util.tree_flatten_with_path(jtree)[0]


def _pick(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _port_grads(params, batch, cfg):
    leaves = list(tgpt.param_leaves(params))
    loss = tgpt.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for t, g in zip(leaves, grads):
        t.grad = g
    return loss, params


def test_loss_matches_jax(model):
    jcfg, jparams, tcfg = model
    jb, tb = _batch()
    ref = float(jgpt.loss_fn(jparams, jb, jcfg))
    out = tgpt.loss_fn(_port_params(jparams), tb, tcfg)
    assert out.dim() == 0 and out.dtype == torch.float32
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)


def test_every_gradient_leaf_matches_jax_grad(model):
    jcfg, jparams, tcfg = model
    jb, tb = _batch(seed=2)
    jgrads = jax.grad(lambda p: jgpt.loss_fn(p, jb, jcfg))(jparams)
    reset_launch_count()
    _, params = _port_grads(_port_params(jparams), tb, tcfg)
    assert sum(launch_counts().values()) == 0  # the CPU takes plain versions
    flat = _leaves_with_paths(jgrads)
    assert len(flat) == len(list(tgpt.param_leaves(params)))
    for path, want in flat:
        got = _pick(params, path).grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_gives_the_same_gradients(model):
    _, jparams, tcfg = model
    _, tb = _batch(seed=3)
    _, plain = _port_grads(_port_params(jparams), tb, tcfg)
    _, remat = _port_grads(_port_params(jparams), tb,
                           dataclasses.replace(tcfg, remat=True))
    for a, b in zip(tgpt.param_leaves(plain), tgpt.param_leaves(remat)):
        torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=0)


def test_adamw_step_matches_optax(model):
    # the optimizer alone, from the same numpy params and grads: Adam turns
    # grad noise near zero into +-lr, so it is held apart from the grads
    _, jparams, _ = model
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    grads = [jax.tree.map(
        lambda a: rng.normal(scale=0.01, size=a.shape).astype(np.float32),
        jp) for _ in range(2)]
    params = _port_params(jp)
    opt = gpu_bench.make_optimizer(params)
    tx = optax.adamw(3e-4)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for path, leaf in _leaves_with_paths(g):
            _pick(params, path).grad = torch.from_numpy(np.array(leaf))
        opt.step()
    for path, want in _leaves_with_paths(jp):
        np.testing.assert_allclose(
            _pick(params, path).detach().numpy(), np.asarray(want),
            rtol=0, atol=1e-6, err_msg=jax.tree_util.keystr(path))


def test_five_steps_lower_the_loss(model):
    _, jparams, tcfg = model
    _, tb = _batch(seed=5)
    params = _port_params(jparams)
    opt = gpu_bench.make_optimizer(params)
    losses = [gpu_bench.train_step(params, opt, tb, tcfg).item()
              for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_step_mfu_on_the_cpu_takes_exactly_its_steps():
    out = gpu_bench.train_step_mfu("test", batch_size=2, seq_len=32,
                                   steps=5, device="cpu")
    assert out["steps"] == 5 and len(out["losses"]) == 5
    assert out["losses"][-1] < out["losses"][0]
    assert out["loss"] == out["losses"][-1]
    assert out["mfu"] is None and out["device"] == "cpu"
    assert out["step_ms"] > 0 and out["tokens_per_s"] > 0
    cfg = tgpt.PRESETS["test"]
    assert out["n_params"] == tgpt.count_params(
        tgpt.init_params(cfg, device="cpu"))
    with pytest.raises(ValueError, match="steps"):
        gpu_bench.train_step_mfu("test", steps=3, device="cpu")


def test_count_params_matches_jax(model):
    jcfg, jparams, _ = model
    assert tgpt.count_params(_port_params(jparams)) == \
        jgpt.count_params(jparams)


def test_params_to_numpy_round_trips_bit_for_bit(model):
    _, jparams, _ = model
    rng = np.random.default_rng(6)
    tree = {"fp32": jax.tree.map(np.asarray, jparams),
            "bf16": {"w": np.asarray(jnp.asarray(
                rng.normal(size=(5, 7)), jnp.bfloat16))}}
    back = params_to_numpy(params_from_jax(tree, device="cpu"))
    for path, want in _leaves_with_paths(tree):
        got = _pick(back, path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
    # trained weights hand back to the JAX package as they are
    assert jnp.asarray(back["bf16"]["w"]).dtype == jnp.bfloat16


def test_moe_loss_raises_as_moe_does():
    """The MoE preset now trains: its loss (cross-entropy plus the
    weighted load-balancing aux) and every gradient leaf match
    ``jax.grad`` of the JAX ``loss_fn`` in fp32 (routing decisions equal,
    so the tolerances of the dense model hold)."""
    jcfg = dataclasses.replace(jgpt.PRESETS["test-moe"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tgpt.PRESETS["test-moe"], dtype=torch.float32)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    jb, tb = _batch(seed=4)
    ref, jgrads = jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, jb, jcfg))(jparams)
    loss, params = _port_grads(_port_params(jparams), tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(ref), **LOSS_TOL)
    for path, want in _leaves_with_paths(jgrads):
        np.testing.assert_allclose(_pick(params, path).grad.numpy(),
                                   np.asarray(want), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
