"""PyTorch port vs JAX package: training with bf16 parameters, on the CPU.

The JAX ``train_step_mfu(bf16_params=True)`` draws the parameters in
bf16 and trains them with ``optax.adamw(3e-4, mu_dtype=bf16)``, whose ν
takes the parameters' dtype too; the port's
``gpu_bench.setup_training(..., bf16_params=True)`` keeps the parameters,
their gradients and both moments in bf16 and writes optax's update out
(``gpu_bench.LowPrecisionAdamW``). The JAX side is compiled with
``xla_allow_excess_precision`` off, so that it rounds to bf16 after every
operation, as its program says and as the port does. From the JAX
``test`` weights drawn in bf16 (B = 4, S = 32, the JAX attention through
its plain reference, the port's through its plain version on the CPU):

- the update alone, fed JAX's own gradients for 4 steps: the parameters
  and both moments bit-equal to optax's (0 ulps), both moments bf16;
- 4 whole steps in fp32 compute: the losses to 1e-6 relative; at most
  0.2 % of each leaf's elements differ from JAX's, each by at most 4 ulps
  of its own bf16 value, where JAX's steps move 14 to 95 % of them (a
  gradient that rounds the other way is the only difference);
- 4 whole steps in the preset's bf16 compute (the card's setting): the
  losses to 1e-3 relative; at most 10 % of each leaf's elements differ,
  each by at most 4 ulps of the leaf's largest value (Adam turns a
  rounding of a small gradient into an lr-sized step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
)
from ray_memory_management_tpu_torch.utils import gpu_bench
from _port_fixtures import one_intra_op_thread  # noqa: F401

STEPS = 4
B, S = 4, 32
EXACT = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)


def _jax_cfg(dtype):
    return dataclasses.replace(jgpt.PRESETS["test"], param_dtype=jnp.bfloat16,
                               dtype=dtype, attention="auto", max_seq=S)


@pytest.fixture(scope="module")
def start():
    params = jgpt.init_params(jax.random.PRNGKey(0), _jax_cfg(jnp.float32))
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                              jgpt.PRESETS["test"].vocab_size)
    return params, {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}


def _jax_run(start, dtype):
    """STEPS steps of the JAX loss and optax's adamw over bf16 params:
    (losses, every step's gradients, the params and the optimizer state
    after each step)."""
    params, batch = start
    cfg = _jax_cfg(dtype)
    opt = optax.adamw(3e-4, mu_dtype=jnp.bfloat16)
    state = opt.init(params)
    grad = _compiled(jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, batch, cfg)), params)

    def update(g, s, p):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    update = _compiled(update, params, state, params)
    losses, grads, after = [], [], []
    for _ in range(STEPS):
        loss, g = grad(params)
        params, state = update(g, state, params)
        losses.append(float(loss))
        grads.append(g)
        after.append((params, state[0]))
    return losses, grads, after


def _port(start, compute):
    """The port's bf16-parameter model, optimizer and batch from the JAX
    start (``setup_training``'s, with the JAX values copied in)."""
    params, batch = start
    tp, opt, _, cfg = gpu_bench.setup_training(
        "test", B, S, False, "flash", torch.device("cpu"), bf16_params=True)
    cfg = dataclasses.replace(cfg, dtype=compute)
    _copy(tp, params_from_jax(jax.tree.map(np.asarray, params),
                              device="cpu"))
    tb = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
          for k, v in batch.items()}
    return tp, opt, tb, cfg


@torch.no_grad()
def _copy(dst, src):
    for k in dst:
        if isinstance(dst[k], dict):
            _copy(dst[k], src[k])
        else:
            assert dst[k].dtype == src[k].dtype == torch.bfloat16
            dst[k].copy_(src[k])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _f32(tree):
    return {k: np.asarray(v).astype(np.float32) for k, v in _leaves(tree)}


def _ulp(x):
    """bf16's ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def test_adamw_update_is_optaxs_bit_for_bit(start):
    """Fed the same bf16 gradients, the written-out update gives optax's
    parameters, μ and ν exactly, step after step."""
    _, grads, after = _jax_run(start, jnp.float32)
    tp, opt, _, _ = _port(start, torch.float32)
    assert isinstance(opt, gpu_bench.LowPrecisionAdamW)
    leaves = dict(_leaves(tp))
    for g, (want_p, want_s) in zip(grads, after):
        for path, t in _leaves(params_from_jax(jax.tree.map(np.asarray, g),
                                               device="cpu")):
            leaves[path].grad = t
        opt.step()
        want_mu, want_nu = _f32(want_s.mu), _f32(want_s.nu)
        got = _f32(params_to_numpy(tp))
        for path, w in _f32(want_p).items():
            state = opt.state[leaves[path]]
            assert state["exp_avg"].dtype == torch.bfloat16
            assert state["exp_avg_sq"].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[path], w, err_msg=path)
            np.testing.assert_array_equal(
                state["exp_avg"].float().numpy(), want_mu[path],
                err_msg=path)
            np.testing.assert_array_equal(
                state["exp_avg_sq"].float().numpy(), want_nu[path],
                err_msg=path)
    assert jax.tree.leaves(after[-1][1].mu)[0].dtype == jnp.bfloat16
    assert jax.tree.leaves(after[-1][1].nu)[0].dtype == jnp.bfloat16


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bf16_params_training_matches_jax(start, compute):
    want_losses, _, after = _jax_run(start, getattr(jnp, compute))
    tp, opt, tb, cfg = _port(start, getattr(torch, compute))
    losses = [float(gpu_bench.train_step(tp, opt, tb, cfg))
              for _ in range(STEPS)]
    assert losses[-1] < losses[0]
    exact = compute == "float32"
    np.testing.assert_allclose(losses, want_losses,
                               rtol=1e-6 if exact else 1e-3)
    first = _f32(start[0])
    got = _f32(params_to_numpy(tp))
    for path, w in _f32(after[-1][0]).items():
        assert got[path].dtype == np.float32 and w.shape == got[path].shape
        diff = np.abs(got[path] - w)
        if exact:
            assert (diff > 0).mean() <= 2e-3, path
            assert (diff <= 4 * _ulp(w)).all(), path
        else:
            assert (diff > 0).mean() <= 0.1, path
            assert diff.max() <= 4 * _ulp(np.abs(w).max()), path
        moved = (first[path] != w).mean()
        if "ln" not in path:  # the norms' ones never move in bf16
            assert moved >= 0.1, (path, moved)


def test_train_step_mfu_keeps_bf16_parameters():
    """``train_step_mfu(bf16_params=True)`` on the CPU: finite, falling
    losses; the parameters it draws are bf16 (``cfg.param_dtype``)."""
    r = gpu_bench.train_step_mfu("test", batch_size=2, seq_len=32, steps=4,
                                 device="cpu", bf16_params=True)
    assert r["bf16_params"] is True and r["mfu"] is None
    assert all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0]
    params, opt, _, cfg = gpu_bench.setup_training(
        "test", 2, 32, False, "flash", torch.device("cpu"), bf16_params=True)
    assert cfg.param_dtype == torch.bfloat16
    assert {t.dtype for _, t in _leaves(params)} == {torch.bfloat16}
    assert r["n_params"] == sum(t.numel() for _, t in _leaves(params))
