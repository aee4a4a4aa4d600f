"""The port's entry points (``utils/dryrun.py``) against the JAX
package's (``__graft_entry__.py``), on the CPU.

``entry()`` gives the ``test`` preset's forward and its arguments;
``dryrun_multichip(8, device="cpu")`` trains one step of each of the JAX
dry run's five layouts (dp 2 x tp 4, dp 4 x pp 2, dp 2 x ep 4, dp 2 x
sp 4, fsdp 2 x tp 4) on a gloo world of 8 spawned ranks, as
``tests/test_parallel.py::test_graft_entry_points`` runs the JAX one on 8
CPU devices. Fed the JAX dry run's own weights and batches (drawn from
its keys, through ``params_from_jax``), each layout's loss equals the
JAX step's on the same mesh, weights, batch and dispatch group size to
1e-4 relative, both sides in fp32 compute (the presets' bf16 rounds the
tp layouts' partial sums where XLA on the CPU keeps fp32, 2.2e-4 apart).
The run the card makes, four ranks in the presets' bf16 compute, is held
against the JAX dry run at four devices in bf16 too, to an eighth of a
bf16 ulp of the loss (2 ** -11 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.parallel import (
    cpu_mesh,
    make_train_step,
    param_pspecs,
    pipeline_loss_fn,
    shard_pytree,
    stacked_param_pspecs,
)
from ray_memory_management_tpu_torch.utils import dryrun
from _port_fixtures import one_intra_op_thread  # noqa: F401

N = 8
# the JAX dry run's batch key of each layout
KEYS = {"dp_tp": 0, "dp_pp": 1, "dp_ep": 2, "dp_sp": 3, "fsdp_tp": 4}


def _jax_cfg(name, n, dtype):
    """The JAX dry run's config of a layout at n devices in compute
    ``dtype``, with the port's dispatch group size for the MoE layout."""
    port = dryrun.layout_config(name, n)
    if name == "dp_ep":
        return dataclasses.replace(
            jgpt.PRESETS["test-moe"], attention="ref", dtype=dtype,
            expert_group_size=port.expert_group_size)
    return dataclasses.replace(
        jgpt.PRESETS["test"], n_heads=port.n_heads, d_model=port.d_model,
        attention="ring" if name == "dp_sp" else "ref", dtype=dtype)


def _jax_layout(name, n=N, dtype=jnp.float32):
    """(the step's loss, params, batch) of the JAX dry run's layout."""
    axes = dryrun.layout_axes(name, n)
    cfg = _jax_cfg(name, n, dtype)
    mesh = cpu_mesh(axes)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    seq = dryrun.SEQ * axes.get("sp", 1)
    tokens = jax.random.randint(jax.random.PRNGKey(KEYS[name]),
                                (dryrun.batch_size(name, n), seq), 0,
                                cfg.vocab_size)
    batch = {"tokens": tokens, "targets": jnp.roll(tokens, -1, axis=1)}
    start = (jax.tree.map(np.asarray, params),
             jax.tree.map(np.asarray, batch))
    specs = param_pspecs(params, mesh, {"dp_tp": "tp", "dp_ep": "ep",
                                        "fsdp_tp": "fsdp+tp"}.get(name, "dp"))
    if name == "dp_pp":
        specs["layers"] = stacked_param_pspecs(params["layers"])

        def loss_fn(p, b):
            return pipeline_loss_fn(p, b, cfg, mesh, n_microbatches=2,
                                    batch_axes=("dp",))
    else:
        def loss_fn(p, b):
            return jgpt.loss_fn(p, b, cfg, mesh,
                                "sp" if name == "dp_sp" else None)
    params = shard_pytree(params, mesh, specs, copy=True)
    opt = optax.adamw(1e-3)
    _, _, loss = make_train_step(loss_fn, opt, mesh)(
        params, opt.init(params), batch)
    return float(loss), start


def test_entry_gives_the_forward_and_its_arguments():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (2, 64, 512)
    assert np.isfinite(out.detach().numpy()).all()
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        dryrun.entry()


def test_dryrun_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)


def test_dryrun_multichip_matches_jax(capsys, monkeypatch):
    monkeypatch.setattr(dryrun, "TIMEOUT_S", 120.0)
    assert dryrun.layouts_for(N) == list(KEYS)
    want, starts = {}, {}
    for name in KEYS:
        want[name], starts[name] = _jax_layout(name)
    # the MoE layout's groups hold one data rank's 32 tokens (JAX's 256
    # would make one group of the whole 64-token batch)
    assert dryrun.layout_config("dp_ep", N).expert_group_size == 32
    losses = dryrun.dryrun_multichip(N, device="cpu", starts=starts,
                                     dtype=torch.float32)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip:")]
    assert lines == [
        f"dryrun_multichip: mesh dp=2 tp=4 step ok, "
        f"loss={losses['dp_tp']:.4f}",
        f"dryrun_multichip: mesh dp=4 pp=2 pipelined step ok, "
        f"loss={losses['dp_pp']:.4f}",
        f"dryrun_multichip: mesh dp=2 ep=4 MoE step ok, "
        f"loss={losses['dp_ep']:.4f}",
        f"dryrun_multichip: mesh dp=2 sp=4 ring-attention step ok, "
        f"loss={losses['dp_sp']:.4f}",
        f"dryrun_multichip: mesh fsdp=2 tp=4 step ok, "
        f"loss={losses['fsdp_tp']:.4f}"]
    for name, loss in losses.items():
        np.testing.assert_allclose(loss, want[name], rtol=1e-4, err_msg=name)


def test_dryrun_multichip_bf16_matches_jax_at_four_ranks(capsys,
                                                         monkeypatch):
    monkeypatch.setattr(dryrun, "TIMEOUT_S", 120.0)
    n = 4
    assert dryrun.layouts_for(n) == list(KEYS)
    want, starts = {}, {}
    for name in KEYS:
        want[name], starts[name] = _jax_layout(name, n, jnp.bfloat16)
    losses = dryrun.dryrun_multichip(n, device="cpu", starts=starts)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip:")]
    assert len(lines) == 5
    for name, loss in losses.items():
        np.testing.assert_allclose(loss, want[name], rtol=2.0 ** -11,
                                   err_msg=name)
