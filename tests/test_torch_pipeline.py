"""PyTorch port vs JAX package: the GPipe pipeline's schedule in one
process (``parallel.pipeline_schedule``: every stage's layer slices held
here, the hand-overs in memory), on the CPU.

The JAX side runs ``pipeline_loss_fn`` on the conftest's CPU devices
(``cpu_mesh({"pp": S})``), the port ``pipeline_schedule`` with S stages,
both from the JAX weights in fp32 with plain attention and the same
batch (8 x 16 tokens). The arithmetic is the same, so the loss is held to
1e-5 relative and every leaf's gradient (``jax.grad`` of the JAX loss) to
1e-4 of that leaf's largest value. The ``test-moe`` aux through the
pipeline is held against the JAX pipeline's, microbatch dispatch groups
and all, to 1e-5 relative. The JAX side of each case is computed once
for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.parallel import (
    cpu_mesh,
    pipeline_loss_fn,
    shard_pytree,
    stacked_param_pspecs,
)
from ray_memory_management_tpu.parallel.pipeline import pipeline_forward
from ray_memory_management_tpu.parallel.sharding import param_pspecs
from ray_memory_management_tpu_torch.models import gpt
from ray_memory_management_tpu_torch.models.convert import params_from_jax
from ray_memory_management_tpu_torch.parallel import pipeline as ppl
from _port_fixtures import one_intra_op_thread  # noqa: F401

# (preset, layers, stages, microbatches)
CASES = [("test", 2, 2, 2), ("test", 2, 2, 4), ("test", 4, 4, 2),
         ("test", 4, 4, 4), ("test-moe", 2, 2, 2), ("test-moe", 2, 2, 4)]


def _jax_cfg(preset, layers):
    return dataclasses.replace(jgpt.PRESETS[preset], dtype=jnp.float32,
                               attention="ref", n_layers=layers)


def _port_cfg(preset, layers):
    return dataclasses.replace(gpt.PRESETS[preset], dtype=torch.float32,
                               attention="ref", n_layers=layers)


def _batch():
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 512)
    return {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def jax_runs():
    """{case: (params, loss, grads, aux)} of the JAX pipeline."""
    out = {}
    batch = _batch()
    for preset, layers, stages, m in CASES:
        cfg = _jax_cfg(preset, layers)
        params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
        mesh = cpu_mesh({"pp": stages})
        specs = param_pspecs(params, mesh, "dp")
        specs["layers"] = stacked_param_pspecs(params["layers"])
        sp = shard_pytree(params, mesh, specs, copy=True)
        (loss, grads), aux = jax.jit(lambda p: (
            jax.value_and_grad(lambda q: pipeline_loss_fn(
                q, batch, cfg, mesh, n_microbatches=m))(p),
            pipeline_forward(p, batch["tokens"], cfg, mesh,
                             n_microbatches=m)[1]))(sp)
        out[preset, layers, stages, m] = (
            jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads), float(aux))
    return out


def _port_batch():
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in _batch().items()}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_schedule_matches_jax_pipeline(jax_runs, case):
    preset, layers, stages, m = case
    params_np, want_loss, want_grads, _ = jax_runs[case]
    params = params_from_jax(params_np, device="cpu")
    leaves = [t.requires_grad_() for t in gpt.param_leaves(params)]
    loss = ppl.pipeline_schedule(params, _port_batch(),
                                 _port_cfg(preset, layers), stages, m)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    want = list(_leaves(want_grads))
    assert len(want) == len(grads)
    for (path, w), g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize("m", [2, 4])
def test_moe_aux_through_the_schedule_matches_jax(jax_runs, m):
    """The MoE aux of the microbatches' own dispatch groups, summed over
    real microbatches and stages and divided by M·L, as the JAX pipeline
    returns it; it differs from the unpipelined aux (other groups)."""
    params_np, _, _, want_aux = jax_runs["test-moe", 2, 2, m]
    cfg = _port_cfg("test-moe", 2)
    params = params_from_jax(params_np, device="cpu")
    tokens = _port_batch()["tokens"]
    with torch.no_grad():
        _, aux = ppl._lm_forward(
            params, tokens, cfg, lambda f, layers, x: ppl._resident_blocks(
                f, layers, x, 2, m, with_aux=True))
        _, plain_aux = gpt.forward_with_aux(params, tokens, cfg)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    assert abs(float(aux) - float(plain_aux)) > 1e-6


def test_schedule_matches_unpipelined_loss_and_grads():
    """The schedule changes no arithmetic of a dense model: loss and
    gradients equal ``gpt.loss_fn``'s to fp32 rounding."""
    cfg = _port_cfg("test", 4)
    params = gpt.init_params(cfg, device="cpu")
    leaves = [t.requires_grad_() for t in gpt.param_leaves(params)]
    batch = _port_batch()
    want = gpt.loss_fn(params, batch, cfg)
    g_want = torch.autograd.grad(want, leaves)
    got = ppl.pipeline_schedule(params, batch, cfg, 4, 4)
    g_got = torch.autograd.grad(got, leaves)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def test_microbatches_must_split_the_batch():
    cfg = _port_cfg("test", 2)
    params = gpt.init_params(cfg, device="cpu")
    batch = {k: v[:6] for k, v in _port_batch().items()}
    with pytest.raises(ValueError, match="per-shard batch 6 .* not "
                       "divisible by 4 microbatches"):
        ppl.pipeline_schedule(params, batch, cfg, 2, 4)
    with pytest.raises(ValueError, match="2 layers do not split over 4"):
        ppl.pipeline_schedule(params, batch, cfg, 4, 2)


def test_jax_raises_on_the_same_microbatch_split():
    cfg = _jax_cfg("test", 2)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    mesh = cpu_mesh({"pp": 2})
    batch = {k: v[:6] for k, v in _batch().items()}
    with pytest.raises(ValueError, match="not divisible by 4 microbatches"):
        pipeline_loss_fn(params, batch, cfg, mesh, n_microbatches=4)


def test_a_stage_tree_refuses_the_unpipelined_forward():
    cfg = _port_cfg("test", 4)
    params = gpt.init_params(cfg, device="cpu")
    stage = dict(params, layers={k: v[:1] for k, v in params["layers"].items()})
    with pytest.raises(ValueError, match="pipeline_loss_fn"):
        gpt.loss_fn(stage, _port_batch(), cfg)


def test_stage_specs_match_jax():
    """``stage_pspec``/``stacked_param_pspecs`` and the pp placement of
    ``param_specs`` give the JAX specs the pipeline tests build."""
    from ray_memory_management_tpu_torch.parallel.sharding import param_specs

    params = jgpt.init_params(jax.random.PRNGKey(0), _jax_cfg("test-moe", 2))
    params_np = jax.tree.map(np.asarray, params)
    for axes, rule in (({"pp": 2}, "dp"), ({"dp": 2, "pp": 2}, "dp"),
                       ({"pp": 2, "ep": 2}, "ep")):
        mesh = cpu_mesh(axes)
        jspecs = param_pspecs(params, mesh, rule)
        jspecs["layers"] = jax.tree.map(
            lambda p, s: jax.sharding.PartitionSpec(
                "pp", *(tuple(s) + (None,) * p.ndim)[1:p.ndim]),
            params["layers"], jspecs["layers"])
        port = dict(_leaves(param_specs(params_np, axes, rule)))
        for path, spec in _leaves(jspecs):
            ndim = dict(_leaves(params_np))[path].ndim
            assert port[path] == (tuple(spec) + (None,) * ndim)[:ndim], path
    assert ppl.stage_pspec(3) == tuple(stacked_param_pspecs(
        {"w": jnp.zeros((2, 2, 2))})["w"])
    assert ppl.stacked_param_pspecs({"w": np.zeros((2, 3))}) == {
        "w": ("pp", None)}
