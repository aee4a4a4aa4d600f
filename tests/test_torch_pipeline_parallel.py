"""PyTorch port vs JAX package: the GPipe pipeline over the ``pp`` ranks of
a gloo world, and checkpoints of the local shards that ep and pp leave on
each rank, on the CPU.

The port runs on one ``LocalWorld`` of 4 spawned ranks (120 s deadline a
call): pp 4 (the ``test`` preset with 4 layers, one a stage) and dp 2 x
pp 2 (2 layers, one a stage, each dp shard its own pipeline), stages cut
by ``shard_pytree``, activations over ``batch_isend_irecv``. The JAX side
runs ``pipeline_loss_fn`` on the same axes of the conftest's CPU devices.
From the JAX weights in fp32 with plain attention: every rank's losses
over 3 Adam(1e-3) steps to 1e-5 relative, and its first-step gradients
(stages gathered) to 1e-4 of each leaf's largest value, against
``jax.grad`` on the JAX mesh; the replicated leaves' gradients are
bit-equal on every rank.

Copied from ``tests/test_parallel.py``: ``TestPipelineParallel`` (3
cases; the JAX cases' pp 2 and dp 4 x pp 2 meshes become dp 2 x pp 2 and
pp 4 on 4 ranks) and ``TestExpertParallel::test_moe_through_pipeline_
keeps_aux``, with the JAX tolerances (bf16, the preset's dtype).

Checkpoints (ep 4 and pp 4 trees): ``Checkpoint.from_pytree`` gathers
the local shards into the global leaves, bit-equal to the unsharded
parameters, and a step resumed from a checkpoint of the parameters and
the Adam state takes the loss the uninterrupted run took.
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
    pipeline_loss_fn,
    shard_pytree,
    stacked_param_pspecs,
)
from ray_memory_management_tpu.parallel.pipeline import pipeline_forward
from ray_memory_management_tpu.parallel.sharding import param_pspecs
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld
from _port_fixtures import one_intra_op_thread  # noqa: F401

WORLD = 4
STEPS = 3
# (axes, layers, microbatches, batch axes)
MESHES = [({"pp": 4}, 4, 4, ()), ({"dp": 2, "pp": 2}, 2, 2, ("dp",))]


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD, timeout_s=120) as w:
        yield w


def _batch():
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 512)
    return {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}


def _jax_params(preset, layers, fp32=True):
    cfg = dataclasses.replace(jgpt.PRESETS[preset], attention="ref",
                              n_layers=layers)
    if fp32:
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    return cfg, jgpt.init_params(jax.random.PRNGKey(0), cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _port_pp(rank, world, params_np, batch_np, axes, steps, m,
             batch_axes=(), preset="test", layers=2, fp32=True,
             probe_aux=False):
    """``steps`` Adam(1e-3) steps through ``make_train_step`` over
    ``pipeline_loss_fn`` on a mesh of ``axes``: (losses, the first step's
    gradients with the stages gathered, the unpipelined loss of the
    start, the pipelined aux of the start if ``probe_aux``)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax, params_to_numpy,
    )
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, make_train_step, param_pspecs, pipeline_forward,
        pipeline_loss_fn, shard_pytree,
    )
    from ray_memory_management_tpu_torch.parallel.sharding import (
        local_shard_cuts,
    )

    cfg = dataclasses.replace(gpt.PRESETS[preset], attention="ref",
                              n_layers=layers)
    if fp32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = params_from_jax(params_np, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    with torch.no_grad():
        unpipelined = float(gpt.loss_fn(params, batch, cfg))
    mesh = cpu_mesh(axes)
    sp = shard_pytree(params, mesh, param_pspecs(params, mesh, "dp"))
    aux = None
    if probe_aux:  # on this rank's rows, as make_train_step hands them
        rows = batch["tokens"]
        if batch_axes:
            rows = rows.chunk(mesh.size(mesh.mesh_dim_names.index("dp")))[
                mesh.get_local_rank("dp")]
        with torch.no_grad():
            aux = float(pipeline_forward(sp, rows, cfg, mesh,
                                         n_microbatches=m,
                                         batch_axes=batch_axes)[1])
    opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
    step = make_train_step(
        lambda p, b: pipeline_loss_fn(p, b, cfg, mesh, n_microbatches=m,
                                      batch_axes=batch_axes), opt, mesh)
    losses = [float(step(sp, batch))]

    def full_grad(node):
        if isinstance(node, dict):
            return {k: full_grad(v) for k, v in node.items()}
        g = node.grad.detach()
        for group, dim in reversed(local_shard_cuts(node) or ()):
            parts = [torch.empty_like(g)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, g.contiguous(), group=group)
            g = torch.cat(parts, dim=dim)
        return g.clone()

    first = params_to_numpy(full_grad(sp))
    losses += [float(step(sp, batch)) for _ in range(steps - 1)]
    return losses, first, unpipelined, aux


def _jax_mesh_specs(params, axes):
    mesh = cpu_mesh(axes)
    specs = param_pspecs(params, mesh, "dp")
    specs["layers"] = stacked_param_pspecs(params["layers"])
    return mesh, shard_pytree(params, mesh, specs, copy=True)


def _jax_pp(cfg, params, batch, axes, m, batch_axes):
    mesh, sp = _jax_mesh_specs(params, axes)

    def loss(p, b):
        return pipeline_loss_fn(p, b, cfg, mesh, n_microbatches=m,
                                batch_axes=batch_axes)

    grads = jax.jit(jax.grad(lambda p: loss(p, batch)))(sp)
    opt = optax.adam(1e-3)
    step = make_train_step(loss, opt, mesh)
    losses, p, s = [], sp, opt.init(sp)
    for _ in range(STEPS):
        p, s, lval = step(p, s, batch)
        losses.append(float(lval))
    return losses, grads


@pytest.mark.parametrize("axes,layers,m,batch_axes", MESHES,
                         ids=["pp4", "dp2xpp2"])
def test_pipeline_losses_and_gradients_match_jax(world, axes, layers, m,
                                                 batch_axes):
    cfg, params = _jax_params("test", layers)
    batch = _batch()
    want_losses, want_grads = _jax_pp(cfg, params, batch, axes, m,
                                      batch_axes)
    want = dict(_leaves(want_grads))
    runs = world.run(_port_pp, _np(params), _np(batch), axes, STEPS, m,
                     batch_axes, "test", layers)
    for losses, grads, _, _ in runs:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
        got = dict(_leaves(grads))
        assert set(got) == set(want)
        for path, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=path)
    # the replicated leaves end each step with one gradient on every rank
    for path in ("/tok_embed", "/final_ln", "/lm_head"):
        for _, grads, _, _ in runs[1:]:
            np.testing.assert_array_equal(dict(_leaves(grads))[path],
                                          dict(_leaves(runs[0][1]))[path])
    assert want_losses[-1] < want_losses[0]


def test_moe_aux_through_the_pipeline_matches_jax(world):
    """test-moe over dp 2 x pp 2: the aux of the microbatches' own
    dispatch groups, summed over stages and averaged over dp, equals the
    JAX pipeline's."""
    cfg, params = _jax_params("test-moe", 2)
    batch = _batch()
    mesh, sp = _jax_mesh_specs(params, {"dp": 2, "pp": 2})
    want = float(jax.jit(lambda p: pipeline_forward(
        p, batch["tokens"], cfg, mesh, n_microbatches=2,
        batch_axes=("dp",))[1])(sp))
    for _, _, _, aux in world.run(_port_pp, _np(params), _np(batch),
                                  {"dp": 2, "pp": 2}, 1, 2, ("dp",),
                                  "test-moe", 2, True, True):
        np.testing.assert_allclose(aux, want, rtol=1e-5)


# ------------------------- copies of tests/test_parallel.py (pipeline cases)
class TestPipelineParallel:
    """GPipe microbatch schedule over P2P stages (parallel/pipeline.py)."""

    @pytest.mark.parametrize("m", [2, 4])
    def test_two_stage_lm_matches_unpipelined_loss(self, world, m):
        cfg, params = _jax_params("test", 2, fp32=False)
        for losses, _, ref, _ in world.run(
                _port_pp, _np(params), _np(_batch()), {"dp": 2, "pp": 2},
                1, m, ("dp",), "test", 2, False):
            np.testing.assert_allclose(losses[0], ref, rtol=2e-2)

    def test_pipeline_gradients_match(self, world):
        """Weight grads come out cut over pp like the weights (gathered
        here), equal to the unpipelined ones."""
        cfg, params = _jax_params("test", 4, fp32=False)
        batch = _batch()
        g_ref = jax.grad(lambda p: jgpt.loss_fn(p, batch, cfg))(params)
        for _, grads, _, _ in world.run(_port_pp, _np(params), _np(batch),
                                        {"pp": 4}, 1, 4, (), "test", 4,
                                        False):
            for name in ("wq", "w2"):
                np.testing.assert_allclose(
                    grads["layers"][name], np.asarray(g_ref["layers"][name]),
                    rtol=5e-2, atol=2e-3)
            np.testing.assert_allclose(grads["lm_head"],
                                       np.asarray(g_ref["lm_head"]),
                                       rtol=5e-2, atol=2e-3)

    def test_pipeline_composes_with_dp_and_trains(self, world):
        cfg, params = _jax_params("test", 2, fp32=False)
        for losses, _, _, _ in world.run(
                _port_pp, _np(params), _np(_batch()), {"dp": 2, "pp": 2},
                4, 2, ("dp",), "test", 2, False):
            assert losses[-1] < losses[0], losses


class TestExpertParallel:
    def test_moe_through_pipeline_keeps_aux(self, world):
        """pipeline_loss_fn carries the MoE load-balancing aux: the
        pipelined loss tracks gpt.loss_fn (which includes it)."""
        cfg, params = _jax_params("test-moe", 2, fp32=False)
        for losses, _, ref, _ in world.run(
                _port_pp, _np(params), _np(_batch()), {"dp": 2, "pp": 2},
                1, 2, ("dp",), "test-moe", 2, False):
            np.testing.assert_allclose(losses[0], ref, rtol=2e-2)


def test_batches_that_do_not_split_raise(world):
    """A global batch that does not split over dp, and a per-shard batch
    that does not split into the microbatches, raise on every rank."""
    cfg, params = _jax_params("test", 2)
    batch = _np(_batch())
    seven = {k: v[:7] for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="does not split over 2 ranks"):
        world.run(_port_pp, _np(params), seven, {"dp": 2, "pp": 2}, 1, 2,
                  ("dp",))
    six = {k: v[:6] for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="per-shard batch 3 .* not "
                       "divisible by 2 microbatches"):
        world.run(_port_pp, _np(params), six, {"dp": 2, "pp": 2}, 1, 2,
                  ("dp",))


# ------------------------------------------ checkpoints of local shards
def _port_ckpt(rank, world, params_np, batch_np, preset, axes):
    """Shard, checkpoint the start, take 2 Adam steps, checkpoint the
    parameters and the Adam state, take two more steps; then restore
    the second checkpoint into a fresh shard and optimizer and take those
    two steps again. Returns (the start's checkpoint, the local w1 shape,
    the checkpointed shape of w1's Adam moment, losses 3-4, resumed
    losses 3-4)."""
    import dataclasses

    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax, params_to_numpy,
    )
    from ray_memory_management_tpu_torch.parallel import (
        cpu_mesh, make_train_step, param_pspecs, pipeline_loss_fn,
        shard_pytree,
    )
    from ray_memory_management_tpu_torch.parallel.sharding import (
        load_optimizer_state,
    )
    from ray_memory_management_tpu_torch.train import Checkpoint

    cfg = dataclasses.replace(gpt.PRESETS[preset], attention="ref",
                              dtype=torch.float32, n_layers=4)
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    mesh = cpu_mesh(axes)
    rule = "ep" if "ep" in axes else "dp"

    def loss_fn(p, b):
        if "pp" in axes:
            return pipeline_loss_fn(p, b, cfg, mesh)
        return gpt.loss_fn(p, b, cfg, mesh)

    def fresh(tree):
        params = params_from_jax(params_to_numpy(tree), device="cpu")
        sp = shard_pytree(params, mesh, param_pspecs(params, mesh, rule))
        opt = torch.optim.Adam(list(gpt.param_leaves(sp)), lr=1e-3)
        return sp, opt, make_train_step(loss_fn, opt, mesh)

    sp, opt, step = fresh(params_from_jax(params_np, device="cpu"))
    start = params_to_numpy(Checkpoint.from_pytree(sp).get_pytree())
    local_w1 = tuple(sp["layers"]["w1"].shape)
    step(sp, batch)
    step(sp, batch)
    ckpt = Checkpoint.from_pytree({"params": sp,
                                   "opt": opt.state_dict()}).get_pytree()
    i_w1 = [id(t) for t in gpt.param_leaves(sp)].index(
        id(sp["layers"]["w1"]))
    moment = tuple(ckpt["opt"]["state"][i_w1]["exp_avg"].shape)
    after = [float(step(sp, batch)) for _ in range(2)]
    sp2, opt2, step2 = fresh(ckpt["params"])
    load_optimizer_state(opt2, ckpt["opt"])
    return (start, local_w1, moment, after,
            [float(step2(sp2, batch)) for _ in range(2)])


@pytest.mark.parametrize("preset,axes", [("test-moe", {"ep": 4}),
                                         ("test", {"pp": 4})],
                         ids=["ep4", "pp4"])
def test_checkpoint_of_local_shards_holds_the_global_leaves(world, preset,
                                                            axes):
    _, params = _jax_params(preset, 4)
    params_np = _np(params)
    runs = world.run(_port_ckpt, params_np, _np(_batch()), preset, axes)
    full = params_np["layers"]["w1"].shape
    for start, local_w1, moment, after, resumed in runs:
        # the local shard is a quarter of its leaf; the checkpoint is whole
        assert local_w1 != full
        assert len(list(_leaves(start))) == len(list(_leaves(params_np)))
        for (path, got), (_, want) in zip(_leaves(start),
                                          _leaves(params_np)):
            np.testing.assert_array_equal(got, want, err_msg=path)
        assert moment == full
        # the fourth loss is the first taken after a step that used the
        # restored Adam moments
        assert resumed == after
    assert all(r[3] == runs[0][3] for r in runs)


def test_a_shard_whose_group_is_gone_is_never_written_whole():
    """Outside a process group a recorded local shard cannot be gathered,
    and ``Checkpoint.from_pytree`` raises rather than write it as the
    whole leaf."""
    import torch

    from ray_memory_management_tpu_torch.parallel import sharding
    from ray_memory_management_tpu_torch.train import Checkpoint

    shard = torch.zeros(1, 4)
    sharding._record_cuts(shard, [(None, 0)])
    assert sharding.local_shard_cuts(shard) == ((None, 0),)
    with pytest.raises(RuntimeError, match="cannot be gathered"):
        Checkpoint.from_pytree({"layers": {"w": shard}})
    plain = torch.zeros(1, 4)
    assert sharding.local_shard_cuts(plain) is None
    assert Checkpoint.from_pytree({"w": plain}).get_pytree()["w"].shape == (
        1, 4)
