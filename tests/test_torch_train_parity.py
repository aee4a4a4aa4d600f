"""Train against the JAX package, and the port's rules for the card.

- The model loop of ``tests/test_train.py:166-211`` (the ``test`` preset,
  3 Adam(1e-3) steps on one batch) through ``TorchTrainer`` gives the
  JAX loop's losses, from the JAX package's initial weights carried
  across by ``models/convert.py``. Both sides compute in fp32 (the
  original loop's bf16 rounds products differently in XLA and torch),
  to 1e-4 relative.
- No CPU fallback: a ``use_gpu`` trainer on a cluster without a GPU
  raises; a ``dist`` trainer or collective group whose worker holds a
  GPU lease but sees no card fails instead of running gloo on the CPU;
  a CUDA mesh without a card raises.
- ROADMAP C: dist-mode chip partitioning hands out the node's device
  NAMES (``CUDA_VISIBLE_DEVICES`` "5,2" gives "5" and "2") where the JAX
  package partitions raw indices ("0" and "1").
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.train.backend_executor import (
    partition_chips_for_host as jax_partition_chips_for_host,
)
from ray_memory_management_tpu_torch import collective as col
from ray_memory_management_tpu_torch.exceptions import RmtError
from ray_memory_management_tpu_torch.train import (
    RunConfig, ScalingConfig, TorchTrainer,
)
from ray_memory_management_tpu_torch.train.backend_executor import (
    WorkerGroup, _TrainWorkerImpl, node_gpu_names,
)
from ray_memory_management_tpu_torch.utils.local_world import LocalWorld
from _port_fixtures import one_intra_op_thread  # noqa: F401

STEPS = 3


@pytest.fixture
def rmt_cpu_only(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rt = rmt.init(num_cpus=4)
    yield rt
    rmt.shutdown()


@pytest.fixture
def rmt_named_gpus(monkeypatch):
    """A node whose CUDA_VISIBLE_DEVICES names cards "5" and "2": two GPUs
    counted, no card behind them."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,2")
    rt = rmt.init(num_cpus=4)
    yield rt
    rmt.shutdown()


# ----------------------------------------------------------- the LM loop
def _jax_losses():
    cfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32)
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(1e-3)
    state = opt.init(params)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                              cfg.vocab_size)
    batch = {"tokens": toks, "targets": jnp.roll(toks, -1, 1)}

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda p_: jgpt.loss_fn(p_, batch, cfg))(p)
        u, s = opt.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s, loss

    init = jax.tree.map(np.asarray, params)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return init, np.asarray(toks), losses


def _lm_loop(config):
    import dataclasses

    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.models.convert import (
        params_from_jax,
    )
    from ray_memory_management_tpu_torch.train import Checkpoint, session

    cfg = dataclasses.replace(gpt.PRESETS["test"], dtype=torch.float32)
    params = params_from_jax(config["params"], device="cpu")
    leaves = list(gpt.param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    toks = torch.from_numpy(config["tokens"].astype("int64"))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    for i in range(config["steps"]):
        opt.zero_grad()
        loss = gpt.loss_fn(params, batch, cfg)
        loss.backward()
        opt.step()
        session.report({"step": i, "loss": float(loss)})
    session.report({"final": True},
                   checkpoint=Checkpoint.from_pytree(params))


def test_lm_loop_through_trainer_matches_jax(rmt_cpu_only, tmp_path):
    init, tokens, want = _jax_losses()
    res = TorchTrainer(
        _lm_loop,
        train_loop_config={"params": init, "tokens": tokens,
                           "steps": STEPS},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="lm", storage_path=str(tmp_path)),
    ).fit()
    assert res.error is None, res.error
    got = [m["loss"] for m in res.metrics_history if "loss" in m]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    tree = res.checkpoint.get_pytree()
    assert tree["lm_head"].shape == init["lm_head"].shape
    assert tree["lm_head"].device.type == "cpu"


# ------------------------------------------------------ no CPU fallback
def test_use_gpu_trainer_without_a_gpu_raises(rmt_cpu_only, tmp_path):
    trainer = TorchTrainer(
        _lm_loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        trainer.fit()


def _never_reached():
    from ray_memory_management_tpu_torch.train import session

    session.report({"ran": True})


def test_dist_trainer_with_a_lease_but_no_card_fails(rmt_named_gpus,
                                                     tmp_path):
    """The worker leases card "5" but CUDA sees none: NCCL cannot form,
    and the world does not fall back to gloo; the loop never runs."""
    res = TorchTrainer(
        _never_reached,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     gpus_per_worker=1,
                                     collective_backend="dist"),
        run_config=RunConfig(storage_path=str(tmp_path)),
    ).fit()
    assert res.error is not None
    assert "no CUDA device" in str(res.error)
    assert not any(m.get("ran") for m in res.metrics_history)


@rmt.remote(num_gpus=1)
class _Leased(col.CollectiveGroupMixin):
    def lease(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_dist_group_on_a_leased_worker_without_card_raises(rmt_named_gpus):
    actor = _Leased.remote()
    assert rmt.get(actor.lease.remote(), timeout=120) in ("5", "2")
    with pytest.raises(RmtError, match="no CUDA device"):
        col.create_collective_group([actor], 1, [0], backend="dist",
                                    group_name="leased")


def test_dist_group_on_cuda_raises_here():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        col.init_collective_group(1, 0, backend="dist", group_name="cuda",
                                  device="cuda",
                                  init_method="tcp://127.0.0.1:1")
    assert not col.is_group_initialized("cuda")


def _meshes(rank, world):
    from ray_memory_management_tpu_torch.parallel import make_mesh

    out = []
    for axes, device_type in (({"dp": world}, "cuda"),
                              ({"dp": world + 1}, "cpu")):
        try:
            make_mesh(axes, device_type=device_type)
            out.append("built")
        except (RuntimeError, ValueError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


def test_make_mesh_needs_its_world_and_the_card():
    from ray_memory_management_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh({"dp": 1}, device_type="cpu")
    with LocalWorld(2) as world:
        cuda, too_big = world.run(_meshes)[0]
    assert cuda.startswith("RuntimeError") and "CUDA" in cuda
    assert too_big.startswith("ValueError") and "3 ranks" in too_big


# ------------------------------------------------- ROADMAP C: device names
def test_dist_partition_uses_device_names_not_raw_indices(rmt_named_gpus):
    """Two dist-mode workers without a GPU lease share a node whose cards
    are "5" and "2": the JAX package's partition of that node is the raw
    indices "0" and "1" (cards the node was not given); the port hands
    each worker one of the node's names."""
    assert jax_partition_chips_for_host(2, 2) == ["0", "1"]
    rt = rmt_named_gpus
    assert node_gpu_names()[rt.head_node().node_id.hex()] == ["5", "2"]
    group = WorkerGroup(2, {"CPU": 1})
    try:
        group.partition_chips()
        infos = rmt.get([a._rmt_host_info.remote() for a in group.actors],
                        timeout=120)
    finally:
        group.shutdown()
    assert [i["visible_chips"] for i in infos] == ["5", "2"]


def test_pick_coordinator_stays_on_this_host(monkeypatch):
    """The rendezvous address is 127.0.0.1 (or RMT_NODE_IP): nothing
    outside the machine is probed to find it."""
    w = _TrainWorkerImpl(0, 1, "g")
    monkeypatch.delenv("RMT_NODE_IP", raising=False)
    host, port = w._rmt_pick_coordinator().rsplit(":", 1)
    assert host == "127.0.0.1" and int(port) > 0
    monkeypatch.setenv("RMT_NODE_IP", "10.1.2.3")
    assert w._rmt_pick_coordinator().startswith("10.1.2.3:")


def test_scaling_config_resolves_backends():
    assert ScalingConfig(collective_backend="xla").collective_backend \
        == "dist"
    assert ScalingConfig(collective_backend="gloo").collective_backend \
        == "objstore"
    assert ScalingConfig(use_gpu=True).bundle() == {"CPU": 1, "GPU": 1}
    assert ScalingConfig(use_gpu=True, gpus_per_worker=2).bundle()["GPU"] \
        == 2
    assert "GPU" not in ScalingConfig().bundle()
    with pytest.raises(ValueError):
        ScalingConfig(collective_backend="mpi")
