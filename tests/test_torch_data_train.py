"""Train fed by the Data library, on the CPU.

- ``TorchTrainer(datasets={"train": ds})`` with a ``data.Dataset``: each
  of two workers gets part i of ``ds.split(2)``, and
  ``session.get_dataset_shard("train").iter_batches`` yields its rows in
  order.
- The slice as a whole, against the JAX package: the ``test`` preset (2
  layers, d_model 64) trained for 4 AdamW steps by ``TorchTrainer`` over
  a one-rank gloo world, running ``runtime_smoke.data_train_loop`` (the
  loop ``chip_smoke.py`` phase 13 runs on the card) on a ``Dataset`` of
  seeded token rows split into inputs and targets by ``map_batches``;
  against the JAX package's ``gpt.loss_fn`` and ``optax.adamw`` on the
  batches of the JAX package's ``Dataset`` of the same rows, in the same
  order. The JAX initial weights cross through ``models/convert.py``.
  Both in fp32; every step's loss within 1e-4 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax

import ray_memory_management_tpu as jrmt
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu import data as jrd
from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu_torch import data as rd
from ray_memory_management_tpu_torch.train import (
    RunConfig, ScalingConfig, TorchTrainer,
)
from ray_memory_management_tpu_torch.utils import runtime_smoke
from _port_fixtures import one_intra_op_thread  # noqa: F401

B, S, STEPS = 2, 16, 4


def _shard_loop(config):
    from ray_memory_management_tpu_torch.train import session

    rows = [int(v) for b in session.get_dataset_shard("train").iter_batches(
        batch_size=5, batch_format="numpy") for v in b]
    with open(f"{config['out']}/{session.get_world_rank()}.json", "w") as f:
        json.dump(rows, f)


def test_dataset_reaches_each_worker_as_its_split_part(tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rmt.init(num_cpus=4)
    try:
        ds = rd.range(23, parallelism=5).random_shuffle(seed=2)
        want = [p.take_all() for p in ds.split(2)]
        res = TorchTrainer(
            _shard_loop, train_loop_config={"out": str(tmp_path)},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="shards",
                                 storage_path=str(tmp_path)),
            datasets={"train": ds}).fit()
        assert res.error is None, res.error
    finally:
        rmt.shutdown()
    got = [json.loads((tmp_path / f"{r}.json").read_text())
           for r in range(2)]
    assert got == want
    assert sorted(got[0] + got[1]) == list(range(23))
    assert all(got)


def _token_rows():
    return np.random.default_rng(7).integers(
        0, 512, size=(B * STEPS, S + 1)).astype(np.int64)


def _jax_losses(cfg):
    """The JAX package's loop: its ``Dataset`` of the same rows, split by
    ``map_batches``, read in order; ``loss_fn`` and ``optax.adamw`` with
    the port's AdamW settings (``gpu_bench.ADAMW``)."""
    params = jgpt.init_params(jax.random.PRNGKey(0), cfg)
    init = jax.tree.map(np.asarray, params)
    opt = optax.adamw(3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    state = opt.init(params)

    @jax.jit
    def step(p, s, batch):
        loss, g = jax.value_and_grad(
            lambda p_: jgpt.loss_fn(p_, batch, cfg))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    jrmt.init(num_cpus=2)
    try:
        ds = jrd.from_numpy(_token_rows()).map_batches(
            lambda b: {"tokens": b[:, :-1], "targets": b[:, 1:]},
            batch_format="numpy")
        losses = []
        for rows in ds.iter_batches(batch_size=B, batch_format="numpy",
                                    drop_last=True):
            batch = {k: jnp.asarray(rows[k], jnp.int32)
                     for k in ("tokens", "targets")}
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
    finally:
        jrmt.shutdown()
    return init, losses


def test_data_fed_trainer_matches_jax(tmp_path, monkeypatch):
    cfg = dataclasses.replace(jgpt.PRESETS["test"], dtype=jnp.float32,
                              max_seq=S)
    init, want = _jax_losses(cfg)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rmt.init(num_cpus=4)
    try:
        ds = rd.from_numpy(_token_rows()).map_batches(
            runtime_smoke.split_next_token, batch_format="numpy")
        res = TorchTrainer(
            runtime_smoke.data_train_loop,
            train_loop_config={"device": "cpu", "preset": "test",
                               "batch": B, "seq": S, "dtype": "float32",
                               "params": init},
            scaling_config=ScalingConfig(num_workers=1,
                                         collective_backend="dist"),
            run_config=RunConfig(name="data", storage_path=str(tmp_path)),
            datasets={"train": ds}).fit()
    finally:
        rmt.shutdown()
    assert res.error is None, res.error
    final = [m for m in res.metrics_history if m.get("final")][0]
    assert final["backend"] == "gloo"
    assert len(final["losses"]) == STEPS == len(final["wait_s"])
    np.testing.assert_allclose(final["losses"], want, rtol=1e-4, atol=0)
    assert all(np.isfinite(final["losses"]))
