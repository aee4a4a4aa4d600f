"""The Data library against the JAX package: one program runs on each
package's runtime in turn, and its rows must be equal, in order.

The program: ``range`` -> ``map_batches`` (numpy, to key/value columns)
-> ``random_shuffle(seed)`` -> ``sort`` -> ``groupby().sum()`` and
``split(3, equal=True)``; and ``from_numpy`` -> ``map_batches`` ->
``random_shuffle(seed)``, materialized by ``to_jax`` (its ``np.asarray``)
and by the port's ``to_torch`` (its ``.numpy()``). Both packages'
shuffles draw from numpy with the same seed, so equal means equal,
element for element. Also the port's rules for the card: ``to_torch``
lands on the card unless asked for the CPU and raises without one, and
a GPU actor pool that finds no card fails the dataset instead of
scoring on the CPU.
"""

import functools
import importlib

import numpy as np
import pytest
from _port_fixtures import one_intra_op_thread  # noqa: F401

PACKAGES = {"jax": "ray_memory_management_tpu",
            "torch": "ray_memory_management_tpu_torch"}


def _plain(rows):
    out = []
    for r in rows:
        if isinstance(r, dict):
            out.append({k: np.asarray(v).item() for k, v in r.items()})
        else:
            out.append(np.asarray(r).tolist())
    return out


@functools.lru_cache(maxsize=None)
def _program(kind: str) -> dict:
    rmt = importlib.import_module(PACKAGES[kind])
    rd = importlib.import_module(PACKAGES[kind] + ".data")
    values = np.random.default_rng(0).standard_normal((40, 3)).astype(
        np.float32)
    # batch functions local to the program travel by value in both
    # packages (a test module is not importable in their workers)
    def _keyed(batch):
        return {"k": batch % 5, "v": (batch * 7) % 61}

    def _affine(batch):
        return batch * 2.0 + 1.0

    def _columns(batch):
        return {"x": batch[:, 0], "n": (batch[:, 1] * 100).astype(np.int32)}

    rmt.init(num_cpus=4)
    try:
        keyed = rd.range(60, parallelism=4).map_batches(
            _keyed, batch_format="numpy")
        shuffled = keyed.random_shuffle(seed=11)
        ordered = shuffled.sort(key="v")
        tensors = rd.from_numpy(values).map_batches(
            _affine, batch_format="numpy").random_shuffle(seed=3)
        columns = rd.from_numpy(values).map_batches(
            _columns, batch_format="numpy").random_shuffle(seed=5)
        out = {
            "shuffled": _plain(shuffled.take_all()),
            "sorted": _plain(ordered.take_all()),
            "sums": ordered.groupby("k").sum("v"),
            "parts": [_plain(p.take_all())
                      for p in shuffled.split(3, equal=True)],
        }
        if kind == "jax":
            import jax

            cpu = jax.devices("cpu")[0]
            out["tensor"] = np.asarray(tensors.to_jax(device=cpu))
            out["columns"] = {k: np.asarray(v) for k, v in
                              columns.to_jax(device=cpu).items()}
        else:
            out["tensor"] = tensors.to_torch(device="cpu").numpy()
            out["columns"] = {k: v.numpy() for k, v in
                              columns.to_torch(device="cpu").items()}
        return out
    finally:
        rmt.shutdown()


@pytest.mark.parametrize("what", ["shuffled", "sorted", "sums", "parts"])
def test_rows_equal_in_order(what):
    want, got = _program("jax")[what], _program("torch")[what]
    assert got == want
    if what == "shuffled":
        assert got != [{"k": i % 5, "v": i * 7 % 61} for i in range(60)]
    if what == "parts":
        assert [len(p) for p in got] == [20, 20, 20]


def test_to_torch_equals_to_jax():
    want, got = _program("jax"), _program("torch")
    assert got["tensor"].dtype == want["tensor"].dtype == np.float32
    np.testing.assert_array_equal(got["tensor"], want["tensor"])
    assert got["columns"].keys() == want["columns"].keys()
    for k in want["columns"]:
        assert got["columns"][k].dtype == want["columns"][k].dtype
        np.testing.assert_array_equal(got["columns"][k], want["columns"][k])


@pytest.fixture
def rmt_torch(monkeypatch):
    import ray_memory_management_tpu_torch as rmt

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rt = rmt.init(num_cpus=2)
    yield rt
    rmt.shutdown()


def test_to_torch_needs_the_card_unless_asked_for_the_cpu(rmt_torch):
    import torch

    from ray_memory_management_tpu_torch import data as rd

    ds = rd.range_tensor(6, shape=(2,), parallelism=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.to_torch()
    t = ds.to_torch(device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.int64
    assert t.shape == (6, 2)


@pytest.fixture
def rmt_named_gpus(monkeypatch):
    """A node whose CUDA_VISIBLE_DEVICES names card "5": one GPU counted,
    no card behind it."""
    import ray_memory_management_tpu_torch as rmt

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")
    rt = rmt.init(num_cpus=2)
    yield rt
    rmt.shutdown()


def test_gpu_actor_pool_without_a_card_fails_the_dataset(rmt_named_gpus):
    """``ActorPoolStrategy(num_gpus=1)`` leases the pool actor GPU "5";
    the scorer finds no card there and raises, and the error reaches the
    caller of the dataset."""
    from ray_memory_management_tpu_torch import data as rd
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    tokens = np.random.default_rng(0).integers(0, 512, size=(4, 16))
    ds = rd.from_numpy(tokens).map_batches(
        runtime_smoke.score_batch, batch_size=2, batch_format="numpy",
        compute=rd.ActorPoolStrategy(size=1, num_gpus=1), preset="test")
    with pytest.raises(Exception, match="no CUDA device"):
        ds.take_all()


def test_scorer_on_the_cpu_matches_the_model():
    """``runtime_smoke.score_batch`` (the pool's batch function on the
    card) on the CPU: each row's mean next-token log-probability and last
    argmax against ``log_softmax`` of the port's ``gpt.forward`` on the
    same seeded weights, in fp32."""
    import dataclasses

    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    tokens = np.random.default_rng(1).integers(0, 512, size=(3, 24))
    got = runtime_smoke.score_batch(tokens, preset="test", seed=4,
                                    dtype="float32", device="cpu")
    cfg = dataclasses.replace(gpt.PRESETS["test"], dtype=torch.float32)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    t = torch.from_numpy(tokens)
    logp = torch.log_softmax(gpt.forward(params, t, cfg), -1)
    want = logp[:, :-1].gather(-1, t[:, 1:, None])[..., 0].mean(-1)
    np.testing.assert_allclose(got["logprob"], want.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got["argmax"],
                                  logp[:, -1].argmax(-1).numpy())
    assert got["logprob"].dtype == np.float32
    assert list(got["launches"]) == [0, 0, 0]   # the CPU takes the plain path
