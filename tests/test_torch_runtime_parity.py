"""One driver program, run against the JAX package and against the port
in turn: the results must be equal, value for value.

The program covers fan-out, ref-argument chains, ``num_returns``, an
actor's state and call ordering, a named actor, a placement group, and
``put``/``get`` of numpy arrays and of an array made from the same
numpy values (a ``jax.Array`` for the JAX package, a ``torch.Tensor``
for the port), through the host store, through a task, and through the
device tier.
"""

import functools
import hashlib
import importlib

import numpy as np
import pytest
from _port_fixtures import one_intra_op_thread  # noqa: F401

PACKAGES = {"jax": "ray_memory_management_tpu",
            "torch": "ray_memory_management_tpu_torch"}


def _array_from(kind: str, values: np.ndarray):
    if kind == "jax":
        import jax.numpy as jnp

        return jnp.asarray(values)
    import torch

    return torch.from_numpy(values.copy())


def _digest(value) -> tuple:
    a = np.asarray(value)
    return (str(a.dtype), a.shape, hashlib.sha256(a.tobytes()).hexdigest())


@functools.lru_cache(maxsize=None)
def _program(kind: str) -> dict:
    rmt = importlib.import_module(PACKAGES[kind])
    util = importlib.import_module(PACKAGES[kind] + ".utils")
    rng = np.random.default_rng(0)
    host = rng.standard_normal(300_000).astype(np.float32)
    dev_values = rng.standard_normal((64, 33)).astype(np.float32)

    rmt.init(num_cpus=4)
    try:
        @rmt.remote
        def add(a, b):
            return a + b

        @rmt.remote(num_returns=3)
        def three(x):
            return x, x * 2, x * 3

        @rmt.remote
        def total(a):
            return float(np.asarray(a, dtype=np.float64).sum())

        @rmt.remote
        class Counter:
            def __init__(self, start):
                self.n = start
                self.log = []

            def inc(self, by):
                self.n += by
                self.log.append(self.n)
                return self.n

            def history(self):
                return list(self.log)

        out = {}
        out["fanout"] = rmt.get([add.remote(i, i * i) for i in range(20)])
        out["chain"] = rmt.get(add.remote(add.remote(1, 2),
                                          add.remote(add.remote(3, 4), 5)))
        out["num_returns"] = rmt.get(list(three.remote(7)))

        c = Counter.remote(10)
        out["actor_calls"] = rmt.get([c.inc.remote(i) for i in range(8)])
        out["actor_history"] = rmt.get(c.history.remote())

        Counter.options(name="parity_counter").remote(100)
        named = rmt.get_actor("parity_counter")
        out["named"] = rmt.get([named.inc.remote(1), named.inc.remote(2)])

        pg = util.placement_group([{"CPU": 1}, {"CPU": 1}],
                                  strategy="PACK")
        assert pg.wait(30)
        strategy = util.PlacementGroupSchedulingStrategy(pg, 1)
        out["pg_task"] = rmt.get(
            add.options(scheduling_strategy=strategy).remote(40, 2))
        util.remove_placement_group(pg)

        ref = rmt.put(host)
        out["numpy_get"] = _digest(rmt.get(ref))
        out["numpy_task"] = rmt.get(total.remote(ref))

        arr = _array_from(kind, dev_values)
        out["array_get"] = _digest(rmt.get(rmt.put(arr)))
        out["array_task"] = rmt.get(total.remote(arr))
        dref = rmt.put(arr, device=True)
        out["array_device_same_object"] = rmt.get(dref) is arr
        out["array_device_task"] = rmt.get(total.remote(dref))
        return out
    finally:
        rmt.shutdown()


def _expected() -> dict:
    rng = np.random.default_rng(0)
    host = rng.standard_normal(300_000).astype(np.float32)
    dev_values = rng.standard_normal((64, 33)).astype(np.float32)
    calls, n = [], 10
    for i in range(8):
        n += i
        calls.append(n)
    return {
        "fanout": [i + i * i for i in range(20)],
        "chain": 15,
        "num_returns": [7, 14, 21],
        "actor_calls": calls,
        "actor_history": calls,
        "named": [101, 103],
        "pg_task": 42,
        "numpy_get": _digest(host),
        "numpy_task": float(host.astype(np.float64).sum()),
        "array_get": _digest(dev_values),
        "array_task": float(dev_values.astype(np.float64).sum()),
        "array_device_same_object": True,
        "array_device_task": float(dev_values.astype(np.float64).sum()),
    }


@pytest.mark.parametrize("kind", list(PACKAGES))
def test_program_matches_plain_python(kind):
    assert _program(kind) == _expected()


def test_packages_give_equal_results():
    assert _program("jax") == _program("torch")
