"""Weight shipping and the serve controller's redeploy rule in the
PyTorch port.

``pack_weights`` payloads are held byte for byte against the JAX
package's (its own params on one side, ``params_from_jax`` of the same
params on the other), ``unpack_weights`` against the JAX package's
dequantized leaves, and a port server given the port's payload against a
JAX server given the JAX payload (greedy tokens, preset ``"test"``). The
controller decides whether a redeploy changed the init arguments by a
digest, so numpy arrays and tensors among them neither raise nor
replace a replica whose arguments are equal. A replica that asks for
the card without a lease fails to start: it never serves from the CPU.
"""

import time

import numpy as np
import pytest
import torch

import jax

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu.core import codec as jcodec
from ray_memory_management_tpu.models import gpt as jgpt
from ray_memory_management_tpu.serve import llm as jllm
from ray_memory_management_tpu_torch import serve
from ray_memory_management_tpu_torch.config import global_config
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from ray_memory_management_tpu_torch.models.convert import params_from_jax
from ray_memory_management_tpu_torch.serve import handle as serve_handle
from ray_memory_management_tpu_torch.serve import llm as tllm

PRECISIONS = ("f32", "bf16", "int8")
SERVER = dict(max_new_tokens=6, max_batch_size=2, pad_multiple=16)
PROMPTS = ([5, 6, 7], list(range(2, 30)), [400, 3, 17, 99, 1])


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), jgpt.PRESETS["test"])


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params),
                           device="cpu")


@pytest.fixture(scope="module")
def _runtime():
    """One runtime for the module's serve cases (the conftest's pattern
    starts one per case); each case starts and shuts down serve on it."""
    rmt.init(num_cpus=4)
    yield
    rmt.shutdown()


@pytest.fixture
def serve_instance(_runtime):
    serve.start(http_port=None)
    yield
    serve.shutdown()


def _leaf_fields(leaf):
    """A payload leaf as comparable bytes: precision, shape, the
    quantized array's dtype and bytes, and the int8 scales and count."""
    out = {"p": leaf["p"], "shape": tuple(leaf["shape"]),
           "q": (leaf["q"].dtype.str, leaf["q"].shape, leaf["q"].tobytes())}
    if "scale" in leaf:
        out["scale"] = (leaf["scale"].dtype.str, leaf["scale"].tobytes())
        out["n"] = int(leaf["n"])
    return out


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pack_weights_byte_equal_to_jax(jax_params, port_params, precision):
    mine = tllm.pack_weights(port_params, precision)
    theirs = jllm.pack_weights(jax_params, precision)
    assert mine["p"] == theirs["p"] == precision
    # the key paths stand where JAX keeps a treedef, in its leaf order
    jax_paths = [tuple(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(jax_params)[0]]
    assert [tuple(p) for p in mine["paths"]] == jax_paths
    assert len(mine["leaves"]) == len(theirs["leaves"])
    for path, a, b in zip(jax_paths, mine["leaves"], theirs["leaves"]):
        assert _leaf_fields(a) == _leaf_fields(b), path


@pytest.mark.parametrize("precision", PRECISIONS)
def test_unpack_weights_equals_dequantized_leaves(jax_params, port_params,
                                                  precision):
    payload = tllm.pack_weights(port_params, precision)
    got = tllm.unpack_weights(payload, "cpu")
    want = jllm.unpack_weights(jllm.pack_weights(jax_params, precision))
    for path, leaf in zip(payload["paths"], payload["leaves"]):
        node, ref = got, want
        for key in path:
            node, ref = node[key], ref[key]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        deq = jcodec.dequantize_array(leaf)
        assert np.array_equal(node.numpy(), deq), path
        assert np.array_equal(np.asarray(ref), deq), path
    if precision == "f32":
        for path, _ in zip(payload["paths"], payload["leaves"]):
            node, src = got, port_params
            for key in path:
                node, src = node[key], src[key]
            assert torch.equal(node, src), path


@pytest.fixture
def fp32_test_preset(monkeypatch):
    """Preset ``"test"`` computing in fp32 in both packages: bf16
    products round differently in XLA and in torch, so greedy tokens are
    compared where both compute in fp32 (as ``test_torch_serve.py``
    compares the engines). The weights are the shipped payload's."""
    import dataclasses

    import jax.numpy as jnp

    from ray_memory_management_tpu_torch.models import gpt as tgpt

    monkeypatch.setitem(jgpt.PRESETS, "test", dataclasses.replace(
        jgpt.PRESETS["test"], dtype=jnp.float32))
    monkeypatch.setitem(tgpt.PRESETS, "test", dataclasses.replace(
        tgpt.PRESETS["test"], dtype=torch.float32))


@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_shipped_server_tokens_equal_jax(jax_params, port_params,
                                         fp32_test_preset, precision):
    jsrv = jllm.LLMServer("test", weights=jllm.pack_weights(
        jax_params, precision), **SERVER)
    try:
        want = [jsrv.generate(p) for p in PROMPTS]
    finally:
        jsrv._engine.close()
    srv = tllm.LLMServer("test", weights=tllm.pack_weights(
        port_params, precision), device="cpu", **SERVER)
    try:
        got = [srv.generate(p) for p in PROMPTS]
    finally:
        srv.close()
    assert got == want
    assert all(len(t) == SERVER["max_new_tokens"] for t in got)


def test_cold_start_metric_tags_its_source(port_params):
    hist = mdefs.serve_cold_start_seconds()
    before = {s: hist.get(tags={"source": s})["count"]
              for s in ("shipped", "init")}
    for weights in (tllm.pack_weights(port_params, "bf16"), None):
        tllm.LLMServer("test", weights=weights, device="cpu",
                       **SERVER).close()
    after = {s: hist.get(tags={"source": s})["count"]
             for s in ("shipped", "init")}
    assert after == {s: before[s] + 1 for s in before}


@serve.deployment
class Holder:
    def __init__(self, value):
        self.value = value

    def __call__(self):
        import os

        return os.getpid(), float(self.value.sum())


def _until(fn, want, timeout_s=60.0):
    """Poll ``fn`` until it returns ``want``: the router learns of a
    replaced replica by long poll, so a request may meet the old one."""
    deadline = time.monotonic() + timeout_s
    got = None
    while time.monotonic() < deadline:
        try:
            got = fn()
        except rmt.RmtError:
            got = None
        if got == want:
            return got
        time.sleep(0.1)
    raise AssertionError(f"waited for {want!r}, last saw {got!r}")


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_redeploy_compares_array_init_args(serve_instance, kind):
    wrap = np.asarray if kind == "numpy" else torch.as_tensor
    h = serve.run(Holder.bind(wrap(np.arange(6.0))))
    pid, total = rmt.get(h.remote(), timeout=120)
    assert total == 15.0
    # an equal value (another object) keeps the live replica
    h = serve.run(Holder.bind(wrap(np.arange(6.0))))
    assert rmt.get(h.remote(), timeout=60) == (pid, 15.0)
    assert serve.status("Holder")["num_replicas"] == 1
    # a changed value replaces it
    h = serve.run(Holder.bind(wrap(np.arange(6.0) + 1)))
    new_pid = _until(lambda: rmt.get(h.remote(), timeout=60)[1], 21.0)
    assert new_pid == 21.0
    assert rmt.get(h.remote(), timeout=60)[0] != pid
    assert serve.status("Holder")["num_replicas"] == 1


def test_redeploy_shipped_llm_keeps_or_replaces(serve_instance):
    def app(precision):
        return tllm.llm_deployment("test", device="cpu",
                                   ship_weights=precision, **SERVER)

    h = serve.run(app("bf16"))
    first = rmt.get(h.remote({"tokens": [5, 6, 7]}), timeout=300)
    assert rmt.get(h.stats.remote(), timeout=60)["requests"] == 1
    # the same payload, packed again: the replica (and its count) stays
    h = serve.run(app("bf16"))
    assert rmt.get(h.stats.remote(), timeout=60)["requests"] == 1
    assert rmt.get(h.remote({"tokens": [5, 6, 7]}),
                   timeout=120) == first
    # another payload: a fresh replica, which has answered nothing yet
    h = serve.run(app("int8"))
    _until(lambda: rmt.get(h.stats.remote(), timeout=60)["requests"], 0)
    assert serve.status("LLM")["num_replicas"] == 1


def test_replica_without_a_card_never_serves(serve_instance, monkeypatch):
    """No ``device="cpu"`` and no card: the replica's ``LLMServer``
    refuses to start (it never falls back to the CPU), the controller
    counts it as a replica that missed readiness, and a request finds
    no replica. Without a card the driver cannot draw weights to ship
    either."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the case is its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllm.llm_deployment("test", ship_weights="bf16", **SERVER)
    h = serve.run(tllm.llm_deployment("test", **SERVER))
    assert serve.status("LLM")["num_replicas"] == 0
    monkeypatch.setattr(global_config(), "serve_backpressure_timeout_s",
                        0.5)
    # the new router's wait for a first routing table: no replica comes
    monkeypatch.setattr(serve_handle, "ROUTING_TABLE_WAIT_S", 0.5)
    with pytest.raises(serve.NoReplicasError):
        h.remote({"tokens": [5, 6, 7]})
