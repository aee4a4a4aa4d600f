"""The device hooks the port re-points, held on the CPU: tensor
serialization (bf16 as integer bits, no ml_dtypes), the structured-array
stream-cache key, GPU detection without initializing CUDA, the GPU lease
in a worker's environment, the zygote's fork guard, the device tier's
capacity rule, and a GPU actor serving through ``LLMServer`` (at a tiny
size, on the CPU).

The JAX package's own behaviour where it differs is a known fault
(``serialization.py`` keys the stream cache on ``dtype.str``), and the
port's test expects the correct value.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import api
from ray_memory_management_tpu_torch import serialization as ser
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import device_store, zygote
from _port_fixtures import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_memory_management_tpu_torch")


def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[
                                    t.element_size()])


# ------------------------------------------------------------ serialization
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.float64,
                                   torch.int64, torch.bool,
                                   torch.float8_e4m3fn],
                         ids=lambda d: str(d).removeprefix("torch."))
def test_tensor_round_trip_bit_exact(dtype):
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.standard_normal((37, 129)).astype(np.float32))
    t = src.to(dtype)
    out = ser.loads(ser.dumps(t))
    assert isinstance(out, torch.Tensor)
    assert out.dtype == dtype and out.shape == t.shape
    assert out.device.type == "cpu"
    assert torch.equal(_bits(out), _bits(t))


def test_bf16_round_trip_big_and_strided():
    """A bf16 tensor past the stream-cache threshold, and a transposed
    (non-contiguous) one, both come back bit-exact and writable."""
    rng = np.random.default_rng(4)
    big = torch.from_numpy(rng.standard_normal(1 << 20).astype(
        np.float32)).to(torch.bfloat16)
    strided = big[: 512 * 256].view(512, 256).t()
    for t in (big, strided):
        out = ser.loads(memoryview(ser.dumps(t)))
        assert out.dtype == torch.bfloat16 and out.shape == t.shape
        assert torch.equal(_bits(out), _bits(t))
        out.add_(1)  # the rebuilt tensor owns its memory


def test_bf16_needs_no_ml_dtypes():
    """bf16 travels as int16 bits with a dtype tag: the stream names no
    ml_dtypes type and no module of the runtime imports ml_dtypes (it
    comes with JAX, which the card's installation need not have). Only
    ``models/convert.py`` may, to hand bf16 parameters to the JAX
    package in the parity tests."""
    import ast

    t = torch.ones(8, dtype=torch.bfloat16)
    assert b"ml_dtypes" not in ser.dumps(t)
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            if not f.endswith(".py") or (
                    f == "convert.py" and dirpath.endswith("models")):
                continue
            with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                assert not any(n.split(".")[0] == "ml_dtypes"
                               for n in names), f


def test_serialization_never_imports_torch():
    """Detection reads the value's type: a process that serializes no
    tensor never pays torch's import."""
    code = ("import sys, numpy as np\n"
            "from ray_memory_management_tpu_torch import serialization as s\n"
            "import ray_memory_management_tpu_torch as rmt\n"
            "s.loads(s.dumps({'a': np.ones(1 << 18), 'b': [1, 'x']}))\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_structured_array_cache_key_keeps_dtype():
    """Two >= 1 MB structured arrays of one itemsize but different
    fields must not share a cached pickle stream (the JAX package keys
    on dtype.str, '|V8' for both, and returns the first dtype)."""
    ser._ARRAY_STREAM_CACHE.clear()
    n = ser._ARRAY_CACHE_MIN_BYTES // 8 + 1
    a = np.zeros(n, dtype=[("x", "<i4"), ("y", "<f4")])
    b = np.zeros(n, dtype=[("p", "<f8")])
    assert a.dtype.str == b.dtype.str  # the collision the key must avoid
    a["x"], a["y"], b["p"] = 3, 1.5, 2.25
    out_a = ser.loads(memoryview(ser.dumps(a)))
    out_b = ser.loads(memoryview(ser.dumps(b)))
    assert out_a.dtype == a.dtype and out_b.dtype == b.dtype
    np.testing.assert_array_equal(out_b["p"], b["p"])
    np.testing.assert_array_equal(out_a["y"], a["y"])


def test_device_demotion_bf16_envelope_rehydrates_a_tensor():
    rng = np.random.default_rng(7)
    src = rng.random(4096).astype(np.float32)
    data = ser.serialize_device_demotion(torch.from_numpy(src), "bf16")
    assert data.total_size < src.nbytes  # the bf16 envelope halves it
    back = ser.loads(data.to_bytes())
    assert isinstance(back, torch.Tensor) and back.dtype == torch.float32
    assert float((back.numpy() - src).__abs__().max()) <= 2 ** -8


# ------------------------------------------------------------ GPU detection
@pytest.mark.parametrize("value,count", [("0", 1), ("0,1,3", 3), ("", 0),
                                         ("GPU-1a2b,GPU-3c4d", 2)])
def test_detect_gpus_reads_cuda_visible_devices(monkeypatch, value, count):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", value)
    assert api._detect_gpus() == count
    assert not torch.cuda.is_initialized()


def test_detect_gpus_never_initializes_cuda(monkeypatch):
    """Without the variable, only an already-initialized CUDA is
    counted; an uninitialized one counts 0 and stays uninitialized."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count",
                        lambda: calls.append(1) or 4)
    assert api._detect_gpus() == 0
    assert not calls and not torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert api._detect_gpus() == 4


def test_resolve_capacity_reads_the_card_only_when_initialized(monkeypatch):
    cfg = Config(device_store_capacity_bytes=0)
    asked = []
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: asked.append(1) or (1 << 30, 80 << 30))
    assert device_store.resolve_capacity(cfg) == 1 << 30
    assert not asked
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert device_store.resolve_capacity(cfg) == int((80 << 30) * 0.6)
    assert device_store.resolve_capacity(
        Config(device_store_capacity_bytes=12345)) == 12345


def _cuda_payload():
    """A pickle stream that rebuilds as a CUDA tensor, as one sent from a
    process with the card would (this build of torch has no CUDA)."""
    return ser.dumps(_ShippedCuda())


class _ShippedCuda:
    def __reduce__(self):
        return (ser._rebuild_tensor,
                (np.arange(6, dtype=np.float32), "float32", "cuda"))


@pytest.mark.parametrize("visible", [None, ""], ids=["unset", "empty"])
def test_cuda_tensor_lands_on_cpu_without_a_card(monkeypatch, visible):
    """A process given no card (the variable "" as in an unleased worker,
    or unset with no device) rebuilds a CUDA tensor on the CPU."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ser.loads(_cuda_payload())
    assert out.device.type == "cpu"
    assert torch.equal(out, torch.arange(6, dtype=torch.float32))


def test_cuda_tensor_under_a_lease_without_a_card_raises(monkeypatch):
    """A process whose CUDA_VISIBLE_DEVICES names a card CUDA cannot see
    (CUDA initialized before the lease, or more GPUs declared than the
    machine has) raises instead of computing on the CPU unseen."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA sees no device"):
        ser.loads(_cuda_payload())


# ---------------------------------------------------------------- GPU lease
def _visible_devices():
    import os

    return os.environ.get("CUDA_VISIBLE_DEVICES")


def _tensor_device(t):
    return t.device.type


@pytest.fixture
def one_gpu_runtime(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rt = rmt.init(num_cpus=2, num_gpus=1)
    yield rt
    rmt.shutdown()


def test_gpu_lease_sets_cuda_visible_devices(one_gpu_runtime):
    assert rmt.cluster_resources()["GPU"] == 1
    leased = rmt.remote(_visible_devices).options(num_gpus=1)
    assert rmt.get(leased.remote(), timeout=120) == "0"
    assert rmt.get(rmt.remote(_visible_devices).remote(),
                   timeout=120) in ("", "0")


def test_gpu_task_without_a_card_raises(one_gpu_runtime):
    """A num_gpus=1 task handed a CUDA tensor on a machine whose CUDA
    sees no card fails; an unleased task, run first (a lease stays in
    its worker's environment, as in the reference), gets it on the
    CPU."""
    arg = _ShippedCuda()
    assert rmt.get(rmt.remote(_tensor_device).remote(arg),
                   timeout=120) == "cpu"
    leased = rmt.remote(_tensor_device).options(num_gpus=1)
    with pytest.raises(Exception, match="CUDA sees no device"):
        rmt.get(leased.remote(arg), timeout=120)


@pytest.mark.parametrize("visible,n,want", [
    (None, 2, ["0", "1"]), ("", 1, ["0"]), ("3", 1, ["3"]),
    ("2, 5", 2, ["2", "5"]), ("GPU-a1,GPU-b2", 1, ["GPU-a1"])],
    ids=["unset", "empty", "one", "two", "uuids"])
def test_visible_devices_maps_through_the_driver(monkeypatch, visible, n,
                                                  want):
    from ray_memory_management_tpu_torch.core.node_manager import (
        visible_devices)

    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert visible_devices(n) == want


def test_visible_devices_refuses_more_gpus_than_named(monkeypatch):
    from ray_memory_management_tpu_torch.core.node_manager import (
        visible_devices)

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    with pytest.raises(ValueError, match="names only 1"):
        visible_devices(2)


def test_gpu_lease_exports_the_drivers_card(monkeypatch):
    """A driver pinned to card 3 leases card 3, not index 0."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    rmt.init(num_cpus=2, num_gpus=1)
    try:
        leased = rmt.remote(_visible_devices).options(num_gpus=1)
        assert rmt.get(leased.remote(), timeout=120) == "3"
    finally:
        rmt.shutdown()


def test_unleased_worker_sees_no_card():
    """A worker that never held a lease starts with
    CUDA_VISIBLE_DEVICES="" (the JAX package's JAX_PLATFORMS=cpu)."""
    rmt.init(num_cpus=2, num_gpus=0)
    try:
        assert rmt.get(rmt.remote(_visible_devices).remote(),
                       timeout=120) == ""
    finally:
        rmt.shutdown()


# --------------------------------------------------------------- fork guard
def test_cuda_live_reads_torch_only(monkeypatch):
    assert not zygote.cuda_live()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert zygote.cuda_live()


def test_zygote_refuses_to_fork_once_cuda_is_initialized():
    """A class preload that leaves CUDA initialized in the zygote (here
    torch.cuda.is_initialized monkeypatched to True inside the zygote
    by the class blob itself) retires the zygote instead of forking: the
    spawn returns None (the caller cold-spawns) and the class is never
    preloaded again."""
    import cloudpickle

    def poison():
        import torch

        torch.cuda.is_initialized = lambda: True

        class Preloaded:
            pass

        return Preloaded

    class Blob:
        def __reduce__(self):
            return (poison, ())

    from ray_memory_management_tpu_torch.core.node_manager import package_env

    client = zygote.ZygoteClient(package_env(), tag="t")
    try:
        cls_id = os.urandom(8)
        env = dict(client._base_env)
        proc = client.spawn(env, bootstrap={
            "type": "create_actor", "cls_id": cls_id,
            "cls_blob": cloudpickle.dumps(Blob())})
        assert proc is None
        assert cls_id in zygote._taint_classes
        client._proc.wait(timeout=30)  # the zygote retired itself
    finally:
        client.close()
        zygote._taint_classes.discard(cls_id)


# ----------------------------------------------------------------- GPU actor
@pytest.mark.parametrize("num_gpus", [0, 1])
def test_llm_server_actor_serves(monkeypatch, num_gpus):
    """The actor path ``chip_smoke.py`` drives on the card, at the tiny
    preset on the CPU: concurrent ``generate`` calls, KV pages back at 0,
    and greedy tokens equal to an in-process server of the same seed."""
    from ray_memory_management_tpu_torch.serve.llm import LLMServer
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rmt.init(num_cpus=2, num_gpus=num_gpus)
    try:
        opts = dict(max_concurrency=8)
        if num_gpus:
            opts["num_gpus"] = 1
        actor = rmt.remote(runtime_smoke.ServedLLM).options(**opts).remote(
            preset="test", max_batch_size=4, max_new_tokens=6, seed=0,
            device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(2, 512, size=n).tolist()
                   for n in (3, 17, 40, 90)]
        outs = rmt.get([actor.generate.remote(p) for p in prompts],
                       timeout=300)
        assert all(len(o) == 6 and all(0 <= t < 512 for t in o)
                   for o in outs)
        c = rmt.get(actor.counters.remote(), timeout=60)
        assert c["stats"]["kv"]["pages_in_use"] == 0
        assert c["cuda_visible_devices"] == ("0" if num_gpus else "")
        srv = LLMServer(preset="test", max_batch_size=4, max_new_tokens=6,
                        seed=0, device="cpu")
        try:
            for p in prompts[:2]:
                assert rmt.get(actor.generate.remote(p),
                               timeout=120) == srv.generate(p)
        finally:
            srv.close()
        rmt.kill(actor)
    finally:
        rmt.shutdown()
