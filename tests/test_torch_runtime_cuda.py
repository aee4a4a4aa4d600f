"""Card-only cases of the port's runtime core: CUDA tensors through the
object plane, the device tier on the card, and ``num_gpus`` leases.
Every case skips without a CUDA card (decided in the fixture). The file
imports no JAX, so it runs on the card as it is:

    python -m pytest tests/test_torch_runtime_cuda.py -q

Every comparison is bit-exact: the object plane copies bytes and the
device tier hands back the live tensor.
"""

import os

import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import transfer as xfer
from ray_memory_management_tpu_torch.core.node_manager import visible_devices
from ray_memory_management_tpu_torch.exceptions import ObjectLostError

N = 1 << 20  # fp32 values per device-tier tensor: 4 MiB


def _bits(t):
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()]).cpu()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cuda_runtime(cuda):
    torch.cuda.init()  # the driver holds CUDA before init, as a user would
    rt = rmt.init(num_cpus=2, _config=Config(
        device_store_capacity_bytes=3 * N * 4))
    yield rt
    rmt.shutdown()


def _randn(n, device, seed, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, device=device, generator=gen).to(dtype)


def test_gpu_counted(cuda_runtime):
    want = torch.cuda.device_count()
    if os.environ.get("CUDA_VISIBLE_DEVICES") is not None:
        want = len([c for c in os.environ["CUDA_VISIBLE_DEVICES"].split(",")
                    if c.strip()])
    assert rmt.cluster_resources()["GPU"] == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_tensor_put_get_bit_exact(cuda_runtime, cuda, dtype):
    x = _randn(3 * N + 7, cuda, 1, dtype)
    y = rmt.get(rmt.put(x))
    assert y.is_cuda and y.dtype == dtype and y.shape == x.shape
    assert torch.equal(_bits(y), _bits(x))


def test_device_put_zero_copy_and_consume(cuda_runtime, cuda):
    x = _randn(N, cuda, 2)
    ptr = x.data_ptr()
    ref = rmt.put(x, device=True)
    assert rmt.get(ref) is x
    taken = rmt.get(ref, consume=True)
    assert taken.data_ptr() == ptr
    assert not cuda_runtime.device_store.contains(ref.binary())
    with pytest.raises(ObjectLostError):
        rmt.get(ref, timeout=5)


def test_bounded_tier_demotes_and_repromotes_to_cuda(cuda_runtime, cuda):
    rt = cuda_runtime
    first = _randn(N, cuda, 3)
    want = first.cpu()
    refs = [rmt.put(first, device=True)]
    del first
    for seed in (4, 5):
        refs.append(rmt.put(_randn(N, cuda, seed), device=True))
    fourth = _randn(N, cuda, 6)
    torch.cuda.synchronize(cuda)
    before = torch.cuda.memory_allocated(cuda)
    refs.append(rmt.put(fourth, device=True))
    del fourth
    torch.cuda.synchronize(cuda)
    assert before - torch.cuda.memory_allocated(cuda) == N * 4
    assert not rt.device_store.contains(refs[0].binary())
    assert rt.device_store.count() == 3
    back = rmt.get(refs[0])
    assert back.is_cuda and torch.equal(_bits(back), _bits(want))
    assert rt.device_store.contains(refs[0].binary())


def _gpu_echo(x):
    import os

    return x * 1, os.environ.get("CUDA_VISIBLE_DEVICES"), \
        xfer.mesh_fingerprint()


def test_gpu_task_result_lands_on_cuda(cuda_runtime, cuda):
    x = _randn(N, cuda, 7)
    y, visible, theirs = rmt.get(
        rmt.remote(_gpu_echo).options(num_gpus=1).remote(x), timeout=300)
    assert visible == visible_devices(1)[0]  # the driver's first card
    assert y.is_cuda and torch.equal(_bits(y), _bits(x))
    # both processes hold CUDA, on the same card (by UUID), and still
    # share no device route: the process token keeps the fingerprints
    # apart
    ours = xfer.mesh_fingerprint()
    assert theirs is not None and ours is not None
    assert theirs[0] == ours[0] == "cuda"
    assert theirs[1] == (str(torch.cuda.get_device_properties(cuda).uuid),)
    assert not xfer.same_mesh(theirs, ours)


def test_move_device_object_to_cuda(cuda_runtime, cuda):
    x = torch.arange(1024, dtype=torch.float32)
    ref = rmt.put(x, device=True)
    assert cuda_runtime.move_device_object(ref.binary(), cuda)
    moved = rmt.get(ref)
    assert moved.is_cuda and torch.equal(moved.cpu(), x)


def _gpu_echo_where(xs):
    import os

    return ([x * 1 for x in xs], os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.environ.get("RMT_NODE_ID"))


def test_gpu_task_on_an_agent_node_round_trips_bit_equal(cuda):
    """The card leased on a node agent (the head holds no GPU): CUDA
    tensors go driver → agent worker → driver bit-equal, and the lease
    is the card the agent's CUDA_VISIBLE_DEVICES names."""
    torch.cuda.init()
    rt = rmt.init(num_cpus=2, num_gpus=0)
    try:
        agent = rt.add_remote_node_process(num_cpus=2, num_gpus=1)
        assert rmt.cluster_resources()["GPU"] == 1
        xs = [_randn(N + 3, cuda, 11), _randn(N + 5, cuda, 12, torch.bfloat16)]
        ys, visible, node = rmt.get(
            rmt.remote(_gpu_echo_where).options(num_gpus=1).remote(xs),
            timeout=300)
        assert node == agent.hex()
        assert visible == visible_devices(1)[0]  # the agent inherits ours
        for x, y in zip(xs, ys):
            assert y.is_cuda and y.dtype == x.dtype and y.shape == x.shape
            assert torch.equal(_bits(y), _bits(x))
    finally:
        rmt.shutdown()
