"""Core task/object API tests (the reference's test_basic.py /
test_advanced.py coverage, python/ray/tests/).

The PyTorch port's copy of ``tests/test_basic.py``: the same cases run
against ``ray_memory_management_tpu_torch``, with its own fixtures (the
shared conftest starts the JAX package's runtime).
"""

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt


_shared = []  # the runtime of the cases that take rmt_start_regular


@pytest.fixture
def rmt_start_regular():
    """One runtime for every case of this module that takes this fixture
    (the conftest's fixture starts one per case): made at the first such
    case and kept for the next; ``_own_runtime`` shuts it down before a
    case that starts its own, and ``_end_shared`` at the module's end."""
    from ray_memory_management_tpu_torch import _worker_context

    if not _shared or _worker_context.get_runtime() is not _shared[0]:
        rmt.shutdown()
        _shared[:] = [rmt.init(num_cpus=4)]
    return _shared[0]


@pytest.fixture(autouse=True)
def _own_runtime(request):
    if _shared and "rmt_start_regular" not in request.fixturenames:
        rmt.shutdown()
        _shared.clear()


@pytest.fixture(autouse=True, scope="module")
def _end_shared():
    yield
    rmt.shutdown()
    _shared.clear()


@rmt.remote
def add(a, b):
    return a + b


@rmt.remote
def make_array(n):
    return np.arange(n, dtype=np.float32)


def test_submit_and_get(rmt_start_regular):
    assert rmt.get(add.remote(1, 2)) == 3


def test_fanout(rmt_start_regular):
    refs = [add.remote(i, i) for i in range(50)]
    assert rmt.get(refs) == [2 * i for i in range(50)]


def test_large_object_zero_copy(rmt_start_regular):
    a = rmt.get(make_array.remote(1_000_000))
    assert a.dtype == np.float32 and a.shape == (1_000_000,)
    # zero-copy from the shared-memory store: the array is a view, read-only
    assert a.base is not None
    assert not a.flags.writeable


def test_put_get_roundtrip(rmt_start_regular):
    for value in [1, "x", {"a": [1, 2]}, np.ones(300_000), None]:
        ref = rmt.put(value)
        out = rmt.get(ref)
        if isinstance(value, np.ndarray):
            assert np.array_equal(out, value)
        else:
            assert out == value


def test_ref_args_chain(rmt_start_regular):
    c = add.remote(add.remote(1, 1), add.remote(2, 2))
    assert rmt.get(c) == 6


def test_num_returns(rmt_start_regular):
    @rmt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    r1, r2, r3 = three.remote()
    assert rmt.get([r1, r2, r3]) == [1, 2, 3]


def test_task_exception_propagates(rmt_start_regular):
    @rmt.remote(max_retries=0)
    def boom():
        raise ValueError("kapow")

    with pytest.raises(rmt.TaskError, match="kapow"):
        rmt.get(boom.remote())


def test_wait(rmt_start_regular):
    refs = [add.remote(i, 1) for i in range(10)]
    ready, rest = rmt.wait(refs, num_returns=5, timeout=30)
    assert len(ready) == 5
    assert len(ready) + len(rest) == 10
    ready_all, rest_all = rmt.wait(refs, num_returns=10, timeout=30)
    assert len(ready_all) == 10 and not rest_all


def test_get_timeout(rmt_start_regular):
    @rmt.remote
    def slow():
        import time

        time.sleep(5)
        return 1

    with pytest.raises(rmt.GetTimeoutError):
        rmt.get(slow.remote(), timeout=0.2)


def test_nested_tasks(rmt_start_regular):
    @rmt.remote
    def outer(x):
        return rmt.get(add.remote(x, 1)) * 2

    assert rmt.get(outer.remote(4)) == 10


def test_nested_put(rmt_start_regular):
    @rmt.remote
    def putter():
        ref = rmt.put(np.ones(500_000))
        return rmt.get(ref).sum()

    assert rmt.get(putter.remote()) == 500_000.0


def test_options_override(rmt_start_regular):
    fast = add.options(num_cpus=2, name="fast_add")
    assert rmt.get(fast.remote(2, 3)) == 5


def test_cluster_and_available_resources(rmt_start_regular):
    total = rmt.cluster_resources()
    assert total["CPU"] == 4.0


def test_cannot_call_remote_fn_directly(rmt_start_regular):
    with pytest.raises(TypeError):
        add(1, 2)


def test_infeasible_task_fails(rmt_start_regular):
    @rmt.remote(num_cpus=1000)
    def huge():
        return 1

    with pytest.raises(rmt.TaskError, match="infeasible"):
        rmt.get(huge.remote(), timeout=10)


def test_task_metadata_pruned_after_refs_released(rmt_start_regular):
    """Finished-task records and futures must not accumulate forever on
    the head (the owner GC's its reference table in the reference; head
    peak memory is a recorded scalability metric)."""
    rt = rmt_start_regular

    @rmt.remote(max_retries=0)
    def noop():
        return 1

    refs = [noop.remote() for _ in range(300)]
    assert sum(rmt.get(refs, timeout=120)) == 300
    with rt._lock:
        tasks_before = len(rt.tasks)
        futures_before = len(rt.futures)
    assert tasks_before >= 300
    del refs  # drop the last ObjectRefs: refcounts hit zero
    import gc
    import time

    gc.collect()
    deadline = time.time() + 10
    while time.time() < deadline:
        with rt._lock:
            if len(rt.tasks) <= tasks_before - 300:
                break
        time.sleep(0.1)
    with rt._lock:
        assert len(rt.tasks) <= tasks_before - 300
        assert len(rt.futures) <= futures_before - 300
        assert len(rt.lineage) <= 5


def test_deferred_free_respects_repin():
    """Zero-ref frees are deferred into a batch; an oid that picks up a
    live reference during the deferral window must be SKIPPED at flush
    (freeing it would drop a value a live handle still expects)."""
    import numpy as np

    rt = rmt.init(num_cpus=2, ignore_reinit_error=True)
    try:
        ref = rmt.put(np.arange(1000, dtype=np.float32))
        oid = ref.binary()
        del ref  # count -> 0: oid enters the deferral buffer
        assert oid in rt._deferred_frees
        # a cached handle is handed out again before any flush
        rt.add_local_ref(oid)
        rt._flush_deferred_frees()
        # the value must still be alive for the re-pinned reference
        from ray_memory_management_tpu_torch.core.object_ref import ObjectRef

        arr = rmt.get(ObjectRef(oid, owner=rt), timeout=60)
        assert float(arr.sum()) == float(np.arange(1000).sum())
        # and once the re-pinned handle drops, the free really happens
        rt._flush_deferred_frees()
    finally:
        rmt.shutdown()
