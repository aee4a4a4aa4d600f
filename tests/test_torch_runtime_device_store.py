"""Device (HBM) object store: refs pinning live torch.Tensors.

The BASELINE.json north-star capability — net-new vs the reference's
host-only plasma. Covers: zero-copy same-process gets, on-demand
device→host materialization for remote readers, device refs as task
args, worker-owned device objects, free, and owner-death behavior.

The PyTorch port's copy of ``tests/test_device_store.py``: the same
cases run against ``ray_memory_management_tpu_torch``, with its own
fixtures (the shared conftest starts the JAX package's runtime), with
jax arrays replaced by CPU tensors made from the same numpy values. The
state API is a later slice, so the directory rows are read from the GCS
directory it reads.
"""

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt
from _port_fixtures import one_intra_op_thread  # noqa: F401


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


def _cpu_array(shape=(64,), seed=0):
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _directory_rows(rt, oid: bytes):
    """The object directory's rows for one object: (tier, size) per
    holder, as the state API's list_objects reports them."""
    located = rt.gcs.locate_objects([oid])
    if oid not in located:
        return []
    size, holders, tiers = located[oid]
    return [{"tier": tiers.get(n, "shm"), "size_bytes": size or None,
             "where": "device" if tiers.get(n, "shm") == "hbm"
             else "store"} for n in holders]


class TestDriverDeviceObjects:
    def test_same_process_zero_copy(self, rmt_start_regular):
        arr = _cpu_array()
        ref = rmt.put(arr, device=True)
        got = rmt.get(ref)
        assert got is arr  # the SAME live array, not a copy

    def test_requires_tensor(self, rmt_start_regular):
        with pytest.raises(TypeError):
            rmt.put(np.zeros(4), device=True)

    def test_task_consumes_device_ref(self, rmt_start_regular):
        arr = _cpu_array(seed=1)
        ref = rmt.put(arr, device=True)

        @rmt.remote
        def total(x):
            return float(np.asarray(x).sum())

        assert rmt.get(total.remote(ref)) == pytest.approx(
            float(np.asarray(arr).sum()), rel=1e-5)

    def test_free_on_ref_drop(self, rmt_start_regular):
        rt = rmt_start_regular
        arr = _cpu_array(seed=2)
        ref = rmt.put(arr, device=True)
        oid = ref.binary()
        assert rt.device_store.contains(oid)
        del ref
        import gc
        import time

        gc.collect()
        # frees batch through the router's deferred buffer; the drop
        # nudges it, but the flush lands on the router thread — poll
        deadline = time.time() + 5
        while rt.device_store.contains(oid) and time.time() < deadline:
            time.sleep(0.02)
        assert not rt.device_store.contains(oid)


class TestWorkerDeviceObjects:
    def test_actor_pins_and_driver_reads(self, rmt_start_regular):
        @rmt.remote
        class Producer:
            def make(self, n):
                import torch

                self.arr = torch.arange(n, dtype=torch.float32)
                self.ref = rmt.put(self.arr, device=True)
                return self.ref

            def local_identity(self):
                # same-process get returns the pinned array itself
                return rmt.get(self.ref) is self.arr

        p = Producer.remote()
        ref = rmt.get(p.make.remote(8))
        np.testing.assert_array_equal(
            np.asarray(rmt.get(ref)), np.arange(8, dtype=np.float32))
        assert rmt.get(p.local_identity.remote()) is True
        rmt.kill(p)

    def test_device_ref_between_workers(self, rmt_start_regular):
        @rmt.remote
        class Producer:
            def make(self):
                import torch

                return rmt.put(torch.full((16,), 3.0), device=True)

        @rmt.remote
        def consume(refs):
            return float(np.asarray(rmt.get(refs[0])).sum())

        p = Producer.remote()
        ref = rmt.get(p.make.remote())
        # wrapped in a list so the ref itself (not its value) ships
        assert rmt.get(consume.remote([ref])) == pytest.approx(48.0)
        rmt.kill(p)

    def test_owner_death_loses_object(self, rmt_start_regular):
        @rmt.remote
        class Mortal:
            def make(self):
                import torch

                return rmt.put(torch.ones(4), device=True)

        m = Mortal.remote()
        ref = rmt.get(m.make.remote())
        rmt.kill(m)
        import time

        time.sleep(0.5)  # let the death propagate
        with pytest.raises(Exception):
            rmt.get(ref, timeout=10)

    def test_materialized_copy_survives_owner(self, rmt_start_regular):
        """Once materialized to host shm, the object outlives its
        device-owning process (the host copy is the spill tier)."""
        @rmt.remote
        class Owner:
            def make(self):
                import torch

                return rmt.put(torch.full((32,), 7.0), device=True)

        o = Owner.remote()
        ref = rmt.get(o.make.remote())
        first = np.asarray(rmt.get(ref))  # forces materialization
        rmt.kill(o)
        import time

        time.sleep(0.3)
        np.testing.assert_array_equal(np.asarray(rmt.get(ref)), first)


def _init_small(capacity=8192, **kw):
    from ray_memory_management_tpu_torch.config import Config

    return rmt.init(num_cpus=2, _config=Config(
        device_store_capacity_bytes=capacity, **kw))


class TestTieredEviction:
    """HBM → shm demotion under a byte budget (device_store_capacity_bytes):
    LRU victim choice, refcount pins, bf16 downcast envelopes,
    re-promotion, and the device.evict fault site (injected errors DEFER
    the eviction — pressure causes slowness, never loss)."""

    def teardown_method(self):
        rmt.shutdown()

    def test_put_over_budget_demotes_lru(self):
        rt = _init_small(capacity=8192)  # two 4 KiB payloads
        refs = [rmt.put(_cpu_array((1024,), seed=i), device=True)
                for i in range(3)]
        assert rt.device_store.count() == 2
        assert not rt.device_store.contains(refs[0].binary())  # LRU went
        # the demoted object is still readable (host shm copy)
        assert rmt.get(refs[0]).shape == (1024,)

    def test_refcount_pin_blocks_eviction(self):
        rt = _init_small(capacity=8192)
        a = rmt.put(_cpu_array((1024,), seed=0), device=True)
        assert rt.device_store.pin(a.binary())
        b = rmt.put(_cpu_array((1024,), seed=1), device=True)
        c = rmt.put(_cpu_array((1024,), seed=2), device=True)
        assert b is not None  # keep the victim's ref alive
        # the pinned LRU entry was skipped; the unpinned middle one went
        assert rt.device_store.contains(a.binary())
        assert rt.device_store.contains(c.binary())
        assert rt.device_store.count() == 2
        rt.device_store.unpin(a.binary())
        assert rt.device_store.pin_count(a.binary()) == 0

    def test_lru_order_respects_reads(self):
        rt = _init_small(capacity=8192)
        a = rmt.put(_cpu_array((1024,), seed=0), device=True)
        b = rmt.put(_cpu_array((1024,), seed=1), device=True)
        rmt.get(a)  # refresh a's recency: b is now the LRU victim
        c = rmt.put(_cpu_array((1024,), seed=2), device=True)
        assert c is not None
        assert rt.device_store.contains(a.binary())
        assert not rt.device_store.contains(b.binary())

    def test_bf16_demotion_round_trip_error_bound(self):
        rt = _init_small(capacity=8192, device_demote_precision="bf16")
        src = np.random.default_rng(7).random(1024).astype(np.float32)
        import torch

        a = rmt.put(torch.from_numpy(src), device=True)
        # fillers stay referenced: a dropped ref frees (router nudge) and
        # releases the very pressure the test is creating
        fillers = [rmt.put(_cpu_array((1024,), seed=i), device=True)
                   for i in (1, 2)]
        assert not rt.device_store.contains(a.binary())  # demoted
        back = np.asarray(rmt.get(a))
        assert back.dtype == np.float32  # envelope rehydrates dtype
        # bf16 truncation bound: 8 mantissa bits on values in [0, 1)
        assert float(np.max(np.abs(back - src))) <= 2 ** -8

    def test_demoted_object_repromotes_on_read(self):
        rt = _init_small(capacity=8192)
        a = rmt.put(_cpu_array((1024,), seed=0), device=True)
        fillers = [rmt.put(_cpu_array((1024,), seed=i), device=True)
                   for i in (1, 2)]
        assert len(fillers) == 2
        assert not rt.device_store.contains(a.binary())
        got = rmt.get(a)  # re-promotion on next device read
        from ray_memory_management_tpu_torch.core.device_store import (
            is_device_array,
        )

        assert is_device_array(got)
        assert rt.device_store.contains(a.binary())

    def test_evict_fault_defers_not_loses(self):
        from ray_memory_management_tpu_torch.utils import faults

        rt = _init_small(capacity=8192)
        refs = [rmt.put(_cpu_array((1024,), seed=i), device=True)
                for i in range(2)]
        faults.configure("device.evict:error:max=1", seed=3)
        try:
            late = rmt.put(_cpu_array((1024,), seed=9), device=True)
            # the injected error deferred the demotion: every object is
            # still device-resident (over budget) and readable
            assert rt.device_store.count() == 3
            for r in (*refs, late):
                assert rmt.get(r).shape == (1024,)
        finally:
            faults.configure("")

    def test_materialize_fault_skips_promotion(self):
        from ray_memory_management_tpu_torch.utils import faults

        rt = _init_small(capacity=8192)
        a = rmt.put(_cpu_array((1024,), seed=0), device=True)
        fillers = [rmt.put(_cpu_array((1024,), seed=i), device=True)
                   for i in (1, 2)]
        assert len(fillers) == 2
        assert not rt.device_store.contains(a.binary())
        faults.configure("device.materialize:error:max=1", seed=4)
        try:
            got = rmt.get(a)  # host copy still serves the read
            assert got.shape == (1024,)
            assert not rt.device_store.contains(a.binary())
        finally:
            faults.configure("")

    def test_promote_on_read_disabled(self):
        rt = _init_small(capacity=8192, device_promote_on_read=False)
        a = rmt.put(_cpu_array((1024,), seed=0), device=True)
        fillers = [rmt.put(_cpu_array((1024,), seed=i), device=True)
                   for i in (1, 2)]
        assert len(fillers) == 2
        assert not rt.device_store.contains(a.binary())
        assert rmt.get(a).shape == (1024,)
        assert not rt.device_store.contains(a.binary())


class TestDonationConsume:
    """consume=True: the last-reader get that TAKES the device entry so
    the caller holds the sole reference and may update it in place."""

    def test_consume_returns_live_buffer_and_unpins(self, rmt_start_regular):
        rt = rmt_start_regular
        arr = _cpu_array((256,), seed=5)
        ref = rmt.put(arr, device=True)
        got = rmt.get(ref, consume=True)
        assert got is arr
        assert not rt.device_store.contains(ref.binary())

    def test_consumed_ref_is_dead(self, rmt_start_regular):
        ref = rmt.put(_cpu_array((256,), seed=6), device=True)
        rmt.get(ref, consume=True)
        from ray_memory_management_tpu_torch.exceptions import ObjectLostError

        with pytest.raises(ObjectLostError):
            rmt.get(ref, timeout=2)

    def test_consumed_buffer_donatable(self, rmt_start_regular):
        """The taken tensor is updated in place — the zero-allocation
        handoff the consume path exists for (torch's donation)."""
        import torch

        src = torch.ones(512, dtype=torch.float32)
        ptr = src.data_ptr()
        ref = rmt.put(src, device=True)
        del src
        x = rmt.get(ref, consume=True)
        out = x.mul_(2.0)
        assert out.data_ptr() == ptr  # the same storage, no allocation
        np.testing.assert_array_equal(out.numpy(),
                                      np.full(512, 2.0, np.float32))

    def test_consume_ignored_for_host_objects(self, rmt_start_regular):
        ref = rmt.put({"k": 1})
        assert rmt.get(ref, consume=True) == {"k": 1}
        assert rmt.get(ref) == {"k": 1}  # still alive


class TestICITransfer:
    """Same-process device movement (the port's device route) and the
    host fallback when producer and consumer share no mesh. On the CPU
    there is one device, so the move lands where it started; the card
    cases move between the CPU and the card
    (tests/test_torch_runtime_cuda.py)."""

    def test_move_device_object_same_mesh(self, rmt_start_regular):
        import torch

        from ray_memory_management_tpu_torch.core import metrics_defs as mdefs

        rt = rmt_start_regular
        dev = torch.device("cpu")
        before = sum(mdefs.device_ici_transfers().series().values())
        ref = rmt.put(_cpu_array((128,), seed=8), device=True)
        assert rt.move_device_object(ref.binary(), dev)
        moved = rt.device_store.get(ref.binary())
        assert moved.device == dev
        after = sum(mdefs.device_ici_transfers().series().values())
        assert after == before + 1

    def test_mesh_fingerprint_differs_across_processes(self,
                                                       rmt_start_regular):
        from ray_memory_management_tpu_torch.core import transfer as xfer

        @rmt.remote
        def fp():
            from ray_memory_management_tpu_torch.core import transfer as x

            return x.mesh_fingerprint()

        theirs = rmt.get(fp.remote())
        ours = xfer.mesh_fingerprint()
        # no process here initialized CUDA, so neither has a device set
        # to share (asking CUDA would initialize it); with the card, the
        # process token keeps the fingerprints apart — either way the
        # host fallback is forced
        assert theirs is None and ours is None
        assert not xfer.same_mesh(theirs, ours)

    def test_ici_fallback_without_shared_mesh(self, rmt_start_regular):
        """Producer and consumer in different processes share no mesh:
        the read falls back to the striped host path (materialize +
        shm), and the ICI counter does not move."""
        from ray_memory_management_tpu_torch.core import metrics_defs as mdefs

        @rmt.remote
        class Producer:
            def make(self):
                import torch

                return rmt.put(torch.full((64,), 9.0), device=True)

        before = sum(mdefs.device_ici_transfers().series().values())
        p = Producer.remote()
        ref = rmt.get(p.make.remote())
        np.testing.assert_array_equal(
            np.asarray(rmt.get(ref)), np.full(64, 9.0, np.float32))
        after = sum(mdefs.device_ici_transfers().series().values())
        assert after == before  # host path, not ICI
        rmt.kill(p)

    def test_ici_move_identity_same_device(self, rmt_start_regular):
        import torch

        from ray_memory_management_tpu_torch.core import transfer as xfer

        arr = _cpu_array((32,), seed=9)
        out = xfer.ici_move(arr, torch.device("cpu"))
        assert out is arr
        np.testing.assert_array_equal(np.asarray(out), np.asarray(arr))


class TestDeviceTierDirectory:
    """The GCS directory tags device holders with tier 'hbm' — visible
    to locality scoring and the state API, filtered from host reads."""

    def test_list_objects_reports_device_tier(self, rmt_start_regular):
        ref = rmt.put(_cpu_array((2048,), seed=10), device=True)
        rows = _directory_rows(rmt_start_regular, ref.binary())
        assert rows and rows[0]["where"] == "device"
        assert rows[0]["tier"] == "hbm"
        assert rows[0]["size_bytes"] == 8192

    def test_materialized_copy_flips_tier_to_shm(self, rmt_start_regular):
        @rmt.remote
        class Owner:
            def make(self):
                import torch

                return rmt.put(torch.ones(2048, dtype=torch.float32),
                               device=True)

        o = Owner.remote()
        ref = rmt.get(o.make.remote())
        rmt.get(ref)  # forces materialization to the owner's node shm
        rows = _directory_rows(rmt_start_regular, ref.binary())
        assert rows and {r["tier"] for r in rows} == {"shm"}
        rmt.kill(o)

    def test_locality_scores_hbm_bytes(self, rmt_start_regular):
        """_batch_locality counts device-resident args (double weight:
        placing elsewhere pays materialization + wire)."""
        rt = rmt_start_regular
        ref = rmt.put(_cpu_array((4096,), seed=11), device=True)

        class _Spec:
            task_id = b"t" * 16

        spec = _Spec()
        rt_deps = rt._ref_deps

        class _FakeSpec:
            task_id = b"t" * 16
            args = ()
            kwargs = {}

        deps = {ref.binary()}
        old = rt._ref_deps
        rt._ref_deps = lambda s: deps if s is spec else old(s)
        try:
            out = rt._batch_locality([spec])
        finally:
            rt._ref_deps = rt_deps
        head = rt.head_node().node_id
        assert out[spec.task_id][head] == 2 * 16384  # hbm counts double
