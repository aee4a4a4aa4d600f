"""Memory monitor + usage stats (reference: test_memory_pressure.py
shape for the monitor; usage_stats module tests).

The PyTorch port's copy of ``tests/test_memory_monitor.py``: the same
cases run against ``ray_memory_management_tpu_torch``, with its own
fixtures (the shared conftest starts the JAX package's runtime).
"""

import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import usage_stats
from ray_memory_management_tpu_torch.core.memory_monitor import (
    MemoryMonitor, make_newest_task_killer, system_memory_usage,
)


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


class TestMemoryMonitor:
    def test_system_usage_readable(self):
        used, total = system_memory_usage()
        assert 0 < used < total

    def test_threshold_logic(self):
        calls = []
        monitor = MemoryMonitor(
            kill_callback=lambda: calls.append(1) or True,
            usage_threshold=0.9,
            usage_fn=lambda: (95, 100))
        assert monitor.is_over_threshold()
        monitor.usage_fn = lambda: (50, 100)
        assert not monitor.is_over_threshold()

    def test_monitor_kills_under_pressure(self, rmt_start_regular):
        rt = rmt_start_regular

        @rmt.remote(max_retries=2)
        def slow(x):
            time.sleep(3)
            return x

        refs = [slow.remote(i) for i in range(2)]
        time.sleep(1.0)  # let tasks start on workers
        pressure = {"on": True}
        monitor = MemoryMonitor(
            kill_callback=make_newest_task_killer(rt),
            usage_threshold=0.9,
            check_interval_s=0.1,
            usage_fn=lambda: (99, 100) if pressure["on"] else (10, 100))
        monitor.start()
        deadline = time.time() + 10
        while time.time() < deadline and monitor.num_kills == 0:
            time.sleep(0.05)
        pressure["on"] = False  # relieve so retries can finish
        monitor.stop()
        assert monitor.num_kills >= 1
        # killed tasks retry and still complete
        assert sorted(rmt.get(refs, timeout=120)) == [0, 1]

    def test_no_kill_without_candidates(self, rmt_start_regular):
        rt = rmt_start_regular
        killer = make_newest_task_killer(rt)
        assert killer() is False  # no busy workers


class TestRuntimeWiring:
    def test_monitor_starts_from_config(self):
        from ray_memory_management_tpu_torch.config import Config

        cfg = Config(memory_monitor_interval_s=0.5)
        rt = rmt.init(num_cpus=2, _config=cfg)
        try:
            assert rt._memory_monitor is not None
            assert rt._memory_monitor.check_interval_s == 0.5
        finally:
            rmt.shutdown()
        assert rt._memory_monitor._thread is None  # stopped on shutdown

    def test_disabled_by_default(self, rmt_start_regular):
        assert rmt_start_regular._memory_monitor is None


class TestUsageStats:
    def test_disabled_by_default(self, tmp_path):
        usage_stats.disable()
        assert usage_stats.report(str(tmp_path / "u.json")) is None

    def test_enabled_writes_locally(self, rmt_start_regular, tmp_path):
        usage_stats.enable()
        try:
            path = usage_stats.report(str(tmp_path / "u.json"))
            assert path is not None
            import json

            rec = json.loads(open(path).read().splitlines()[-1])
            assert rec["num_nodes"] == 1
            assert "library_version" in rec
        finally:
            usage_stats.disable()
