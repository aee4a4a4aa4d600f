"""Utility surface: ActorPool, Queue, metrics, timeline/profiling.

Mirrors the reference's test_actor_pool.py / test_queue.py /
test_metrics_agent.py coverage at unit scale.

The PyTorch port's copy of ``tests/test_utils.py``: the same cases run
against ``ray_memory_management_tpu_torch``, with its own fixtures (the
shared conftest starts the JAX package's runtime).
"""

import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.utils import ActorPool, Empty, Full, Queue
from ray_memory_management_tpu_torch.utils import metrics, timeline


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
class _PoolActor:
    def double(self, v):
        return 2 * v

    def slow_double(self, v):
        time.sleep(0.05 * v)
        return 2 * v


class TestActorPool:
    def test_map_ordered(self, rmt_start_regular):
        pool = ActorPool([_PoolActor.remote() for _ in range(2)])
        out = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
        assert out == [0, 2, 4, 6, 8, 10]

    def test_map_unordered(self, rmt_start_regular):
        pool = ActorPool([_PoolActor.remote() for _ in range(2)])
        out = list(pool.map_unordered(
            lambda a, v: a.double.remote(v), range(6)))
        assert sorted(out) == [0, 2, 4, 6, 8, 10]

    def test_submit_get_next(self, rmt_start_regular):
        pool = ActorPool([_PoolActor.remote()])
        pool.submit(lambda a, v: a.double.remote(v), 10)
        pool.submit(lambda a, v: a.double.remote(v), 20)
        assert pool.get_next() == 20
        assert pool.get_next() == 40
        assert not pool.has_next()

    def test_task_exception_returns_actor(self, rmt_start_regular):
        @rmt.remote
        class Failer:
            def boom(self, v):
                if v == 0:
                    raise ValueError("boom")
                return v

        pool = ActorPool([Failer.remote()])
        pool.submit(lambda a, v: a.boom.remote(v), 0)
        with pytest.raises(Exception):
            pool.get_next()
        # actor must be back in the pool after the failure
        pool.submit(lambda a, v: a.boom.remote(v), 7)
        assert pool.get_next() == 7

    def test_mix_ordered_unordered(self, rmt_start_regular):
        pool = ActorPool([_PoolActor.remote() for _ in range(2)])
        for v in range(4):
            pool.submit(lambda a, v: a.double.remote(v), v)
        first = pool.get_next_unordered()
        rest = [pool.get_next() for _ in range(3)]
        assert sorted([first] + rest) == [0, 2, 4, 6]

    def test_empty_pool_rejects_submit(self, rmt_start_regular):
        pool = ActorPool([])
        with pytest.raises(RuntimeError):
            pool.submit(lambda a, v: a.double.remote(v), 1)

    def test_push_pop_idle(self, rmt_start_regular):
        a1 = _PoolActor.remote()
        pool = ActorPool([a1])
        popped = pool.pop_idle()
        assert popped is a1
        assert pool.pop_idle() is None
        pool.push(a1)
        assert pool.has_free()
        with pytest.raises(ValueError):
            pool.push(a1)


class TestQueue:
    def test_put_get_fifo(self, rmt_start_regular):
        q = Queue()
        for i in range(5):
            q.put(i)
        assert q.qsize() == 5
        assert [q.get() for _ in range(5)] == [0, 1, 2, 3, 4]
        assert q.empty()

    def test_nowait_and_maxsize(self, rmt_start_regular):
        q = Queue(maxsize=2)
        q.put_nowait(1)
        q.put_nowait(2)
        assert q.full()
        with pytest.raises(Full):
            q.put_nowait(3)
        assert q.get_nowait() == 1
        q.get_nowait()
        with pytest.raises(Empty):
            q.get_nowait()

    def test_blocking_timeout(self, rmt_start_regular):
        q = Queue()
        t0 = time.time()
        with pytest.raises(Empty):
            q.get(timeout=0.2)
        assert time.time() - t0 >= 0.15

    def test_batch_ops(self, rmt_start_regular):
        q = Queue(maxsize=4)
        q.put_nowait_batch([1, 2, 3])
        with pytest.raises(Full):
            q.put_nowait_batch([4, 5])
        assert q.get_nowait_batch(2) == [1, 2]
        with pytest.raises(Empty):
            q.get_nowait_batch(5)

    def test_many_blocked_getters(self, rmt_start_regular):
        """Blocked async gets park on the actor loop under the 1000-slot
        async concurrency cap, not on executor threads — many blocked
        getters coexist with later puts."""
        q = Queue()

        @rmt.remote
        def getter(queue):
            return queue.get(timeout=30)

        refs = [getter.remote(q) for _ in range(5)]
        time.sleep(0.5)  # let all five block inside the actor
        for i in range(5):
            q.put(i)
        assert sorted(rmt.get(refs)) == [0, 1, 2, 3, 4]
        q.shutdown()  # graceful: no blocked calls remain

    def test_queue_passed_to_task(self, rmt_start_regular):
        q = Queue()

        @rmt.remote
        def producer(queue, n):
            for i in range(n):
                queue.put(i)
            return n

        assert rmt.get(producer.remote(q, 3)) == 3
        assert sorted(q.get() for _ in range(3)) == [0, 1, 2]


class TestMetrics:
    def setup_method(self):
        metrics.clear_registry()

    def test_counter(self):
        c = metrics.Counter("req_total", "requests", tag_keys=("route",))
        c.inc(tags={"route": "/a"})
        c.inc(2, tags={"route": "/a"})
        c.inc(tags={"route": "/b"})
        assert c.get(tags={"route": "/a"}) == 3
        with pytest.raises(ValueError):
            c.inc(0)
        with pytest.raises(ValueError):
            c.inc(tags={"bogus": "x"})

    def test_gauge_default_tags(self):
        g = metrics.Gauge("inflight", tag_keys=("node",))
        g.set_default_tags({"node": "n0"})
        g.set(7)
        assert g.get() == 7
        g.set(3, tags={"node": "n1"})
        assert g.get(tags={"node": "n1"}) == 3

    def test_histogram(self):
        h = metrics.Histogram(
            "latency_s", boundaries=[0.1, 1.0], tag_keys=())
        for v in (0.05, 0.5, 5.0, 0.09):
            h.observe(v)
        snap = h.get()
        assert snap["count"] == 4
        counts = [c for _, c in snap["buckets"]]
        assert counts == [2, 1, 1]
        with pytest.raises(ValueError):
            metrics.Histogram("bad", boundaries=[])

    def test_reregistration_merges(self):
        c1 = metrics.Counter("shared_total", tag_keys=("k",))
        c1.inc(3, tags={"k": "a"})
        c2 = metrics.Counter("shared_total", tag_keys=("k",))
        c2.inc(2, tags={"k": "a"})
        assert c1.get(tags={"k": "a"}) == 5
        assert c2.get(tags={"k": "a"}) == 5
        with pytest.raises(ValueError):
            metrics.Gauge("shared_total")

    def test_label_escaping(self):
        g = metrics.Gauge("esc", tag_keys=("p",))
        g.set(1, tags={"p": 'say "hi"\nback\\slash'})
        text = metrics.export_prometheus()
        assert r'p="say \"hi\"\nback\\slash"' in text

    def test_prometheus_export(self):
        c = metrics.Counter("exports_total", "d", tag_keys=("k",))
        c.inc(5, tags={"k": "v"})
        text = metrics.export_prometheus()
        assert "# TYPE exports_total counter" in text
        assert 'exports_total{k="v"} 5' in text


class TestTimeline:
    def test_profile_and_dump(self, rmt_start_regular, tmp_path):
        timeline.clear()

        @rmt.remote
        def traced():
            with timeline.profile("inner", extra={"k": 1}):
                time.sleep(0.01)
            return 1

        assert rmt.get(traced.remote()) == 1
        # worker events arrive with the done reply; events include the
        # task span and the user's profile() span
        deadline = time.time() + 5
        names = []
        while time.time() < deadline:
            names = [e["name"] for e in timeline.chrome_trace_events()]
            if any(n == "inner" for n in names) and any(
                    n.startswith("task::") for n in names):
                break
            time.sleep(0.05)
        assert any(n == "inner" for n in names)
        assert any(n.startswith("task::traced") for n in names)

        out = tmp_path / "trace.json"
        path = rmt.timeline(str(out))
        assert path == str(out)
        import json

        trace = json.loads(out.read_text())
        # slices plus the synthesized flow arrows linking a span's
        # slices across processes
        assert all(ev["ph"] in ("X", "s", "t", "f") for ev in trace)
        assert any(ev["name"] == "inner" for ev in trace)
