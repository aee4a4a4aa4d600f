"""Cluster profiling plane (utils/profiler.py + state.get_profile +
/api/profile + ``rmt-torch profile``).

The acceptance scenario: a CPU-burning task on a non-head
virtual node shows up in ``state.get_profile(trace_id=...)`` as folded
stacks containing the burner's frame, tagged with the SAME
task_id/trace_id the lifecycle row carries, and ``list_tasks`` reports
its cpu_s/peak_rss rusage deltas. Satellite coverage rides here too:
the RMT_WORKER_PROFILE deprecation alias.

The PyTorch port's copy of ``tests/test_profiler.py``. Left out: the
perf-regression gate's cases (``TestPerfGate``:
``test_gate_passes_within_tolerance``,
``test_gate_fails_past_tolerance_with_field_lines``,
``test_gate_skips_unparseable_round``,
``test_gate_only_votes_on_shared_fields``, ``test_gate_json_output``,
``test_gate_against_repo_rounds``,
``test_first_round_trivially_passes``), which need
``analysis/check_perf.py``; they come with the port's benchmark.
"""

import json
import os
import sys
import threading
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.utils import profiler, tracing
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_profiler():
    profiler.clear()
    yield
    profiler.clear()


def _affinity(node_id):
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )
    return NodeAffinitySchedulingStrategy(node_id=node_id, soft=False)


# ------------------------------------------------------------ sampling core
class TestSampling:
    def test_fold_frame_is_root_first_basenames(self):
        def leaf():
            return profiler.fold_frame(sys._getframe())

        stack = leaf()
        parts = stack.split(";")
        # leaf frame LAST (root-first order), names are file.py:func
        assert parts[-1] == "test_torch_profiler.py:leaf"
        assert "test_torch_profiler.py:test_fold_frame_is_root_first_basenames" \
            in parts
        assert not any(p.startswith("/") for p in parts)

    def test_record_sample_aggregates_and_stamps_identity(self):
        prev = (profiler._node_id, profiler._role)
        profiler.configure(node_id="aabbccdd", role="tester")
        tok = profiler.set_task_context("task-1", "tr-1")
        try:
            frame = sys._getframe()
            ident = threading.get_ident()
            profiler.record_sample("MainThread", ident, frame, ts=1.0)
            profiler.record_sample("MainThread", ident, frame, ts=2.0)
            # identity is stamped at drain time: drain while configured
            recs = profiler.drain_samples()
        finally:
            profiler.reset_task_context(tok)
            profiler._node_id, profiler._role = prev
            profiler.configure(role=prev[1] or "driver")
        assert len(recs) == 1  # identical stacks collapse between flushes
        rec = recs[0]
        assert rec["count"] == 2
        assert rec["ts"] == 2.0  # last occurrence wins
        assert rec["node_id"] == "aabbccdd"
        assert rec["role"] == "tester"
        assert rec["pid"] == os.getpid()
        assert rec["thread"] == "MainThread"
        assert rec["task_id"] == "task-1"
        assert rec["trace_id"] == "tr-1"
        assert "test_torch_profiler.py:" in rec["stack"]
        assert profiler.drain_samples() == []  # drained

    def test_task_context_is_readable_cross_thread(self):
        done = threading.Event()
        ident_box = {}

        def tagged():
            profiler.set_task_context("t-worker", "tr-worker")
            ident_box["ident"] = threading.get_ident()
            done.set()
            time.sleep(0.5)

        t = threading.Thread(target=tagged, daemon=True)
        t.start()
        assert done.wait(5)
        # the sampler thread resolves ANOTHER thread's task identity
        assert profiler.current_task_context(ident_box["ident"]) == \
            ("t-worker", "tr-worker")
        t.join()

    def test_current_task_context_falls_back_to_tracing(self):
        ttok = tracing.set_current(("tr-drv", "sp-1", None))
        try:
            assert profiler.current_task_context() == (None, "tr-drv")
        finally:
            tracing.reset(ttok)

    def test_reset_task_context_restores_previous(self):
        tok1 = profiler.set_task_context("outer", "tr-o")
        tok2 = profiler.set_task_context("inner", "tr-i")
        assert profiler.current_task_context() == ("inner", "tr-i")
        profiler.reset_task_context(tok2)
        assert profiler.current_task_context() == ("outer", "tr-o")
        profiler.reset_task_context(tok1)
        assert profiler.current_task_context()[0] is None

    def test_agg_overflow_drops_new_with_accounting(self):
        frame = sys._getframe()
        ident = threading.get_ident()
        extra = 5
        for i in range(profiler.MAX_AGG + extra):
            # distinct thread names make distinct aggregation keys
            profiler.record_sample(f"t{i}", ident, frame)
        assert profiler.dropped_count() >= extra
        recs = profiler.drain_samples()
        assert len(recs) == profiler.MAX_AGG
        # established entries keep counting even when the map is full
        profiler.record_sample("t0", ident, frame)
        assert len(profiler.drain_samples()) == 1

    def test_reingest_front_extends(self):
        frame = sys._getframe()
        ident = threading.get_ident()
        profiler.record_sample("first", ident, frame)
        batch = profiler.drain_samples()
        profiler.record_sample("second", ident, frame)
        profiler.reingest(batch)
        threads = [r["thread"] for r in profiler.drain_samples()]
        assert threads == ["first", "second"]

    def test_ingest_feeds_attached_store_and_filters_junk(self):
        store = profiler.ProfileStore()
        profiler.attach_store(store)
        try:
            profiler.ingest([{"stack": "a;b", "count": 1, "ts": 1.0},
                             "not-a-dict", None])
            assert len(store.query()) == 1
        finally:
            profiler.attach_store(None)

    def test_attach_store_drains_backlog(self):
        frame = sys._getframe()
        profiler.record_sample("backlog", threading.get_ident(), frame)
        store = profiler.ProfileStore()
        profiler.attach_store(store)
        try:
            assert any(r["thread"] == "backlog" for r in store.query())
        finally:
            profiler.attach_store(None)

    def test_sample_once_captures_other_threads(self):
        stop = threading.Event()

        def spinning_beacon():
            while not stop.wait(0.005):
                pass

        t = threading.Thread(target=spinning_beacon, daemon=True,
                             name="beacon")
        t.start()
        try:
            time.sleep(0.05)
            assert profiler.sample_once() >= 1
        finally:
            stop.set()
            t.join()
        recs = profiler.drain_samples()
        mine = [r for r in recs if r["thread"] == "beacon"]
        assert mine, recs
        assert any("spinning_beacon" in r["stack"] for r in mine)

    def test_rmt_profile_gate_disables_everything(self):
        prev = profiler.is_enabled()
        profiler.set_enabled(False)
        try:
            profiler.record_sample("x", threading.get_ident(),
                                   sys._getframe())
            assert profiler.sample_once() == 0
            assert profiler.drain_samples() == []
            assert profiler.start_sampler() is False
            assert profiler.burst(0.05) == 0
        finally:
            profiler.set_enabled(prev)

    def test_start_stop_sampler_lifecycle(self):
        if not profiler.is_enabled():
            pytest.skip("profiling disabled in this environment")
        assert profiler.start_sampler(hz=50.0) is True
        try:
            assert profiler.sampler_running()
            assert profiler.start_sampler(hz=50.0) is False  # idempotent
            time.sleep(0.2)
        finally:
            profiler.stop_sampler()
        assert not profiler.sampler_running()
        # the continuous ticks sampled this (busy) main thread
        assert profiler.drain_samples()

    def test_burst_samples_land_in_pipeline(self):
        if not profiler.is_enabled():
            pytest.skip("profiling disabled in this environment")
        stop = threading.Event()
        t = threading.Thread(
            target=lambda: [None for _ in iter(stop.is_set, True)],
            daemon=True, name="burst-target")
        t.start()
        try:
            assert profiler.burst(0.1, hz=200.0) > 0
        finally:
            stop.set()
            t.join()
        assert profiler.drain_samples()

    def test_start_burst_dumps_folded_file(self, tmp_path):
        if not profiler.is_enabled():
            pytest.skip("profiling disabled in this environment")
        stop = threading.Event()
        t = threading.Thread(
            target=lambda: [None for _ in iter(stop.is_set, True)],
            daemon=True, name="dump-target")
        t.start()
        path = tmp_path / "prof.folded"
        try:
            bt = profiler.start_burst(0.15, hz=200.0, path=str(path))
            bt.join(5)
        finally:
            stop.set()
            t.join()
        text = path.read_text()
        assert text.strip(), "burst dump is empty"
        for line in text.strip().splitlines():
            stack, count = line.rsplit(" ", 1)
            assert ";" in stack or ":" in stack
            assert int(count) >= 1


# ----------------------------------------------------------- rusage deltas
class TestRusage:
    def test_cpu_and_rss_deltas(self):
        begin = profiler.task_rusage_begin()
        # burn actual CPU so the thread clock moves
        acc = 0
        while time.thread_time() - begin["tcpu"] < 0.05:
            acc += sum(range(500))
        out = profiler.task_rusage_end(begin)
        assert out["cpu_s"] >= 0.04
        assert out["peak_rss"] > 0
        assert out["hbm_bytes"] == 0  # no device store passed

    def test_hbm_delta_uses_device_store(self):
        class FakeStore:
            def __init__(self):
                self.v = 100

            def total_bytes(self):
                return self.v

        ds = FakeStore()
        begin = profiler.task_rusage_begin(ds)
        ds.v = 356
        out = profiler.task_rusage_end(begin, ds)
        assert out["hbm_bytes"] == 256

    def test_cross_thread_end_falls_back_to_process_clock(self):
        begin = profiler.task_rusage_begin()
        box = {}

        def end_elsewhere():
            box["out"] = profiler.task_rusage_end(begin)

        t = threading.Thread(target=end_elsewhere)
        t.start()
        t.join()
        assert box["out"]["cpu_s"] >= 0.0  # process-clock path, no crash


# --------------------------------------------------------------- the store
def _smp(stack, ts=0.0, count=1, task=None, trace=None, node=None):
    return {"stack": stack, "ts": ts, "count": count, "task_id": task,
            "trace_id": trace, "node_id": node}


class TestProfileStore:
    def test_query_filters_compose(self):
        store = profiler.ProfileStore()
        store.add(_smp("a", ts=1.0, task="t1", trace="tr1", node="n1"))
        store.add(_smp("b", ts=2.0, task="t1", trace="tr1", node="n2"))
        store.add(_smp("c", ts=3.0, task="t2", trace="tr1", node="n1"))
        store.add(_smp("d", ts=4.0, task="t2", trace="tr2", node="n2"))
        assert [r["stack"] for r in store.query(task_id="t1")] == \
            ["a", "b"]
        assert [r["stack"] for r in store.query(trace_id="tr1")] == \
            ["a", "b", "c"]
        assert [r["stack"] for r in store.query(node_id="n2")] == \
            ["b", "d"]
        # since is an exclusive ts lower bound
        assert [r["stack"] for r in store.query(since=2.0)] == ["c", "d"]
        # ANDed combinations
        assert [r["stack"] for r in store.query(trace_id="tr1",
                                                node_id="n1")] == \
            ["a", "c"]
        assert store.query(task_id="t1", trace_id="tr2") == []
        # newest-limit, and the limit=0 gotcha (means none, not all)
        assert [r["stack"] for r in store.query(limit=2)] == ["c", "d"]
        assert store.query(limit=0) == []

    def test_retention_evicts_oldest_with_accounting(self):
        store = profiler.ProfileStore(retention=4)
        for i in range(10):
            store.add(_smp(f"s{i}", ts=float(i), task="t1"))
        assert store.dropped_count() == 6
        stacks = [r["stack"] for r in store.query(task_id="t1")]
        assert stacks == ["s6", "s7", "s8", "s9"]  # index lazily pruned
        assert [r["stack"] for r in store.query()] == stacks

    def test_fold_and_folded_lines(self):
        samples = [_smp("a;b", count=2), _smp("a;b", count=3),
                   _smp("a;c", count=4), _smp("", count=9)]
        folded = profiler.fold(samples)
        assert folded == {"a;b": 5, "a;c": 4}
        assert profiler.folded_lines(folded) == ["a;b 5", "a;c 4"]


# --------------------------------------------------- cluster acceptance
class TestClusterProfilePlane:
    def test_burner_task_profiled_and_attributed(self):
        """The acceptance scenario, on a non-head virtual node."""
        if not profiler.is_enabled():
            pytest.skip("profiling disabled in this environment")
        rt = rmt.init(num_cpus=2)
        try:
            other = rt.add_node({"num_cpus": 2})

            @rmt.remote
            def burner(budget_s):
                import time as _t
                t0 = _t.thread_time()
                acc = 0
                while _t.thread_time() - t0 < budget_s:
                    acc += sum(range(2000))
                return acc

            ref = burner.options(
                scheduling_strategy=_affinity(other)).remote(1.2)
            assert rmt.get(ref, timeout=120) > 0

            row = next(r for r in state.list_tasks()
                       if "burner" in r["name"])
            # per-task rusage deltas landed on the lifecycle row
            assert row["cpu_s"] is not None and row["cpu_s"] >= 1.0, row
            assert row["peak_rss"] > 0
            assert row["hbm_bytes"] == 0  # burner never touched HBM
            # folded stacks for the task's trace carry the burner frame,
            # queryable immediately after get() (samples rode the reply)
            folded = state.get_profile(trace_id=row["trace_id"])
            assert folded, "no samples for the burner's trace"
            assert any("burner" in r["stack"] for r in folded), folded
            # the raw samples carry the exact task/trace identity
            raw = state.get_profile(task_id=row["task_id"], fold=False)
            burner_recs = [r for r in raw if "burner" in r["stack"]]
            assert burner_recs, raw
            for rec in burner_recs:
                assert rec["task_id"] == row["task_id"]
                assert rec["trace_id"] == row["trace_id"]
                assert rec["node_id"] == other.hex()
                assert rec["role"] == "worker"
            # per-stage summary grew the resources columns
            lat = state.summarize_task_latencies()
            res = lat.get("resources")
            assert res and res["cpu_s_count"] >= 1
            assert res["cpu_s_mean"] > 0
        finally:
            rmt.shutdown()

    def test_rusage_attributed_for_actor_methods(self):
        rt = rmt.init(num_cpus=2)
        try:
            del rt

            @rmt.remote
            class Worker:
                def spin(self):
                    acc = 0
                    for i in range(200_000):
                        acc += i % 7
                    return acc

            a = Worker.remote()
            assert rmt.get(a.spin.remote(), timeout=60) > 0
            row = next(r for r in state.list_tasks()
                       if "spin" in r["name"])
            assert row["cpu_s"] is not None and row["cpu_s"] >= 0.0
            assert row["peak_rss"] > 0
        finally:
            rmt.shutdown()


# ------------------------------------------------------------- the surfaces
class TestProfileSurfaces:
    def test_api_profile_serves_folded_and_raw(self):
        from ray_memory_management_tpu_torch.dashboard import Dashboard

        rt = rmt.init(num_cpus=1)
        try:
            rt.profile_store.add(_smp("root;hot", ts=time.time(),
                                      count=3, task="t-api",
                                      trace="tr-api", node="n-api"))
            dash = Dashboard.__new__(Dashboard)  # _route needs no server
            status, ctype, body = dash._route("/api/profile")
            assert status == 200 and ctype == "application/json"
            data = json.loads(body)
            assert isinstance(data["dropped"], int)
            assert any(r["stack"] == "root;hot" and r["count"] == 3
                       for r in data["profile"])
            # raw mode + server-side filters
            status, _, body = dash._route(
                "/api/profile?fold=0&task_id=t-api")
            assert status == 200
            raw = json.loads(body)["profile"]
            assert raw and raw[0]["trace_id"] == "tr-api"
            status, _, body = dash._route(
                "/api/profile?task_id=no-such-task")
            assert status == 200
            assert json.loads(body)["profile"] == []
        finally:
            rmt.shutdown()

    def test_api_profile_rejects_bad_params(self):
        from ray_memory_management_tpu_torch.dashboard import Dashboard

        dash = Dashboard.__new__(Dashboard)
        for query in ("limit=abc", "limit=-5", "since=noon", "fold=maybe"):
            status, _, body = dash._route(f"/api/profile?{query}")
            assert status == 400, query
            assert b"error" in body, query

    def test_cli_profile_prints_and_writes_folded(self, capsys, tmp_path):
        from ray_memory_management_tpu_torch.scripts import cli

        rt = rmt.init(num_cpus=1)
        try:
            rt.profile_store.add(_smp("main;work", count=7,
                                      trace="tr-cli"))
            assert cli.main(["profile", "--trace", "tr-cli"]) == 0
            out = capsys.readouterr().out
            assert "main;work 7" in out
            # the flamegraph workflow: -o writes collapsed-stack lines
            path = tmp_path / "prof.folded"
            assert cli.main(["profile", "--trace", "tr-cli",
                             "-o", str(path)]) == 0
            assert "1 folded stacks written" in capsys.readouterr().out
            assert path.read_text() == "main;work 7\n"
        finally:
            rmt.shutdown()

    def test_cli_profile_without_runtime_errors(self, capsys):
        from ray_memory_management_tpu_torch.scripts import cli

        assert cli.main(["profile"]) == 1
        assert "no cluster" in capsys.readouterr().err


# --------------------------------------------- RMT_WORKER_PROFILE deprecation
def test_worker_profile_env_is_deprecated_burst_alias(tmp_path):
    """The old cProfile hook warns and takes a burst capture instead."""
    import subprocess

    prefix = tmp_path / "wp"
    code = (
        "import time, warnings\n"
        "import ray_memory_management_tpu_torch as rmt\n"
        "rmt.init(num_cpus=1)\n"
        "@rmt.remote\n"
        "def spin():\n"
        "    t0 = time.time()\n"
        "    acc = 0\n"
        "    while time.time() - t0 < 2.2:\n"
        "        acc += sum(range(1000))\n"
        "    return acc\n"
        "print(rmt.get(spin.remote(), timeout=60) > 0)\n"
        "rmt.shutdown()\n"
    )
    env = dict(os.environ, RMT_WORKER_PROFILE=str(prefix),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    assert "True" in proc.stdout
    assert "deprecated" in proc.stderr
    dumps = list(tmp_path.glob("wp.*"))
    assert dumps, "no burst dump written"
    assert any(p.read_text().strip() for p in dumps)
