"""Core-runtime metrics instrumentation + per-task lifecycle timing
(reference coverage shape: metrics-agent export tests, task_events
state-API tests, `ray summary tasks`).

Covers: the Prometheus exposition golden format, HELP-line sanitizing,
worker->head series delta/merge, the worker exit flush, and the
acceptance workload (>=50 tasks incl. a retry and an object spill ->
non-zero task/scheduler/object-store series, per-stage percentiles via
state.summarize_task_latencies / the dashboard / the CLI)."""

import json
import os
import time
from types import MethodType, SimpleNamespace

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from ray_memory_management_tpu_torch.utils import events, metrics, timeline
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()



@pytest.fixture(autouse=True)
def _clean_buffers():
    events.clear()
    yield
    events.clear()


class TestPrometheusExposition:
    """Satellite: golden test for the exposition text format."""

    def test_golden_counter_gauge_histogram(self):
        metrics.clear_registry()
        try:
            c = metrics.Counter("g_requests_total", "requests served",
                                tag_keys=("endpoint",))
            c.inc(3, tags={"endpoint": 'a"b\\c\nd'})  # needs escaping
            g = metrics.Gauge("g_depth", "queue depth")
            g.set(2.5)
            h = metrics.Histogram("g_lat", "latency",
                                  boundaries=[0.1, 1.0], tag_keys=("op",))
            for v in (0.05, 0.5, 5.0):
                h.observe(v, tags={"op": "x"})
            text = metrics.export_prometheus()
            lines = text.splitlines()
            assert "# HELP g_requests_total requests served" in lines
            assert "# TYPE g_requests_total counter" in lines
            # label values escape backslash, quote and newline
            assert ('g_requests_total{endpoint="a\\"b\\\\c\\nd"} 3.0'
                    in lines)
            assert "# TYPE g_depth gauge" in lines
            assert "g_depth 2.5" in lines
            # cumulative le buckets ending +Inf, then _sum and _count
            assert "# TYPE g_lat histogram" in lines
            assert 'g_lat_bucket{le="0.1",op="x"} 1' in lines
            assert 'g_lat_bucket{le="1.0",op="x"} 2' in lines
            assert 'g_lat_bucket{le="+Inf",op="x"} 3' in lines
            assert 'g_lat_sum{op="x"} 5.55' in lines
            assert 'g_lat_count{op="x"} 3' in lines
        finally:
            metrics.clear_registry()

    def test_help_newline_sanitized(self):
        """Satellite: a multi-line description must not split the HELP
        line (every exposition line must start with # or a metric name)."""
        metrics.clear_registry()
        try:
            metrics.Counter("g_ml_total", "first line\nsecond \\ line").inc()
            text = metrics.export_prometheus()
            lines = text.splitlines()
            assert "# HELP g_ml_total first line\\nsecond \\\\ line" in lines
            for line in lines:
                if not line:
                    continue
                assert line.startswith("#") or line.startswith("g_ml_total")
        finally:
            metrics.clear_registry()

    def test_locality_and_prefetch_series_in_exposition(self):
        """Golden coverage for the locality-scheduler / prestage series:
        each new counter must surface in the exposition with sane HELP
        and TYPE lines once it has moved."""
        new = ("rmt_scheduler_locality_hits_total",
               "rmt_scheduler_locality_misses_total",
               "rmt_scheduler_locality_bytes_avoided_total",
               "rmt_prefetch_started_total",
               "rmt_prefetch_completed_total")
        for name in new:
            assert name in mdefs.DEFS, name
            mdefs.get(name).inc(1)
        text = metrics.export_prometheus()
        lines = text.splitlines()
        for name in new:
            assert f"# TYPE {name} counter" in lines, name
            assert any(line.startswith(f"# HELP {name} ") and
                       len(line) > len(f"# HELP {name} ")
                       for line in lines), name
            assert any(line.startswith(name) and
                       float(line.rsplit(" ", 1)[1]) > 0
                       for line in lines), name

    def test_compression_series_in_exposition(self):
        """Golden coverage for the compressed-movement-plane series: the
        per-codec byte counters, the encode/decode seconds histogram, the
        skip counter, and the quantized-collective counter must all
        surface in the exposition once they have moved."""
        counters = ("rmt_transfer_compress_bytes_in_total",
                    "rmt_transfer_compress_bytes_out_total",
                    "rmt_transfer_compress_skipped_total",
                    "rmt_collective_quantized_ops_total")
        for name in counters + ("rmt_transfer_compress_seconds",):
            assert name in mdefs.DEFS, name
        mdefs.transfer_compress_bytes_in().inc(
            1 << 20, tags={"codec": "zrle"})
        mdefs.transfer_compress_bytes_out().inc(
            1 << 10, tags={"codec": "zrle"})
        mdefs.transfer_compress_skipped().inc(
            tags={"reason": "incompressible"})
        mdefs.collective_quantized_ops().inc(
            tags={"op": "allreduce", "precision": "int8"})
        mdefs.transfer_compress_seconds().observe(
            0.01, tags={"codec": "zrle", "op": "encode"})
        text = metrics.export_prometheus()
        lines = text.splitlines()
        for name in counters:
            assert f"# TYPE {name} counter" in lines, name
            assert any(line.startswith(f"# HELP {name} ") and
                       len(line) > len(f"# HELP {name} ")
                       for line in lines), name
            assert any(line.startswith(name) and
                       float(line.rsplit(" ", 1)[1]) > 0
                       for line in lines), name
        assert "# TYPE rmt_transfer_compress_seconds histogram" in lines
        assert any(line.startswith(
            'rmt_transfer_compress_seconds_count{codec="zrle",op="encode"}')
            for line in lines)
        assert ('rmt_collective_quantized_ops_total'
                '{op="allreduce",precision="int8"}') in text

    def test_logging_series_in_exposition(self):
        """Golden coverage for the log-plane series: the record/byte
        counters (per stream), the drop counter (per reason), and the
        flush-latency histogram must all surface in the exposition once
        they have moved."""
        counters = ("rmt_logs_records_total",
                    "rmt_logs_bytes_total",
                    "rmt_logs_dropped_total")
        for name in counters + ("rmt_logs_flush_seconds",):
            assert name in mdefs.DEFS, name
        mdefs.logs_records().inc(tags={"stream": "stdout"})
        mdefs.logs_records().inc(tags={"stream": "logging"})
        mdefs.logs_bytes().inc(512)
        mdefs.logs_dropped().inc(tags={"reason": "buffer_full"})
        mdefs.logs_dropped().inc(tags={"reason": "retention"})
        mdefs.logs_flush_seconds().observe(0.002)
        text = metrics.export_prometheus()
        lines = text.splitlines()
        for name in counters:
            assert f"# TYPE {name} counter" in lines, name
            assert any(line.startswith(f"# HELP {name} ") and
                       len(line) > len(f"# HELP {name} ")
                       for line in lines), name
            assert any(line.startswith(name) and
                       float(line.rsplit(" ", 1)[1]) > 0
                       for line in lines), name
        assert "# TYPE rmt_logs_flush_seconds histogram" in lines
        assert any(line.startswith("rmt_logs_flush_seconds_count")
                   for line in lines)
        assert 'rmt_logs_records_total{stream="stdout"}' in text
        assert 'rmt_logs_dropped_total{reason="buffer_full"}' in text

    def test_profile_series_in_exposition(self):
        """Golden coverage for the profiling-plane series: the per-role
        process CPU counter, the RSS gauge, and the sample/byte/drop
        counters must all surface in the exposition once they have
        moved."""
        counters = ("rmt_proc_cpu_seconds_total",
                    "rmt_profile_samples_total",
                    "rmt_profile_bytes_total",
                    "rmt_profile_dropped_total")
        for name in counters + ("rmt_proc_rss_bytes",):
            assert name in mdefs.DEFS, name
        mdefs.proc_cpu_seconds().inc(0.25, tags={"role": "worker"})
        mdefs.proc_rss_bytes().set(123456.0)
        mdefs.profile_samples().inc(11)
        mdefs.profile_bytes().inc(2048)
        mdefs.profile_dropped().inc(tags={"reason": "agg_full"})
        mdefs.profile_dropped().inc(tags={"reason": "retention"})
        text = metrics.export_prometheus()
        lines = text.splitlines()
        for name in counters:
            assert f"# TYPE {name} counter" in lines, name
            assert any(line.startswith(f"# HELP {name} ") and
                       len(line) > len(f"# HELP {name} ")
                       for line in lines), name
            assert any(line.startswith(name) and
                       float(line.rsplit(" ", 1)[1]) > 0
                       for line in lines), name
        assert "# TYPE rmt_proc_rss_bytes gauge" in lines
        assert "rmt_proc_rss_bytes 123456.0" in lines
        assert 'rmt_proc_cpu_seconds_total{role="worker"}' in text
        assert 'rmt_profile_dropped_total{reason="agg_full"}' in text

    def test_device_series_in_exposition(self):
        """Golden coverage for the device-tier series: pinned-object and
        pinned-byte gauges, the eviction counter (tagged by destination
        tier), the zero-copy hit counter, and the ICI transfer counter
        must all surface in the exposition once they have moved."""
        counters = ("rmt_device_zero_copy_hits_total",
                    "rmt_device_ici_transfers_total")
        gauges = ("rmt_device_objects_pinned", "rmt_device_bytes_pinned")
        for name in counters:
            assert name in mdefs.DEFS, name
            mdefs.get(name).inc(1)
        for name in gauges:
            assert name in mdefs.DEFS, name
            mdefs.get(name).set(3.0)
        assert "rmt_device_evictions_total" in mdefs.DEFS
        mdefs.get("rmt_device_evictions_total").inc(
            1, tags={"to_tier": "shm"})
        text = metrics.export_prometheus()
        lines = text.splitlines()
        for name in counters:
            assert f"# TYPE {name} counter" in lines, name
            assert any(line.startswith(name) and
                       float(line.rsplit(" ", 1)[1]) > 0
                       for line in lines), name
        for name in gauges:
            assert f"# TYPE {name} gauge" in lines, name
            assert f"{name} 3.0" in lines, name
        assert "# TYPE rmt_device_evictions_total counter" in lines
        assert any(
            line.startswith('rmt_device_evictions_total{to_tier="shm"}')
            and float(line.rsplit(" ", 1)[1]) > 0 for line in lines)
        # the accessors alias the registered instruments' storage
        before = sum(mdefs.get(
            "rmt_device_zero_copy_hits_total").series().values())
        mdefs.device_zero_copy_hits().inc(2)
        after = sum(mdefs.get(
            "rmt_device_zero_copy_hits_total").series().values())
        assert after == before + 2

    def test_serve_series_in_exposition(self):
        """Golden coverage for the serving data plane's series: request
        counter/latency, the shed counter (tagged by reason), the
        queue-depth gauge, autoscale error/decision counters, the paged
        KV gauges, cold-start latency, and placement-mode counter must
        all surface in the exposition once they have moved."""
        tagged_counters = {
            "rmt_serve_requests_total": {"deployment": "d", "result": "ok"},
            "rmt_serve_shed_total": {"reason": "backpressure_timeout"},
            "rmt_serve_autoscale_decisions_total": {"direction": "up"},
            "rmt_serve_replica_placements_total": {"mode": "tier_affine"},
        }
        for name, tags in tagged_counters.items():
            assert name in mdefs.DEFS, name
            mdefs.get(name).inc(1, tags=tags)
        assert "rmt_serve_autoscale_errors_total" in mdefs.DEFS
        mdefs.serve_autoscale_errors().inc(1)
        assert "rmt_serve_kv_backpressure_total" in mdefs.DEFS
        mdefs.serve_kv_backpressure().inc(1)
        gauges = ("rmt_serve_kv_pages_in_use",)
        for name in gauges:
            assert name in mdefs.DEFS, name
            mdefs.get(name).set(5.0)
        mdefs.serve_queue_depth().set(2.0, tags={"deployment": "d"})
        mdefs.serve_request_seconds().observe(
            0.05, tags={"deployment": "d"})
        mdefs.serve_cold_start_seconds().observe(
            1.5, tags={"source": "shipped"})
        text = metrics.export_prometheus()
        lines = text.splitlines()
        for name in tagged_counters:
            assert f"# TYPE {name} counter" in lines, name
        assert 'rmt_serve_requests_total{deployment="d",result="ok"}' \
            in text
        assert 'rmt_serve_shed_total{reason="backpressure_timeout"}' \
            in text
        assert "# TYPE rmt_serve_kv_pages_in_use gauge" in lines
        assert "rmt_serve_kv_pages_in_use 5.0" in lines
        assert 'rmt_serve_queue_depth{deployment="d"} 2.0' in text
        assert "# TYPE rmt_serve_request_seconds histogram" in lines
        assert any(line.startswith("rmt_serve_request_seconds_count")
                   for line in lines)
        assert "# TYPE rmt_serve_cold_start_seconds histogram" in lines
        assert any(
            line.startswith('rmt_serve_cold_start_seconds_count') and
            'source="shipped"' in line for line in lines)
        # the accessors alias the registered instruments' storage
        before = sum(mdefs.get(
            "rmt_serve_kv_backpressure_total").series().values())
        mdefs.serve_kv_backpressure().inc(2)
        after = sum(mdefs.get(
            "rmt_serve_kv_backpressure_total").series().values())
        assert after == before + 2

    def test_canonical_defs_construct(self):
        """Every declared instrument is constructible and re-entrant
        (aliases prior storage instead of shadowing it)."""
        for name in mdefs.DEFS:
            m1 = mdefs.get(name)
            m1_type = type(m1)
            m2 = mdefs.get(name)
            assert type(m2) is m1_type
            if isinstance(m1, metrics.Counter):
                before = sum(m1.series().values())
                m2.inc(1)
                assert sum(m1.series().values()) == before + 1


class TestSeriesMerge:
    """Worker->head aggregation: snapshot_deltas / merge_series."""

    def test_counter_roundtrip_and_delta_semantics(self):
        metrics.clear_registry()
        try:
            c = metrics.Counter("m_x_total", "x", tag_keys=("k",))
            c.inc(5, tags={"k": "a"})
            snap = metrics.snapshot_deltas()
            row = next(s for s in snap if s["name"] == "m_x_total")
            assert row["kind"] == "counter"
            assert list(row["series"].values()) == [5.0]
            # nothing moved since: no delta rows for that metric
            assert not any(s["name"] == "m_x_total"
                           for s in metrics.snapshot_deltas())
            c.inc(2, tags={"k": "a"})
            snap2 = metrics.snapshot_deltas()
            row2 = next(s for s in snap2 if s["name"] == "m_x_total")
            assert list(row2["series"].values()) == [2.0]
            # merge into a fresh "head" registry reconstructs the series
            metrics.clear_registry()
            metrics.merge_series(snap)
            metrics.merge_series(snap2)
            merged = metrics.Counter("m_x_total", "x", tag_keys=("k",))
            assert merged.get(tags={"k": "a"}) == 7.0
        finally:
            metrics.clear_registry()

    def test_histogram_and_gauge_roundtrip(self):
        metrics.clear_registry()
        try:
            h = metrics.Histogram("m_h", "h", boundaries=[1.0, 10.0])
            h.observe(0.5)
            h.observe(5.0)
            metrics.Gauge("m_g", "g").set(3.25)
            snap = metrics.snapshot_deltas()
            metrics.clear_registry()
            metrics.merge_series(snap)
            hm = metrics.Histogram("m_h", "h", boundaries=[1.0, 10.0])
            got = hm.get()
            assert got["count"] == 2 and got["sum"] == 5.5
            assert [c for _, c in got["buckets"]] == [1, 1, 0]
            assert metrics.Gauge("m_g", "g").get() == 3.25
        finally:
            metrics.clear_registry()

    def test_malformed_frame_is_dropped(self):
        metrics.merge_series([{"kind": "counter"},  # no name
                              {"kind": "histogram", "name": "m_bad",
                               "series": {}},  # no boundaries
                              "not-a-dict"])  # type: ignore[list-item]


class TestWorkerExitFlush:
    """Satellite: buffered spans/events/metric deltas survive worker
    exit via the unconditional final flush (unit-level: the full-cluster
    shutdown path tears the router down before workers exit, so the
    frame's delivery there is best-effort by design)."""

    def test_final_flush_ships_buffered_state(self):
        from ray_memory_management_tpu_torch.core.worker import Worker

        class _RecordingSender:
            def __init__(self):
                self.sent = []

            def send_now(self, msg):
                self.sent.append(msg)
                return True

        from ray_memory_management_tpu_torch.utils import structlog

        timeline.clear()
        metrics.clear_registry()
        structlog.clear()  # _flush_frame drains the structlog buffer too
        try:
            stub = SimpleNamespace(sender=_RecordingSender())
            stub._flush_frame = MethodType(Worker._flush_frame, stub)
            timeline.record_event("tail-span", "test", 1.0, 2.0)
            events.emit("W_EVT", "buffered on worker", source="test")
            metrics.Counter("w_final_total", "x").inc()
            Worker._final_flush(stub)
            assert stub.sender.sent, "final flush wrote nothing"
            frame = stub.sender.sent[0]
            assert frame["type"] == "profile"
            assert "tail-span" in [e["name"] for e in frame["profile"]]
            assert any(e["label"] == "W_EVT" for e in frame["events"])
            assert any(s["name"] == "w_final_total"
                       for s in frame["series"])
            # empty buffers -> no frame at all (no wakeup spam on exit)
            stub2 = SimpleNamespace(sender=_RecordingSender())
            stub2._flush_frame = MethodType(Worker._flush_frame, stub2)
            Worker._final_flush(stub2)
            assert not stub2.sender.sent
        finally:
            metrics.clear_registry()
            timeline.clear()


class TestAcceptanceWorkload:
    def test_workload_populates_metrics_and_summaries(self, tmp_path):
        """>=50 tasks + one retry + one spill -> non-zero task/scheduler/
        object-store series, >=3 lifecycle stages with p50/p95/p99, and
        the dashboard route + CLI printing the same numbers."""
        from ray_memory_management_tpu_torch.config import Config

        cfg = Config(object_store_memory=32 << 20,
                     min_spilling_size=1 << 20)
        rt = rmt.init(num_cpus=4, _config=cfg)
        try:
            sub0 = mdefs.tasks_submitted().get()
            fin0 = mdefs.tasks_finished().get()
            ret0 = mdefs.tasks_retried().get()
            spill0 = mdefs.objects_spilled().get()

            @rmt.remote
            def f(x):
                return x + 1

            refs = [f.remote(i) for i in range(55)]
            assert rmt.get(refs, timeout=120) == [i + 1 for i in range(55)]

            @rmt.remote(max_retries=2, retry_exceptions=True)
            def flaky(path):
                if not os.path.exists(path):
                    open(path, "w").close()
                    raise ValueError("first attempt fails")
                return "ok"

            marker = str(tmp_path / "marker")
            assert rmt.get(flaky.remote(marker), timeout=60) == "ok"

            # overfill the 32 MB store: 6 x 8 MB puts force spilling
            big = [rmt.put(bytes([i]) * (8 << 20)) for i in range(6)]
            assert rmt.get(big[0], timeout=60)[:4] == b"\x00" * 4

            assert mdefs.tasks_submitted().get() - sub0 >= 56
            assert mdefs.tasks_finished().get() - fin0 >= 56
            assert mdefs.tasks_retried().get() - ret0 >= 1
            assert mdefs.objects_spilled().get() - spill0 >= 1

            # per-stage percentiles for >=3 lifecycle stages
            lat = state.summarize_task_latencies()
            assert len(lat) >= 3
            for stage, row in lat.items():
                if stage == "resources":
                    # the profiling plane's rusage columns: native units
                    # (seconds/bytes), not stage latencies
                    assert row["cpu_s_count"] >= 1, row
                    continue
                for key in ("count", "p50_ms", "p95_ms", "p99_ms"):
                    assert key in row, (stage, row)
                assert row["p50_ms"] <= row["p95_ms"] <= row["p99_ms"]
            assert "run" in lat and "total" in lat  # worker stamps merged

            # list_tasks rows carry per-stage durations
            done_rows = [r for r in state.list_tasks()
                         if r["state"] == "FINISHED" and r["durations"]]
            assert done_rows and "total" in done_rows[0]["durations"]

            # /metrics scrape: non-zero task/scheduler/object-store series
            rt._refresh_gauges()  # deterministic gauge sample
            text = metrics.export_prometheus()
            values = {}
            for line in text.splitlines():
                if line.startswith("#") or " " not in line:
                    continue
                series, val = line.rsplit(" ", 1)
                values[series.split("{")[0]] = (
                    values.get(series.split("{")[0], 0.0) + float(val))
            for name in ("rmt_tasks_submitted_total",
                         "rmt_tasks_finished_total",
                         "rmt_tasks_retried_total",
                         "rmt_scheduler_placements_total",
                         "rmt_objects_spilled_total",
                         "rmt_objects_spilled_bytes_total",
                         "rmt_object_store_bytes",
                         "rmt_task_stage_seconds_count"):
                assert values.get(name, 0.0) > 0.0, (name, sorted(values))

            # worker-side series merge into the head registry via the
            # flush ticker (1 s period): poll the scrape briefly
            deadline = time.time() + 10
            while time.time() < deadline:
                if mdefs.worker_tasks_executed().get() > 0:
                    break
                time.sleep(0.2)
            assert mdefs.worker_tasks_executed().get() >= 1

            # dashboard routes (direct dispatch, no socket)
            from ray_memory_management_tpu_torch.dashboard import Dashboard

            dash = Dashboard.__new__(Dashboard)  # _route needs no server
            status, _, body = dash._route("/api/task_summary")
            assert status == 200
            summary = json.loads(body)
            assert set(summary["latencies"]) == set(lat)
            status, _, body = dash._route("/api/timeline")
            tl = json.loads(body)
            assert status == 200 and isinstance(tl["traceEvents"], list)
            assert isinstance(tl["dropped"], int)
            status, _, body = dash._route("/metrics")
            assert status == 200 and b"rmt_tasks_submitted_total" in body
        finally:
            rmt.shutdown()

    def test_cli_summary_prints_latencies(self, rmt_start_regular, capsys):
        from ray_memory_management_tpu_torch.scripts import cli

        @rmt.remote
        def f(x):
            return x * 2

        assert rmt.get([f.remote(i) for i in range(8)], timeout=60) == [
            i * 2 for i in range(8)]
        expected = state.summarize_task_latencies()
        assert cli.main(["summary"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["tasks"]["total"] >= 8
        assert set(out["latencies"]) == set(expected)
        for stage, row in expected.items():
            if stage == "resources":  # rusage columns, no "count" key
                continue
            assert out["latencies"][stage]["count"] == row["count"]

    def test_cli_summary_without_runtime_errors(self, capsys):
        from ray_memory_management_tpu_torch.scripts import cli

        assert cli.main(["summary"]) == 1
        assert "no cluster" in capsys.readouterr().err
