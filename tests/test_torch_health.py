"""Cluster health plane (utils/tsdb.py + core/health.py +
state.query_series/get_alerts + /api/series + /api/alerts + ``rmt
doctor``).

The acceptance scenario: fault-injected task failures plus a
KV-backpressure burst on a cluster whose work runs on a non-head
virtual node trip TWO distinct default rules; both alerts surface from
``state.get_alerts()`` within one for_duration, each carrying >=3
evidence samples and (for the task rule) an exemplar trace id that
resolves through ``state.get_trace``; ``rmt doctor`` ranks them first;
and ``query_series`` deltas match the counters' sampled increments
exactly (``rate * span_s == delta`` by construction). ``RMT_HEALTH=0``
keeps the store empty.
"""

import json
import os
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from ray_memory_management_tpu_torch.core.health import (
    HEALTH_ALERT, HealthEngine, Rule, default_rules,
)
from ray_memory_management_tpu_torch.utils import events, faults, metrics, tsdb
from _port_fixtures import one_intra_op_thread  # noqa: F401

T0 = 1_000_000.0  # synthetic clock base for standalone-store tests


@pytest.fixture(autouse=True)
def _clean_health_plane():
    yield
    os.environ.pop("RMT_fault_injection_spec", None)
    os.environ.pop("RMT_fault_injection_seed", None)
    faults.reset()
    metrics.set_series_cap(None)


def _counter_snap(value, tags=()):
    return {tuple(tags): float(value)}


# ---------------------------------------------------------------- tsdb rings
class TestTSDB:
    def test_ring_eviction_and_downsample(self):
        store = tsdb.TSDB(raw_points=10, downsample_every=5,
                          downsample_points=4)
        for i in range(20):
            store.ingest("g", "gauge", _counter_snap(i), T0 + i)
        st = store.stats()
        assert st["names"] == 1 and st["series"] == 1
        assert st["points"] <= 10 + 4  # bounded by construction
        # raw ring kept the newest 10 points only
        [series] = store.range("g")
        raw_part = [p for p in series["points"] if p[0] >= T0 + 10]
        assert [v for _, v in raw_part] == [float(i) for i in range(10, 20)]
        # downsample aggregates fold every 5th ingest: (ts,min,max,last,n)
        [d] = store.down("g")
        assert [tuple(p) for p in d["points"]] == [
            (T0 + 4, 0.0, 4.0, 4.0, 5),
            (T0 + 9, 5.0, 9.0, 9.0, 5),
            (T0 + 14, 10.0, 14.0, 14.0, 5),
            (T0 + 19, 15.0, 19.0, 19.0, 5),
        ]
        # range() splices only the down history that predates the raw
        # ring, so the merged view has no duplicated interval
        down_part = [p for p in series["points"] if p[0] < T0 + 10]
        assert down_part == [[T0 + 4, 4.0], [T0 + 9, 9.0]]

    def test_rate_delta_exact_and_quantile(self):
        store = tsdb.TSDB()
        for i in range(10):
            store.ingest("c", "counter", _counter_snap(3 * i), T0 + i)
        now = T0 + 9
        # delta is EXACTLY the counted increments between the window's
        # first and last samples; rate * span == delta by construction
        assert store.delta("c", window=5.0, now=now) == 15.0
        assert store.span("c", window=5.0, now=now) == 5.0
        assert store.rate("c", window=5.0, now=now) == 3.0
        d = store.delta("c", window=100.0, now=now)
        r = store.rate("c", window=100.0, now=now)
        s = store.span("c", window=100.0, now=now)
        assert d == 27.0 and r * s == d
        # scalar quantile: nearest-rank over the window's samples
        for i in range(10):
            store.ingest("lat", "gauge", _counter_snap(i + 1), T0 + i)
        assert store.quantile_over_time("lat", 0.5, 100.0,
                                        now=now) == 5.0
        assert store.quantile_over_time("lat", 1.0, 100.0,
                                        now=now) == 10.0
        with pytest.raises(ValueError):
            store.quantile_over_time("lat", 1.5, 100.0)

    def test_histogram_quantile_interpolates_window_deltas(self):
        store = tsdb.TSDB()
        bounds = [1.0, 2.0, 4.0]
        # cumulative bucket counts: 4 observations land in (1, 2]
        store.ingest("h", "histogram", {(): ([0, 0, 0, 0], 0.0, 0)},
                     T0, boundaries=bounds)
        store.ingest("h", "histogram", {(): ([0, 4, 0, 0], 6.0, 4)},
                     T0 + 2, boundaries=bounds)
        q = store.quantile_over_time("h", 0.5, 100.0, now=T0 + 2)
        assert q == pytest.approx(1.5)
        # scalar view of a histogram series = cumulative observations
        assert store.last("h") == 4.0
        assert store.delta("h", 100.0, now=T0 + 2) == 4.0

    def test_cardinality_cap_folds_into_other_bucket(self):
        store = tsdb.TSDB(max_series_per_name=2)
        snap = {(("node", f"n{i}"),): 10.0 + i for i in range(4)}
        folded = store.ingest("c", "counter", snap, T0)
        assert folded == 2
        assert store.stats()["series"] == 3  # 2 dedicated + __other__
        # the over-cap combos (n2, n3: first two were admitted) are
        # SUMMED into the __other__ bucket, not dropped: nothing is lost
        [other] = store.range("c", tags={"node": tsdb.OVERFLOW_TAG_VALUE})
        assert other["points"] == [[T0, 12.0 + 13.0]]

    def test_overflow_bucket_stays_monotonic_for_counters(self):
        store = tsdb.TSDB(max_series_per_name=1)
        for tick in range(3):
            snap = {(("node", f"n{i}"),): float(tick * 10 + i)
                    for i in range(3)}
            store.ingest("c", "counter", snap, T0 + tick)
        [other] = store.range("c", tags={"node": tsdb.OVERFLOW_TAG_VALUE})
        vals = [v for _, v in other["points"]]
        assert vals == sorted(vals)  # admission is stable -> monotonic

    def test_sample_registry_counts_drops(self, monkeypatch):
        # the registry is process-global: in a worker that ran other
        # files first it also holds their over-cap series (the JAX
        # package's copy of this case fails there), so this case samples
        # a registry of its own instruments
        monkeypatch.setattr(metrics, "_registry", {})
        monkeypatch.setattr(tsdb, "_m_dropped", None)
        prev = tsdb.is_enabled()
        tsdb.set_enabled(True)
        try:
            c = metrics.Counter("healthtest_fanout_total",
                                tag_keys=("node",))
            for i in range(5):
                c.inc(1.0, tags={"node": f"n{i}"})
            store = tsdb.TSDB(max_series_per_name=2)
            before = sum(mdefs.tsdb_dropped().series().values())
            store.sample_registry(now=T0)
            after = sum(mdefs.tsdb_dropped().series().values())
            assert after - before == 3  # 5 combos, cap 2 -> 3 folded
            key = (("reason", "cardinality"),)
            assert mdefs.tsdb_dropped().series()[key] >= 3
        finally:
            tsdb.set_enabled(prev)

    def test_rmt_health_gate_keeps_store_empty(self):
        prev = tsdb.is_enabled()
        tsdb.set_enabled(False)
        try:
            metrics.Counter("healthtest_gate_total").inc()
            store = tsdb.TSDB()
            store.sample_registry()
            assert store.stats() == {"names": 0, "series": 0,
                                     "points": 0}
        finally:
            tsdb.set_enabled(prev)


# ----------------------------------------------------------- metrics guard
class TestMetricsCardinalityGuard:
    def test_new_overcap_combos_fold_to_other(self):
        metrics.set_series_cap(3)
        c = metrics.Counter("healthtest_cap_total", tag_keys=("k",))
        for i in range(6):
            c.inc(1.0, tags={"k": f"v{i}"})
        snap = c.series()
        assert len(snap) == 4  # 3 dedicated + the fold bucket
        okey = (("k", metrics.OVERFLOW_TAG_VALUE),)
        assert snap[okey] == 3.0  # v3..v5 all folded, none lost
        ov = mdefs.metrics_series_overflow().series()
        assert ov[(("metric", "healthtest_cap_total"),)] >= 3.0

    def test_existing_series_keep_writing_past_the_cap(self):
        metrics.set_series_cap(2)
        g = metrics.Gauge("healthtest_capg", tag_keys=("k",))
        g.set(1.0, tags={"k": "a"})
        g.set(2.0, tags={"k": "b"})
        g.set(9.0, tags={"k": "a"})  # admitted key: still dedicated
        g.set(5.0, tags={"k": "c"})  # new over-cap key: folds
        snap = g.series()
        assert snap[(("k", "a"),)] == 9.0
        assert snap[(("k", metrics.OVERFLOW_TAG_VALUE),)] == 5.0


# ------------------------------------------------------------- rules engine
class TestHealthEngine:
    def _ticking(self, store, name, values, step=0.5):
        for i, v in enumerate(values):
            store.ingest(name, "counter", _counter_snap(v), T0 + i * step)

    def test_for_duration_lifecycle_and_paired_resolved_event(self):
        events.clear()
        store = tsdb.TSDB()
        rule = Rule("t-rule", ("rate", "healthtest_sig_total", 30.0),
                    0.5, 1.0, "WARNING", "test rule")
        eng = HealthEngine(store, rules=[rule])

        def tick(i, value):
            ts = T0 + i * 0.5
            store.ingest("healthtest_sig_total", "counter",
                         _counter_snap(value), ts)
            eng.evaluate(now=ts)

        tick(0, 0.0)   # single sample: no rate yet
        tick(1, 5.0)   # breach starts (rate 10/s) but must HOLD 1.0s
        assert eng.alerts(state="firing") == []
        tick(2, 10.0)  # held 0.5s: still pending
        assert eng.alerts(state="firing") == []
        tick(3, 15.0)  # held 1.0s: fires
        [alert] = eng.alerts(state="firing")
        assert alert["rule"] == "t-rule" and alert["state"] == "firing"
        assert alert["value"] > 0.5
        assert len(alert["evidence"]) >= 3
        # flat counter far in the future: the window's samples agree ->
        # rate 0 -> resolves on the FIRST non-breaching tick
        store.ingest("healthtest_sig_total", "counter",
                     _counter_snap(15.0), T0 + 60.0)
        store.ingest("healthtest_sig_total", "counter",
                     _counter_snap(15.0), T0 + 60.5)
        eng.evaluate(now=T0 + 60.5)
        assert eng.alerts(state="firing") == []
        [resolved] = eng.alerts(state="resolved")
        assert resolved["resolved_ts"] == T0 + 60.5
        # firing + resolved are a PAIRED event stream
        evs = [e for e in events.list_events()
               if e.get("label") == HEALTH_ALERT
               and e.get("fields", {}).get("rule") == "t-rule"]
        assert [e["fields"]["state"] for e in evs] == \
            ["firing", "resolved"]
        assert len(evs[0]["fields"]["evidence"]) >= 3
        assert evs[1]["severity"] == "INFO"

    def test_one_tick_spike_never_fires(self):
        store = tsdb.TSDB()
        rule = Rule("spike", ("delta", "healthtest_spike_total", 30.0),
                    1.0, 1.0, "WARNING")
        eng = HealthEngine(store, rules=[rule])
        self._ticking(store, "healthtest_spike_total",
                      [0.0, 9.0, 9.0, 9.0])
        eng.evaluate(now=T0 + 0.5)   # breaching: the hold clock starts
        eng.evaluate(now=T0 + 1.2)   # still breaching, held < 1.0s
        assert eng.alerts() == []
        # the window slides past the step before for_duration elapses:
        # flat counter -> non-breach -> the hold clock resets unfired
        store.ingest("healthtest_spike_total", "counter",
                     _counter_snap(9.0), T0 + 60.0)
        eng.evaluate(now=T0 + 60.0)
        assert eng.alerts() == []

    def test_value_rule_and_cmp_below(self):
        store = tsdb.TSDB()
        rule = Rule("floor", ("value", "healthtest_level"), 10.0,
                    0.0, "ERROR", cmp="<")
        eng = HealthEngine(store, rules=[rule])
        store.ingest("healthtest_level", "gauge", _counter_snap(3.0), T0)
        eng.evaluate(now=T0)
        [alert] = eng.alerts(state="firing")
        assert alert["value"] == 3.0 and alert["severity"] == "ERROR"

    def test_default_pack_series_all_declared(self):
        # the alert-rule-registry rmtcheck rule enforces this statically;
        # this is the runtime half of the same contract
        for rule in default_rules():
            assert rule.series in mdefs.DEFS, rule.name
        assert len(default_rules()) == 8

    def test_alert_ranking_severity_then_recency(self):
        store = tsdb.TSDB()
        rules = [
            Rule("warn-rule", ("value", "healthtest_rank"), 1.0, 0.0,
                 "WARNING"),
            Rule("err-rule", ("value", "healthtest_rank"), 2.0, 0.0,
                 "ERROR"),
        ]
        eng = HealthEngine(store, rules=rules)
        store.ingest("healthtest_rank", "gauge", _counter_snap(5.0), T0)
        eng.evaluate(now=T0)
        rows = eng.alerts()
        assert [a["rule"] for a in rows] == ["err-rule", "warn-rule"]


# ---------------------------------------------------------- dashboard 400s
class TestDashboardRoutes:
    def _dash(self):
        from ray_memory_management_tpu_torch.dashboard import Dashboard

        return Dashboard.__new__(Dashboard)  # _route needs no server

    def test_api_series_rejects_bad_params(self):
        dash = self._dash()
        for query in ("", "since=noon&name=x", "window=abc&name=x",
                      "window=0&name=x", "rate=maybe&name=x",
                      "delta=2&name=x", "quantile=abc&name=x",
                      "quantile=1.5&name=x"):
            status, _, body = dash._route(f"/api/series?{query}")
            assert status == 400, query
            assert b"error" in body, query

    def test_api_alerts_rejects_bad_params(self):
        dash = self._dash()
        for query in ("state=zzz", "limit=abc", "limit=-1"):
            status, _, body = dash._route(f"/api/alerts?{query}")
            assert status == 400, query
            assert b"error" in body, query


# ------------------------------------------------------- acceptance scenario
def test_acceptance_two_default_rules_fire(capsys):
    """Acceptance: fault-injected task failures + a KV
    backpressure burst (work placed on a non-head virtual node) trip
    task-failure-rate AND kv-backpressure; both alerts carry evidence
    and the failure alert pivots into the tracing plane; doctor ranks
    them first; query_series aggregates are exact."""
    events.clear()
    os.environ["RMT_fault_injection_spec"] = "worker.exec:error:max=40"
    os.environ["RMT_fault_injection_seed"] = "7"
    rt = rmt.init(num_cpus=0)  # head holds no slots: tasks go remote
    try:
        rt.add_node({"num_cpus": 2})

        @rmt.remote(max_retries=0)
        def boom(i):
            return i

        # both signals climb ACROSS heartbeat ticks: a single burst
        # between two ticks would sample as one flat jump (the series
        # is born at its final value and the windowed delta reads 0)
        kv = mdefs.serve_kv_backpressure()
        failed = 0
        for wave in range(6):
            refs = [boom.remote(i) for i in range(5)]
            kv.inc(10.0)
            for r in refs:
                try:
                    rmt.get(r, timeout=120)
                except Exception:
                    failed += 1
            time.sleep(0.4)
        assert failed >= 15, f"fault plane only failed {failed} tasks"

        want = {"task-failure-rate", "kv-backpressure"}
        got = {}
        deadline = time.time() + 20
        while time.time() < deadline:
            got = {a["rule"]: a
                   for a in state.get_alerts(state="firing")
                   if a["rule"] in want}
            if set(got) == want:
                break
            time.sleep(0.25)
        assert set(got) == want, state.get_alerts()

        for alert in got.values():
            assert len(alert["evidence"]) >= 3, alert
            assert alert["value"] > alert["threshold"]
        # the failure alert's exemplar pivots into the tracing plane
        ex = got["task-failure-rate"]["exemplar"]
        assert ex and ex.get("trace_id") and ex.get("task_id"), got
        trace = state.get_trace(ex["trace_id"])
        assert len(trace["spans"]) >= 1

        # doctor: unhealthy exit, our two rules ranked at the top with
        # the ERROR-severity failure rule first
        from ray_memory_management_tpu_torch.scripts import cli

        rc = cli.main(["doctor", "--json"])
        payload = json.loads(capsys.readouterr().out)
        assert rc == 1 and payload["healthy"] is False
        firing = [a for a in payload["alerts"]
                  if a["state"] == "firing"]
        assert firing[0]["rule"] == "task-failure-rate"
        assert "kv-backpressure" in [a["rule"] for a in firing[:4]]
        # human-readable mode renders the same diagnosis
        rc = cli.main(["doctor"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "task-failure-rate" in out and "rule pack" in out

        # query_series exactness: delta == the sampled counter's
        # in-window increments, and rate * span == delta
        q = state.query_series("rmt_serve_kv_backpressure_total",
                               window=30.0, rate=True, delta=True)
        [series] = q["series"]
        pts = series["points"]
        in_win = [p for p in pts if p[0] >= pts[-1][0] - 30.0]
        assert q["delta"] == in_win[-1][1] - in_win[0][1]
        # at least the post-first-sample waves are counted increments
        assert q["delta"] >= 20.0
        assert q["rate"] * q["span_s"] == pytest.approx(q["delta"],
                                                        rel=1e-9)

        # the store's own accounting is queryable like any other series
        names = rt.tsdb.names()
        assert "rmt_tasks_failed_total" in names
        assert "rmt_serve_kv_backpressure_total" in names
    finally:
        rmt.shutdown()


def test_runtime_health_disabled_store_stays_empty():
    prev = tsdb.is_enabled()
    os.environ["RMT_HEALTH"] = "0"
    tsdb.set_enabled(False)
    rt = rmt.init(num_cpus=1)
    try:
        @rmt.remote
        def ok():
            return 1

        assert rmt.get(ok.remote(), timeout=60) == 1
        time.sleep(1.2)  # a couple of heartbeat ticks
        assert rt.tsdb.stats() == {"names": 0, "series": 0, "points": 0}
        assert state.query_series("rmt_tasks_finished_total") == {
            "name": "rmt_tasks_finished_total", "series": []}
        assert state.get_alerts() == []
    finally:
        rmt.shutdown()
        os.environ.pop("RMT_HEALTH", None)
        tsdb.set_enabled(prev)
