"""End-to-end distributed tracing: causal span propagation across
processes, flow-linked Perfetto export, critical-path attribution.

The acceptance shape: a multi-node run produces ONE trace
where a cross-node task's submit/schedule/prefetch-transfer/dispatch/
exec spans share one trace_id connected by flow events; nested submits
chain parent_span_id; the ring drop counter and the /api/timeline
filters behave.
"""

import json
import time
from collections import deque

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.utils import timeline, tracing
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()



@pytest.fixture(autouse=True)
def _clear_timeline():
    timeline.clear()
    yield
    timeline.clear()


def _poll(pred, timeout=20.0):
    """Poll until pred() is truthy (worker spans ride the 1 s profile
    flush ticker, so head-side visibility lags task completion)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = pred()
        if out:
            return out
        time.sleep(0.2)
    return pred()


class TestContext:
    def test_mint_and_chain(self):
        root = tracing.new_root()
        assert root[2] is None and len(root[0]) == 32 and len(root[1]) == 16
        child = tracing.child_of(root)
        assert child[0] == root[0] and child[2] == root[1]
        assert child[1] != root[1]
        # no parent -> fresh root
        fresh = tracing.child_of(None)
        assert fresh[2] is None and fresh[0] != root[0]

    def test_wire_roundtrip_rejects_garbage(self):
        ctx = tracing.new_root()
        assert tracing.from_wire(list(ctx)) == ctx
        assert tracing.from_wire(None) is None
        assert tracing.from_wire("nope") is None
        assert tracing.from_wire(("a", 7, None)) is None
        assert tracing.from_wire(("a",)) is None

    def test_contextvar_set_reset(self):
        assert tracing.get_current() is None
        ctx = tracing.new_root()
        tok = tracing.set_current(ctx)
        assert tracing.get_current() == ctx
        tracing.reset(tok)
        assert tracing.get_current() is None


class TestCrossProcessFlow:
    def test_cross_node_task_links_submit_transfer_exec(self):
        """A consumer pinned off the producer's node: its head-side
        lifecycle spans, the argument transfer, and the worker-side exec
        span must all carry the submitting trace_id, and the export must
        connect them with paired flow events."""
        import numpy as np

        from ray_memory_management_tpu_torch.core.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        def pin(node_id):
            return NodeAffinitySchedulingStrategy(node_id=node_id,
                                                  soft=False)

        rt = rmt.init(num_cpus=2)
        try:
            head = rt.head_node().node_id
            other = rt.add_node({"num_cpus": 2})

            @rmt.remote
            def produce():
                return np.ones(1 << 20, dtype=np.uint8)

            @rmt.remote
            def consume(x):
                return int(x[0]) + x.nbytes

            ref = produce.options(scheduling_strategy=pin(head)).remote()
            rmt.get(ref, timeout=60)
            out = consume.options(scheduling_strategy=pin(other)).remote(ref)
            assert rmt.get(out, timeout=60) == 1 + (1 << 20)

            rows = [r for r in state.list_tasks() if r["name"] == "consume"]
            assert rows and rows[0]["trace_id"] and rows[0]["span_id"]
            tid = rows[0]["trace_id"]
            span = rows[0]["span_id"]

            # head-side lifecycle spans landed under the trace
            evs = timeline.chrome_trace_events(trace_id=tid, flows=False)
            names = {e["name"] for e in evs}
            assert f"submit::consume" in names
            # the argument transfer is a CHILD span of the task's span,
            # same trace
            transfers = [e for e in evs if e["cat"] == "transfer"]
            assert transfers, f"no transfer span in trace: {names}"
            assert any(e["args"].get("parent_span_id") == span
                       for e in transfers)

            # worker-side exec span arrives over the profile channel
            def worker_exec():
                return [e for e in timeline.chrome_trace_events(
                    trace_id=tid, flows=False)
                    if e["cat"] == "task" and "consume" in e["name"]]
            execs = _poll(worker_exec)
            assert execs, "worker exec span never reached the head"
            # exec slice shares the TASK's span_id -> one flow group
            # crossing the process boundary
            assert any(e["args"].get("span_id") == span for e in execs)

            # flow events: each id pairs exactly one "s" with one "f",
            # ordered; the task's own flow crosses processes
            full = timeline.chrome_trace_events(trace_id=tid)
            flows = [e for e in full if e.get("ph") in ("s", "t", "f")]
            assert flows, "no flow events synthesized"
            by_id = {}
            for f in flows:
                by_id.setdefault(f["id"], []).append(f)
            for fid, steps in by_id.items():
                steps.sort(key=lambda e: e["ts"])
                phs = [s["ph"] for s in steps]
                assert phs[0] == "s" and phs[-1] == "f", (fid, phs)
                assert phs.count("s") == 1 and phs.count("f") == 1
            task_flow = by_id.get(span)
            assert task_flow, "task span has no flow"
            assert len({str(s["pid"]) for s in task_flow}) >= 2, \
                "task flow does not cross processes"

            # trace filter is exact: nothing from other traces leaks in
            for e in timeline.chrome_trace_events(trace_id=tid,
                                                  flows=False):
                assert e["args"]["trace_id"] == tid

            # span tree + critical path (state API and dashboard route)
            tree = state.get_trace(tid)
            assert tree["num_spans"] >= 1 and tree["roots"]
            span_ids = {s["span_id"] for s in tree["spans"]}
            assert span in span_ids
            cp = state.summarize_critical_path(tid)
            assert cp["wall_time_s"] > 0
            total = sum(cp["stages"].values()) + cp["overhead_s"]
            assert total == pytest.approx(cp["wall_time_s"], rel=1e-6)
            assert cp["stages"].get("exec", 0.0) > 0

            from ray_memory_management_tpu_torch.dashboard import Dashboard

            dash = Dashboard.__new__(Dashboard)  # _route needs no server
            status, _, body = dash._route(f"/api/trace?trace_id={tid}")
            assert status == 200
            payload = json.loads(body)
            assert payload["trace"]["trace_id"] == tid
            assert payload["critical_path"]["wall_time_s"] > 0
            status, _, _ = dash._route("/api/trace")
            assert status == 400
            status, _, body = dash._route(
                f"/api/timeline?trace_id={tid}&cat=lifecycle&limit=3")
            assert status == 200
            tl = json.loads(body)
            slices = [e for e in tl["traceEvents"] if e["ph"] == "X"]
            assert 0 < len(slices) <= 3
            assert all(e["cat"] == "lifecycle" for e in slices)

            # CLI: lists trace ids; dumps one trace
            from ray_memory_management_tpu_torch.scripts import cli

            assert cli.main(["trace"]) == 0
            assert cli.main(["trace", tid]) == 0
        finally:
            rmt.shutdown()

    def test_nested_submit_chains_parent_span(self, rmt_start_regular):
        """A task submitted INSIDE a worker inherits the enclosing
        task's context: same trace_id, parent_span_id = outer span."""

        @rmt.remote
        def inner(x):
            return x + 1

        @rmt.remote
        def outer(x):
            return rmt.get(inner.remote(x)) + 1

        assert rmt.get(outer.remote(1), timeout=60) == 3

        def rows():
            r = {row["name"]: row for row in state.list_tasks()
                 if row["name"] in ("inner", "outer")}
            return r if len(r) == 2 else None
        got = _poll(rows)
        assert got, "inner/outer task rows not observable"
        assert got["inner"]["trace_id"] == got["outer"]["trace_id"]
        assert got["inner"]["parent_span_id"] == got["outer"]["span_id"]
        assert got["outer"]["parent_span_id"] is None

        # the tree reflects the chain
        tree = state.get_trace(got["outer"]["trace_id"])
        by_span = {s["span_id"]: s for s in tree["spans"]}
        outer_span = by_span[got["outer"]["span_id"]]
        assert got["inner"]["span_id"] in outer_span["children"]


class TestTimelineRing:
    def test_drop_accounting(self, monkeypatch):
        monkeypatch.setattr(timeline, "MAX_EVENTS", 4)
        monkeypatch.setattr(timeline, "_events", deque(maxlen=4))
        for i in range(6):
            timeline.record_event(f"e{i}", "t", 0.0, 1.0)
        assert timeline.dropped_count() == 2
        batch = [{"name": "x", "cat": "t", "start": 0.0, "end": 1.0,
                  "pid": 1, "tid": 1}] * 3
        timeline.ingest_events(batch)
        assert timeline.dropped_count() == 5
        # survivors are the NEWEST events
        names = [e["name"] for e in timeline._events]
        assert len(names) == 4 and names[-1] == "x"

    def test_drop_counter_metric(self, monkeypatch):
        from ray_memory_management_tpu_torch.core import metrics_defs as mdefs

        base = sum(mdefs.timeline_events_dropped().series().values())
        monkeypatch.setattr(timeline, "MAX_EVENTS", 2)
        monkeypatch.setattr(timeline, "_events", deque(maxlen=2))
        for i in range(5):
            timeline.record_event(f"e{i}", "t", 0.0, 1.0)
        now = sum(mdefs.timeline_events_dropped().series().values())
        assert now - base == 3

    def test_filters_and_limit(self):
        a = tracing.new_root()
        b = tracing.new_root()
        timeline.record_event("ev_a", "catx", 1.0, 2.0, trace=a,
                              extra={"task_id": "t1"})
        timeline.record_event("ev_b", "caty", 2.0, 3.0, trace=b,
                              extra={"task_id": "t2"})
        timeline.record_event("ev_c", "catx", 3.0, 4.0,
                              extra={"task_id": "t1"})
        by_trace = timeline.chrome_trace_events(trace_id=a[0], flows=False)
        assert [e["name"] for e in by_trace] == ["ev_a"]
        by_task = timeline.chrome_trace_events(task_id="t1", flows=False)
        assert {e["name"] for e in by_task} == {"ev_a", "ev_c"}
        by_cat = timeline.chrome_trace_events(cat="catx", flows=False)
        assert {e["name"] for e in by_cat} == {"ev_a", "ev_c"}
        both = timeline.chrome_trace_events(cat="catx", task_id="t1",
                                            trace_id=a[0], flows=False)
        assert [e["name"] for e in both] == ["ev_a"]
        # limit keeps the NEWEST n
        newest = timeline.chrome_trace_events(limit=2, flows=False)
        assert [e["name"] for e in newest] == ["ev_b", "ev_c"]
        assert timeline.chrome_trace_events(limit=0, flows=False) == []

    def test_flow_synthesis_pairs_and_parents(self):
        root = tracing.new_root()
        child = tracing.child_of(root)
        # two slices of the root span in different "processes"
        timeline.record_event("stage1", "t", 1.0, 2.0, pid="p1",
                              trace=root)
        timeline.record_event("stage2", "t", 2.0, 3.0, pid="p2",
                              trace=root)
        # single-slice child span: parent anchor makes it a 2-step flow
        timeline.record_event("sub", "t", 2.5, 2.8, pid="p3", trace=child)
        evs = timeline.chrome_trace_events()
        flows = [e for e in evs if e.get("ph") in ("s", "t", "f")]
        root_flow = sorted([f for f in flows if f["id"] == root[1]],
                           key=lambda e: e["ts"])
        child_flow = sorted([f for f in flows if f["id"] == child[1]],
                            key=lambda e: e["ts"])
        assert [f["ph"] for f in root_flow] == ["s", "f"]
        assert [f["ph"] for f in child_flow] == ["s", "f"]
        # child flow STARTS on the parent's latest slice at-or-before it
        assert child_flow[0]["pid"] == "p2"
        assert child_flow[1]["pid"] == "p3"

    def test_record_disabled_is_noop(self):
        timeline.set_enabled(False)
        try:
            timeline.record_event("nope", "t", 0.0, 1.0)
            assert timeline.chrome_trace_events() == []
        finally:
            timeline.set_enabled(True)


class TestCriticalPath:
    def test_priority_attribution_sums_to_wall(self, rmt_start_regular):
        @rmt.remote
        def work(ms):
            time.sleep(ms / 1000.0)
            return ms

        assert rmt.get([work.remote(20) for _ in range(4)],
                       timeout=60) == [20] * 4
        rows = [r for r in state.list_tasks() if r["name"] == "work"]
        tid = rows[0]["trace_id"]
        cp = state.summarize_critical_path(tid)
        assert cp["tasks"] >= 1
        total = sum(cp["stages"].values()) + cp["overhead_s"]
        assert total == pytest.approx(cp["wall_time_s"], rel=1e-6)
        # exec dominates a sleep workload; attribution must be >= 95%
        assert cp["coverage"] >= 0.0
        assert cp["stages"].get("exec", 0.0) >= 0.015

    def test_unknown_trace_is_empty(self, rmt_start_regular):
        cp = state.summarize_critical_path("deadbeef" * 4)
        assert cp["tasks"] == 0 and cp["wall_time_s"] == 0.0
        tree = state.get_trace("deadbeef" * 4)
        assert tree["num_spans"] == 0 and tree["spans"] == []
