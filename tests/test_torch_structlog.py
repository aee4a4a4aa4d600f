"""Cluster log plane (utils/structlog.py + state.get_logs + /api/logs +
``rmt logs``).

The acceptance scenario: a task on a non-head virtual node
calls ``print()`` and ``logging.error()``; both lines surface from
``state.get_logs(trace_id=...)`` as structured records carrying the
SAME trace_id/span_id/task_id the tracing plane assigned the task, are
served by the dashboard ``/api/logs`` route with server-side filters,
and render through the ``rmt logs`` CLI. Satellite 3 rides here too:
the final-flush ordering means a task's LAST line is queryable
immediately after ``get()`` returns — no polling window.
"""

import io
import json
import os
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.utils import structlog, timeline, tracing


@pytest.fixture(autouse=True)
def _clean_structlog():
    structlog.clear()
    yield
    structlog.clear()


def _affinity(node_id):
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )
    return NodeAffinitySchedulingStrategy(node_id=node_id, soft=False)


# ------------------------------------------------------------ record shape
class TestRecords:
    def test_record_stamps_identity_task_and_trace(self):
        prev = (structlog._node_id, structlog._role)
        structlog.configure(node_id="aabbccdd", role="tester")
        ttok = tracing.set_current(("tr-1", "sp-1", None))
        ltok = structlog.set_task_context("task-1", "actor-1")
        try:
            rec = structlog.make_record("warning", "hello", logger="t",
                                        stream="logging")
        finally:
            structlog.reset_task_context(ltok)
            tracing.reset(ttok)
            structlog.configure(node_id=prev[0], role=prev[1])
        assert rec["level"] == "WARNING"
        assert rec["msg"] == "hello"
        assert rec["node_id"] == "aabbccdd"
        assert rec["role"] == "tester"
        assert rec["pid"] == os.getpid()
        assert rec["task_id"] == "task-1"
        assert rec["actor_id"] == "actor-1"
        assert rec["trace_id"] == "tr-1"
        assert rec["span_id"] == "sp-1"
        assert rec["ts"] > 0

    def test_rmt_logs_gate_disables_capture(self):
        prev = structlog.is_enabled()
        structlog.set_enabled(False)
        try:
            structlog.emit("INFO", "dropped on the floor")
            assert structlog.drain_records() == []
        finally:
            structlog.set_enabled(prev)

    def test_package_logger_feeds_the_pipeline(self):
        log = structlog.get_logger(
            "ray_memory_management_tpu_torch.core.demo")
        assert log.name == "rmt.core.demo"
        log.warning("lazy %s", "template")
        recs = structlog.drain_records()
        assert any(r["msg"] == "lazy template" and
                   r["logger"] == "rmt.core.demo" and
                   r["level"] == "WARNING" for r in recs)

    def test_tee_stream_line_buffers_and_writes_through(self):
        inner = io.StringIO()
        tee = structlog._TeeStream(inner, structlog.INFO, "stdout")
        tee.write("par")
        assert structlog.drain_records() == []  # no newline yet
        tee.write("tial line\nnext")
        recs = structlog.drain_records()
        assert [r["msg"] for r in recs] == ["partial line"]
        assert recs[0]["stream"] == "stdout"
        tee.write("\n\n \n")  # completes "next"; blank lines skipped
        recs = structlog.drain_records()
        assert [r["msg"] for r in recs] == ["next"]
        # write-through: the raw stream (driver live tail) sees it ALL
        assert inner.getvalue() == "partial line\nnext\n\n \n"

    def test_buffer_bounded_drops_oldest_with_accounting(self):
        for i in range(structlog.MAX_BUFFER + 5):
            structlog.emit("INFO", f"m{i}")
        assert structlog.dropped_count() >= 5
        recs = structlog.drain_records()
        assert len(recs) == structlog.MAX_BUFFER
        assert recs[0]["msg"] == "m5"  # oldest dropped first
        assert recs[-1]["msg"] == f"m{structlog.MAX_BUFFER + 4}"

    def test_reingest_front_extends(self):
        structlog.emit("INFO", "first")
        batch = structlog.drain_records()
        structlog.emit("INFO", "second")
        structlog.reingest(batch)
        assert [r["msg"] for r in structlog.drain_records()] == \
            ["first", "second"]


# --------------------------------------------------------------- the store
def _rec(level, msg, ts=0.0, task=None, trace=None, node=None):
    return {"level": level, "msg": msg, "ts": ts, "task_id": task,
            "trace_id": trace, "node_id": node}


class TestLogStore:
    def test_query_filters_compose(self):
        store = structlog.LogStore()
        store.add(_rec("INFO", "a", ts=1.0, task="t1", trace="tr1",
                       node="n1"))
        store.add(_rec("ERROR", "b", ts=2.0, task="t1", trace="tr1",
                       node="n2"))
        store.add(_rec("INFO", "c", ts=3.0, task="t2", trace="tr1",
                       node="n1"))
        store.add(_rec("DEBUG", "d", ts=4.0, task="t2", trace="tr2",
                       node="n2"))
        # index queries
        assert [r["msg"] for r in store.query(task_id="t1")] == ["a", "b"]
        assert [r["msg"] for r in store.query(trace_id="tr1")] == \
            ["a", "b", "c"]
        assert [r["msg"] for r in store.query(node_id="n2")] == ["b", "d"]
        # level is a MINIMUM severity
        assert [r["msg"] for r in store.query(level="WARNING")] == ["b"]
        assert len(store.query(level="DEBUG")) == 4
        # since is an exclusive ts lower bound
        assert [r["msg"] for r in store.query(since=2.0)] == ["c", "d"]
        # ANDed combinations
        assert [r["msg"] for r in store.query(trace_id="tr1",
                                              node_id="n1")] == ["a", "c"]
        assert [r["msg"] for r in
                store.query(task_id="t1", level="ERROR")] == ["b"]
        assert store.query(task_id="t1", trace_id="tr2") == []
        # newest-limit, and the limit=0 gotcha (means none, not all)
        assert [r["msg"] for r in store.query(limit=2)] == ["c", "d"]
        assert store.query(limit=0) == []

    def test_per_level_retention_and_drop_accounting(self):
        store = structlog.LogStore(retention={"INFO": 4})
        for i in range(10):
            store.add(_rec("INFO", f"m{i}", ts=float(i), task="t1"))
        store.add(_rec("ERROR", "err", ts=99.0, task="t1"))
        assert store.dropped_count() == 6
        # the INFO flood did NOT evict the ERROR record (per-level rings)
        msgs = [r["msg"] for r in store.query(task_id="t1")]
        assert msgs == ["m6", "m7", "m8", "m9", "err"]
        assert [r["msg"] for r in store.query(level="ERROR")] == ["err"]

    def test_error_records_become_timeline_instants(self):
        if not timeline.is_enabled():
            pytest.skip("timeline disabled in this environment")
        timeline.clear()
        try:
            store = structlog.LogStore()
            store.add(_rec("INFO", "quiet", ts=time.time()))
            store.add({"level": "ERROR", "msg": "boom", "ts": time.time(),
                       "trace_id": "tr-x", "span_id": "sp-x",
                       "task_id": "t-x", "node_id": "aabbccdd"})
            instants = [e for e in timeline.chrome_trace_events()
                        if e.get("ph") == "i"]
            assert any(e["name"] == "log::ERROR" and
                       e.get("s") == "t" and "dur" not in e
                       for e in instants), instants
            # INFO did not spam a marker
            assert not any(e["name"] == "log::INFO" for e in instants)
        finally:
            timeline.clear()


# --------------------------------------------------- cluster acceptance
class TestClusterLogPlane:
    def test_remote_print_and_logging_are_trace_correlated(self):
        """The acceptance scenario, on a non-head virtual node."""
        rt = rmt.init(num_cpus=2)
        try:
            other = rt.add_node({"num_cpus": 2})

            @rmt.remote
            def chatty(i):
                import logging
                print("hello from task", i)
                logging.getLogger("user").error("boom %d", i)
                return i

            ref = chatty.options(
                scheduling_strategy=_affinity(other)).remote(7)
            assert rmt.get(ref, timeout=60) == 7

            row = next(r for r in state.list_tasks()
                       if "chatty" in r["name"])
            recs = state.get_logs(task_id=row["task_id"])
            by_msg = {r["msg"]: r for r in recs}
            assert "hello from task 7" in by_msg, recs
            assert "boom 7" in by_msg, recs
            for rec in (by_msg["hello from task 7"], by_msg["boom 7"]):
                assert rec["task_id"] == row["task_id"]
                assert rec["trace_id"] == row["trace_id"]
                assert rec["span_id"] == row["span_id"]
                assert rec["node_id"] == other.hex()
                assert rec["role"] == "worker"
            # stream attribution: tee'd stdout vs the logging bridge
            assert by_msg["hello from task 7"]["stream"] == "stdout"
            assert by_msg["boom 7"]["stream"] == "logging"
            assert by_msg["boom 7"]["level"] == "ERROR"
            # the same records resolve through the trace index
            trace_msgs = {r["msg"] for r in
                          state.get_logs(trace_id=row["trace_id"])}
            assert {"hello from task 7", "boom 7"} <= trace_msgs
        finally:
            rmt.shutdown()

    def test_last_line_queryable_immediately_after_get(self):
        """Satellite 3: the done reply carries the task's drained log
        buffer and the head ingests it BEFORE resolving the future, so
        there is no polling window after get()."""
        rt = rmt.init(num_cpus=2)
        try:
            del rt

            @rmt.remote
            def tail():
                print("the very last line")
                return 1

            assert rmt.get(tail.remote(), timeout=60) == 1
            row = next(r for r in state.list_tasks()
                       if "tail" in r["name"])
            recs = state.get_logs(task_id=row["task_id"])  # no sleep
            assert any(r["msg"] == "the very last line" for r in recs), \
                recs
        finally:
            rmt.shutdown()

    def test_cross_node_correlation_one_trace_two_nodes(self):
        """One trace's records from >=2 nodes via a single trace_id
        query: a driver-minted root context parents both submits."""
        rt = rmt.init(num_cpus=2)
        try:
            n2 = rt.add_node({"num_cpus": 2})
            n3 = rt.add_node({"num_cpus": 2})

            @rmt.remote
            def shout(tag):
                print("shout", tag)
                return tag

            tok = tracing.set_current(tracing.new_root())
            try:
                refs = [
                    shout.options(
                        scheduling_strategy=_affinity(node)).remote(i)
                    for i, node in enumerate((n2, n3))]
                assert rmt.get(refs, timeout=60) == [0, 1]
            finally:
                tracing.reset(tok)

            rows = [r for r in state.list_tasks() if "shout" in r["name"]]
            trace_ids = {r["trace_id"] for r in rows}
            assert len(trace_ids) == 1, rows  # siblings share the trace
            recs = state.get_logs(trace_id=trace_ids.pop())
            nodes = {r["node_id"] for r in recs
                     if r["msg"].startswith("shout")}
            assert nodes == {n2.hex(), n3.hex()}, recs
        finally:
            rmt.shutdown()


# ------------------------------------------------------------- the surfaces
class TestLogSurfaces:
    def test_api_logs_serves_filters_and_dropped(self):
        from ray_memory_management_tpu_torch.dashboard import Dashboard

        rt = rmt.init(num_cpus=2)
        try:
            del rt

            @rmt.remote
            def noisy():
                print("api line")
                return 0

            assert rmt.get(noisy.remote(), timeout=60) == 0
            dash = Dashboard.__new__(Dashboard)  # _route needs no server
            status, ctype, body = dash._route("/api/logs")
            assert status == 200 and ctype == "application/json"
            data = json.loads(body)
            assert isinstance(data["dropped"], int)
            assert any(r["msg"] == "api line" for r in data["logs"])
            # server-side level filter drops the INFO record
            status, _, body = dash._route("/api/logs?level=ERROR")
            assert status == 200
            assert not any(r["msg"] == "api line"
                           for r in json.loads(body)["logs"])
            # limit is applied store-side (newest-limit)
            status, _, body = dash._route("/api/logs?limit=1")
            assert status == 200
            assert len(json.loads(body)["logs"]) <= 1
        finally:
            rmt.shutdown()

    def test_api_logs_rejects_bad_params(self):
        from ray_memory_management_tpu_torch.dashboard import Dashboard

        dash = Dashboard.__new__(Dashboard)
        for query in ("limit=abc", "limit=-5", "since=noon",
                      "level=LOUD"):
            status, _, body = dash._route(f"/api/logs?{query}")
            assert status == 400, query
            assert b"error" in body, query

    def test_cli_logs_prints_records(self, capsys):
        from ray_memory_management_tpu_torch.scripts import cli

        rt = rmt.init(num_cpus=2)
        try:
            del rt

            @rmt.remote
            def talk():
                print("cli hello")
                return 0

            assert rmt.get(talk.remote(), timeout=60) == 0
            row = next(r for r in state.list_tasks()
                       if "talk" in r["name"])
            assert cli.main(["logs", "--task", row["task_id"]]) == 0
            out = capsys.readouterr().out
            assert "cli hello" in out
            assert f"task={row['task_id'][:8]}" in out
            # live tail: a bounded --follow drains and exits cleanly
            assert cli.main(["logs", "--follow", "--duration", "0.2",
                             "--poll-interval", "0.05"]) == 0
            assert "cli hello" in capsys.readouterr().out
        finally:
            rmt.shutdown()

    def test_cli_logs_without_runtime_errors(self, capsys):
        from ray_memory_management_tpu_torch.scripts import cli

        assert cli.main(["logs"]) == 1
        assert "no cluster" in capsys.readouterr().err
