"""Structured events, xprof profiling bridge, pluggable spill storage
(reference coverage shape: dashboard event-module tests, tracing tests,
external-storage tests in test_object_spilling.py)."""

import json
import os

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.utils import events, profiling


@pytest.fixture
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()



@pytest.fixture(autouse=True)
def _clear_events():
    events.clear()
    yield
    events.set_sink(None)
    events.clear()


class TestEvents:
    def test_node_lifecycle_events(self):
        rt = rmt.init(num_cpus=2, num_nodes=2)
        try:
            added = state.list_cluster_events({"label": "NODE_ADDED"})
            assert len(added) >= 2
            victim = [n for n in rt.nodes if n != rt.head_node().node_id][0]
            rt.remove_node(victim)
            dead = state.list_cluster_events({"label": "NODE_DEAD"})
            assert any(e["node_id"] == victim.hex() for e in dead)
            assert all(e["severity"] == events.ERROR for e in dead)
        finally:
            rmt.shutdown()

    def test_task_retry_event(self, rmt_start_regular):
        @rmt.remote(max_retries=2, retry_exceptions=True)
        def flaky(path):
            if not os.path.exists(path):
                open(path, "w").close()
                raise ValueError("first attempt fails")
            return "ok"

        import tempfile

        marker = os.path.join(tempfile.mkdtemp(), "marker")
        assert rmt.get(flaky.remote(marker), timeout=60) == "ok"
        retries = state.list_cluster_events({"label": "TASK_RETRY"})
        assert retries and retries[-1]["source"] == "core_worker"

    def test_remote_agent_events_reach_head(self):
        """Events emitted inside a node-agent PROCESS (e.g. its store
        spilling) ride the ping/pong keepalive to the head's buffer."""
        import time

        import numpy as np

        from ray_memory_management_tpu_torch.core.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        rt = rmt.init(num_cpus=2, object_store_memory=32 << 20)
        try:
            remote_id = rt.add_remote_node_process(num_cpus=2)

            @rmt.remote(max_retries=0)
            def consume(arr):
                return float(arr[0])

            # put on the head, consume on the remote node: localization
            # pushes 48 MB of args into the agent's 32 MB store, forcing
            # agent-process spills (the push path allocates via the
            # agent's NodeObjectStore -> _create_with_spill)
            refs = [rmt.put(np.full(1 << 20, i, dtype=np.float64))
                    for i in range(6)]  # 8 MB each
            outs = [consume.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=remote_id, soft=False)).remote(r)
                for i, r in enumerate(refs)]
            assert rmt.get(outs, timeout=120) == [float(i)
                                                  for i in range(6)]
            deadline = time.time() + 15  # next keepalive flushes
            spilled = []
            while time.time() < deadline and not spilled:
                spilled = [
                    e for e in state.list_cluster_events(
                        {"label": "OBJECT_SPILLED"})
                    if e.get("node_id") == remote_id.hex()]
                time.sleep(0.2)
            assert spilled, "remote agent spill event never reached head"
        finally:
            rmt.shutdown()

    def test_sink_writes_jsonl(self, tmp_path):
        import json

        sink = str(tmp_path / "events.jsonl")
        events.set_sink(sink)
        events.emit("CUSTOM", "hello", source="test", answer=42)
        with open(sink) as f:
            rows = [json.loads(line) for line in f]
        assert rows[-1]["label"] == "CUSTOM"
        assert rows[-1]["fields"]["answer"] == 42

    def test_filters_and_limit(self):
        for i in range(5):
            events.emit("A", f"a{i}", source="test")
        events.emit("B", "b", severity=events.WARNING, source="test")
        assert len(events.list_events({"label": "A"})) == 5
        assert len(events.list_events({"label": "A"}, limit=2)) == 2
        assert events.list_events({"severity": events.WARNING})[-1][
            "label"] == "B"

    def test_state_api_accepts_both_filter_forms(self):
        """list_cluster_events must take the [(key, op, value)] tuples every
        sibling state API uses, as well as the events-module dict form."""
        events.emit("FORMS", "x", source="test")
        dict_rows = state.list_cluster_events({"label": "FORMS"})
        tuple_rows = state.list_cluster_events([("label", "=", "FORMS")])
        assert dict_rows and tuple_rows
        assert dict_rows[-1]["label"] == tuple_rows[-1]["label"] == "FORMS"


class TestProfiling:
    def test_annotate_records_timeline_span(self):
        from ray_memory_management_tpu_torch.utils import timeline

        timeline.clear()
        with profiling.annotate("my-region"):
            pass
        names = [e["name"] for e in timeline.dump_timeline()]
        assert "my-region" in names

    def test_trace_writes_capture(self, tmp_path):
        import torch

        logdir = str(tmp_path / "trace")
        with profiling.trace(logdir, device="cpu"):
            with profiling.annotate("doubling"):
                (torch.ones((8, 8)) * 2).sum()
        # torch.profiler's Chrome trace lands at logdir/trace.json
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        assert "doubling" in names and "aten::mul" in names

    def test_trace_on_the_card_never_falls_back_to_the_cpu(self, tmp_path):
        import torch

        if torch.cuda.is_available():
            pytest.skip("the card is here: the trace runs")
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            with profiling.trace(str(tmp_path / "trace")):
                pass
        assert not os.path.exists(tmp_path / "trace" / "trace.json")

    def test_device_memory_profile(self, tmp_path):
        import torch

        path = str(tmp_path / "mem.pickle")
        out = profiling.save_device_memory_profile(path)
        if not torch.cuda.is_available():
            assert out is None and not os.path.exists(path)
            return
        assert out == path and os.path.getsize(path) > 0


class TestPluggableSpillStorage:
    def test_registered_scheme_spills_and_restores(self, tmp_path):
        from ray_memory_management_tpu_torch.config import Config
        from ray_memory_management_tpu_torch.core import external_storage as ext
        from ray_memory_management_tpu_torch.core.object_store import (
            NodeObjectStore,
        )

        blobs = {}

        class MemStorage(ext.ExternalStorage):
            def __init__(self, uri):
                self.uri = uri

            def spill(self, object_id, data):
                blobs[object_id] = bytes(data)
                return f"mem://{object_id.hex()}"

            def restore(self, object_id, url):
                return blobs[object_id]

            def delete(self, url):
                blobs.pop(bytes.fromhex(url.split("//")[1]), None)

        ext.register_storage_scheme("mem", MemStorage)
        cfg = Config(object_store_memory=4 << 20,
                     object_store_fallback_directory="mem://spill",
                     min_spilling_size=1 << 20)
        store = NodeObjectStore("/rmt_test_memspill", cfg)
        try:
            # overfill: 6 x 1 MiB into a 4 MiB store forces spilling
            payloads = {}
            for i in range(6):
                oid = bytes([i]) * 16
                payloads[oid] = bytes([i]) * (1 << 20)
                store.put_bytes(oid, payloads[oid])
                store.release(oid)
            assert store.spilled_count() > 0 and blobs
            for oid, want in payloads.items():  # restores transparently
                view = store.get(oid)
                assert view is not None and bytes(view) == want
                store.release(oid)
        finally:
            store.close(unlink=True)

    def test_cloud_storage_url_mapping(self):
        from ray_memory_management_tpu_torch.core import external_storage as ext

        # construction requires an SDK; the registry mapping must still
        # route s3:// and gs:// to CloudStorage (clear error, not KeyError)
        for scheme in ("s3", "gs"):
            assert ext._SCHEMES[scheme] is ext.CloudStorage
        with pytest.raises(ValueError):
            ext.storage_for_uri("azure://bucket/prefix")
