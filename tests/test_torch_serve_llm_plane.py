"""The LLM deployment and the serve data plane of the PyTorch port.

The port's copies of ``tests/test_serve.py``'s ``TestLLMServing`` (on
the CPU through ``device="cpu"``) and of the ``TestContinuousBatching``
cases ``tests/test_torch_serve.py`` does not already hold (solo decode
against ``gpt.generate``, step-granular leave, an oversubscribed burst
with per-request budgets, the continuous default), and of
``tests/test_serve_paged.py``'s control-plane cases: the backpressure
knob, the typed and counted ``BackpressureTimeout``, HTTP 429 with a
trace id, and a ``replica.exec`` fault that leaves the replica serving.
The paged-KV engine cases of ``test_serve_paged.py`` are in
``test_torch_serve.py``.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import serve
from ray_memory_management_tpu_torch.config import Config, global_config
from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
from ray_memory_management_tpu_torch.utils import faults
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


@pytest.fixture
def serve_instance(rmt_start_regular):
    serve.start(http_port=None)
    yield
    serve.shutdown()


@pytest.fixture(autouse=True)
def _clean_fault_plane():
    yield
    os.environ.pop("RMT_fault_injection_spec", None)
    os.environ.pop("RMT_fault_injection_seed", None)
    faults.reset()


class TestLLMServing:
    def test_dynamic_batcher_coalesces(self):
        from ray_memory_management_tpu_torch.serve.llm import DynamicBatcher

        sizes = []

        def fn(items):
            sizes.append(len(items))
            return [i * 10 for i in items]

        b = DynamicBatcher(fn, max_batch_size=4, batch_wait_timeout_s=0.1)
        try:
            results = {}

            def call(i):
                results[i] = b.submit(i)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert results == {i: i * 10 for i in range(4)}
            # 4 concurrent callers within one window -> ONE model call
            assert max(sizes) >= 2, sizes
        finally:
            b.close()

    def test_batcher_error_propagates(self):
        from ray_memory_management_tpu_torch.serve.llm import DynamicBatcher

        def boom(items):
            raise RuntimeError("model fell over")

        b = DynamicBatcher(boom, max_batch_size=2,
                           batch_wait_timeout_s=0.01)
        try:
            with pytest.raises(RuntimeError, match="fell over"):
                b.submit(1)
        finally:
            b.close()

    def test_llm_deployment_end_to_end(self, serve_instance):
        """Handle request -> batched KV-cached generate -> tokens back
        (tiny preset on the CPU; the card's path is the same program)."""
        from ray_memory_management_tpu_torch.serve.llm import llm_deployment

        serve.run(llm_deployment("test", max_new_tokens=4,
                                 max_batch_size=2,
                                 batch_wait_timeout_s=0.005,
                                 pad_multiple=16, device="cpu"))
        handle = serve.get_handle("LLM")

        out = rmt.get(handle.remote({"tokens": [5, 6, 7]}), timeout=300)
        assert len(out["tokens"]) == 4
        assert all(isinstance(t, int) for t in out["tokens"])
        assert out["prompt_len"] == 3

        # determinism at temperature 0: same prompt -> same continuation
        out2 = rmt.get(handle.remote({"tokens": [5, 6, 7]}), timeout=120)
        assert out2["tokens"] == out["tokens"]

        # text path (fallback tokenizer)
        out3 = rmt.get(handle.remote({"text": "hello"}), timeout=120)
        assert len(out3["tokens"]) == 4

        # batching really coalesced concurrent requests
        stats = rmt.get(handle.stats.remote(), timeout=60)
        assert stats["requests"] >= 3 and stats["batches"] >= 1

    def test_llm_http_ingress(self, rmt_start_regular):
        from ray_memory_management_tpu_torch.serve.api import _ctrl
        from ray_memory_management_tpu_torch.serve.http_proxy import (
            start_proxy)
        from ray_memory_management_tpu_torch.serve.llm import llm_deployment

        serve.start(http_port=0)
        try:
            port = start_proxy(_ctrl(), 0)
            h = serve.run(llm_deployment("test", max_new_tokens=3,
                                         max_batch_size=2,
                                         batch_wait_timeout_s=0.005,
                                         pad_multiple=16, device="cpu"))
            rmt.get(h.remote({"tokens": [1]}), timeout=300)  # warm up
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/LLM",
                data=json.dumps({"tokens": [9, 8]}).encode(),
                headers={"Content-Type": "application/json"})
            body = json.loads(urllib.request.urlopen(req, timeout=120).read())
            assert len(body["tokens"]) == 3
        finally:
            serve.shutdown()


class TestContinuousBatching:
    """Decode-step-granular scheduling (serve/llm.ContinuousBatcher):
    join/leave at step granularity and EXACT mixed-length batches via
    per-row positions (models/gpt.forward_with_cache_rows)."""

    @pytest.fixture(scope="class")
    def engine_setup(self):
        from ray_memory_management_tpu_torch.models import gpt

        cfg = gpt.TransformerConfig(vocab_size=128, n_layers=2, n_heads=2,
                                    d_model=32, max_seq=128)
        params = gpt.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")
        yield gpt, cfg, params

    @staticmethod
    def _solo(gpt, cfg, params, prompt, steps):
        with torch.inference_mode():
            out = gpt.generate(params, cfg, torch.tensor([prompt]), steps)
        return out[0, len(prompt):].tolist()

    def test_single_request_matches_generate(self, engine_setup):
        from ray_memory_management_tpu_torch.serve.llm import (
            ContinuousBatcher)

        gpt, cfg, params = engine_setup
        eng = ContinuousBatcher(params, cfg, max_slots=4, max_new_tokens=8,
                                pad_multiple=8)
        try:
            prompt = [5, 9, 17, 3]
            out = eng.submit(prompt)
            assert out == self._solo(gpt, cfg, params, prompt, 8)
        finally:
            eng.close()

    def test_short_request_completes_while_long_mid_decode(
            self, engine_setup):
        """Step-granular leave: a 1-token request submitted AFTER a
        96-token request, once its decode has begun, must finish first
        (the barrier design would park it behind the whole batch)."""
        from ray_memory_management_tpu_torch.serve.llm import (
            ContinuousBatcher)

        gpt, cfg, params = engine_setup
        eng = ContinuousBatcher(params, cfg, max_slots=4,
                                max_new_tokens=96, pad_multiple=8)
        try:
            order = []

            def go(name, p, budget):
                eng.submit(p, max_new_tokens=budget)
                order.append(name)

            long_t = threading.Thread(
                target=go, args=("long", list(range(2, 14)), 96))
            long_t.start()
            # wait until long is mid-decode: eager decoding of this tiny
            # model can run all 96 steps within a fixed sleep
            deadline = time.monotonic() + 60
            while eng.steps == 0 and time.monotonic() < deadline:
                time.sleep(0.001)
            assert eng.steps > 0
            short_t = threading.Thread(
                target=go, args=("short", [5, 9, 17, 3], 1))
            short_t.start()
            long_t.join(120)
            short_t.join(120)
            assert not (long_t.is_alive() or short_t.is_alive())
            assert order and order[0] == "short", order
        finally:
            eng.close()

    def test_burst_oversubscribed_slots_all_exact(self, engine_setup):
        """A 24-request burst over 8 slots — admission queueing while
        every slot is occupied, serial prefills racing decode quanta,
        join/retire churn — must still produce EXACTLY each request's
        solo greedy decode, and every request must complete."""
        from ray_memory_management_tpu_torch.serve.llm import (
            ContinuousBatcher)

        gpt, cfg, params = engine_setup
        eng = ContinuousBatcher(params, cfg, max_slots=8,
                                max_new_tokens=12, pad_multiple=8)
        try:
            rng = np.random.default_rng(0)
            prompts = [
                [int(t) for t in rng.integers(2, 100,
                                              size=int(rng.integers(2, 20)))]
                for _ in range(24)
            ]
            budgets = [int(rng.integers(1, 12)) for _ in range(24)]
            res = [None] * 24

            def go(i):
                res[i] = eng.submit(prompts[i], max_new_tokens=budgets[i])

            ts = [threading.Thread(target=go, args=(i,))
                  for i in range(24)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            assert all(r is not None for r in res)  # nothing stranded
            for i, (p, b) in enumerate(zip(prompts, budgets)):
                assert res[i] == self._solo(gpt, cfg, params, p, b), i
        finally:
            eng.close()

    def test_llm_server_continuous_mode_default(self):
        from ray_memory_management_tpu_torch.serve.llm import LLMServer

        srv = LLMServer(preset="test", max_new_tokens=4, max_batch_size=2,
                        pad_multiple=16, device="cpu")
        try:
            assert srv.batching == "continuous"
            out = srv({"tokens": [5, 6, 7]})
            assert len(out["tokens"]) == 4
            # per-request budget honored
            out1 = srv({"tokens": [5, 6, 7], "max_new_tokens": 1})
            assert len(out1["tokens"]) == 1
        finally:
            srv.close()


# --- config knob + typed shed errors -----------------------------------------

def test_backpressure_timeout_knob_registered():
    assert Config().serve_backpressure_timeout_s == 60.0
    assert Config(serve_backpressure_timeout_s=3.0) \
        .serve_backpressure_timeout_s == 3.0
    os.environ["RMT_serve_backpressure_timeout_s"] = "7.5"
    try:
        assert Config().serve_backpressure_timeout_s == 7.5
    finally:
        os.environ.pop("RMT_serve_backpressure_timeout_s")


def test_backpressure_timeout_typed_and_counted(rmt_start_regular,
                                                monkeypatch):
    """Routing past a saturated deployment raises the TYPED
    BackpressureTimeout (not a bare RuntimeError) after
    serve_backpressure_timeout_s, and counts the shed by reason."""
    from ray_memory_management_tpu_torch.serve.handle import (
        BackpressureTimeout)

    serve.start(http_port=None)
    try:
        @serve.deployment(max_concurrent_queries=1)
        def snooze(x=None):
            time.sleep(2.5)
            return "ok"

        h = serve.run(snooze)
        monkeypatch.setattr(global_config(),
                            "serve_backpressure_timeout_s", 0.5)
        slow = threading.Thread(
            target=lambda: rmt.get(h.remote(1), timeout=60), daemon=True)
        slow.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:  # wait until it holds the slot
            if h._router.queue_depth() >= 1:
                break
            time.sleep(0.02)
        before = mdefs.serve_shed().get(tags={"reason":
                                              "backpressure_timeout"})
        with pytest.raises(BackpressureTimeout,
                           match="backpressure timeout routing to"):
            h.remote(2)
        assert mdefs.serve_shed().get(
            tags={"reason": "backpressure_timeout"}) == before + 1
        slow.join(60)
    finally:
        serve.shutdown()


def test_http_sheds_429_with_trace_id(rmt_start_regular):
    """HTTP ingress under saturation: the overflow request gets 429 (a
    'retry later', not a 500), and EVERY response — shed or served —
    carries the root x-rmt-trace-id header that stitches the
    proxy→router→replica spans together."""
    from ray_memory_management_tpu_torch import config as cfgmod
    from ray_memory_management_tpu_torch.serve.api import _ctrl
    from ray_memory_management_tpu_torch.serve.http_proxy import start_proxy

    os.environ["RMT_serve_backpressure_timeout_s"] = "1.0"
    cfgmod.set_global_config(Config())
    serve.start(http_port=0)
    try:
        @serve.deployment(max_concurrent_queries=1)
        def plod(x=None):
            time.sleep(3.0)
            return {"ok": True}

        serve.run(plod)
        port = start_proxy(_ctrl(), 0)
        results = {}

        def first():
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/plod",
                data=json.dumps(1).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                results["status"] = resp.status
                results["trace"] = resp.headers.get("x-rmt-trace-id")

        t = threading.Thread(target=first, daemon=True)
        t.start()
        time.sleep(0.8)  # first request is mid-service, slot held
        req2 = urllib.request.Request(
            f"http://127.0.0.1:{port}/plod",
            data=json.dumps(2).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req2, timeout=60)
        assert exc.value.code == 429
        shed_trace = exc.value.headers.get("x-rmt-trace-id")
        assert shed_trace and int(shed_trace, 16) >= 0  # hex trace id
        t.join(60)
        assert results.get("status") == 200
        served_trace = results.get("trace")
        assert served_trace and int(served_trace, 16) >= 0
        assert served_trace != shed_trace  # one root trace per request
    finally:
        serve.shutdown()
        os.environ.pop("RMT_serve_backpressure_timeout_s", None)
        cfgmod.set_global_config(Config())


# --- serve fault matrix ------------------------------------------------------

def test_replica_exec_fault_surfaces_and_replica_survives():
    """An injected replica.exec error surfaces to the caller as a task
    error (propagated via the env spec — the child-process path); the
    replica is NOT torn down and the next request succeeds."""
    os.environ["RMT_fault_injection_spec"] = "replica.exec:error:max=1"
    os.environ["RMT_fault_injection_seed"] = "17"
    faults.reset()  # in-process plane re-discovers the env spec too
    rmt.init(num_cpus=4, ignore_reinit_error=True)
    try:
        serve.start(http_port=None)
        try:
            @serve.deployment
            def echo(x):
                return {"x": x}

            h = serve.run(echo)
            with pytest.raises(Exception, match="injected"):
                rmt.get(h.remote(1), timeout=60)
            assert rmt.get(h.remote(2), timeout=60) == {"x": 2}
        finally:
            serve.shutdown()
    finally:
        rmt.shutdown()
