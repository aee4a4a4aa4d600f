"""Serve control plane of the PyTorch port: deploy, handles, replicas,
reconfigure, scaling, composition, autoscaling, HTTP ingress.

The port's copy of ``tests/test_serve.py``'s control-plane classes; the
LLM cases are in ``test_torch_serve_llm_plane.py``. The fixtures are the
file's own: the shared conftest starts the JAX package's runtime.
"""

import json
import time
import urllib.request

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import serve
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


@serve.deployment
class Doubler:
    def __call__(self, x):
        return 2 * x

    def plus(self, x, y):
        return x + y


@serve.deployment
def shout(text):
    return str(text).upper()


class TestBasics:
    def test_class_deployment(self, serve_instance):
        h = serve.run(Doubler.bind())
        assert rmt.get(h.remote(21)) == 42
        assert "Doubler" in serve.list_deployments()

    def test_method_handle(self, serve_instance):
        h = serve.run(Doubler.bind())
        assert rmt.get(h.plus.remote(3, 4)) == 7

    def test_function_deployment(self, serve_instance):
        h = serve.run(shout.bind())
        assert rmt.get(h.remote("quiet")) == "QUIET"

    def test_get_handle_by_name(self, serve_instance):
        serve.run(Doubler.bind())
        h = serve.get_handle("Doubler")
        assert rmt.get(h.remote(5)) == 10

    def test_delete(self, serve_instance):
        serve.run(Doubler.bind())
        serve.delete("Doubler")
        assert "Doubler" not in serve.list_deployments()


class TestReplicas:
    def test_multiple_replicas_all_serve(self, serve_instance):
        @serve.deployment(num_replicas=3)
        class WhoAmI:
            def __init__(self):
                import os

                self.pid = os.getpid()

            def __call__(self):
                return self.pid

        h = serve.run(WhoAmI.bind())
        pids = {rmt.get(h.remote()) for _ in range(30)}
        assert len(pids) >= 2  # load spreads across replica processes

    def test_scale_up_down(self, serve_instance):
        @serve.deployment(num_replicas=1)
        class S:
            def __call__(self):
                return "ok"

        serve.run(S.bind())
        assert serve.status("S")["num_replicas"] == 1
        serve.run(S.options(num_replicas=3).bind())
        deadline = time.time() + 30
        while time.time() < deadline:
            if serve.status("S")["num_replicas"] == 3:
                break
            time.sleep(0.2)
        assert serve.status("S")["num_replicas"] == 3
        serve.run(S.options(num_replicas=1).bind())
        deadline = time.time() + 30
        while time.time() < deadline:
            if serve.status("S")["num_replicas"] == 1:
                break
            time.sleep(0.2)
        assert serve.status("S")["num_replicas"] == 1

    def test_reconfigure_user_config(self, serve_instance):
        @serve.deployment(user_config={"threshold": 1})
        class Configurable:
            def __init__(self):
                self.threshold = None

            def reconfigure(self, cfg):
                self.threshold = cfg["threshold"]

            def __call__(self):
                return self.threshold

        h = serve.run(Configurable.bind())
        assert rmt.get(h.remote()) == 1
        serve.run(Configurable.options(
            user_config={"threshold": 9}).bind())
        deadline = time.time() + 20
        while time.time() < deadline:
            if rmt.get(h.remote()) == 9:
                break
            time.sleep(0.2)
        assert rmt.get(h.remote()) == 9


class TestComposition:
    def test_bound_dependency_becomes_handle(self, serve_instance):
        @serve.deployment
        class Preprocess:
            def __call__(self, x):
                return x + 1

        @serve.deployment
        class Pipeline:
            def __init__(self, pre):
                self.pre = pre

            def __call__(self, x):
                y = rmt.get(self.pre.remote(x))
                return y * 10

        h = serve.run(Pipeline.bind(Preprocess.bind()))
        assert rmt.get(h.remote(4)) == 50


class TestScaling:
    def test_autoscale_up(self, serve_instance):
        @serve.deployment(
            autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                "target_num_ongoing_requests_per_replica": 1},
            max_concurrent_queries=10)
        class Slow:
            def __call__(self):
                time.sleep(0.4)
                return 1

        h = serve.run(Slow.bind())
        refs = [h.remote() for _ in range(24)]
        deadline = time.time() + 30
        peak = 1
        while time.time() < deadline:
            peak = max(peak, serve.status("Slow")["num_replicas"])
            if peak >= 2:
                break
            time.sleep(0.1)
        assert sum(rmt.get(refs)) == 24
        assert peak >= 2


class TestHTTP:
    def test_http_ingress(self, rmt_start_regular):
        port = 0
        serve.start(http_port=0)
        try:
            from ray_memory_management_tpu_torch.serve.api import _ctrl
            from ray_memory_management_tpu_torch.serve.http_proxy import (
                start_proxy)

            port = start_proxy(_ctrl(), 0)
            h = serve.run(shout.bind())
            rmt.get(h.remote("warm"))  # ensure replica up
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/shout",
                data=json.dumps("hello").encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read()) == "HELLO"
        finally:
            serve.shutdown()
