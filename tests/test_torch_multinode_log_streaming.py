"""Driver log streaming: worker stdout/stderr reaches the driver, prefixed.

The reference's log monitor tails worker log files and republishes them to
the driver (python/ray/_private/services.py:1126 and the ``(pid=..., ip=...)``
line prefixes); here worker fds are captured in-process and the chunks ride
the worker pipe (and the node-agent tunnel for remote workers) as ``log``
frames (VERDICT r1 item 10).

The PyTorch port's copy of ``tests/test_log_streaming.py``: the same
cases run against ``ray_memory_management_tpu_torch``, with its own
fixtures (the shared conftest starts the JAX package's runtime).
"""

import sys
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


def _wait_for(capfd, *needles: str, timeout: float = 30.0) -> str:
    """Poll captured stderr until every one of ``needles`` shows up (log
    frames are asynchronous — they can trail the task's done reply, and
    each read of the worker's output pipe travels as its own frame, so
    one print can arrive before another)."""
    collected = ""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out, err = capfd.readouterr()
        collected += out + err
        if all(needle in collected for needle in needles):
            return collected
        time.sleep(0.1)
    return collected


def test_task_print_reaches_driver(rmt_start_regular, capfd):
    @rmt.remote
    def chatty():
        print("hello from the worker side")
        sys.stderr.write("stderr travels too\n")
        return 1

    assert rmt.get(chatty.remote(), timeout=120) == 1
    got = _wait_for(capfd, "hello from the worker side",
                    "stderr travels too")
    assert "hello from the worker side" in got
    assert "stderr travels too" in got
    # the log monitor prefix carries the worker identity
    line = next(l for l in got.splitlines()
                if "hello from the worker side" in l)
    assert line.startswith("(worker=") and "node=" in line


def test_actor_print_reaches_driver(rmt_start_regular, capfd):
    @rmt.remote
    class Talker:
        def speak(self):
            print("actor speaking")
            return "ok"

    t = Talker.remote()
    assert rmt.get(t.speak.remote(), timeout=120) == "ok"
    assert "actor speaking" in _wait_for(capfd, "actor speaking")


def test_remote_node_print_reaches_driver(capfd):
    """A worker on a node-agent host (separate OS process, no shared fds)
    still streams its prints to the driver through the agent channel."""
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    rt = rmt.init(num_cpus=2)
    try:
        remote_id = rt.add_remote_node_process(num_cpus=2)

        @rmt.remote(max_retries=0)
        def remote_chatty():
            print("hello from another host")
            return 2

        ref = remote_chatty.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=remote_id, soft=False)
        ).remote()
        assert rmt.get(ref, timeout=120) == 2
        assert "hello from another host" in _wait_for(
            capfd, "hello from another host", timeout=60)
    finally:
        rmt.shutdown()
