"""Workflow library tests: DAG execution, durability/resume semantics,
retries, continuations, events (reference workflow/tests shape).

The PyTorch port's copy of ``tests/test_workflow.py``: the same cases
run against ``ray_memory_management_tpu_torch``, with its own fixture
(the shared conftest starts the JAX package's runtime)."""

import os
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import workflow
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def rmt_start_regular():
    """One runtime for the module's cases (each case's own init and
    shutdown cost about 2 s here, twenty times its body)."""
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


@pytest.fixture
def wf_storage(tmp_path, rmt_start_regular):
    old = workflow.get_storage()
    workflow.set_storage(str(tmp_path / "wf"))
    yield str(tmp_path / "wf")
    workflow.set_storage(old)


@workflow.step
def add(a, b):
    return a + b


@workflow.step
def double(x):
    return 2 * x


class TestBasics:
    def test_dag_run(self, wf_storage):
        dag = double.step(add.step(2, 3))
        assert workflow.run(dag, workflow_id="w1") == 10
        assert workflow.get_status("w1") == workflow.SUCCESS
        assert workflow.get_output("w1") == 10

    def test_diamond_dag_shares_step(self, wf_storage):
        shared = add.step(1, 1)
        dag = add.step(double.step(shared), double.step(shared))
        assert workflow.run(dag, workflow_id="w2") == 8
        # shared node committed once (content-addressed id)
        steps = [s for s in os.listdir(os.path.join(wf_storage, "w2",
                                                    "steps"))]
        assert len([s for s in steps if s.startswith("add-")]) == 2

    def test_list_and_delete(self, wf_storage):
        workflow.run(add.step(1, 2), workflow_id="w3")
        assert ("w3", workflow.SUCCESS) in workflow.list_all()
        workflow.delete("w3")
        assert all(wid != "w3" for wid, _ in workflow.list_all())

    def test_run_async(self, wf_storage):
        fut = workflow.run_async(add.step(4, 5), workflow_id="w4")
        assert fut.result(timeout=60) == 9


class TestDurability:
    def test_resume_skips_committed_steps(self, wf_storage, tmp_path):
        marker = tmp_path / "ran_flaky"

        @workflow.step
        def stable():
            return 7

        @workflow.step
        def flaky(x):
            if not marker.exists():
                marker.write_text("1")
                raise RuntimeError("first run dies")
            return x + 1

        dag = flaky.options(max_retries=0).step(stable.step())
        with pytest.raises(Exception):
            workflow.run(dag, workflow_id="w5")
        assert workflow.get_status("w5") == workflow.FAILED
        # rerun: 'stable' loads from storage, only 'flaky' re-executes
        assert workflow.rerun(dag, workflow_id="w5") == 8
        assert workflow.get_status("w5") == workflow.SUCCESS

    def test_completed_steps_not_reexecuted(self, wf_storage, tmp_path):
        counter = tmp_path / "count"
        counter.write_text("0")

        @workflow.step
        def counting():
            n = int(counter.read_text()) + 1
            counter.write_text(str(n))
            return n

        dag = double.step(counting.step())
        assert workflow.run(dag, workflow_id="w6") == 2
        assert workflow.rerun(dag, workflow_id="w6") == 2
        assert counter.read_text() == "1"  # side effect ran exactly once

    def test_retries(self, wf_storage, tmp_path):
        attempts = tmp_path / "attempts"
        attempts.write_text("0")

        @workflow.step
        def eventually_works():
            n = int(attempts.read_text()) + 1
            attempts.write_text(str(n))
            if n < 3:
                raise ValueError(f"attempt {n}")
            return "ok"

        dag = eventually_works.options(max_retries=4).step()
        assert workflow.run(dag, workflow_id="w7") == "ok"
        assert attempts.read_text() == "3"

    def test_catch_exceptions(self, wf_storage):
        @workflow.step
        def boom():
            raise ValueError("expected")

        dag = boom.options(catch_exceptions=True, max_retries=0).step()
        result, err = workflow.run(dag, workflow_id="w8")
        assert result is None
        assert isinstance(err, Exception)


class TestAdvanced:
    def test_continuation(self, wf_storage):
        @workflow.step
        def recurse(n):
            if n <= 0:
                return "bottom"
            return recurse.step(n - 1)

        assert workflow.run(recurse.step(2), workflow_id="w9") == "bottom"

    def test_wait_for_event(self, wf_storage, tmp_path):
        flag = tmp_path / "flag"

        class FileListener(workflow.EventListener):
            async def poll_for_event(self, path):
                import asyncio

                while not os.path.exists(path):
                    await asyncio.sleep(0.02)
                return open(path).read()

        fut = workflow.run_async(
            double.step(workflow.wait_for_event(FileListener, str(flag))),
            workflow_id="w10")
        time.sleep(0.3)
        flag.write_text("3")
        # "3" * 2 == "33" (string doubling proves the event value flowed)
        assert fut.result(timeout=60) == "33"

    def test_sleep_step(self, wf_storage):
        t0 = time.time()
        assert workflow.run(workflow.sleep(0.2), workflow_id="w11") == 0.2
        assert time.time() - t0 >= 0.15


def test_cancel_aborts_at_step_boundary(wf_storage, tmp_path):
    """cancel() from another thread aborts the run at its next step
    boundary with WorkflowCancelledError; committed steps stay committed
    and a later run() resumes past them (the reference's cancellation
    semantics)."""
    import time as _time

    from ray_memory_management_tpu_torch.workflow import WorkflowCancelledError

    gate = str(tmp_path / "gate")

    @workflow.step
    def slow(x):
        import os
        import time

        open(gate, "w").write("reached")
        time.sleep(1.0)
        return x + 1

    @workflow.step
    def after(x):
        return x * 10

    wid = "cancel-test"
    dag = after.step(slow.step(1))
    fut = workflow.run_async(dag, workflow_id=wid)
    for _ in range(200):  # wait until the first step is actually running
        if (tmp_path / "gate").exists():
            break
        _time.sleep(0.05)
    workflow.cancel(wid)
    try:
        fut.result(timeout=120)
        raise AssertionError("expected cancellation")
    except WorkflowCancelledError:
        pass
    assert workflow.get_status(wid) == "CANCELED"
    # the committed first step is reused on resume; the rest completes
    result = workflow.run(dag, workflow_id=wid)
    assert result == 20
    assert workflow.get_status(wid) == "SUCCESS"


def test_cancel_unknown_workflow_raises(wf_storage):
    with pytest.raises(ValueError):
        workflow.cancel("never-ran")
    # probing with a bad id must not pollute storage with a phantom dir
    assert "never-ran" not in [w for w, _ in workflow.list_all()]


def test_cancel_after_success_is_a_noop(wf_storage):
    dag = double.step(add.step(1, 2))
    assert workflow.run(dag, workflow_id="done-wf") == 6
    workflow.cancel("done-wf")  # late cancel must not relabel the run
    assert workflow.get_status("done-wf") == "SUCCESS"
