"""Workflow API: durable DAG execution with resume.

The reference's workflow library (python/ray/workflow/ —
``WorkflowExecutor`` at workflow_executor.py:32, DAG/state rebuild in
workflow_state_from_{dag,storage}.py, event listeners in
event_listener.py). Surface:

    @workflow.step
    def fetch(url): ...

    dag = process.step(fetch.step(url))
    result = workflow.run(dag, workflow_id="etl-1")
    # crash mid-run → workflow.resume("etl-1") re-executes ONLY the
    # steps whose results never committed to storage.

Each step runs as a cluster task; committed results are pickled into
workflow storage keyed by a deterministic step id, so resume is
idempotent across drivers.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, List, Optional

from .. import api
from .. import serialization as ser
from .storage import WorkflowStorage, list_workflows

class WorkflowCancelledError(RuntimeError):
    """Raised inside a running workflow when cancel() flipped its
    status (the reference's WorkflowCancellationError)."""


RUNNING = "RUNNING"
SUCCESS = "SUCCESS"
FAILED = "FAILED"
CANCELED = "CANCELED"


class StepNode:
    """One node of a workflow DAG (the reference's DAGNode bound to a
    step function)."""

    def __init__(self, fn: Callable, args: tuple, kwargs: dict,
                 options: dict):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.options = dict(options)
        self.name = options.get("name") or getattr(
            fn, "__name__", "step")

    def step_id(self, cache: Dict[int, str]) -> str:
        """Deterministic content-derived id: step name + the ids of
        upstream steps + a digest of the literal args. Re-running the
        same DAG yields the same ids, which is what makes storage lookups
        on resume hit. Positional and keyword slots hash with distinct
        markers so ``f.step(('k', 1))`` and ``f.step(k=1)`` never
        collide."""
        if id(self) in cache:
            return cache[id(self)]
        h = hashlib.sha256(self.name.encode())

        def hash_value(v):
            if isinstance(v, StepNode):
                h.update(b"\x02" + v.step_id(cache).encode())
            else:
                try:
                    h.update(ser.dumps(v))
                except Exception:
                    h.update(repr(v).encode())

        for a in self.args:
            h.update(b"\x00arg")
            hash_value(a)
        for k, v in sorted(self.kwargs.items()):
            h.update(b"\x01kw:" + k.encode())
            hash_value(v)
        sid = f"{self.name}-{h.hexdigest()[:16]}"
        cache[id(self)] = sid
        return sid


class WorkflowStepFunction:
    """``@workflow.step`` wrapper: ``.step(*args)`` builds a DAG node;
    ``.options(...)`` sets per-step retry/naming."""

    def __init__(self, fn: Callable, **options):
        self.fn = fn
        self._options = options

    def options(self, *, name: Optional[str] = None,
                max_retries: Optional[int] = None,
                catch_exceptions: Optional[bool] = None,
                num_cpus: Optional[float] = None,
                num_gpus: Optional[float] = None) -> "WorkflowStepFunction":
        merged = dict(self._options)
        for k, v in (("name", name), ("max_retries", max_retries),
                     ("catch_exceptions", catch_exceptions),
                     ("num_cpus", num_cpus), ("num_gpus", num_gpus)):
            if v is not None:
                merged[k] = v
        return WorkflowStepFunction(self.fn, **merged)

    def step(self, *args, **kwargs) -> StepNode:
        return StepNode(self.fn, args, kwargs, self._options)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def step(fn: Optional[Callable] = None, **options):
    """``@workflow.step`` / ``@workflow.step(max_retries=3)``."""
    if fn is not None:
        return WorkflowStepFunction(fn)
    return lambda f: WorkflowStepFunction(f, **options)


# -------------------------------------------------------------- execution
class _Executor:
    """Depth-first DAG executor with storage commit per step
    (workflow_executor.py:32; recovery = skip committed steps)."""

    def __init__(self, store: WorkflowStorage):
        self.store = store
        self.cache: Dict[int, str] = {}
        self._memo: Dict[str, Any] = {}

    def execute(self, node: Any) -> Any:
        if not isinstance(node, StepNode):
            return node
        sid = node.step_id(self.cache)
        if sid in self._memo:
            return self._memo[sid]
        if self.store.has_step_result(sid):
            result = self.store.load_step_result(sid)
            self._memo[sid] = result
            return result
        # cancellation is checked at step boundaries — AFTER the memo /
        # committed lookups (cached hits cost no status read) and again
        # after argument resolution below: cancel() from another
        # thread/process flips the stored status and the next dispatch
        # aborts; committed steps stay committed for a later resume
        if self.store.get_status() == CANCELED:
            raise WorkflowCancelledError(self.store.workflow_id)
        args = [self.execute(a) for a in node.args]
        kwargs = {k: self.execute(v) for k, v in node.kwargs.items()}
        # re-check AFTER argument resolution: a cancel landing while a
        # child step ran must stop the parent from dispatching
        if self.store.get_status() == CANCELED:
            raise WorkflowCancelledError(self.store.workflow_id)
        t0 = time.time()
        opts = {
            "num_cpus": node.options.get("num_cpus", 1),
            "max_retries": node.options.get("max_retries", 3),
            "retry_exceptions": True,
        }
        if node.options.get("num_gpus"):
            opts["num_gpus"] = node.options["num_gpus"]
        remote_fn = api.remote(node.fn).options(**opts)
        attempts = 1
        try:
            result = api.get(remote_fn.remote(*args, **kwargs))
            if node.options.get("catch_exceptions"):
                result = (result, None)
        except Exception as e:
            if node.options.get("catch_exceptions"):
                result = (None, e)
            else:
                raise
        # a nested StepNode return value means "continue with this DAG"
        # (the reference's workflow continuation)
        if isinstance(result, StepNode):
            result = self.execute(result)
        self.store.save_step_result(sid, result, meta={
            "name": node.name, "attempts": attempts,
            "wall_s": time.time() - t0,
        })
        self._memo[sid] = result
        return result


def run(dag: StepNode, *, workflow_id: Optional[str] = None) -> Any:
    """Execute a workflow DAG durably; returns the root step's result."""
    if workflow_id is None:
        workflow_id = f"workflow-{int(time.time() * 1000):x}"
    store = WorkflowStorage(workflow_id)
    ex = _Executor(store)
    store.set_status(RUNNING)
    store.set_output_step(dag.step_id(ex.cache))
    try:
        result = ex.execute(dag)
    except WorkflowCancelledError:
        raise  # status is already CANCELED; do not overwrite with FAILED
    except BaseException:
        # a cancel racing the failure keeps CANCELED (atomic transition)
        store.transition_status(FAILED, expect={RUNNING})
        raise
    # cancel-wins: if cancel() landed while the FINAL step ran (no later
    # boundary existed to observe it), the caller still gets the
    # cancellation they asked for — the committed results make a rerun
    # complete instantly. A failed transition for any OTHER reason (a
    # concurrent driver of the same workflow id finished first and wrote
    # a terminal status) is a success: the result is committed.
    if not store.transition_status(SUCCESS, expect={RUNNING}):
        if store.get_status() == CANCELED:
            raise WorkflowCancelledError(workflow_id)
    return result


def run_async(dag: StepNode, *, workflow_id: Optional[str] = None):
    """Run in a background thread; returns a concurrent Future."""
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(1, thread_name_prefix="workflow")
    fut = ex.submit(run, dag, workflow_id=workflow_id)
    ex.shutdown(wait=False)
    return fut


def resume(workflow_id: str) -> Any:
    """Re-run a workflow from storage: committed steps load, missing
    steps (and only those) execute (workflow_state_from_storage.py)."""
    store = WorkflowStorage(workflow_id)
    status = store.get_status()
    if status is None:
        raise ValueError(f"no workflow {workflow_id!r} in storage")
    if status == SUCCESS:
        return get_output(workflow_id)
    raise ValueError(
        "resume() needs the original DAG in this runtime; call "
        "run(dag, workflow_id=...) again — committed steps are skipped"
    )


def rerun(dag: StepNode, *, workflow_id: str) -> Any:
    """Explicit resume-with-DAG: identical to run(); committed steps are
    loaded from storage instead of re-executing."""
    return run(dag, workflow_id=workflow_id)


def cancel(workflow_id: str) -> None:
    """Request cancellation: the run aborts at its next step boundary
    (in-flight steps finish; committed steps stay committed, so a later
    ``run(dag, workflow_id=...)`` resumes past them). Only a RUNNING
    workflow can be canceled: terminal statuses stay put (a late cancel
    must not relabel a completed run), and an unknown id raises without
    leaving a phantom directory behind."""
    if workflow_id not in list_workflows():
        raise ValueError(f"no workflow {workflow_id!r} in storage")
    # atomic RUNNING->CANCELED: a cancel racing the run's completion
    # write must never relabel a finished workflow
    WorkflowStorage(workflow_id).transition_status(
        CANCELED, expect={RUNNING})


def get_status(workflow_id: str) -> Optional[str]:
    return WorkflowStorage(workflow_id).get_status()


def get_output(workflow_id: str) -> Any:
    store = WorkflowStorage(workflow_id)
    sid = store.get_output_step()
    if sid is None or not store.has_step_result(sid):
        raise ValueError(f"workflow {workflow_id!r} has no output yet")
    return store.load_step_result(sid)


def list_all() -> List[tuple]:
    return [(wid, get_status(wid)) for wid in list_workflows()]


def delete(workflow_id: str) -> None:
    import shutil

    shutil.rmtree(WorkflowStorage(workflow_id).root, ignore_errors=True)


# ---------------------------------------------------------------- events
class EventListener:
    """Event-listener contract (reference event_listener.py): subclass
    and implement poll_for_event; use with ``wait_for_event``."""

    async def poll_for_event(self, *args, **kwargs) -> Any:
        raise NotImplementedError


def wait_for_event(listener_cls, *args, poll_interval_s: float = 0.1,
                   timeout_s: float = 3600.0, **kwargs) -> StepNode:
    """A DAG node that resolves when the listener's event fires. The
    committed event value is durable: a resumed workflow does not
    re-wait."""

    def _wait():
        import asyncio

        listener = listener_cls()
        return asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(
                listener.poll_for_event(*args, **kwargs), timeout_s))

    # the listener args live in the closure, invisible to step_id — fold
    # their digest into the step name so distinct waits get distinct ids
    arg_digest = hashlib.sha256(
        repr((args, sorted(kwargs.items()))).encode()).hexdigest()[:8]
    _wait.__name__ = (
        f"wait_for_event_{listener_cls.__name__}_{arg_digest}")
    return WorkflowStepFunction(_wait).step()


def sleep(duration_s: float) -> StepNode:
    """Durable sleep step (workflow.sleep in the reference)."""

    def _sleep():
        time.sleep(duration_s)
        return duration_s

    _sleep.__name__ = f"sleep_{duration_s}"
    return WorkflowStepFunction(_sleep).step()
