"""Workflow library: durable DAG execution on storage.

The reference's ``ray.workflow`` (python/ray/workflow/ — executor,
storage-backed state, resume, event listeners).
"""

from .api import (  # noqa: F401
    CANCELED,
    FAILED,
    RUNNING,
    SUCCESS,
    EventListener,
    StepNode,
    WorkflowStepFunction,
    cancel,
    WorkflowCancelledError,
    delete,
    get_output,
    get_status,
    list_all,
    rerun,
    resume,
    run,
    run_async,
    sleep,
    step,
    wait_for_event,
)
from .storage import get_storage, set_storage  # noqa: F401
