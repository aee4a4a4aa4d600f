"""Durable workflow storage.

The reference persists workflow DAG state to pluggable storage and
rebuilds execution state from it on resume
(python/ray/workflow/workflow_state_from_storage.py,
workflow_storage.py). Here: a filesystem layout, one directory per
workflow, one pickle per completed step — the FileSystemStorage tier of
the reference's storage stack (S3/GCS layers mount the same interface
over a remote path).

A step's result is pickled with each ``torch.Tensor`` as its host values
and its device type: a CUDA tensor comes back bit-equal on the loading
process's card, and loading it in a process without a card raises
instead of landing on the CPU.

Layout::

    <base>/<workflow_id>/
        status            # RUNNING | SUCCESS | FAILED | CANCELED
        output            # step_id of the DAG root
        steps/<step_id>/
            result.pkl    # present iff the step committed
            meta.json     # name, attempt count, wall time
"""

from __future__ import annotations

import io
import json
import os
import pickle
import tempfile
from typing import Any, List, Optional

from .. import serialization as ser

_DEFAULT_BASE = os.path.join(tempfile.gettempdir(), "rmt_workflows")
_base_dir = os.environ.get("RMT_WORKFLOW_STORAGE", _DEFAULT_BASE)


def set_storage(path: str) -> None:
    global _base_dir
    _base_dir = path


def get_storage() -> str:
    return _base_dir


class _StepPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if ser._is_tensor(obj):
            np_value, dtype = ser._tensor_to_host(obj)
            return (_load_tensor, (np_value, dtype, obj.device.type))
        return NotImplemented


def _dumps(result: Any) -> bytes:
    buf = io.BytesIO()
    _StepPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(result)
    return buf.getvalue()


def _load_tensor(np_value, dtype: str, device_type: str):
    import torch

    t = ser._host_tensor(torch, np_value, dtype)
    if device_type == "cuda":
        device = ser._consumer_cuda_device(torch)
        if device is None:
            raise RuntimeError(
                "a workflow step's CUDA tensor was loaded from storage in "
                "a process without a card (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        t = t.to(device)
    return t


class WorkflowStorage:
    def __init__(self, workflow_id: str, base: Optional[str] = None):
        self.workflow_id = workflow_id
        self.root = os.path.join(base or _base_dir, workflow_id)
        os.makedirs(os.path.join(self.root, "steps"), exist_ok=True)

    # -- workflow level ------------------------------------------------------
    def set_status(self, status: str) -> None:
        self._atomic_write(os.path.join(self.root, "status"),
                           status.encode())

    def get_status(self) -> Optional[str]:
        try:
            with open(os.path.join(self.root, "status")) as f:
                return f.read().strip()
        except FileNotFoundError:
            return None

    def transition_status(self, to: str, expect) -> bool:
        """Atomically move status to ``to`` iff the current status is in
        ``expect`` (an fcntl lock serializes racing writers — e.g. a
        cancel() racing the run's own completion write). Returns whether
        the transition happened."""
        import fcntl

        lock_path = os.path.join(self.root, ".status.lock")
        with open(lock_path, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            if self.get_status() not in expect:
                return False
            self._atomic_write(os.path.join(self.root, "status"),
                               to.encode())
            return True

    def set_output_step(self, step_id: str) -> None:
        self._atomic_write(os.path.join(self.root, "output"),
                           step_id.encode())

    def get_output_step(self) -> Optional[str]:
        try:
            with open(os.path.join(self.root, "output")) as f:
                return f.read().strip()
        except FileNotFoundError:
            return None

    # -- step level ----------------------------------------------------------
    def _step_dir(self, step_id: str) -> str:
        return os.path.join(self.root, "steps", step_id)

    def has_step_result(self, step_id: str) -> bool:
        return os.path.exists(
            os.path.join(self._step_dir(step_id), "result.pkl"))

    def save_step_result(self, step_id: str, result: Any,
                         meta: Optional[dict] = None) -> None:
        d = self._step_dir(step_id)
        os.makedirs(d, exist_ok=True)
        if meta is not None:
            self._atomic_write(os.path.join(d, "meta.json"),
                               json.dumps(meta).encode())
        # result.pkl lands last and atomically: its presence IS the commit
        self._atomic_write(os.path.join(d, "result.pkl"), _dumps(result))

    def load_step_result(self, step_id: str) -> Any:
        with open(os.path.join(self._step_dir(step_id), "result.pkl"),
                  "rb") as f:
            return pickle.load(f)

    def list_steps(self) -> List[str]:
        steps_dir = os.path.join(self.root, "steps")
        return sorted(os.listdir(steps_dir)) if os.path.isdir(steps_dir) \
            else []

    def _atomic_write(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


def list_workflows(base: Optional[str] = None) -> List[str]:
    root = base or _base_dir
    return sorted(os.listdir(root)) if os.path.isdir(root) else []
