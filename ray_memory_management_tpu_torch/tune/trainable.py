"""Trainable: the step/save/restore contract every trial actor implements.

Mirrors the reference's tune/trainable/trainable.py:65 (train:308,
save:436, restore:599) and the function-trainable wrapper
(tune/trainable/function_trainable.py): a function ``fn(config)`` that calls
``session.report(...)`` is adapted to the step-wise class contract by running
it on a background thread and treating each report as one training iteration.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional

RESULT_DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Subclass contract: override setup/step/save_checkpoint/load_checkpoint.

    ``train()``/``save()``/``restore()``/``reset_config()``/``stop()`` are the
    driver-callable surface (invoked as actor methods by the trial runner).
    """

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 trial_info: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.trial_info = dict(trial_info or {})
        self.iteration = 0
        self._start_time = time.time()
        self.setup(self.config)

    # -- user overrides -------------------------------------------------------
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable can hot-swap configs (PBT exploit
        without an actor restart — trainable.py reset semantics)."""
        return False

    # -- driver-callable surface ----------------------------------------------
    def train(self) -> Dict[str, Any]:
        result = self.step() or {}
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        result.setdefault("time_total_s", time.time() - self._start_time)
        result.setdefault(RESULT_DONE, False)
        result.setdefault("trial_id", self.trial_info.get("id", ""))
        return result

    def save(self) -> bytes:
        tmp = tempfile.mkdtemp(prefix="rmt_tune_ckpt_")
        try:
            self.save_checkpoint(tmp)
            files = {}
            for root, _dirs, names in os.walk(tmp):
                for name in names:
                    full = os.path.join(root, name)
                    files[os.path.relpath(full, tmp)] = open(full, "rb").read()
            return pickle.dumps({"files": files, "iteration": self.iteration})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def restore(self, blob: bytes) -> None:
        state = pickle.loads(blob)
        tmp = tempfile.mkdtemp(prefix="rmt_tune_ckpt_")
        try:
            for rel, data in state["files"].items():
                full = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(full), exist_ok=True)
                with open(full, "wb") as f:
                    f.write(data)
            self.load_checkpoint(tmp)
            self.iteration = state["iteration"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def reset(self, new_config: Dict[str, Any]) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = dict(new_config)
        return ok

    def stop(self) -> None:
        self.cleanup()


class FunctionTrainable(Trainable):
    """Adapts ``fn(config)`` + session.report to the step contract
    (function_trainable.py analog: fn runs on a thread; train() blocks until
    the next report or function exit)."""

    _fn: Optional[Callable] = None  # bound by wrap_function subclassing

    def setup(self, config: Dict[str, Any]) -> None:
        from ..train import session as session_mod

        self._session = session_mod.init_session(
            world_rank=0, world_size=1, checkpoint=None,
            trial_info=self.trial_info,
        )
        # The fn thread starts lazily on the first step() so a restore()
        # issued right after actor creation lands its checkpoint in the
        # session before user code runs (the reference resolves the same
        # race by passing the checkpoint into the session at start).
        self._thread: Optional[threading.Thread] = None

    def _run(self, config):
        s = self._session
        try:
            type(self)._fn(config)
        except BaseException as e:  # surfaced by train()
            s.error = e
        finally:
            s.finished.set()

    def step(self) -> Dict[str, Any]:
        s = self._session
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, args=(self.config,), daemon=True)
            self._thread.start()
        while True:
            try:
                item = s.queue.get(timeout=0.1)
                metrics = dict(item["metrics"])
                ckpt = item.get("checkpoint")
                if ckpt is not None:
                    self._latest_fn_ckpt = ckpt.to_bytes()
                return metrics
            except queue.Empty:
                if s.finished.is_set() and s.queue.empty():
                    if s.error is not None:
                        raise s.error
                    return {RESULT_DONE: True}

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        blob = getattr(self, "_latest_fn_ckpt", None)
        if blob is not None:
            with open(os.path.join(checkpoint_dir, "fn_ckpt.bin"), "wb") as f:
                f.write(blob)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        path = os.path.join(checkpoint_dir, "fn_ckpt.bin")
        if os.path.exists(path):
            from ..train.checkpoint import Checkpoint

            blob = open(path, "rb").read()
            self._latest_fn_ckpt = blob
            self._session.loaded_checkpoint = Checkpoint.from_bytes(blob)


def wrap_function(fn: Callable) -> type:
    """Build a FunctionTrainable subclass bound to ``fn``."""

    class _Wrapped(FunctionTrainable):
        _fn = staticmethod(fn)

    _Wrapped.__name__ = getattr(fn, "__name__", "fn") + "_trainable"
    return _Wrapped
