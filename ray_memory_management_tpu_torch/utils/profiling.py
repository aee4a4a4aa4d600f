"""Card profiling: ``torch.profiler`` traces + CUDA memory snapshots.

The reference's profiling story is (a) per-worker ProfileEvents to GCS
rendered by ``ray timeline`` (src/ray/core_worker/profiling.h:30; covered
here by utils/timeline.py) and (b) torch-profiler integration inside Train
(train/torch/train_loop_utils.py:232 TorchWorkerProfiler). This module is
(b), a thin bridge over ``torch.profiler``:

  - ``trace(logdir, device)``   capture a Chrome trace (CPU activity, and
                                CUDA activity on the card) of the enclosed
                                code into ``logdir/trace.json``, and record
                                the span in the runtime timeline so
                                host-side task spans and device traces
                                line up;
  - ``annotate(name)``          a ``record_function`` range visible in the
                                trace AND a timeline span — one annotation,
                                both views;
  - ``start_server(port)``      live capture: torch has no profiler server,
                                so this returns False (as the JAX package
                                does without jax);
  - ``save_device_memory_profile(path)``  a CUDA allocator snapshot
                                (``torch.cuda.memory._snapshot``, pickled;
                                ``torch.cuda._memory_viz`` renders it) —
                                the OOM-debugging tool; None without a card.

``device`` defaults to the card, as every entry point of the port does. A
trace asked for on the card raises where there is no card: it never
profiles the CPU alone in its place; ``device="cpu"`` traces CPU activity.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Optional

from . import timeline


def _activities(device: str):
    import torch
    from torch.profiler import ProfilerActivity

    if device == "cpu":
        return [ProfilerActivity.CPU]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "profiling.trace(device='cuda') needs a CUDA card; pass "
            "device='cpu' to trace the CPU")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


@contextlib.contextmanager
def trace(logdir: str, device: str = "cuda"):
    """Capture a Chrome trace of the enclosed block into
    ``logdir/trace.json`` (the TorchWorkerProfiler analog). The card's
    work is synchronized before the trace closes, so every kernel the
    block launched is in it."""
    import torch
    from torch.profiler import profile

    activities = _activities(device)
    os.makedirs(logdir, exist_ok=True)
    start = time.time()
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if device != "cpu":
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    timeline.record_event("torch_profiler_trace", "profiler", start,
                          time.time(), extra={"logdir": logdir,
                                              "path": path})


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in BOTH a ``trace`` (``record_function``) and
    the runtime chrome timeline."""
    import torch

    start = time.time()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        timeline.record_event(name, "annotation", start, time.time())


def start_server(port: int = 9012) -> bool:
    """Live profiler server: torch.profiler has none, so False (the JAX
    package's answer when its profiler is unavailable)."""
    del port
    return False


def stop_server() -> None:
    """Counterpart of :func:`start_server`; nothing is running."""


def save_device_memory_profile(path: str) -> Optional[str]:
    """Dump the card's allocator state (segments, blocks and, when
    ``torch.cuda.memory._record_memory_history`` is on, their stacks) as
    a pickle at ``path``; None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    snapshot = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)
    return path
