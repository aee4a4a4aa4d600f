"""Task and actor bodies that ``chip_smoke.py``'s runtime phase sends to
the port's workers.

They live in an importable module of the port, so the runtime pickles
them by reference (``serialization._needs_by_value`` is False for the
port's own modules) and a worker imports them as it would any library
code; nothing here runs at import.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from ..serve.llm import LLMServer


def _require_cuda(*tensors) -> None:
    """A GPU task whose inputs did not land on the card fails: it never
    computes on the CPU in the card's place."""
    for t in tensors:
        if not t.is_cuda:
            raise RuntimeError(
                f"a GPU task got a {t.device} tensor (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); the card "
                "is not visible to this worker")


def _device_uuid(device) -> str:
    """The UUID of the card behind ``device``: what a worker and its
    driver compare to show they use the same physical card (an index
    means a different card under a different ``CUDA_VISIBLE_DEVICES``)."""
    import torch

    return str(torch.cuda.get_device_properties(device).uuid)


def attend(q, k, v, causal: bool = True) -> Dict[str, Any]:
    """Run the port's flash attention on the worker's card. ``q``, ``k``
    and ``v`` arrive as ObjectRef arguments, rebuilt on the worker's
    CUDA device. Returns the output with the worker's
    ``CUDA_VISIBLE_DEVICES``, its card's UUID and the kernel launches of
    this call."""
    from ..ops.flash_attention import (
        flash_attention, fwd_design_counts, launch_counts,
        reset_launch_count)

    _require_cuda(q, k, v)
    reset_launch_count()
    out = flash_attention(q, k, v, causal=causal)
    return {"out": out,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_uuid": _device_uuid(out.device),
            "launches": launch_counts(),
            "designs": fwd_design_counts()}


class ServedLLM(LLMServer):
    """``LLMServer`` as a GPU actor or serve replica, with reads of the
    process's own state that a caller outside it cannot make: the flash
    attention launch counts, the KV page pool, its card's UUID (on the
    CPU, None), its pid and its cold starts. Serving is ``LLMServer``'s,
    unchanged (``generate``, ``__call__``)."""

    def reset_counters(self) -> None:
        from ..ops.flash_attention import reset_launch_count

        reset_launch_count()

    def counters(self) -> Dict[str, Any]:
        from ..core import metrics_defs as mdefs
        from ..ops.flash_attention import fwd_design_counts, launch_counts

        cold = mdefs.serve_cold_start_seconds()
        return {"launches": launch_counts(),
                "pid": os.getpid(),
                "cold_starts": {
                    source: {k: cold.get(tags={"source": source})[k]
                             for k in ("count", "sum")}
                    for source in ("shipped", "init")},
                "designs": fwd_design_counts(),
                "stats": self.stats(),
                "device": str(self.device),
                "device_uuid": (_device_uuid(self.device)
                                if self.device.type == "cuda" else None),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES")}
