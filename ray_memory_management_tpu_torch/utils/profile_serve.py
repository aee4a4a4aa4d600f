"""Where serving time goes on the card: one traced pass of the main path.

    python3 -m ray_memory_management_tpu_torch.utils.profile_serve

Builds ``LLMServer`` (gpt2-small, paged continuous batching, 8 slots, 32
new tokens), warms it up, then serves one closed-loop burst of
concurrent requests twice: untraced (the wall time users see) and under
``torch.profiler`` with CUDA activity. It prints the device-busy share
of the traced wall time, the flash attention kernel's share, and the
kernels that take the most time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from ..ops.flash_attention import launch_count, reset_launch_count
from ..serve.llm import LLMServer

PROMPT_LENS = (5, 40, 64, 100, 250, 513, 800, 991, 1000)


def _burst(srv: LLMServer, prompts) -> float:
    errors = []

    def call(p):
        try:
            srv({"tokens": p})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=call, args=(p,)) for p in prompts]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving failed: {errors}")
    return wall


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(2, 50_000, size=n).tolist()
               for n in PROMPT_LENS]
    srv = LLMServer(preset="gpt2-small", max_batch_size=8,
                    max_new_tokens=32, seed=args.seed)
    try:
        srv({"tokens": [5, 6, 7]})  # warm-up
        wall_plain = _burst(srv, prompts)
        reset_launch_count()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_traced = _burst(srv, prompts)
            torch.cuda.synchronize()
        launches = launch_count()
    finally:
        srv.close()
    # kernel rows only: operator rows carry their kernels' time as well
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events)
    flash_us = sum(_device_us(e) for e in events
                   if "flash_fwd_kernel" in e.key)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"requests: {len(prompts)} concurrent, prompt lens "
          f"{list(PROMPT_LENS)}, 32 new tokens each")
    print(f"wall untraced {wall_plain * 1e3:.1f} ms, traced "
          f"{wall_traced * 1e3:.1f} ms")
    print(f"device busy {busy_us / 1e3:.1f} ms = "
          f"{100 * busy_us / 1e6 / wall_traced:.1f}% of traced wall "
          f"(idle {100 - 100 * busy_us / 1e6 / wall_traced:.1f}%)")
    print(f"flash_fwd_kernel {flash_us / 1e3:.2f} ms over {launches} "
          f"launches = {100 * flash_us / max(busy_us, 1e-9):.2f}% of busy")
    print(f"top {args.top} kernels by device time:")
    for e in sorted(events, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / 1e3:9.2f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
