# rmtcheck: disable-file=log-discipline — a command-line report
"""Where the card's time goes: one traced window of a main path.

    python3 -m ray_memory_management_tpu_torch.utils.profile_serve
    python3 -m ray_memory_management_tpu_torch.utils.profile_serve --mode train
    python3 -m ray_memory_management_tpu_torch.utils.profile_serve --mode sharded
    python3 -m ray_memory_management_tpu_torch.utils.profile_serve --mode train \\
        --preset mixtral-tiny --batch 4 --seq 2048

``--mode serve`` (the default) builds ``LLMServer`` (gpt2-small, paged
continuous batching, 8 slots, 32 new tokens), warms it up, then serves
one closed-loop burst of concurrent requests twice: untraced (the wall
time users see) and under ``torch.profiler`` with CUDA activity.
``--mode train`` takes AdamW steps of gpt2-small at B = 8, S = 1024,
set up as ``utils/gpu_bench.py`` ``train_step_mfu`` sets it up: two
warm-up steps, a window of four steps untraced, then the same window
traced. ``--mode sharded`` takes the same steps through the parallel
library, as ``TorchTrainer``'s worker does in ``chip_smoke.py`` phase
10: a one-rank NCCL world, ``make_mesh({"dp": 1})``, ``shard_pytree``
and ``make_train_step`` (dp: plain tensors, DDP's shape). Each prints
the device-busy share
of the traced wall time, each
flash attention kernel's time and share, and the kernels that take the
most time. ``--preset`` (and for training ``--batch``, ``--seq``) trace
another model than gpt2-small. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from ..ops.flash_attention import (DKV, DQ, FWD, SIMT, WGMMA,
                                   bwd_design_counts, fwd_design_counts,
                                   reset_launch_count)
from ..serve.llm import LLMServer
from . import gpu_bench

PROMPT_LENS = (5, 40, 64, 100, 250, 513, 800, 991, 1000)
TRAIN_STEPS = 4  # training steps per window, traced and untraced
# device kernel name (the __global__ function's) -> the port's kernel and
# the design whose launch counter it is; no name is part of another
PORT_KERNELS = {"flash_fwd_wgmma_kernel": (FWD, WGMMA),
                "flash_fwd_kernel": (FWD, SIMT),
                "flash_bwd_dq_wgmma_kernel": (DQ, WGMMA),
                "flash_bwd_dq_kernel": (DQ, SIMT),
                "flash_bwd_dkv_wgmma_kernel": (DKV, WGMMA),
                "flash_bwd_dkv_kernel": (DKV, SIMT)}


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


def device_us(evt) -> float:
    """A profiler row's own device time in µs."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def kernel_rows(prof):
    """The device rows of a trace's ``key_averages()``: kernels, copies
    and sets. Operator rows carry their kernels' time as well, and a user
    annotation's device row (the optimizer's step) spans kernels that have
    rows of their own, so neither is one."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def _serve(args, profile, activities):
    srv = LLMServer(preset=args.preset, max_batch_size=8,
                    max_new_tokens=32, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    vocab = min(50_000, srv.cfg.vocab_size)
    prompts = [rng.integers(2, vocab, size=n).tolist() for n in PROMPT_LENS]
    try:
        srv({"tokens": [5, 6, 7]})  # warm-up
        wall_plain = _burst(srv, prompts)
        reset_launch_count()
        with profile(activities=activities) as prof:
            wall_traced = _burst(srv, prompts)
            torch.cuda.synchronize()
    finally:
        srv.close()
    print(f"requests: {len(prompts)} concurrent, prompt lens "
          f"{list(PROMPT_LENS)}, 32 new tokens each")
    return prof, wall_plain, wall_traced


def _train_windows(args, step, profile, activities, label):
    """Two warm-up calls of ``step``, then a window of TRAIN_STEPS calls
    untraced and the same window traced."""
    def window():
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(2):  # warm-up
        step()
    torch.cuda.synchronize()
    wall_plain = window()
    reset_launch_count()
    with profile(activities=activities) as prof:
        wall_traced = window()
    print(f"training{label}: {args.preset} B={args.batch} S={args.seq} "
          f"AdamW, {TRAIN_STEPS} "
          f"steps per window; untraced "
          f"{wall_plain / TRAIN_STEPS * 1e3:.2f} ms/step")
    return prof, wall_plain, wall_traced


def _train(args, profile, activities):
    device = torch.device("cuda", torch.cuda.current_device())
    params, opt, batch, cfg = gpu_bench.setup_training(
        args.preset, args.batch, args.seq, remat=False, attention="flash",
        device=device)
    return _train_windows(
        args, lambda: gpu_bench.train_step(params, opt, batch, cfg),
        profile, activities, "")


def _sharded(args, profile, activities):
    import torch.distributed as dist

    from .. import parallel as par
    from ..collective.collective import init_dist_world, pick_address
    from ..models import gpt

    device = torch.device("cuda", torch.cuda.current_device())
    init_dist_world(1, 0, f"tcp://{pick_address()}", "cuda")
    try:
        mesh = par.make_mesh({"dp": 1})
        params, _, batch, cfg = gpu_bench.setup_training(
            args.preset, args.batch, args.seq, remat=False,
            attention="flash", device=device)
        sp = par.shard_pytree(params, mesh,
                              par.param_pspecs(params, mesh, "dp"))
        opt = torch.optim.AdamW(list(gpt.param_leaves(sp)),
                                **gpu_bench.ADAMW)
        step = par.make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg),
                                   opt, mesh)
        return _train_windows(args, lambda: step(sp, batch), profile,
                              activities,
                              " over make_train_step, a one-rank mesh")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("serve", "train", "sharded"),
                    default="serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--preset", default="gpt2-small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    run = {"serve": _serve, "train": _train, "sharded": _sharded}[args.mode]
    prof, wall_plain, wall_traced = run(
        args, profile, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    launches = {FWD: fwd_design_counts(), **bwd_design_counts()}
    events = kernel_rows(prof)
    busy_us = sum(device_us(e) for e in events)
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"wall untraced {wall_plain * 1e3:.1f} ms, traced "
          f"{wall_traced * 1e3:.1f} ms")
    print(f"device busy {busy_us / 1e3:.1f} ms = "
          f"{100 * busy_us / 1e6 / wall_traced:.1f}% of traced wall "
          f"(idle {100 - 100 * busy_us / 1e6 / wall_traced:.1f}%)")
    for kernel, (port_kernel, design) in PORT_KERNELS.items():
        us = sum(device_us(e) for e in events if kernel in e.key)
        print(f"{kernel} {us / 1e3:.2f} ms over "
              f"{launches[port_kernel][design]} launches = "
              f"{100 * us / max(busy_us, 1e-9):.2f}% of busy")
    print(f"top {args.top} kernels by device time:")
    for e in sorted(events, key=device_us, reverse=True)[:args.top]:
        print(f"  {device_us(e) / 1e3:9.2f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
