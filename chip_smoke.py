#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold it to its plain
versions.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (any failure exits non-zero):

  1. build    — compile every CUDA kernel library of the port from
                ``ray_memory_management_tpu_torch/csrc`` with nvcc, one
                nvcc per source, all started together.
  2. kernels  — the flash attention forward kernel against its plain
                version (``reference_attention``, and ``logsumexp`` of the
                plain scores for its lse output) at the serving path's
                shapes (BH = 12, D = 64, S in {64, 992, 1024}, causal and
                not, S != Skv, fp32 and bf16; bf16 D = 128 at S = 992 and
                a ragged S = 1000) and at the training shape (BH = 96,
                S = 1024), each case checked for the design it took
                (bf16 with D = 64 or 128: wgmma; fp32: SIMT); then the
                backward kernels (dq, dk/dv) against
                ``reference_flash_bwd`` at the training shape in bf16 and
                fp32, non-causal, S != Skv, odd lengths, a ragged S =
                1000 and one query row, each case checked for the design
                it took (the forward's rule). Each kernel's
                device time (``device_ms``: the kernels of a
                ``torch.profiler`` trace) is printed beside its plain
                version's, a PyTorch yardstick the port never calls (SDPA
                forward; the SDPA backward for the dq + dk/dv pair, only
                its ``autograd.grad`` traced) and the card's bound; the
                CUDA-event figures, which take in host time, stand beside
                them under ``*_event_ms``. At the serving main case and the
                training shape the forward's previous (SIMT) design is
                timed in turns with the wgmma one (prev, new, new, prev),
                and so are the backward kernels' at the training shape.
  3. forward  — ``gpt.forward`` of gpt2-small at B = 8, S = 1024 with the
                kernel against ``attention="ref"``.
  4. grad     — gradients of ``gpt.loss_fn`` for gpt2-small at B = 8,
                S = 1024 with the kernels against ``attention="ref"``;
                every kernel launch of the bf16 gradient must be wgmma.
  5. serve    — a main path: ``LLMServer`` (gpt2-small, paged
                continuous batching) answers a burst of concurrent
                requests; kernel launch counts are zeroed just before and
                read just after, and every forward launch must be wgmma.
                Two more bursts are timed (median reported). Then a fp32
                engine's greedy tokens are held against ``gpt.generate``.
  6. train    — the other main path: ``train_step_mfu`` takes 8 AdamW
                steps of gpt2-small at B = 8, S = 1024 with the launch
                counts zeroed just before and read just after; every
                kernel must launch once per layer per step, all through
                the wgmma design.
  7. runtime  — the runtime core with the card as its ``GPU`` resource:
                ``rmt.init`` counts one GPU; the driver's device tier
                hands back the pinned tensor (same ``data_ptr``),
                ``consume`` kills the ref, and a tier bounded at three
                tensors demotes the least recently used one to the shm
                store when a fourth is pinned (``memory_allocated``
                falls by its bytes; the next get re-promotes it onto
                the card bit-equal); 256 MiB fp32 and bf16 CUDA tensors
                go through ``put``/``get`` bit-exact; a ``num_gpus=1``
                task runs the forward kernel on q, k, v passed as
                ObjectRefs (output bit-equal to the driver's own call,
                wgmma launches, ``CUDA_VISIBLE_DEVICES`` set to the
                driver's first visible device, "0" when the driver's is
                unset, and the worker's card the driver's by UUID); a
                GPU actor (``LLMServer`` with ``num_gpus=1``, on the
                driver's card by the same checks) serves
                ``phase_serve``'s burst with its launch counts zeroed
                just before and read just after, and its greedy tokens
                equal an in-process ``LLMServer``'s; after
                ``rmt.shutdown()`` no shm segment of this driver and no
                worker or zygote of the port is left.
  8. serve plane — the main path behind the serve API: in-process
                ``LLMServer``s of seed 0 (drawn, and from a bf16
                ``pack_weights`` payload of the same params) give the
                reference tokens and the cold starts; then ``rmt.init``
                with a 4 GiB shm store, ``serve.start`` and the HTTP
                proxy, and ``serve.run`` of ``llm_deployment("gpt2-small",
                ray_actor_options={"num_gpus": 1}, ship_weights="bf16")``
                with ``utils/runtime_smoke.ServedLLM`` in place of
                ``LLMServer`` (the same arguments and payload, plus reads
                of the replica's process). Held: one live replica on the
                driver's card by UUID; the payload equal to the
                in-process one; ``phase_serve``'s burst through
                ``handle.remote`` complete, KV pages at 0, the replica's
                forward launches (counts zeroed just before) >= 12 per
                request and all wgmma; greedy tokens of three prompts
                through the handle and through HTTP equal the in-process
                shipped server's; redeploying the same application keeps
                the replica (same pid, no second cold start); a
                deployment without ``ship_weights`` gives the in-process
                seed-0 server's tokens; nothing left behind after
                ``serve.shutdown()`` and ``rmt.shutdown()``.
  9. multinode — the multi-node runtime with the card on a node agent:
                ``rmt.init(num_gpus=0)`` (the head holds no card) and
                ``add_remote_node_process(num_gpus=1)``, an agent process
                on this host that holds it (cluster GPU 1, all on the
                agent). A ``num_gpus=1`` task runs the forward kernel on
                the agent, on q, k, v the driver put: it must run on the
                agent's node, with the lease the agent reported, on the
                driver's card by UUID, bit-equal to the driver's own call,
                every launch wgmma (first call and the warm median of ten
                timed). 256 MiB fp32 and bf16 CUDA tensors go driver →
                a GPU task on the agent → driver bit-equal, timed each
                way. A ``num_gpus=1`` actor pinned to the agent serves
                ``phase_serve``'s burst (KV pages back to 0, >= 12
                forward launches per request, all wgmma, greedy tokens
                equal to an in-process server's). Then the agent process
                is SIGKILLed: the actor's next call raises
                ``ActorDiedError`` and the cluster's GPU total reads 0;
                after ``rmt.shutdown()`` no ``rmtA_`` segment and no
                agent, worker or zygote process of the port is left.
  10. train plane — collectives, parallel strategies and Train on the
                card: ``rmt.init`` with a 6 GiB shm store (the
                checkpoint crosses it). (a) A ``num_gpus=1`` actor
                (``runtime_smoke.CollectiveProbe``, with
                ``CollectiveGroupMixin``) joins a world-1 ``dist`` group
                through ``create_collective_group``: NCCL, on the
                driver's card by UUID with the driver's lease. Every
                collective (allreduce sum/max/min/product, reducescatter,
                reduce in f32, bf16 and int8; allgather, broadcast,
                ppermute) runs on a 4 Mi-element CUDA tensor: f32
                bit-equal to the plain expectation, bf16 and int8 within
                the JAX test's envelopes (absmax x 2^-7 and absmax x
                0.75/127), each quantized call counted once in
                ``rmt_collective_quantized_ops_total``. (b) ``TorchTrainer``
                (``ScalingConfig(num_workers=1, use_gpu=True,
                gpus_per_worker=1, collective_backend="dist")``) runs
                ``runtime_smoke.train_loop``: ``make_mesh({"dp": 1})`` on
                cuda, ``param_pspecs``, ``shard_pytree``,
                ``make_train_step`` with AdamW, 8 steps of gpt2-small at
                B = 8, S = 1024 from phase 6's seed, launch counts zeroed
                just before the steps and read just after in the worker.
                Held: the worker's lease and card are the driver's; NCCL;
                each kernel launched 12 x 8 times, all wgmma; the losses
                finite and falling, the first equal to phase 6's to
                1e-5 relative and the eighth to 1e-3. The loop reports a
                checkpoint (parameters and AdamW state) at step 4. (c) A
                second ``fit(resume_from_checkpoint=...)`` runs steps
                4-7: its losses equal the first run's within the same
                tolerances. (d) After ``rmt.shutdown()`` no shm segment,
                worker or zygote of the port is left. Printed: the
                worker's cold start, step time, tokens/s and MFU beside
                phase 6's, ``fit()`` wall, the checkpoint's save seconds
                and bytes, and ``phase_s``.
  11. moe      — mixtral-tiny at full width (32k vocab, d_model 1024, 8
                layers, 16 heads of 64 over 4 kv heads, 8 experts top-2,
                capacity 1.25, groups of 256; random weights from a
                seed): (a) ``phase_serve``'s burst from a bf16
                ``LLMServer`` of 8 slots, the MoE FFN on prefill and
                decode, every forward launch wgmma; (b) ``train_step_mfu``
                takes 8 AdamW steps at B = 4, S = 2048 (each kernel 8 x 8
                launches, all wgmma, the loss finite and falling) and one
                step's gradients are held against ``attention="ref"``
                by phase 4's rule; (c) the ring's chunk schedule of an
                sp = 4 run in one process (``ring_schedule``: each rank's
                query chunk against the K/V chunks in ring order, merged
                by lse; per-chunk dq and dk/dv from the merged lse) at
                BH = 64, S = 2048, bf16, causal, through the kernels (10
                launches of each), against plain attention over the whole
                sequence.

It prints the card's name and power limit first, one JSON line of kernel
figures before the last line (the forward kernel runs on both main paths:
its entry gives the serving figures, and the training ones under keys
ending in ``_train``), and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA card, or run from a
directory that does not hold the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense tensor-core bf16
            "float32": 67e12}       # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# lse is fp32 from both sides (only the order of the sums differs)
LSE_TOL = dict(atol=1e-3, rtol=1e-4)
# backward: fp32 to 1e-4 (the same fp32 sums, possibly in another
# order); a bf16 output is one rounding (at most 2^-9 relative) of a fp32
# sum of up to 1024 terms, so it is held to twice that relative to |ref|,
# plus 1e-3 of the output's largest |ref| where the sum cancels to ~0
BWD_TOL = {"float32": dict(rtol=1e-4, atol_of_max=0.0, atol=1e-4),
           "bfloat16": dict(rtol=2.0 ** -8, atol_of_max=1e-3, atol=0.0)}
BH, HEAD_DIM = 12, 64               # gpt2-small: 12 heads of 64, one row
MAIN_CASE = ("bfloat16", 992, 992, True)  # the paged prefill's 992 bucket
TRAIN_B, TRAIN_S = 8, 1024          # the training batch of train_step_mfu
TRAIN_BH = TRAIN_B * 12             # attention rows per layer in training
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of one call from CUDA events around ``reps`` calls. It
    takes in the host's gaps between launches, so it reads host time where
    a call is short or is several launches behind Python; it is kept only
    under ``*_event_ms`` keys, beside :func:`device_ms`."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3, attempts: int = 5):
    """Mean device time of one call of ``fn``: the summed device time of
    the CUDA kernels (and copies and sets) in a ``torch.profiler`` trace of
    ``reps`` calls, over ``reps``. Returns (ms, names of the device rows).
    Each call launches the same kernels, so a complete trace has every
    row a multiple of ``reps`` times. On the H100 the profiler now and
    then returns a trace with no device rows, or with some calls' rows
    missing (18 of 20); such a trace is taken again, up to ``attempts``
    times, and then this raises: there is no fallback to events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_memory_management_tpu_torch.utils.profile_serve import (
        device_us, kernel_rows)

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        if rows and all(e.count % reps == 0 for e in rows):
            us = sum(device_us(e) for e in rows)
            return us / 1e3 / reps, sorted({e.key for e in rows})
        log(f"[profiler] trace {attempt} of {attempts} incomplete for {reps} "
            f"calls: {[(e.key[:40], e.count) for e in rows]}")
    raise AssertionError(f"device_ms: no complete profiler trace in "
                         f"{attempts} attempts")


def short_names(names, width=60):
    return ", ".join(n if len(n) <= width else n[:width] + "..."
                     for n in names)


def admitted_pairs(s, skv, causal):
    """(row, col) pairs of one head that the mask admits."""
    if not causal:
        return s * skv
    off = skv - s
    return sum(min(skv, max(0, r + off + 1)) for r in range(s))


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def attention_bound(bh, s, skv, d, causal, dtype_name, itemsize,
                    save_lse=False):
    """Least time (ms) for the forward: each of q, k, v, o (and lse) moved
    once, and the QK^T and PV products over the pairs the mask admits."""
    nbytes = (2 * bh * s * d + 2 * bh * skv * d) * itemsize
    nbytes += 4 * bh * s if save_lse else 0
    ops = 4 * bh * admitted_pairs(s, skv, causal) * d
    return _bound(nbytes, ops, dtype_name)


def backward_bound(kernel, bh, s, skv, d, causal, dtype_name, itemsize):
    """Least time (ms) for one backward kernel. dq reads q, dO, k, v, lse
    and delta and writes dq, and runs 3 products (QK^T, dO V^T, ds K) over
    the admitted pairs; dk/dv reads the same and writes dk and dv, and
    runs 4 (QK^T, dO V^T, p^T dO, ds^T Q)."""
    rows_s, rows_kv, products = ((3, 2, 3) if kernel == "dq" else (2, 4, 4))
    nbytes = (rows_s * bh * s * d + rows_kv * bh * skv * d) * itemsize
    nbytes += 2 * 4 * bh * s  # lse and delta, fp32
    ops = 2 * products * bh * admitted_pairs(s, skv, causal) * d
    return _bound(nbytes, ops, dtype_name)


def bwd_close(got, ref, dtype_name, scale=1):
    """(max abs error, worst error over its limit, ok) under ``scale``
    times BWD_TOL for one backward output; ok iff that ratio is at most
    1."""
    t = BWD_TOL[dtype_name]
    err = (got.float() - ref).abs()
    limit = scale * (t["atol"] + t["atol_of_max"] * ref.abs().max()
                     + t["rtol"] * ref.abs())
    # 0 / 0 counts as 0: an output that is exactly 0 where the bound is 0
    ratio = (err / limit).masked_fill(err == 0, 0.0).max().item()
    return err.max().item(), ratio, bool((err <= limit).all())


# ------------------------------------------------------------------ phases
def phase_build():
    """One nvcc per source, all started together; returns the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_memory_management_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_build.build, SOURCES))
    wall = time.perf_counter() - t0
    for name, (path, seconds, compiler_out) in zip(SOURCES, built):
        for line in compiler_out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
        log(f"[build] {name}: {path.name}, nvcc {seconds:.2f} s")
    log(f"[build] {len(SOURCES)} libraries in {wall:.2f} s wall")
    return wall


def _sdpa_kwargs(device, s, skv, causal):
    import torch

    if causal and s != skv:  # SDPA aligns is_causal top-left
        mask = (torch.arange(skv, device=device)[None, :]
                <= torch.arange(s, device=device)[:, None] + (skv - s))
        return {"attn_mask": mask}
    return {"is_causal": causal}


def phase_kernels(device):
    """The forward kernel, o and lse, in every case, each case launched
    through the main path's dispatch and checked for the design it took;
    timed (profiler device time) beside its plain version, SDPA and its
    bound; at the serving main case and the training shape also the SIMT
    design in turns with the wgmma one (prev, new, new, prev). Returns
    (rows, serving main row, training shape row)."""
    import torch
    import torch.nn.functional as F

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_simt, fwd_design,
        fwd_design_counts, reference_attention, reference_lse,
        reset_launch_count)

    cases = []
    for dtype_name in ("float32", "bfloat16"):
        for s in (64, 992, 1024):
            for causal in (True, False):
                cases.append((dtype_name, BH, s, s, HEAD_DIM, causal))
        for s, skv in ((64, 1024), (992, 1024)):
            cases.append((dtype_name, BH, s, skv, HEAD_DIM, True))
    cases += [("bfloat16", BH, 992, 992, 128, True),    # D = 128
              ("bfloat16", BH, 1000, 1000, HEAD_DIM, True)]  # ragged S
    train_case = ("bfloat16", TRAIN_BH, TRAIN_S, TRAIN_S, HEAD_DIM, True)
    cases.append(train_case)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, main, train = [], None, None
    for case in cases:
        dtype_name, bh, s, skv, d, causal = case
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=gen,
                               device=device).to(dtype)

        q, k, v = rand(s), rand(skv), rand(skv)
        design = fwd_design(dtype, d)
        reset_launch_count()
        out, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
        torch.cuda.synchronize()
        designs = fwd_design_counts()
        # the plain version in fp32 on the same values: the kernel
        # computes in fp32 and rounds its output to the input dtype (the
        # wgmma design also rounds p to bf16 before P V)
        ref = reference_attention(q.float(), k.float(), v.float(), causal)
        ref_lse = reference_lse(q.float(), k.float(), causal)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL[dtype_name]
        ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)
                  and torch.allclose(lse, ref_lse, **LSE_TOL)
                  and designs[design] == 1 and sum(designs.values()) == 1)
        save = case == train_case

        def kernel():
            return flash_attention_fwd(q, k, v, causal=causal,
                                       save_lse=save)

        def prev():
            return flash_attention_fwd_simt(q, k, v, causal=causal,
                                            save_lse=save)

        b = bh // BH  # [B, 12 heads, S, D] for SDPA
        kw = _sdpa_kwargs(device, s, skv, causal)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.view(b, -1, s, d), k.view(b, -1, skv, d),
                v.view(b, -1, skv, d), **kw)

        timed = {}
        is_main = ((dtype_name, s, skv, causal) == MAIN_CASE and bh == BH
                   and d == HEAD_DIM)
        compare = is_main or save
        if compare:  # the SIMT design in turns with the wgmma one
            order = (("prev", prev), ("new", kernel), ("new", kernel),
                     ("prev", prev))
            for name, fn in order:
                timed.setdefault(name, []).append(device_ms(fn)[0])
            kernel_ms = sum(timed["new"]) / 2
        else:
            kernel_ms = device_ms(kernel)[0]
        plain_ms = device_ms(
            lambda: (reference_attention(q, k, v, causal),
                     reference_lse(q, k, causal) if save else None),
            reps=5)[0]
        library_ms, library_kernels = device_ms(sdpa)
        bound_ms, bound_by, nbytes, ops = attention_bound(
            bh, s, skv, d, causal, dtype_name, q.element_size(),
            save_lse=save)
        row = dict(dtype=dtype_name, BH=bh, S=s, Skv=skv, D=d,
                   causal=causal, save_lse=save, design=design,
                   designs=designs, max_abs_err=err,
                   lse_max_abs_err=lse_err, tol=tol, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_kernels=library_kernels,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   ops=ops, tflops=ops / (kernel_ms * 1e-3) / 1e12)
        extra = ""
        if compare:
            row["kernel_event_ms"] = cuda_time_ms(kernel)
            row["library_event_ms"] = cuda_time_ms(sdpa)
            row["prev_ms"] = sum(timed["prev"]) / 2
            row["prev_tflops"] = ops / (row["prev_ms"] * 1e-3) / 1e12
            row["turns_ms"] = timed
            extra = (f" [turns prev {timed['prev'][0]:.4f} new "
                     f"{timed['new'][0]:.4f} new {timed['new'][1]:.4f} prev "
                     f"{timed['prev'][1]:.4f}] prev_ms={row['prev_ms']:.4f} "
                     f"({row['prev_tflops']:.1f} TFLOP/s) event_ms kernel "
                     f"{row['kernel_event_ms']:.4f} sdpa "
                     f"{row['library_event_ms']:.4f}; sdpa kernels: "
                     f"{short_names(library_kernels)}")
        rows.append(row)
        log(f"[kernels] flash_fwd {dtype_name:8s} BH={bh} S={s:4d} "
            f"Skv={skv:4d} D={d} causal={causal!s:5s} design={design} "
            f"max_abs_err={err:.3e} (tol {tol:g}, atol=rtol) "
            f"lse_err={lse_err:.2e} {'ok' if ok else 'FAIL'} "
            f"kernel_ms={kernel_ms:.4f}{' (lse)' if save else ''} "
            f"({row['tflops']:.1f} TFLOP/s) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({bound_by}){extra}")
        if is_main:
            main = row
        if save:
            train = row
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"or took another design in {len(bad)} "
                             f"case(s): {bad}")
    return rows, main, train


def phase_backward(device):
    """dq and dk/dv kernels against ``reference_flash_bwd`` (in fp32 on the
    same values, with o and lse from the forward kernel), each case
    checked for the design it took; then, at the main backward case, each
    kernel timed in turns with its SIMT design (prev, new, new, prev),
    beside its plain version, its bound and the SDPA backward of the
    pair."""
    import torch
    import torch.nn.functional as F

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        DKV, DQ, SIMT, WGMMA, bwd_design, bwd_design_counts,
        flash_attention_bwd,
        flash_attention_dkv, flash_attention_dkv_simt, flash_attention_dq,
        flash_attention_dq_simt, flash_attention_fwd, reference_delta,
        reference_flash_bwd, reference_flash_dkv, reference_flash_dq,
        reference_lse, reset_launch_count)

    main_case = ("bfloat16", TRAIN_BH, TRAIN_S, TRAIN_S, HEAD_DIM, True)
    cases = [main_case, ("float32",) + main_case[1:]]
    for dtype_name in ("bfloat16", "float32"):
        cases += [(dtype_name, BH, 1024, 1024, HEAD_DIM, False),
                  (dtype_name, BH, 64, 1024, HEAD_DIM, True),
                  (dtype_name, BH, 992, 1024, HEAD_DIM, True),
                  (dtype_name, BH, 67, 67, HEAD_DIM, True),
                  (dtype_name, BH, 131, 131, HEAD_DIM, False),
                  (dtype_name, BH, 1000, 1000, HEAD_DIM, True),
                  (dtype_name, BH, 1, 77, HEAD_DIM, True),
                  (dtype_name, BH, 96, 160, 128, True)]
    gen = torch.Generator(device=device).manual_seed(1)
    rows, main = [], None
    for case in cases:
        dtype_name, bh, s, skv, d, causal = case
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=gen,
                               device=device).to(dtype)

        q, k, v, do = rand(s), rand(skv), rand(skv), rand(s)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
        design = bwd_design(dtype, d)
        reset_launch_count()
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        designs = bwd_design_counts()
        other = SIMT if design == WGMMA else WGMMA
        design_ok = all(designs[n] == {design: 1, other: 0}
                        for n in (DQ, DKV))
        want = reference_flash_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal)
        checks = [bwd_close(g, w, dtype_name) for g, w in zip(got, want)]
        lse_ok = bool(torch.allclose(
            lse, reference_lse(q.float(), k.float(), causal), **LSE_TOL))
        ok = lse_ok and design_ok and all(c[2] for c in checks)
        errs = {f"d{n}": c[0] for n, c in zip("qkv", checks)}
        ratios = {f"d{n}_over_limit": c[1] for n, c in zip("qkv", checks)}
        row = dict(dtype=dtype_name, BH=bh, S=s, Skv=skv, D=d,
                   causal=causal, design=design, designs=designs, ok=ok,
                   lse_ok=lse_ok, **errs, **ratios)
        del want
        if case == main_case:
            delta = reference_delta(o, do)

            def dq():
                return flash_attention_dq(q, k, v, do, lse, delta, causal)

            def dkv():
                return flash_attention_dkv(q, k, v, do, lse, delta, causal)

            def dq_prev():
                return flash_attention_dq_simt(q, k, v, do, lse, delta,
                                               causal)

            def dkv_prev():
                return flash_attention_dkv_simt(q, k, v, do, lse, delta,
                                                causal)

            # the SIMT design in turns with the wgmma one, per kernel
            for kernel, new, prev in (("dq", dq, dq_prev),
                                      ("dkv", dkv, dkv_prev)):
                timed = {}
                for name, fn in (("prev", prev), ("new", new),
                                 ("new", new), ("prev", prev)):
                    timed.setdefault(name, []).append(device_ms(fn)[0])
                row[f"{kernel}_ms"] = sum(timed["new"]) / 2
                row[f"{kernel}_prev_ms"] = sum(timed["prev"]) / 2
                row[f"{kernel}_turns_ms"] = timed
            row["dq_event_ms"] = cuda_time_ms(dq)
            row["dkv_event_ms"] = cuda_time_ms(dkv)
            row["dq_plain_ms"] = device_ms(lambda: reference_flash_dq(
                q, k, v, do, lse, delta, causal), reps=5)[0]
            row["dkv_plain_ms"] = device_ms(lambda: reference_flash_dkv(
                q, k, v, do, lse, delta, causal), reps=5)[0]
            # the yardstick: SDPA's backward for the pair (dq, dk, dv
            # together) on a retained graph; only the backward is traced
            b = bh // 12
            leaves = [t.view(b, 12, -1, d).detach().requires_grad_()
                      for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            do4 = do.view(b, 12, s, d)

            def pair():
                return torch.autograd.grad(out, leaves, do4,
                                           retain_graph=True)

            row["pair_library_ms"], row["pair_library_kernels"] = (
                device_ms(pair))
            row["pair_library_event_ms"] = cuda_time_ms(pair)
            for kernel in ("dq", "dkv"):
                bound_ms, bound_by, nbytes, ops = backward_bound(
                    kernel, bh, s, skv, d, causal, dtype_name,
                    q.element_size())
                row[f"{kernel}_bound_ms"] = bound_ms
                row[f"{kernel}_bound_by"] = bound_by
                row[f"{kernel}_bytes"], row[f"{kernel}_ops"] = nbytes, ops
                # the function's products (3 and 4), not the split's 4, 6
                for key in ("", "prev_"):
                    row[f"{kernel}_{key}tflops"] = (
                        ops / (row[f"{kernel}_{key}ms"] * 1e-3) / 1e12)
            main = row
            del out, leaves
        rows.append(row)
        timing = "".join(
            f" {n}_ms={row[f'{n}_ms']:.4f} ({row[f'{n}_tflops']:.1f} "
            f"TFLOP/s; turns prev {row[f'{n}_turns_ms']['prev'][0]:.4f} "
            f"new {row[f'{n}_turns_ms']['new'][0]:.4f} new "
            f"{row[f'{n}_turns_ms']['new'][1]:.4f} prev "
            f"{row[f'{n}_turns_ms']['prev'][1]:.4f}; prev_ms "
            f"{row[f'{n}_prev_ms']:.4f}, plain {row[f'{n}_plain_ms']:.4f}, "
            f"bound {row[f'{n}_bound_ms']:.5f} {row[f'{n}_bound_by']})"
            for n in ("dq", "dkv")) if case == main_case else ""
        timing += (f" sdpa_bwd_pair_ms={row['pair_library_ms']:.4f} "
                  f"(event_ms dq {row['dq_event_ms']:.4f} dkv "
                  f"{row['dkv_event_ms']:.4f} sdpa pair "
                  f"{row['pair_library_event_ms']:.4f}; sdpa kernels: "
                  f"{short_names(row['pair_library_kernels'])})"
                  if case == main_case else "")
        log(f"[kernels] flash_bwd {dtype_name:8s} BH={bh} S={s:4d} "
            f"Skv={skv:4d} D={d} causal={causal!s:5s} design={design} "
            f"max_abs_err "
            + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
            + " err/limit " + " ".join(f"{c[1]:.3f}" for c in checks)
            + f" lse {'ok' if lse_ok else 'FAIL'} "
            f"{'ok' if ok else 'FAIL'}{timing}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_bwd disagrees with its plain version "
                             f"or took another design in {len(bad)} "
                             f"case(s): {bad}")
    return rows, main


def phase_forward(device, preset="gpt2-small", batch=8, seq=1024):
    """Full-width forward with the kernel vs attention="ref". bf16 is held
    to the plain path's own rounding noise (its distance to the fp32
    model, times two); fp32 to a fixed tolerance."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        fwd_design_counts, launch_count, reset_launch_count)

    cfg = gpt.PRESETS[preset]
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init_params(cfg, gen, device)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    with torch.inference_mode():
        reset_launch_count()
        t0 = time.perf_counter()
        logits = gpt.forward(params, toks, cfg)
        sync()
        fwd_s = time.perf_counter() - t0
        launches = launch_count()
        designs = fwd_design_counts()
        ref = gpt.forward(params, toks, dataclasses.replace(
            cfg, attention="ref"))
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref32 = gpt.forward(params, toks, dataclasses.replace(
            f32, attention="ref"))
        ker32 = gpt.forward(params, toks, f32)
        sync()
    err = (logits - ref).abs().max().item()
    floor = (ref - ref32).abs().max().item()
    err32 = (ker32 - ref32).abs().max().item()
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(ker32).all())
    shape_ok = tuple(logits.shape) == (batch, seq, cfg.vocab_size)
    tol32 = 1e-3
    log(f"[forward] {preset} B={batch} S={seq}: bf16 kernel-vs-ref "
        f"max_abs_err={err:.4e} (limit 2 x bf16 noise floor "
        f"{floor:.4e}); fp32 kernel-vs-ref max_abs_err={err32:.3e} "
        f"(tol {tol32:g}); flash launches={launches} {designs} "
        f"(expect {cfg.n_layers}, all wgmma); first bf16 forward "
        f"{fwd_s * 1e3:.1f} ms")
    if not (finite and shape_ok):
        raise AssertionError("forward logits are not finite or misshaped")
    if err > 2 * floor or err32 > tol32:
        raise AssertionError("forward with the kernel disagrees with "
                             "attention='ref'")
    if device.type == "cuda" and (launches != cfg.n_layers
                                  or designs["wgmma"] != cfg.n_layers):
        raise AssertionError(f"expected {cfg.n_layers} flash launches, all "
                             f"wgmma, got {launches} {designs}")
    return dict(err=err, floor=floor, err32=err32, launches=launches,
                designs=designs)


def phase_grad(device, preset="gpt2-small", batch=TRAIN_B, seq=TRAIN_S):
    """Full-width gradients of ``loss_fn`` with the kernels vs
    attention="ref". fp32 is held to 1e-3 of each leaf's largest
    gradient; bf16 to twice the plain path's own rounding noise (its
    distance to the fp32 model), leaf by leaf. A MoE model's routing is
    discontinuous: a rounding-sized change of a router input can move a
    token to another expert, which moves its gradient wholesale. The
    fp32 kernel run therefore replays the fp32 "ref" run's expert
    choices, so that the fp32 rule measures the kernels alone; the
    tokens whose own choice differed are counted and printed. (The bf16
    rule's floor, bf16 against fp32, holds such moves already.)"""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reset_launch_count)
    from ray_memory_management_tpu_torch.ops.moe import pinned_routing
    from ray_memory_management_tpu_torch.utils import gpu_bench

    cfg = dataclasses.replace(gpt.PRESETS[preset], attention="flash")
    gen = torch.Generator(device=device).manual_seed(2)
    params = gpt.init_params(cfg, gen, device)
    data = gpu_bench.make_batch(cfg, batch, seq, gen, device)
    leaves = [t.requires_grad_() for t in gpt.param_leaves(params)]
    names = [f"{k}.{n}" if isinstance(v, dict) else k
             for k, v in params.items()
             for n in (v if isinstance(v, dict) else [None])]

    def grads(c):
        loss = gpt.loss_fn(params, data, c)
        return loss.item(), torch.autograd.grad(loss, leaves)

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    reset_launch_count()
    loss_k, gk = grads(cfg)
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    loss_r, gr = grads(dataclasses.replace(cfg, attention="ref"))
    choices, flips = [], []
    with pinned_routing(record=choices):
        loss_r32, gr32 = grads(dataclasses.replace(f32, attention="ref"))
    with pinned_routing(replay=choices, flips=flips):
        loss_k32, gk32 = grads(f32)
    torch.cuda.synchronize()
    tol32, rows = 1e-3, []
    for name, a, b, c, d in zip(names, gk, gr, gr32, gk32):
        scale = c.abs().max().item()
        rows.append(dict(leaf=name, err=(a - b).abs().max().item(),
                         floor=(b - c).abs().max().item(),
                         err32=(d - c).abs().max().item(), scale32=scale,
                         finite=bool(torch.isfinite(a).all()
                                     and torch.isfinite(d).all())))
    moved = int(sum(flips))
    bf16_ok = all(r["err"] <= 2 * r["floor"] for r in rows)
    fp32_ok = all(r["err32"] <= tol32 * r["scale32"] for r in rows)
    finite = all(r["finite"] for r in rows)
    worst = max(rows, key=lambda r: r["err"] / r["floor"])
    worst32 = max(rows, key=lambda r: r["err32"] / r["scale32"])
    log(f"[grad] {preset} B={batch} S={seq}: loss bf16 kernel {loss_k:.5f} "
        f"ref {loss_r:.5f}, fp32 kernel {loss_k32:.6f} ref {loss_r32:.6f}; "
        f"bf16 worst leaf {worst['leaf']} max_abs_err={worst['err']:.3e} "
        f"(limit 2 x bf16 noise floor {worst['floor']:.3e}); fp32 worst "
        f"leaf {worst32['leaf']} max_abs_err={worst32['err32']:.3e} "
        f"(tol {tol32:g} x max|grad| {worst32['scale32']:.3e}"
        + (f", routing replayed: {moved} of "
           f"{sum(c.numel() for c in choices)} fp32 kernel choices differed"
           if cfg.n_experts else "") + "); launches "
        f"{launches} forward {designs} backward {bwd_designs} (expect "
        f"{cfg.n_layers} each, all wgmma)")
    if not finite:
        raise AssertionError("grad: non-finite gradients")
    if not (bf16_ok and fp32_ok):
        raise AssertionError(f"grad: gradients with the kernels disagree "
                             f"with attention='ref': {rows}")
    if (any(n != cfg.n_layers for n in launches.values())
            or designs["wgmma"] != cfg.n_layers
            or any(c["wgmma"] != cfg.n_layers
                   for c in bwd_designs.values())):
        raise AssertionError(f"grad: launches {launches} {designs} "
                             f"{bwd_designs}, expected {cfg.n_layers} of "
                             f"each kernel, all wgmma")
    return dict(loss_bf16=loss_k, loss_ref_bf16=loss_r, loss_fp32=loss_k32,
                loss_ref_fp32=loss_r32, worst_bf16=worst, worst_fp32=worst32,
                routing_flips_fp32=moved,
                launches=launches, designs=designs, bwd_designs=bwd_designs)


def _serve_requests(vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    # a few tokens up to past the 992 cap (clipped into the 992 bucket)
    lens = (5, 40, 64, 100, 250, 513, 800, 991, 1000)
    reqs = [{"tokens": rng.integers(2, vocab, size=n).tolist()}
            for n in lens]
    reqs.append({"text": "The port serves GPT-2 small on one card."})
    return reqs


def _burst(srv, reqs):
    """Send every request from its own thread at once; return (results,
    per-request latencies in s, wall s, errors, requests still hung)."""
    results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []

    def call(i):
        t0 = time.perf_counter()
        try:
            results[i] = srv(reqs[i])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    return results, lat, wall, errors, sum(t.is_alive() for t in threads)


def phase_serve(device, preset="gpt2-small", max_batch_size=8,
                max_new_tokens=32, seed=0, bursts=3):
    """The main path, driven once with the launch counts zeroed around it,
    then ``bursts - 1`` more times for timing only (host time varies from
    run to run; the median burst is reported, every burst is printed)."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        fwd_design_counts, launch_count, reset_launch_count)
    from ray_memory_management_tpu_torch.serve.llm import LLMServer

    srv = LLMServer(preset=preset, max_batch_size=max_batch_size,
                    max_new_tokens=max_new_tokens, batching="continuous",
                    kv_cache="paged", seed=seed,
                    device=None if device.type == "cuda" else device)
    try:
        srv({"tokens": [5, 6, 7]})  # warm-up: allocator, cuBLAS handles
        reqs = _serve_requests(srv.cfg.vocab_size, seed)
        reset_launch_count()
        runs = [_burst(srv, reqs)]
        launches = launch_count()
        designs = fwd_design_counts()
        stats = srv.stats()
        runs += [_burst(srv, reqs) for _ in range(bursts - 1)]
    finally:
        srv.close()
    if any(errors or hung for _, _, _, errors, hung in runs):
        raise AssertionError(f"serve: failed or hung requests: "
                             f"{[(r[3], r[4]) for r in runs]}")
    results = runs[0][0]
    gen_tokens = sum(len(r["tokens"]) for r in results)
    answers = [r for run in runs for r in run[0]]
    budget_ok = all(len(r["tokens"]) == max_new_tokens for r in answers)
    vocab_ok = all(0 <= t < srv.cfg.vocab_size
                   for r in answers for t in r["tokens"])
    pages = stats["kv"]["pages_in_use"]
    need = srv.cfg.n_layers * len(reqs)
    walls = [w for _, _, w, _, _ in runs]
    wall = float(np.median(walls))
    lat_ms = sorted(x * 1e3 for _, lat, _, _, _ in runs for x in lat)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    log(f"[serve] {preset} on {where}, paged continuous, {len(reqs)} "
        f"concurrent requests (prompt lens "
        f"{[r['prompt_len'] for r in results]}), "
        f"{len(runs)} bursts: walls {[round(w, 3) for w in walls]} s; "
        f"median {len(reqs) / wall:.2f} requests/s, "
        f"{gen_tokens / wall:.1f} generated tokens/s; latency over "
        f"{len(lat_ms)} requests median {float(np.median(lat_ms)):.1f} ms "
        f"max {lat_ms[-1]:.1f} ms; flash launches in the first burst="
        f"{launches} {designs} (need >= {need}, all wgmma); pages_in_use "
        f"after it={pages}; "
        f"kv_backpressure={stats['kv']['kv_backpressure']}")
    if not (budget_ok and vocab_ok):
        raise AssertionError("serve: a request missed its token budget or "
                             "returned ids outside the vocabulary")
    if pages != 0:
        raise AssertionError(f"serve: {pages} KV pages still in use")
    if device.type == "cuda" and launches < need:
        raise AssertionError(f"serve: {launches} flash launches, fewer than "
                             f"one per layer per request ({need})")
    if device.type == "cuda" and designs["wgmma"] != launches:
        raise AssertionError(f"serve: flash launches by design {designs}; "
                             f"every one of {launches} should be wgmma")
    return dict(launches=launches, designs=designs, walls_s=walls,
                requests_per_s=len(reqs) / wall,
                tokens_per_s=gen_tokens / wall, requests=len(reqs),
                latency_ms_median=float(np.median(lat_ms)),
                latency_ms_max=lat_ms[-1])


def phase_engine_parity(device, preset="gpt2-small", new_tokens=8):
    """fp32 engine at full width vs per-prompt ``gpt.generate``: the
    batched, paged, bucketed path must give the same greedy tokens."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.serve.llm import ContinuousBatcher

    cfg = dataclasses.replace(gpt.PRESETS[preset], dtype=torch.float32)
    params = gpt.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(1), device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab_size,
                            size=min(n, cfg.max_seq - new_tokens)).tolist()
               for n in (7, 130, 991)]
    eng = ContinuousBatcher(params, cfg, max_slots=4,
                            max_new_tokens=new_tokens, kv_cache="paged")
    try:
        got = [None] * len(prompts)

        def call(i):
            got[i] = eng.submit(prompts[i], timeout=600)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        eng.close()
    with torch.inference_mode():
        want = [gpt.generate(params, cfg, torch.tensor([p], device=device),
                             new_tokens)[0, len(p):].tolist()
                for p in prompts]
    same = got == want
    log(f"[serve] fp32 engine vs gpt.generate, prompt lens "
        f"{[len(p) for p in prompts]}: greedy tokens "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"engine tokens {got} != generate {want}")


def phase_train(device, steps=8, preset="gpt2-small", batch=TRAIN_B,
                seq=TRAIN_S):
    """The training main path: ``train_step_mfu`` (gpt2-small, B = 8,
    S = 1024, AdamW, unless told otherwise) with the launch counts zeroed
    just before its steps and read just after."""
    import math

    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reset_launch_count)
    from ray_memory_management_tpu_torch.utils.gpu_bench import (
        train_step_mfu)

    n_layers = gpt.PRESETS[preset].n_layers
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_count()
    r = train_step_mfu(preset, batch_size=batch, seq_len=seq, steps=steps,
                       device=device)
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    losses = r["losses"]
    log(f"[train] {preset} B={batch} S={seq} on {r['device']}: "
        f"{steps} AdamW steps, losses {[round(x, 4) for x in losses]}; "
        f"step_ms={r['step_ms']:.2f} tokens_per_s={r['tokens_per_s']:.1f} "
        f"mfu={r['mfu']:.4f} (PaLM accounting, 989 TFLOP/s peak) "
        f"n_params={r['n_params']} peak_mem={peak_gb:.2f} GB; launches "
        f"{launches} forward {designs} backward {bwd_designs} (need "
        f"{n_layers * steps} each, all wgmma)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train: non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if (any(n != n_layers * steps for n in launches.values())
            or designs["wgmma"] != n_layers * steps
            or any(c["wgmma"] != n_layers * steps
                   for c in bwd_designs.values())):
        raise AssertionError(f"train: launches {launches} {designs} "
                             f"{bwd_designs}, expected {n_layers * steps} "
                             f"of each kernel, all wgmma")
    return dict(r, launches=launches, designs=designs,
                bwd_designs=bwd_designs, peak_mem_gb=peak_gb)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    """Bytes the caching allocator holds in live tensors, after the
    queued work is done."""
    import torch

    _sync(device)
    return torch.cuda.memory_allocated(device)


def _bits(t):
    """A tensor's raw bits, for bit-exact comparison (NaN-safe)."""
    import torch

    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[
                                    t.element_size()])


def _bit_equal(a, b) -> bool:
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a.cpu()), _bits(b.cpu())))


def _runtime_device_tier(device, rt, n):
    """Driver device tier: zero-copy get, consume, then LRU demotion of
    a tier bounded at three tensors of ``n`` fp32 values and
    re-promotion onto the card."""
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.exceptions import ObjectLostError

    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn(n, device=device, generator=gen)
    ptr = x.data_ptr()
    ref = rmt.put(x, device=True)
    got = rmt.get(ref)
    if got is not x or got.data_ptr() != ptr:
        raise AssertionError("runtime: device-tier get is not the pinned "
                             "tensor")
    del got
    taken = rmt.get(ref, consume=True)
    if taken.data_ptr() != ptr or rt.device_store.contains(ref.binary()):
        raise AssertionError("runtime: consume did not hand over the "
                             "pinned tensor")
    try:
        rmt.get(ref, timeout=5)
    except ObjectLostError:
        pass
    else:
        raise AssertionError("runtime: a consumed ref is still readable")
    del x, taken, ref

    nbytes = n * 4
    refs, first = [], None
    for i in range(3):
        t = torch.randn(n, device=device, generator=gen)
        if i == 0:
            first = t.cpu()
        refs.append(rmt.put(t, device=True))
        del t
    fourth = torch.randn(n, device=device, generator=gen)
    before = _allocated(device)
    refs.append(rmt.put(fourth, device=True))
    del fourth
    after = _allocated(device)
    demoted = not rt.device_store.contains(refs[0].binary())
    resident = rt.device_store.count()
    back = rmt.get(refs[0])
    repromoted = rt.device_store.contains(refs[0].binary())
    ok = (demoted and resident == 3 and before - after == nbytes
          and back.device.type == device.type and _bit_equal(back, first)
          and repromoted)
    log(f"[runtime] device tier: get returns the pinned tensor (same "
        f"data_ptr), consume hands it over and kills the ref; a tier of "
        f"3 x {nbytes / 2**20:.0f} MiB demoted the LRU tensor to shm when "
        f"a fourth was pinned: demoted={demoted} resident={resident} "
        f"memory_allocated fell {before - after} bytes (want {nbytes}); "
        f"next get on {back.device} bit-equal={_bit_equal(back, first)} "
        f"re-promoted={repromoted}")
    if not ok:
        raise AssertionError("runtime: device-tier demotion or "
                             "re-promotion failed")
    del back, refs


def _runtime_host_path(device, nbytes=256 << 20, reps=3):
    """CUDA tensors through the host object plane (device→host copy,
    shm store, host→device copy): bit-exact, with put and get GB/s."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt

    gen = torch.Generator(device=device).manual_seed(12)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = nbytes // torch.tensor([], dtype=dtype).element_size()
        x = torch.randn(n, device=device, generator=gen).to(dtype)
        puts, gets = [], []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            ref = rmt.put(x)
            puts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            y = rmt.get(ref)
            _sync(device)
            gets.append(time.perf_counter() - t0)
            if not (y.device.type == device.type and _bit_equal(y, x)):
                raise AssertionError(f"runtime: a {dtype} CUDA tensor did "
                                     f"not come back bit-equal on cuda "
                                     f"(got {y.device})")
            del ref, y
        name = str(dtype).removeprefix("torch.")
        out[name] = dict(put_gb_s=nbytes / float(np.median(puts)) / 1e9,
                         get_gb_s=nbytes / float(np.median(gets)) / 1e9,
                         put_s=puts, get_s=gets)
        log(f"[runtime] host path {name} {nbytes >> 20} MiB: bit-equal on "
            f"{device.type}; put {out[name]['put_gb_s']:.2f} GB/s, get "
            f"{out[name]['get_gb_s']:.2f} GB/s (median of {reps}; puts "
            f"{[round(t, 4) for t in puts]} s, gets "
            f"{[round(t, 4) for t in gets]} s)")
        del x
    return out


def _runtime_gpu_task(device, warm=10, lease=None, node=None,
                      tag="runtime"):
    """A ``num_gpus=1`` task runs the forward kernel in its worker on
    q, k, v passed as ObjectRefs at the serving prefill shape. ``lease``
    is the ``CUDA_VISIBLE_DEVICES`` the worker must see (default: the
    driver's first card) and ``node`` the node it must run on (default:
    any)."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        flash_attention)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v = (torch.randn(BH, MAIN_CASE[1], HEAD_DIM, device=device,
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    refs = [rmt.put(t) for t in (q, k, v)]
    attend = rmt.remote(runtime_smoke.attend).options(num_gpus=1)
    t0 = time.perf_counter()
    first = rmt.get(attend.remote(*refs), timeout=600)
    first_s = time.perf_counter() - t0
    warm_s = []
    for _ in range(warm):
        t0 = time.perf_counter()
        rmt.get(attend.remote(*refs), timeout=600)
        warm_s.append(time.perf_counter() - t0)
    with torch.inference_mode():
        want = flash_attention(q, k, v, causal=True)
    out = first["out"]
    launches = first["launches"]["flash_attention_fwd"]
    driver_lease, uuid = _driver_card(device)
    lease = driver_lease if lease is None else lease
    on_node = node is None or first["node_id"] == node.hex()
    ok = (out.device.type == device.type and _bit_equal(out, want)
          and launches >= 1 and first["designs"]["wgmma"] == launches
          and first["cuda_visible_devices"] == lease
          and first["device_uuid"] == uuid and on_node)
    where = "" if node is None else (
        f" on node {first['node_id'][:8]} (want {node.hex()[:8]})")
    log(f"[{tag}] GPU task (num_gpus=1){where} flash_attention bf16 BH={BH} "
        f"S={MAIN_CASE[1]} D={HEAD_DIM} causal from ObjectRefs: output on "
        f"{out.device} bit-equal to the driver's call="
        f"{_bit_equal(out, want)}; worker CUDA_VISIBLE_DEVICES="
        f"{first['cuda_visible_devices']!r} (want {lease!r}), its card "
        f"the driver's={first['device_uuid'] == uuid}, launches "
        f"{first['launches']} "
        f"{first['designs']}; first call {first_s:.3f} s (spawn, torch "
        f"import, CUDA init, library load), warm median "
        f"{float(np.median(warm_s)) * 1e3:.1f} ms over {warm}")
    if not ok:
        raise AssertionError(f"{tag}: the GPU task's kernel call failed "
                             "its checks")
    return dict(first_s=first_s, warm_ms_median=float(np.median(warm_s))
                * 1e3, warm_s=warm_s, launches=launches,
                designs=first["designs"])


def _runtime_actor(device, serve, preset="gpt2-small", max_batch_size=8,
                   max_new_tokens=32, seed=0, lease=None, node=None,
                   tag="runtime", keep=False):
    """A GPU actor serving gpt2-small: ``phase_serve``'s burst through
    ``.generate.remote``, then greedy parity with an in-process
    ``LLMServer`` of the same seed, one prompt at a time. ``lease`` and
    ``node`` as for ``_runtime_gpu_task`` (a ``node`` also pins the
    actor there); with ``keep`` the live actor is returned under
    ``"actor"`` instead of killed."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.serve.llm import (
        LLMServer, _bytes_tokenize)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    cfg = gpt.PRESETS[preset]
    opts = dict(num_gpus=1, max_concurrency=16)
    if node is not None:
        from ray_memory_management_tpu_torch.core.scheduling_strategies \
            import NodeAffinitySchedulingStrategy

        opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
            node_id=node, soft=False)
    served = rmt.remote(runtime_smoke.ServedLLM).options(**opts)
    t0 = time.perf_counter()
    actor = served.remote(preset=preset, max_batch_size=max_batch_size,
                          max_new_tokens=max_new_tokens, seed=seed)
    rmt.get(actor.generate.remote([5, 6, 7]), timeout=600)  # warm-up
    start_s = time.perf_counter() - t0
    prompts = [r["tokens"] if "tokens" in r
               else _bytes_tokenize(r["text"], cfg.vocab_size)
               for r in _serve_requests(cfg.vocab_size, seed)]
    rmt.get(actor.reset_counters.remote(), timeout=60)
    t0 = time.perf_counter()
    outs = rmt.get([actor.generate.remote(p) for p in prompts], timeout=600)
    wall = time.perf_counter() - t0
    c = rmt.get(actor.counters.remote(), timeout=60)
    launches = c["launches"]["flash_attention_fwd"]
    pages = c["stats"]["kv"]["pages_in_use"]
    need = cfg.n_layers * len(prompts)
    gen_tokens = sum(len(o) for o in outs)
    budget_ok = all(len(o) == max_new_tokens for o in outs)
    vocab_ok = all(0 <= t < cfg.vocab_size for o in outs for t in o)

    rng = np.random.default_rng(2)
    seq = [rng.integers(2, cfg.vocab_size, size=n).tolist()
           for n in (7, 130, 600)]
    srv = LLMServer(preset=preset, max_batch_size=max_batch_size,
                    max_new_tokens=max_new_tokens, seed=seed,
                    device=device)
    try:
        mine = [srv.generate(p) for p in seq]
    finally:
        srv.close()
    theirs = [rmt.get(actor.generate.remote(p), timeout=600) for p in seq]
    same = mine == theirs
    if not keep:
        rmt.kill(actor)
    rps, tps = len(prompts) / wall, gen_tokens / wall
    driver_lease, uuid = _driver_card(device)
    lease = driver_lease if lease is None else lease
    on_node = node is None or c["node_id"] == node.hex()
    where = "" if node is None else (
        f" on node {c['node_id'][:8]} (want {node.hex()[:8]})")
    log(f"[{tag}] GPU actor {preset}{where} on {c['device']} (worker "
        f"CUDA_VISIBLE_DEVICES={c['cuda_visible_devices']!r}, want "
        f"{lease!r}; its card the driver's={c['device_uuid'] == uuid}), "
        f"started in "
        f"{start_s:.2f} s; burst of {len(prompts)} concurrent "
        f".generate.remote requests: wall {wall:.3f} s, {rps:.2f} "
        f"requests/s, {tps:.1f} generated tokens/s (in-process "
        f"phase_serve median: {serve['requests_per_s']:.2f} requests/s, "
        f"{serve['tokens_per_s']:.1f} tokens/s); flash launches "
        f"{launches} {c['designs']} (need >= {need}, all wgmma); "
        f"pages_in_use after it={pages}; sequential greedy tokens vs an "
        f"in-process LLMServer of seed {seed}, prompt lens "
        f"{[len(p) for p in seq]}: {'equal' if same else 'DIFFER'}")
    if not (budget_ok and vocab_ok):
        raise AssertionError(f"{tag}: an actor request missed its token "
                             "budget or returned ids outside the vocabulary")
    if pages != 0:
        raise AssertionError(f"{tag}: the actor holds {pages} KV pages")
    if launches < need or c["designs"]["wgmma"] != launches:
        raise AssertionError(f"{tag}: actor flash launches {launches} "
                             f"{c['designs']}, need >= {need}, all wgmma")
    if (c["cuda_visible_devices"] != lease or c["device_uuid"] != uuid
            or not c["device"].startswith("cuda") or not on_node):
        raise AssertionError(f"{tag}: the actor runs on {c['device']} "
                             f"with CUDA_VISIBLE_DEVICES="
                             f"{c['cuda_visible_devices']!r} on node "
                             f"{c['node_id']}")
    if not same:
        raise AssertionError(f"{tag}: actor tokens {theirs} != "
                             f"in-process {mine}")
    out = dict(start_s=start_s, wall_s=wall, requests_per_s=rps,
               tokens_per_s=tps, launches=launches, designs=c["designs"],
               requests=len(prompts))
    if keep:
        out["actor"] = actor
    return out


def _driver_card(device):
    """(the ``CUDA_VISIBLE_DEVICES`` a one-GPU lease must export, the
    UUID of the driver's card): a GPU worker must run on the driver's
    card, whatever the driver's own variable says."""
    from ray_memory_management_tpu_torch.core.node_manager import (
        visible_devices)
    from ray_memory_management_tpu_torch.utils.runtime_smoke import (
        _device_uuid)

    return visible_devices(1)[0], _device_uuid(device)


def _port_processes():
    """PIDs of live node-agent, worker and zygote processes of the
    port."""
    marks = (b"ray_memory_management_tpu_torch.core.worker_main",
             b"ray_memory_management_tpu_torch.core.zygote",
             b"ray_memory_management_tpu_torch.core.node_agent")
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{name}/stat", "rb") as f:
                state = f.read().rsplit(b")", 1)[1].split()[0]
        except OSError:
            continue
        if state != b"Z" and any(m in cmd for m in marks):
            pids.append(int(name))
    return pids


def _leftovers(wait_s=20.0):
    """(shm segments of this driver and of any node agent, live
    node-agent/worker/zygote processes of the port), waiting up to
    ``wait_s`` for a shutdown to clear them."""
    prefixes = (f"rmt_{os.getpid()}_", "rmtA_")
    deadline = time.monotonic() + wait_s
    while True:
        segs = [n for n in os.listdir("/dev/shm") if n.startswith(prefixes)]
        procs = _port_processes()
        if not (segs or procs) or time.monotonic() > deadline:
            return segs, procs
        time.sleep(0.2)


def phase_runtime(device, serve, card, tier_n=16 << 20):
    """The runtime core on the card (see the module docstring, phase 7)."""
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.config import Config

    cfg = Config(device_store_capacity_bytes=3 * tier_n * 4)
    t0 = time.perf_counter()
    rt = rmt.init(num_cpus=4, object_store_memory=2 << 30, _config=cfg)
    init_s = time.perf_counter() - t0
    try:
        gpus = rmt.cluster_resources().get("GPU")
        log(f"[runtime] rmt.init(num_cpus=4) in {init_s:.3f} s; "
            f"cluster_resources GPU={gpus} (CUDA initialized in the driver "
            f"before init: {torch.cuda.is_initialized()})")
        if gpus != 1:
            raise AssertionError(f"runtime: {gpus} GPUs counted, want 1")
        _runtime_device_tier(device, rt, tier_n)
        host = _runtime_host_path(device)
        task = _runtime_gpu_task(device)
        actor = _runtime_actor(device, serve)
    finally:
        rmt.shutdown()
    segs, procs = _leftovers()
    log(f"[runtime] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"runtime: left behind shm {segs} and "
                             f"processes {procs}")
    figures = (f"[runtime] {card}: init_s={init_s:.3f} gpu_task_first_s="
        f"{task['first_s']:.3f} gpu_task_warm_ms={task['warm_ms_median']:.2f}"
        f" put_gb_s fp32={host['float32']['put_gb_s']:.2f} "
        f"bf16={host['bfloat16']['put_gb_s']:.2f} get_gb_s "
        f"fp32={host['float32']['get_gb_s']:.2f} "
        f"bf16={host['bfloat16']['get_gb_s']:.2f} actor_start_s="
        f"{actor['start_s']:.2f} actor_requests_per_s="
        f"{actor['requests_per_s']:.2f} actor_tokens_per_s="
        f"{actor['tokens_per_s']:.1f} in_process_requests_per_s="
        f"{serve['requests_per_s']:.2f} in_process_tokens_per_s="
        f"{serve['tokens_per_s']:.1f}")
    log(figures)
    return dict(init_s=init_s, gpus=gpus, host=host, task=task,
                actor=actor, figures=figures)


SERVE_PLANE_STORE = 4 << 30  # shm for the payload's hops (324 MB each)


def _served(app):
    """``app`` (an ``llm_deployment``) with ``ServedLLM`` in place of
    ``LLMServer``: the same name, options, arguments and payload, plus
    reads of the replica's own process (launches, card, pid, cold
    starts) through a handle method."""
    from ray_memory_management_tpu_torch import serve as rserve
    from ray_memory_management_tpu_torch.utils.runtime_smoke import (
        ServedLLM)

    d = app.deployment
    return rserve.deployment(
        ServedLLM, name=d.name, ray_actor_options=d.ray_actor_options,
        max_concurrent_queries=d.max_concurrent_queries,
        placement_hint=d.placement_hint).bind(*app.args, **app.kwargs)


def _same_payload(a, b) -> bool:
    import numpy as np

    return (a["p"] == b["p"] and a["paths"] == b["paths"]
            and all(x["p"] == y["p"] and x["q"].dtype == y["q"].dtype
                    and np.array_equal(x["q"], y["q"])
                    for x, y in zip(a["leaves"], b["leaves"])))


def _http_post(port, name, body, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{name}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class _Echo:
    """An actor, and a deployment, that hands its argument back: what a
    request costs on each layer of the serve plane without the model."""

    def __call__(self, x=None):
        return x

    echo = __call__  # an actor handle calls no __call__


def _plane_overhead(rserve, rmt, port, body, n=30):
    """Median and max ms of ``n`` sequential echo requests of ``body``
    by a plain actor call, through ``handle.remote`` (router, replica
    wrapper) and through the HTTP proxy (JSON, proxy actor, router)."""
    import numpy as np

    actor = rmt.remote(_Echo).options(num_cpus=0).remote()
    handle = rserve.run(rserve.deployment(_Echo, name="echo").bind())
    paths = {"actor": lambda: rmt.get(actor.echo.remote(body), timeout=60),
             "handle": lambda: rmt.get(handle.remote(body), timeout=60),
             "http": lambda: _http_post(port, "echo", body, timeout=60)}
    out = {}
    try:
        for name, call in paths.items():
            if call() != body:
                raise AssertionError(f"serve plane: {name} echo differs")
            ms = []
            for _ in range(n):
                t0 = time.perf_counter()
                call()
                ms.append((time.perf_counter() - t0) * 1e3)
            out[name] = (float(np.median(ms)), max(ms))
    finally:
        rmt.kill(actor)
        rserve.delete("echo")
    return out


def _deploy_served(rserve, rmt, app, t0):
    """``serve.run`` of ``app`` as ``ServedLLM``; returns (handle, run s,
    s from ``t0`` to the first reply). One replica must be live when
    ``serve.run`` returns: a replica that missed readiness leaves none."""
    handle = rserve.run(_served(app))
    run_s = time.perf_counter() - t0
    live = rserve.status("LLM")["num_replicas"]
    if live != 1:
        raise AssertionError(f"serve plane: {live} live replicas after "
                             "serve.run, want 1")
    rmt.get(handle.remote({"tokens": [5, 6, 7]}), timeout=600)
    return handle, run_s, time.perf_counter() - t0


def phase_serve_plane(device, serve, actor, card, preset="gpt2-small",
                      max_batch_size=8, max_new_tokens=32, seed=0):
    """The serve plane on the card (see the module docstring, phase 8)."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import serve as rserve
    from ray_memory_management_tpu_torch.core import codec
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.serve.api import _ctrl
    from ray_memory_management_tpu_torch.serve.http_proxy import start_proxy
    from ray_memory_management_tpu_torch.serve.llm import (
        LLMServer, llm_deployment, pack_weights)

    cfg = gpt.PRESETS[preset]
    kw = dict(max_batch_size=max_batch_size, max_new_tokens=max_new_tokens,
              seed=seed)
    rng = np.random.default_rng(2)
    seq = [rng.integers(2, cfg.vocab_size, size=n).tolist()
           for n in (7, 130, 600)]
    reqs = _serve_requests(cfg.vocab_size, seed)

    # in-process references and cold starts: init, then pack + shipped
    t0 = time.perf_counter()
    srv = LLMServer(preset=preset, device=device, **kw)
    _sync(device)
    cold_init_s = time.perf_counter() - t0
    try:
        want_init = [srv.generate(p) for p in seq]
        t0 = time.perf_counter()
        payload = pack_weights(srv.params, "bf16")
        pack_s = time.perf_counter() - t0
    finally:
        srv.close()
    del srv
    payload_bytes = sum(codec.quantized_nbytes(leaf)
                        for leaf in payload["leaves"])
    t0 = time.perf_counter()
    srv = LLMServer(preset=preset, weights=payload, device=device, **kw)
    _sync(device)
    cold_shipped_s = time.perf_counter() - t0
    try:
        want_shipped = [srv.generate(p) for p in seq]
    finally:
        srv.close()
    del srv
    torch.cuda.empty_cache()
    log(f"[serve-plane] in-process {preset} on {device}: cold start init "
        f"{cold_init_s:.3f} s, shipped {cold_shipped_s:.3f} s (+ pack "
        f"{pack_s:.3f} s = {pack_s + cold_shipped_s:.3f} s); bf16 payload "
        f"{payload_bytes} bytes for {sum(l['q'].size for l in payload['leaves'])} "
        f"parameters")

    opts = {"num_gpus": 1}
    t0 = time.perf_counter()
    rmt.init(num_cpus=4, object_store_memory=SERVE_PLANE_STORE)
    init_s = time.perf_counter() - t0
    try:
        rserve.start(http_port=0)
        port = start_proxy(_ctrl(), 0)
        log(f"[serve-plane] rmt.init(num_cpus=4, object_store_memory="
            f"{SERVE_PLANE_STORE}) in {init_s:.3f} s; HTTP proxy on "
            f"127.0.0.1:{port}")

        overhead = _plane_overhead(rserve, rmt, port,
                                   {"tokens": seq[2]})
        log(f"[serve-plane] echo of a {len(seq[2])}-token request, "
            f"median / max ms of 30: " + ", ".join(
                f"{k} {m:.2f} / {x:.2f}" for k, (m, x) in overhead.items()))

        # the main path: shipped weights, one GPU replica
        t0 = time.perf_counter()
        app = llm_deployment(preset, ray_actor_options=opts,
                             ship_weights="bf16", **kw)
        build_s = time.perf_counter() - t0
        if not _same_payload(app.kwargs["weights"], payload):
            raise AssertionError("serve plane: llm_deployment's payload "
                                 "differs from the in-process one")
        h, run_s, first_s = _deploy_served(rserve, rmt, app, t0)
        c0 = rmt.get(h.counters.remote(), timeout=60)
        rmt.get(h.reset_counters.remote(), timeout=60)
        runs = [_burst(lambda r: rmt.get(h.remote(r), timeout=600), reqs)]
        c = rmt.get(h.counters.remote(), timeout=60)
        runs.append(_burst(lambda r: rmt.get(h.remote(r), timeout=600),
                           reqs))
        got = [rmt.get(h.remote({"tokens": p}), timeout=600)["tokens"]
               for p in seq]
        http_got = [_http_post(port, "LLM", {"tokens": p})["tokens"]
                    for p in seq]
        http_runs = [_burst(lambda r: _http_post(port, "LLM", r), reqs)
                     for _ in range(2)]
        before = rmt.get(h.counters.remote(), timeout=60)
        t0 = time.perf_counter()
        h = rserve.run(_served(llm_deployment(
            preset, ray_actor_options=opts, ship_weights="bf16", **kw)))
        redeploy_s = time.perf_counter() - t0
        after = rmt.get(h.counters.remote(), timeout=60)
        live = rserve.status("LLM")["num_replicas"]
        rserve.delete("LLM")

        # the same without shipping: the replica draws its own weights
        t0 = time.perf_counter()
        app = llm_deployment(preset, ray_actor_options=opts, **kw)
        h, run_init_s, first_init_s = _deploy_served(rserve, rmt, app, t0)
        got_init = [rmt.get(h.remote({"tokens": p}), timeout=600)["tokens"]
                    for p in seq]
        c_init = rmt.get(h.counters.remote(), timeout=60)
    finally:
        rserve.shutdown()
        rmt.shutdown()
    segs, procs = _leftovers()

    errors = [(r[3], r[4]) for r in runs + http_runs if r[3] or r[4]]
    answers = [r for run in runs + http_runs for r in run[0] if r]
    budget_ok = all(len(r["tokens"]) == max_new_tokens for r in answers)
    vocab_ok = all(0 <= t < cfg.vocab_size
                   for r in answers for t in r["tokens"])
    launches = c["launches"]["flash_attention_fwd"]
    pages = c["stats"]["kv"]["pages_in_use"]
    need = cfg.n_layers * len(reqs)
    lease, uuid = _driver_card(device)

    def rate(run):
        gen = sum(len(r["tokens"]) for r in run[0] if r)
        return len(reqs) / run[2], gen / run[2]

    handle_rates = [rate(r) for r in runs]
    http_rates = [rate(r) for r in http_runs]
    kept = (after["pid"] == before["pid"]
            and after["stats"]["requests"] == before["stats"]["requests"]
            and after["cold_starts"] == before["cold_starts"])
    log(f"[serve-plane] serve.run(llm_deployment({preset!r}, "
        f"ray_actor_options={opts}, ship_weights='bf16')): llm_deployment "
        f"(draw, pack, put) {build_s:.3f} s, serve.run returned at "
        f"{run_s:.3f} s, first reply at {first_s:.3f} s; replica pid "
        f"{c0['pid']} on {c0['device']} (CUDA_VISIBLE_DEVICES="
        f"{c0['cuda_visible_devices']!r}, want {lease!r}; its card the "
        f"driver's={c0['device_uuid'] == uuid}); its cold start "
        f"{c0['cold_starts']}")
    log(f"[serve-plane] bursts of {len(reqs)} concurrent requests through "
        f"handle.remote: walls {[round(r[2], 3) for r in runs]} s, "
        f"requests/s {[round(x, 2) for x, _ in handle_rates]}, tokens/s "
        f"{[round(y, 1) for _, y in handle_rates]}; through the HTTP proxy:"
        f" walls {[round(r[2], 3) for r in http_runs]} s, requests/s "
        f"{[round(x, 2) for x, _ in http_rates]}, tokens/s "
        f"{[round(y, 1) for _, y in http_rates]} (in-process phase_serve "
        f"median {serve['requests_per_s']:.2f} requests/s, "
        f"{serve['tokens_per_s']:.1f} tokens/s; GPU actor "
        f"{actor['requests_per_s']:.2f} requests/s, "
        f"{actor['tokens_per_s']:.1f} tokens/s); replica flash launches in "
        f"the first burst {launches} {c['designs']} (need >= {need}, all "
        f"wgmma); pages_in_use after it={pages}; errors {errors}")
    log(f"[serve-plane] greedy tokens, prompt lens {[len(p) for p in seq]}:"
        f" handle vs in-process LLMServer(weights=payload) "
        f"{'equal' if got == want_shipped else 'DIFFER'}; HTTP "
        f"{'equal' if http_got == want_shipped else 'DIFFER'}; redeploy of "
        f"the same application in {redeploy_s:.3f} s kept the replica="
        f"{kept} (pid {before['pid']} -> {after['pid']}, requests "
        f"{before['stats']['requests']} -> {after['stats']['requests']}, "
        f"{live} live); without ship_weights: serve.run returned at "
        f"{run_init_s:.3f} s, first reply at {first_init_s:.3f} s, replica "
        f"cold start {c_init['cold_starts']}, tokens vs in-process "
        f"LLMServer(seed={seed}) "
        f"{'equal' if got_init == want_init else 'DIFFER'}")
    log(f"[serve-plane] after serve.shutdown() and rmt.shutdown(): shm "
        f"segments {segs}, port worker/zygote processes {procs}")
    if errors:
        raise AssertionError(f"serve plane: failed or hung requests "
                             f"{errors}")
    if not (budget_ok and vocab_ok):
        raise AssertionError("serve plane: a request missed its token "
                             "budget or returned ids outside the vocabulary")
    if pages != 0:
        raise AssertionError(f"serve plane: the replica holds {pages} KV "
                             "pages")
    if launches < need or c["designs"]["wgmma"] != launches:
        raise AssertionError(f"serve plane: replica flash launches "
                             f"{launches} {c['designs']}, need >= {need}, "
                             "all wgmma")
    for probe in (c0, c_init):
        if (probe["cuda_visible_devices"] != lease
                or probe["device_uuid"] != uuid
                or not probe["device"].startswith("cuda")):
            raise AssertionError(
                f"serve plane: a replica runs on {probe['device']} with "
                f"CUDA_VISIBLE_DEVICES={probe['cuda_visible_devices']!r}")
    if c0["cold_starts"]["shipped"]["count"] != 1 or \
            c_init["cold_starts"]["init"]["count"] != 1:
        raise AssertionError("serve plane: replica cold starts "
                             f"{c0['cold_starts']} {c_init['cold_starts']}")
    if got != want_shipped or http_got != want_shipped:
        raise AssertionError(f"serve plane: handle {got} / HTTP {http_got}"
                             f" != in-process {want_shipped}")
    if got_init != want_init:
        raise AssertionError(f"serve plane: unshipped replica {got_init} "
                             f"!= in-process {want_init}")
    if not kept or live != 1:
        raise AssertionError(f"serve plane: the redeploy replaced the "
                             f"replica ({before} -> {after}, {live} live)")
    if segs or procs:
        raise AssertionError(f"serve plane: left behind shm {segs} and "
                             f"processes {procs}")
    med = lambda xs: float(np.median(xs))  # noqa: E731
    figures = (
        f"[serve-plane] {card}: handle_requests_per_s="
        f"{med([x for x, _ in handle_rates]):.2f} handle_tokens_per_s="
        f"{med([y for _, y in handle_rates]):.1f} http_requests_per_s="
        f"{med([x for x, _ in http_rates]):.2f} http_tokens_per_s="
        f"{med([y for _, y in http_rates]):.1f} in_process_requests_per_s="
        f"{serve['requests_per_s']:.2f} actor_requests_per_s="
        f"{actor['requests_per_s']:.2f} run_to_first_reply_shipped_s="
        f"{first_s:.3f} run_to_first_reply_init_s={first_init_s:.3f} "
        f"cold_start_in_process_init_s={cold_init_s:.3f} "
        f"cold_start_in_process_shipped_s={cold_shipped_s:.3f} pack_s="
        f"{pack_s:.3f} payload_bytes={payload_bytes} redeploy_s="
        f"{redeploy_s:.3f} echo_ms_median actor="
        f"{overhead['actor'][0]:.2f} handle={overhead['handle'][0]:.2f} "
        f"http={overhead['http'][0]:.2f}")
    log(figures)
    return dict(launches=launches, designs=c["designs"],
                handle_rates=handle_rates, http_rates=http_rates,
                first_reply_shipped_s=first_s, first_reply_init_s=first_init_s,
                build_s=build_s, run_s=run_s, run_init_s=run_init_s,
                cold_init_s=cold_init_s, cold_shipped_s=cold_shipped_s,
                pack_s=pack_s, payload_bytes=payload_bytes,
                redeploy_s=redeploy_s, init_s=init_s, overhead=overhead,
                figures=figures)


def _multinode_bytes(device, agent, lease, nbytes=256 << 20, reps=3):
    """CUDA tensors driver → a ``num_gpus=1`` task on the agent, which
    hands them back → driver: bit-equal both ways, with GB/s each way
    (the task stamps when the tensor had landed on its card and when it
    returned; the driver's clock reads the rest, on the same host). The
    way there is split at the driver's ``put`` (device→host copy into
    the head's store) and the rest (to the agent's card)."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    echo = rmt.remote(runtime_smoke.echo).options(num_gpus=1)
    gen = torch.Generator(device=device).manual_seed(14)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = nbytes // torch.tensor([], dtype=dtype).element_size()
        x = torch.randn(n, device=device, generator=gen).to(dtype)
        there, back, puts = [], [], []
        for _ in range(reps):
            _sync(device)
            t0 = time.time()
            ref = rmt.put(x)
            puts.append(time.time() - t0)
            r = rmt.get(echo.remote(ref), timeout=600)
            y = r["x"]
            _sync(device)
            t1 = time.time()
            there.append(r["t_in"] - t0)
            back.append(t1 - r["t_out"])
            if not (y.device.type == device.type and _bit_equal(y, x)):
                raise AssertionError(f"multinode: a {dtype} CUDA tensor did "
                                     f"not come back bit-equal on cuda "
                                     f"(got {y.device})")
            if (r["node_id"] != agent.hex()
                    or r["cuda_visible_devices"] != lease):
                raise AssertionError(f"multinode: the echo ran on node "
                                     f"{r['node_id']} with "
                                     f"CUDA_VISIBLE_DEVICES="
                                     f"{r['cuda_visible_devices']!r}")
            del r, y, ref
        name = str(dtype).removeprefix("torch.")
        out[name] = dict(to_agent_gb_s=nbytes / float(np.median(there)) / 1e9,
                         from_agent_gb_s=nbytes / float(np.median(back))
                         / 1e9, to_agent_s=there, from_agent_s=back,
                         put_s=puts)
        log(f"[multinode] {name} {nbytes >> 20} MiB driver -> agent GPU task "
            f"-> driver: bit-equal both ways on the agent's node; to the "
            f"agent {out[name]['to_agent_gb_s']:.2f} GB/s, back "
            f"{out[name]['from_agent_gb_s']:.2f} GB/s (median of {reps}; "
            f"{[round(t, 4) for t in there]} s, of which the driver's put "
            f"{[round(t, 4) for t in puts]} s, and "
            f"{[round(t, 4) for t in back]} s)")
        del x
    return out


def phase_multinode(device, serve, gpu_actor, card):
    """The multi-node runtime with the card on a node agent (see the
    module docstring, phase 9)."""
    import signal

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.exceptions import ActorDiedError

    t_phase = t0 = time.perf_counter()
    rt = rmt.init(num_cpus=4, num_gpus=0, object_store_memory=2 << 30)
    init_s = time.perf_counter() - t0
    try:
        head_gpus = rmt.cluster_resources().get("GPU", 0)
        t0 = time.perf_counter()
        agent = rt.add_remote_node_process(num_cpus=4, num_gpus=1)
        join_s = time.perf_counter() - t0
        nm = rt.nodes[agent]
        # the names the agent reported for its GPU, before any lease
        reported = list(nm.free_chips)
        gpus = rmt.cluster_resources().get("GPU", 0)
        on_agent = nm.resources.total.get("GPU")
        on_head = rt.head_node().resources.total.get("GPU")
        log(f"[multinode] rmt.init(num_cpus=4, num_gpus=0) in {init_s:.3f} "
            f"s (GPU={head_gpus}); add_remote_node_process(num_cpus=4, "
            f"num_gpus=1) joined node {agent.hex()[:8]} (agent pid "
            f"{nm.agent_pid}) in {join_s:.3f} s; cluster GPU={gpus}, on the "
            f"agent {on_agent}, on the head {on_head}; the agent's reported "
            f"device names {reported}")
        if head_gpus != 0 or gpus != 1 or on_agent != 1 or on_head != 0 \
                or len(reported) != 1:
            raise AssertionError(f"multinode: GPU {head_gpus} before the "
                                 f"agent, {gpus} after ({on_agent} on the "
                                 f"agent, {on_head} on the head), names "
                                 f"{reported}")
        lease = reported[0]
        task = _runtime_gpu_task(device, lease=lease, node=agent,
                                 tag="multinode")
        moved = _multinode_bytes(device, agent, lease)
        store_path = type(rt._store_clients.get(agent)).__name__
        log(f"[multinode] the head reads the agent's store through "
            f"{store_path} (StoreClient: the same-host shm store mapped "
            f"directly; else pulled over the channel)")
        actor = _runtime_actor(device, serve, lease=lease, node=agent,
                               tag="multinode", keep=True)
        handle = actor.pop("actor")

        # agent death: SIGKILL the agent process
        os.kill(nm.agent_pid, signal.SIGKILL)
        t0 = time.perf_counter()
        while nm.alive and time.perf_counter() - t0 < 60:
            time.sleep(0.05)
        detect_s = time.perf_counter() - t0
        try:
            rmt.get(handle.generate.remote([5, 6, 7]), timeout=120)
            died = "answered"
        except ActorDiedError as e:
            died = type(e).__name__
        gpus_after = rmt.cluster_resources().get("GPU", 0)
        log(f"[multinode] SIGKILL of the agent: node dead after "
            f"{detect_s:.3f} s (alive={nm.alive}); the actor's next call "
            f"raised {died}; cluster GPU={gpus_after}")
        if nm.alive or died != "ActorDiedError" or gpus_after != 0:
            raise AssertionError(f"multinode: after the agent's death the "
                                 f"node alive={nm.alive}, the actor call "
                                 f"{died}, GPU={gpus_after}")
        del handle
    finally:
        rmt.shutdown()
    segs, procs = _leftovers()
    log(f"[multinode] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"multinode: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[multinode] {card}: phase_s={phase_s:.1f} join_s={join_s:.3f} "
        f"agent_task_first_s="
        f"{task['first_s']:.3f} agent_task_warm_ms="
        f"{task['warm_ms_median']:.2f} to_agent_gb_s fp32="
        f"{moved['float32']['to_agent_gb_s']:.2f} bf16="
        f"{moved['bfloat16']['to_agent_gb_s']:.2f} from_agent_gb_s fp32="
        f"{moved['float32']['from_agent_gb_s']:.2f} bf16="
        f"{moved['bfloat16']['from_agent_gb_s']:.2f} store_path={store_path}"
        f" agent_actor_start_s={actor['start_s']:.2f} "
        f"agent_actor_requests_per_s={actor['requests_per_s']:.2f} "
        f"agent_actor_tokens_per_s={actor['tokens_per_s']:.1f} "
        f"gpu_actor_requests_per_s={gpu_actor['requests_per_s']:.2f} "
        f"gpu_actor_tokens_per_s={gpu_actor['tokens_per_s']:.1f} "
        f"agent_death_detect_s={detect_s:.3f}")
    log(figures)
    return dict(phase_s=phase_s, init_s=init_s, join_s=join_s, lease=lease,
                task=task,
                moved=moved, store_path=store_path, actor=actor,
                detect_s=detect_s, figures=figures)


# the step-4 checkpoint (1,946,661,486 bytes on an H100 80GB HBM3 at
# 700 W, chip call 13) crosses the store twice: 3.9 GB of its 6.4 GB
TRAIN_PLANE_STORE = 6 << 30
PROBE_N = 1 << 22             # elements of the collectives' CUDA tensor
# the JAX package's quantized-allreduce envelopes (tests/test_collective.py
# :222-223), times absmax and the world size (1 here)
COLLECTIVE_TOL = {"bf16": 2.0 ** -7, "int8": 0.75 / 127.0}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _train_plane_collectives(card_lease, card_uuid, gpus):
    """Phase 10 (a): every collective of a world-1 dist group on the
    probe actor's card, each beside its plain expectation."""
    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import collective as col
    from ray_memory_management_tpu_torch.collective.coordinator import (
        destroy_coordinator)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    probe = rmt.remote(num_gpus=gpus)(runtime_smoke.CollectiveProbe).remote()
    t0 = time.perf_counter()
    col.create_collective_group([probe], 1, [0], backend="dist",
                                group_name="train_plane")
    join_s = time.perf_counter() - t0
    c = rmt.get(probe.probe.remote("train_plane", PROBE_N), timeout=600)
    rmt.kill(probe)
    destroy_coordinator("train_plane")
    bad = []
    for row in c["rows"]:
        p = row["precision"]
        if p == "f32":
            ok = row["bit_equal"] and row["counted"] == 0
        else:
            ok = (row["max_abs_err"] <= c["absmax"] * COLLECTIVE_TOL[p]
                  and row["counted"] == 1)
        if not ok or (gpus and not row["device"].startswith("cuda")):
            bad.append(row)
    log(f"[train_plane] collectives: a num_gpus={gpus} actor joined a "
        f"world-{c['world']} dist group over {c['backend']} in "
        f"{join_s:.3f} s (lease {c['lease']!r}); {len(c['rows'])} calls on "
        f"{PROBE_N} elements (absmax {c['absmax']:.4f}): " + "; ".join(
            f"{r['op']}/{r['reduce']}/{r['precision']} "
            f"{'bit-equal' if r['bit_equal'] else 'err'} "
            f"{r['max_abs_err']:.3g} counted {r['counted']:g} "
            f"{r['ms']:.3f} ms" for r in c["rows"]))
    if gpus and (c["backend"] != "nccl" or c["lease"] != card_lease
                 or c["device_uuid"] != card_uuid):
        raise AssertionError(
            f"train plane: the collective actor ran over {c['backend']} "
            f"with lease {c['lease']!r} on {c['device_uuid']}, want nccl, "
            f"{card_lease!r}, {card_uuid}")
    if bad:
        raise AssertionError(f"train plane: collectives off their plain "
                             f"expectation: {bad}")
    return dict(join_s=join_s, absmax=c["absmax"], rows=c["rows"],
                backend=c["backend"])


def _train_plane_final(result, tag):
    if result.error is not None:
        raise AssertionError(f"train plane: {tag} fit() failed: "
                             f"{result.error}")
    finals = [m for m in result.metrics_history if m.get("final")]
    if len(finals) != 1:
        raise AssertionError(f"train plane: {tag} reported "
                             f"{result.metrics_history}")
    return finals[0]


def _check_trainer_launches(final, n_steps, n_layers, tag):
    want = n_layers * n_steps
    launches, designs = final["launches"], final["designs"]
    bwd = final["bwd_designs"]
    if (any(n != want for n in launches.values())
            or designs["wgmma"] != want
            or any(c["wgmma"] != want for c in bwd.values())):
        raise AssertionError(f"train plane: {tag} launches {launches} "
                             f"{designs} {bwd}, want {want} of each, all "
                             f"wgmma")


def phase_train_plane(device, train, card, preset="gpt2-small", steps=8,
                      ckpt_at=4):
    """Collectives, the parallel library and Train on the card (see the
    module docstring, phase 10). ``train`` is phase 6's result, whose
    losses the trainer's must equal."""
    import math
    import shutil
    import tempfile

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.train import (
        CheckpointConfig, RunConfig, ScalingConfig, TorchTrainer)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    gpus = int(device.type == "cuda")
    if gpus:
        import torch

        # the workers need the card's memory that this driver's earlier
        # phases left in its allocator's cache
        torch.cuda.empty_cache()
    n_layers = gpt.PRESETS[preset].n_layers
    lease, uuid = _driver_card(device)
    storage = tempfile.mkdtemp(prefix="rmt_train_plane_")
    t_phase = time.perf_counter()
    rmt.init(num_cpus=4, object_store_memory=TRAIN_PLANE_STORE)
    try:
        coll = _train_plane_collectives(lease, uuid, gpus)
        config = dict(device=device.type, preset=preset, batch=TRAIN_B,
                      seq=TRAIN_S, steps=steps, ckpt_at=ckpt_at)
        scaling = ScalingConfig(num_workers=1, use_gpu=bool(gpus),
                                gpus_per_worker=gpus,
                                collective_backend="dist")
        saves = mdefs.train_checkpoint_save_seconds()
        before = saves.get(tags={"phase": "drain"})
        t0 = time.time()
        r1 = TorchTrainer(
            runtime_smoke.train_loop, train_loop_config=config,
            scaling_config=scaling,
            run_config=RunConfig(name="first", storage_path=storage,
                                 checkpoint_config=CheckpointConfig(
                                     mode="sync"))).fit()
        fit_s = time.time() - t0
        first = _train_plane_final(r1, "first")
        cold_s = first["t_loop"] - t0
        setup_s = first["t_ready"] - first["t_loop"]
        after = saves.get(tags={"phase": "drain"})
        save_s = after["sum"] - before["sum"]
        ckpt_dir = os.path.join(storage, "first", "checkpoint_000000")
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(ckpt_dir) for f in fs)
        losses = first["losses"]
        log(f"[train_plane] TorchTrainer fit(): {fit_s:.2f} s; the worker's "
            f"loop started {cold_s:.2f} s after fit() (lease "
            f"{first['lease']!r}, {first['backend']}), set up its mesh, "
            f"model and optimizer in {setup_s:.2f} s; {steps} steps, losses "
            f"{[round(x, 5) for x in losses]} (phase 6: "
            f"{[round(x, 5) for x in train['losses']]}); step_ms="
            f"{first['step_ms']:.2f} tokens_per_s={first['tokens_per_s']:.1f}"
            f" mfu={first['mfu']} (phase 6 step_ms={train['step_ms']:.2f} "
            f"tokens_per_s={train['tokens_per_s']:.1f} mfu={train['mfu']}); "
            f"segments {first['segments']}; launches {first['launches']} "
            f"forward {first['designs']} backward {first['bwd_designs']}; "
            f"checkpoint at step {ckpt_at}: snapshot "
            f"{first['snapshot_s']:.2f} s in the worker, durable save "
            f"{save_s:.2f} s, {ckpt_bytes} bytes; peak_mem="
            f"{first['peak_mem_gb']} GB")
        if gpus and (first["lease"] != lease
                     or first["device_uuid"] != uuid
                     or first["backend"] != "nccl"):
            raise AssertionError(
                f"train plane: the worker ran with lease "
                f"{first['lease']!r} on {first['device_uuid']} over "
                f"{first['backend']}, want {lease!r}, {uuid}, nccl")
        _check_trainer_launches(first, steps, n_layers, "first")
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"train plane: losses {losses}")
        ref = train["losses"]
        if len(losses) != steps or _rel(losses[0], ref[0]) > 1e-5 \
                or _rel(losses[-1], ref[steps - 1]) > 1e-3:
            raise AssertionError(f"train plane: losses {losses} against "
                                 f"phase 6's {ref}")
        if r1.checkpoint is None or not any(
                m.get("checkpoint_at") == ckpt_at
                for m in r1.metrics_history):
            raise AssertionError("train plane: no checkpoint at step "
                                 f"{ckpt_at}")

        t0 = time.time()
        r2 = TorchTrainer(
            runtime_smoke.train_loop, train_loop_config=config,
            scaling_config=scaling,
            run_config=RunConfig(name="resumed", storage_path=storage),
            resume_from_checkpoint=r1.checkpoint).fit()
        resume_fit_s = time.time() - t0
        second = _train_plane_final(r2, "resumed")
        resumed = second["losses"]
        log(f"[train_plane] resumed fit(): {resume_fit_s:.2f} s from step "
            f"{second['start']}; losses {[round(x, 5) for x in resumed]} "
            f"(first run's steps {ckpt_at}-{steps - 1}: "
            f"{[round(x, 5) for x in losses[ckpt_at:]]})")
        _check_trainer_launches(second, steps - ckpt_at, n_layers,
                                "resumed")
        tol = [1e-5] + [1e-3] * (steps - ckpt_at - 1)
        if second["start"] != ckpt_at \
                or len(resumed) != steps - ckpt_at \
                or any(_rel(a, b) > t for a, b, t in
                       zip(resumed, losses[ckpt_at:], tol)):
            raise AssertionError(f"train plane: resumed losses {resumed} "
                                 f"against {losses[ckpt_at:]}")
    finally:
        rmt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    segs, procs = _leftovers()
    log(f"[train_plane] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"train plane: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[train_plane] {card}: phase_s={phase_s:.1f} "
        f"collective_join_s={coll['join_s']:.3f} cold_start_s={cold_s:.2f} "
        f"setup_s={setup_s:.2f} step_ms={first['step_ms']:.2f} "
        f"tokens_per_s={first['tokens_per_s']:.1f} mfu={first['mfu']} "
        f"in_process_step_ms={train['step_ms']:.2f} in_process_tokens_per_s"
        f"={train['tokens_per_s']:.1f} in_process_mfu={train['mfu']} "
        f"fit_s={fit_s:.2f} resume_fit_s={resume_fit_s:.2f} "
        f"ckpt_snapshot_s={first['snapshot_s']:.2f} ckpt_save_s="
        f"{save_s:.2f} ckpt_bytes={ckpt_bytes} first_loss_rel="
        f"{_rel(losses[0], train['losses'][0]):.3g} last_loss_rel="
        f"{_rel(losses[-1], train['losses'][steps - 1]):.3g}")
    log(figures)
    return dict(phase_s=phase_s, collectives=coll, cold_start_s=cold_s,
                setup_s=setup_s, fit_s=fit_s, resume_fit_s=resume_fit_s,
                save_s=save_s, ckpt_bytes=ckpt_bytes, first=first,
                resumed=second, launches=first["launches"],
                figures=figures)


MOE_PRESET = "mixtral-tiny"   # 8 experts, top-2, GQA 16/4, 32k vocab
MOE_B, MOE_S = 4, 2048         # the MoE training batch
RING = 4                       # the sp size whose chunk schedule is held


def _ring_schedule_check(device, cfg):
    """The ring's per-chunk schedule of an sp = ``RING`` run in one
    process (``ring_attention.ring_schedule``: each rank's query chunk
    against the K/V chunks in ring order, merged by lse; the backward's
    dq and dk/dv per chunk from the merged lse; the same per-rank loops,
    ``ring_forward`` and ``ring_backward``, that sp-ring training runs
    over rotating chunks) at the MoE training
    shape, bf16, causal, through the three kernels, held against the
    plain attention over the whole sequence: the output against
    ``reference_attention``, and dq, dk and dv against
    ``reference_flash_bwd`` given that output (as phase 2 gives the
    backward kernels and their plain version the same o). A row's
    output, dq, dk and dv are sums of up to ``RING`` chunk terms, each a
    kernel output rounded once to bf16 (the single kernel's tolerance
    holds one rounding), so they are held to ``RING`` times the single
    kernel's tolerance: the output to ``RING x TOL``, dq, dk and dv to
    ``RING x BWD_TOL``."""
    import torch

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reference_attention, reference_flash_bwd, reference_lse,
        reset_launch_count)
    from ray_memory_management_tpu_torch.ops.ring_attention import (
        ring_schedule)

    gen = torch.Generator(device=device).manual_seed(11)
    bh, d = MOE_B * cfg.n_heads, cfg.head_dim
    q, k, v, do = (torch.randn(bh, MOE_S, d, generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    reset_launch_count()
    o, dq, dk, dv = ring_schedule(q, k, v, do, RING, causal=True)
    _sync(device)
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    o_ref = reference_attention(q, k, v, True)
    lse_ref = reference_lse(q, k, True)
    grads_ref = reference_flash_bwd(q, k, v, o, lse_ref, do, True)
    o_err = (o.float() - o_ref.float()).abs().max().item()
    o_tol = RING * TOL["bfloat16"]
    rows = {name: bwd_close(got, ref.float(), "bfloat16", scale=RING)
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      grads_ref)}
    steps = RING * (RING + 1) // 2  # the causal ring's chunks attended
    log(f"[moe] ring schedule sp={RING} BH={bh} S={MOE_S} D={d} bf16 "
        f"causal: o max_abs_err={o_err:.3e} (tol {o_tol:g}); "
        + "; ".join(f"{n} max_abs_err={e:.3e} worst/limit={r:.3f}"
                    for n, (e, r, _) in rows.items())
        + f"; launches {launches} forward {designs} backward "
        f"{bwd_designs} (expect {steps} each, all wgmma)")
    if not torch.isfinite(o.float()).all() or o_err > o_tol:
        raise AssertionError("moe: the ring's schedule disagrees with "
                             "plain attention over the whole sequence")
    if not all(ok for _, _, ok in rows.values()):
        raise AssertionError(f"moe: the ring's backward disagrees with "
                             f"the plain backward: {rows}")
    if device.type == "cuda" and (
            any(n != steps for n in launches.values())
            or designs["wgmma"] != steps
            or any(c["wgmma"] != steps for c in bwd_designs.values())):
        raise AssertionError(f"moe: ring launches {launches} {designs} "
                             f"{bwd_designs}, expected {steps} of each "
                             f"kernel, all wgmma")
    return dict(o_err=o_err, launches=launches,
                **{n: dict(max_abs_err=e, worst_over_limit=r)
                   for n, (e, r, _) in rows.items()})


def phase_moe(device, steps=8):
    """Phase 11: mixtral-tiny at full width on the card. (a) serve-burst:
    ``LLMServer`` (bf16, 8 slots, paged) answers ``phase_serve``'s
    requests through the MoE FFN on prefill and decode, launch counts
    zeroed around the first burst; (b) ``train_step_mfu`` takes ``steps``
    AdamW steps at B = 4, S = 2048 (each kernel launched once per layer
    per step, all wgmma; the loss finite and falling), and one step's
    gradients are held against ``attention="ref"`` by phase 4's rule;
    (c) the ring's chunk schedule (sp = 4) through the kernels against
    plain attention."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt

    t0 = time.perf_counter()
    cfg = gpt.PRESETS[MOE_PRESET]
    serve = phase_serve(device, preset=MOE_PRESET, bursts=2)
    train = phase_train(device, steps=steps, preset=MOE_PRESET,
                        batch=MOE_B, seq=MOE_S)
    grad = phase_grad(device, preset=MOE_PRESET, batch=MOE_B, seq=MOE_S)
    torch.cuda.empty_cache()
    ring = _ring_schedule_check(device, cfg)
    phase_s = time.perf_counter() - t0
    log(f"[moe] {MOE_PRESET}: n_params={train['n_params']} serve "
        f"{serve['requests_per_s']:.2f} requests/s "
        f"{serve['tokens_per_s']:.1f} tokens/s; train step_ms="
        f"{train['step_ms']:.2f} tokens_per_s={train['tokens_per_s']:.1f} "
        f"mfu={train['mfu']:.4f} (6N counts every expert) peak_mem="
        f"{train['peak_mem_gb']:.2f} GB; phase_s={phase_s:.1f}")
    return dict(serve=serve, train=train, grad=grad, ring=ring,
                phase_s=phase_s)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here,
                                      "ray_memory_management_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} CUDA_VISIBLE_DEVICES="
        f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}")

    t0 = time.perf_counter()
    build_s = phase_build()
    rows, main_row, train_fwd = phase_kernels(device)
    bwd_rows, bwd = phase_backward(device)
    fwd = phase_forward(device)
    grad = phase_grad(device)
    serve = phase_serve(device)
    phase_engine_parity(device)
    train = phase_train(device)
    runtime = phase_runtime(device, serve, card)
    plane = phase_serve_plane(device, serve, runtime["actor"], card)
    multinode = phase_multinode(device, serve, runtime["actor"], card)
    train_plane = phase_train_plane(device, train, card)
    moe = phase_moe(device)
    total_s = time.perf_counter() - t0

    log(json.dumps({"summary": {
        "card": card, "build_s": build_s, "total_s": total_s,
        "main_shape": {"BH": BH, "S": MAIN_CASE[1], "Skv": MAIN_CASE[2],
                       "D": HEAD_DIM, "dtype": MAIN_CASE[0],
                       "causal": MAIN_CASE[3]},
        "forward_train_shape": train_fwd, "backward_main": bwd,
        "forward": fwd, "grad": grad, "serve": serve, "train": train,
        "runtime": runtime, "serve_plane": plane,
        "multinode": multinode, "train_plane": train_plane, "moe": moe}}))
    # the runtime's, the serve plane's and the multi-node figures again,
    # where the end of the output keeps them
    log(runtime["figures"])
    log(plane["figures"])
    log(multinode["figures"])
    log(train_plane["figures"])
    src = "ray_memory_management_tpu_torch/csrc/"
    ref = "ray_memory_management_tpu/ops/flash_attention.py:"
    pair = ("SDPA backward, dq, dk and dv together, on the same inputs")
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": src + "flash_attention_fwd.cu",
        "replaces": ref + "74",
        "launches": serve["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # the design every bf16 launch of both main paths took, and the
        # previous (SIMT) design's time in the same call
        "design": main_row["design"],
        "prev_ms": main_row["prev_ms"],
        "tflops": main_row["tflops"],
        "kernel_event_ms": main_row["kernel_event_ms"],
        "library_event_ms": main_row["library_event_ms"],
        # the training path: its launches, and the lse variant at BH = 96
        "launches_train": train["launches"]["flash_attention_fwd"],
        "max_abs_err_train": train_fwd["max_abs_err"],
        "ms_train": train_fwd["kernel_ms"],
        "plain_ms_train": train_fwd["plain_ms"],
        "bound_ms_train": train_fwd["bound_ms"],
        "bound_by_train": train_fwd["bound_by"],
        "library_ms_train": train_fwd["library_ms"],
        "prev_ms_train": train_fwd["prev_ms"],
        "tflops_train": train_fwd["tflops"],
        "kernel_event_ms_train": train_fwd["kernel_event_ms"],
        "library_event_ms_train": train_fwd["library_event_ms"],
        # the runtime path: launches in the GPU actor's burst (its own
        # process, counts zeroed just before) and in one GPU task
        "launches_actor": runtime["actor"]["launches"],
        "launches_gpu_task": runtime["task"]["launches"],
        # the serve plane: launches in the replica's first burst through
        # handle.remote (its own process, counts zeroed just before)
        "launches_replica": plane["launches"],
        # the multi-node path: launches in one GPU task on the node agent
        # and in the agent-hosted GPU actor's burst (counts zeroed just
        # before, in their own processes)
        "launches_agent_task": multinode["task"]["launches"],
        "launches_agent_actor": multinode["actor"]["launches"],
        # the train plane: launches in the TorchTrainer worker's 8 steps
        # (its own process, counts zeroed just before)
        "launches_trainer": train_plane["launches"]["flash_attention_fwd"],
        # mixtral-tiny (phase 11): its serve burst, its 8 training steps,
        # and the sp = 4 ring's chunk schedule
        "launches_moe_serve": moe["serve"]["launches"],
        "launches_moe_train": moe["train"]["launches"]["flash_attention_fwd"],
        "launches_ring_schedule": moe["ring"]["launches"][
            "flash_attention_fwd"],
    }, {
        "name": "flash_attention_dq",
        "route": "cuda",
        "source": src + "flash_attention_bwd.cu",
        "replaces": ref + "168",
        "launches": train["launches"]["flash_attention_dq"],
        "launches_trainer": train_plane["launches"]["flash_attention_dq"],
        "launches_moe_train": moe["train"]["launches"]["flash_attention_dq"],
        "launches_ring_schedule": moe["ring"]["launches"][
            "flash_attention_dq"],
        "max_abs_err": bwd["dq"],
        "ms": bwd["dq_ms"],
        "plain_ms": bwd["dq_plain_ms"],
        "bound_ms": bwd["dq_bound_ms"],
        "bound_by": bwd["dq_bound_by"],
        "library_ms": bwd["pair_library_ms"],
        "library_covers": pair,
        # the design every bf16 launch of the training path took, and the
        # previous (SIMT) design's time in the same call
        "design": bwd["design"],
        "max_err_over_limit": bwd["dq_over_limit"],
        "prev_ms": bwd["dq_prev_ms"],
        "tflops": bwd["dq_tflops"],
        "prev_tflops": bwd["dq_prev_tflops"],
        "kernel_event_ms": bwd["dq_event_ms"],
        "library_event_ms": bwd["pair_library_event_ms"],
    }, {
        "name": "flash_attention_dkv",
        "route": "cuda",
        "source": src + "flash_attention_bwd.cu",
        "replaces": ref + "208",
        "launches": train["launches"]["flash_attention_dkv"],
        "launches_trainer": train_plane["launches"]["flash_attention_dkv"],
        "launches_moe_train": moe["train"]["launches"][
            "flash_attention_dkv"],
        "launches_ring_schedule": moe["ring"]["launches"][
            "flash_attention_dkv"],
        "max_abs_err": max(bwd["dk"], bwd["dv"]),
        "ms": bwd["dkv_ms"],
        "plain_ms": bwd["dkv_plain_ms"],
        "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"],
        "library_ms": bwd["pair_library_ms"],
        "library_covers": pair,
        # the design every bf16 launch of the training path took, and the
        # previous (SIMT) design's time in the same call
        "design": bwd["design"],
        "max_err_over_limit": max(bwd["dk_over_limit"], bwd["dv_over_limit"]),
        "prev_ms": bwd["dkv_prev_ms"],
        "tflops": bwd["dkv_tflops"],
        "prev_tflops": bwd["dkv_prev_tflops"],
        "kernel_event_ms": bwd["dkv_event_ms"],
        "library_event_ms": bwd["pair_library_event_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
