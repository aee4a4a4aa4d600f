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


def bwd_close(got, ref, dtype_name):
    """(max abs error, worst error over its limit, ok) under BWD_TOL for
    one backward output; ok iff that ratio is at most 1."""
    t = BWD_TOL[dtype_name]
    err = (got.float() - ref).abs()
    limit = (t["atol"] + t["atol_of_max"] * ref.abs().max()
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
    distance to the fp32 model), leaf by leaf."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reset_launch_count)
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
    loss_r32, gr32 = grads(dataclasses.replace(f32, attention="ref"))
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
        f"(tol {tol32:g} x max|grad| {worst32['scale32']:.3e}); launches "
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


def phase_train(device, steps=8):
    """The training main path: ``train_step_mfu`` (gpt2-small, B = 8,
    S = 1024, AdamW) with the launch counts zeroed just before its steps
    and read just after."""
    import math

    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reset_launch_count)
    from ray_memory_management_tpu_torch.utils.gpu_bench import (
        train_step_mfu)

    n_layers = gpt.PRESETS["gpt2-small"].n_layers
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_count()
    r = train_step_mfu("gpt2-small", batch_size=TRAIN_B, seq_len=TRAIN_S,
                       steps=steps, device=device)
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    losses = r["losses"]
    log(f"[train] gpt2-small B={TRAIN_B} S={TRAIN_S} on {r['device']}: "
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
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_s = phase_build()
    rows, main_row, train_fwd = phase_kernels(device)
    bwd_rows, bwd = phase_backward(device)
    fwd = phase_forward(device)
    grad = phase_grad(device)
    serve = phase_serve(device)
    phase_engine_parity(device)
    train = phase_train(device)
    total_s = time.perf_counter() - t0

    log(json.dumps({"summary": {
        "card": card, "build_s": build_s, "total_s": total_s,
        "main_shape": {"BH": BH, "S": MAIN_CASE[1], "Skv": MAIN_CASE[2],
                       "D": HEAD_DIM, "dtype": MAIN_CASE[0],
                       "causal": MAIN_CASE[3]},
        "forward_train_shape": train_fwd, "backward_main": bwd,
        "forward": fwd, "grad": grad, "serve": serve, "train": train}}))
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
    }, {
        "name": "flash_attention_dq",
        "route": "cuda",
        "source": src + "flash_attention_bwd.cu",
        "replaces": ref + "168",
        "launches": train["launches"]["flash_attention_dq"],
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
