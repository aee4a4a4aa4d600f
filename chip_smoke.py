#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold it to its plain
versions.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (any failure exits non-zero):

  1. build    — compile every CUDA kernel of the serving path from
                ``ray_memory_management_tpu_torch/csrc`` with nvcc.
  2. kernels  — the flash attention forward kernel against its plain
                version (``reference_attention``) at the serving path's
                shapes (BH = 12, D = 64, S in {64, 992, 1024}, causal and
                not, S != Skv, fp32 and bf16), with its time beside the
                plain version's, SDPA's (a yardstick the port never
                calls) and the card's bound.
  3. forward  — ``gpt.forward`` of gpt2-small at B = 8, S = 1024 with the
                kernel against ``attention="ref"``.
  4. serve    — the main path: ``LLMServer`` (gpt2-small, paged
                continuous batching) answers a burst of concurrent
                requests; kernel launch counts are zeroed just before and
                read just after. Two more bursts are timed (median
                reported). Then a fp32 engine's greedy tokens are held
                against ``gpt.generate``.

It prints the card's name and power limit first, one JSON line of kernel
figures before the last line, and as its last line
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
BH, HEAD_DIM = 12, 64               # gpt2-small: 12 heads of 64, one row
MAIN_CASE = ("bfloat16", 992, 992, True)  # the paged prefill's 992 bucket


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``reps``."""
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


def attention_bound(bh, s, skv, d, causal, dtype_name, itemsize):
    """Least time (ms) for the work: each of q, k, v, o moved once, and the
    QK^T and PV products over the (row, col) pairs the mask admits."""
    off = skv - s
    if causal:
        pairs = sum(min(skv, max(0, r + off + 1)) for r in range(s))
    else:
        pairs = s * skv
    nbytes = (2 * bh * s * d + 2 * bh * skv * d) * itemsize
    ops = 4 * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


# ------------------------------------------------------------------ phases
def phase_build():
    from ray_memory_management_tpu_torch.ops import _build

    path, seconds, compiler_out = _build.build("flash_attention_fwd")
    for line in compiler_out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"[build] {path.name}: nvcc {seconds:.2f} s")
    return seconds


def phase_kernels(device):
    import torch
    import torch.nn.functional as F

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, reference_attention)

    cases = []
    for dtype_name in ("float32", "bfloat16"):
        for s in (64, 992, 1024):
            for causal in (True, False):
                cases.append((dtype_name, s, s, causal))
        for s, skv in ((64, 1024), (992, 1024)):
            cases.append((dtype_name, s, skv, True))
    gen = torch.Generator(device=device).manual_seed(0)
    rows, main = [], None
    for dtype_name, s, skv, causal in cases:
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((BH, n, HEAD_DIM), generator=gen,
                               device=device).to(dtype)

        q, k, v = rand(s), rand(skv), rand(skv)
        out = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        # the plain version in fp32 on the same values: the kernel
        # computes in fp32 and rounds only its output to the input dtype
        ref = reference_attention(q.float(), k.float(), v.float(), causal)
        err = (out.float() - ref).abs().max().item()
        tol = TOL[dtype_name]
        ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol))
        kernel_ms = cuda_time_ms(
            lambda: flash_attention_fwd(q, k, v, causal=causal))
        plain_ms = cuda_time_ms(
            lambda: reference_attention(q, k, v, causal))
        if causal and s != skv:  # SDPA aligns is_causal top-left
            mask = (torch.arange(skv, device=device)[None, :]
                    <= torch.arange(s, device=device)[:, None] + (skv - s))
            kw = {"attn_mask": mask}
        else:
            kw = {"is_causal": causal}
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], **kw))
        bound_ms, bound_by, nbytes, ops = attention_bound(
            BH, s, skv, HEAD_DIM, causal, dtype_name, q.element_size())
        row = dict(dtype=dtype_name, S=s, Skv=skv, causal=causal,
                   max_abs_err=err, tol=tol, ok=ok, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   ops=ops)
        rows.append(row)
        log(f"[kernels] flash_fwd {dtype_name:8s} BH={BH} S={s:4d} "
            f"Skv={skv:4d} D={HEAD_DIM} causal={causal!s:5s} "
            f"max_abs_err={err:.3e} (tol {tol:g}, atol=rtol) "
            f"{'ok' if ok else 'FAIL'} kernel_ms={kernel_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by})")
        if (dtype_name, s, skv, causal) == MAIN_CASE:
            main = row
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"in {len(bad)} case(s): {bad}")
    return rows, main


def phase_forward(device, preset="gpt2-small", batch=8, seq=1024):
    """Full-width forward with the kernel vs attention="ref". bf16 is held
    to the plain path's own rounding noise (its distance to the fp32
    model, times two); fp32 to a fixed tolerance."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        launch_count, reset_launch_count)

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
        f"(tol {tol32:g}); flash launches={launches} "
        f"(expect {cfg.n_layers}); first bf16 forward {fwd_s * 1e3:.1f} ms")
    if not (finite and shape_ok):
        raise AssertionError("forward logits are not finite or misshaped")
    if err > 2 * floor or err32 > tol32:
        raise AssertionError("forward with the kernel disagrees with "
                             "attention='ref'")
    if device.type == "cuda" and launches != cfg.n_layers:
        raise AssertionError(f"expected {cfg.n_layers} flash launches, got "
                             f"{launches}")
    return dict(err=err, floor=floor, err32=err32, launches=launches)


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
        launch_count, reset_launch_count)
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
        f"{launches} (need >= {need}); pages_in_use after it={pages}; "
        f"kv_backpressure={stats['kv']['kv_backpressure']}")
    if not (budget_ok and vocab_ok):
        raise AssertionError("serve: a request missed its token budget or "
                             "returned ids outside the vocabulary")
    if pages != 0:
        raise AssertionError(f"serve: {pages} KV pages still in use")
    if device.type == "cuda" and launches < need:
        raise AssertionError(f"serve: {launches} flash launches, fewer than "
                             f"one per layer per request ({need})")
    return dict(launches=launches, walls_s=walls,
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
    rows, main_row = phase_kernels(device)
    fwd = phase_forward(device)
    serve = phase_serve(device)
    phase_engine_parity(device)
    total_s = time.perf_counter() - t0

    log(json.dumps({"summary": {
        "card": card, "build_s": build_s, "total_s": total_s,
        "main_shape": {"BH": BH, "S": MAIN_CASE[1], "Skv": MAIN_CASE[2],
                       "D": HEAD_DIM, "dtype": MAIN_CASE[0],
                       "causal": MAIN_CASE[3]},
        "forward": fwd, "serve": serve}}))
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_memory_management_tpu_torch/csrc/"
                  "flash_attention_fwd.cu",
        "replaces": "ray_memory_management_tpu/ops/flash_attention.py:74",
        "launches": serve["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
