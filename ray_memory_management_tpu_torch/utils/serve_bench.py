"""Serve data-plane bench: paged-KV capacity + open-loop SLO load gen.

Four measurements, matching the serving data plane's acceptance
criteria:

  - **Paged vs monolithic KV capacity** — at EQUAL device-memory
    budget, how many
    requests can decode concurrently? The monolithic slab hard-caps at
    ``budget / (max_seq x token_bytes)`` rows because every slot
    reserves worst-case capacity forever; the paged engine reserves each
    request's page-aligned lifetime need, so short requests pack many
    more live slots into the same bytes (target: >= 1.5x).
  - **Continuous vs barrier throughput** — tokens/s on STAGGERED
    arrivals (the serving shape): iteration-level scheduling admits a
    request the moment a slot frees; the whole-batch barrier makes every
    arrival wait out the previous batch's full budget.
  - **Open-loop SLO curve** — requests fired at fixed offered RPS
    regardless of completions (open loop: a closed-loop generator
    self-throttles and hides queueing collapse), p50/p99 latency and the
    fraction of requests over the SLO per level, through the REAL stack:
    handle -> router (p2c) -> replica actor -> engine.
  - **Cold start** — replica init seconds with locally-initialized
    params vs weights shipped quantized over the movement plane
    (:func:`~..serve.llm.pack_weights`).

Every suite runs on the card unless the caller passes ``device="cpu"``;
without a card and without ``device="cpu"`` it raises. Run directly:
``python -m ray_memory_management_tpu_torch.utils.serve_bench [--device cpu]``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

SERVE_DEFAULTS = dict(slo_ms=2000.0, rps_levels=(4.0, 16.0),
                      requests_per_level=16)


def _percentile(xs: List[float], p: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    idx = min(len(ys) - 1, max(0, int(round(p / 100.0 * (len(ys) - 1)))))
    return ys[idx]


BENCH_CONFIG = dict(vocab_size=256, n_layers=2, n_heads=2, d_model=32,
                    max_seq=256)


def _bench_model(device):
    """The suites' tiny model, weights drawn on ``device`` from a
    generator seeded 0."""
    import torch

    from ..models import gpt

    cfg = gpt.TransformerConfig(**BENCH_CONFIG)
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init_params(cfg, gen, device)
    return gpt, cfg, params


def _capacity_suite(mini: bool, device) -> Dict:
    """Peak concurrent decode slots, paged vs monolithic, at equal device
    budget. Short requests (8-token prompt + 8-token budget -> one
    16-token page) are the favorable-but-realistic serving shape the
    monolithic layout wastes 93% of its bytes on."""
    from ..serve.kv_cache import row_token_bytes
    from ..serve.llm import ContinuousBatcher

    gpt, cfg, params = _bench_model(device)
    token_bytes = row_token_bytes(cfg)
    slab_slots = 4  # the monolithic engine's whole budget...
    budget = slab_slots * cfg.max_seq * token_bytes
    max_slots = 8 if mini else 32  # ...and the paged slot table it funds
    n_req = max_slots if mini else 2 * max_slots

    eng = ContinuousBatcher(
        params, cfg, max_slots=max_slots, max_new_tokens=8,
        pad_multiple=8, steps_per_iter=4, kv_cache="paged",
        kv_page_tokens=16, kv_pool_bytes=budget)
    peak = 0
    stop = threading.Event()

    def sampler():
        nonlocal peak
        while not stop.is_set():
            peak = max(peak, sum(
                p is not None for p in eng._slot_pending))
            time.sleep(0.001)

    samp = threading.Thread(target=sampler, daemon=True)
    try:
        eng.submit([3, 5, 7, 2, 9, 4, 6, 8])  # warm
        samp.start()
        done: List[int] = []

        def one(i):
            out = eng.submit([2 + (i % 40), 5, 7, 2, 9, 4, 6, 8])
            done.append(len(out))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        dt = time.perf_counter() - t0
        tokens = sum(done)
    finally:
        stop.set()
        samp.join(timeout=1)
        kv_backpressure = eng.kv_backpressure
        eng.close()
    return {
        "slab_slots": slab_slots,
        "paged_slots": peak,
        "paged_slots_ratio": round(peak / max(slab_slots, 1), 2),
        "kv_backpressure": kv_backpressure,
        "capacity_budget_mb": round(budget / 2**20, 3),
        "capacity_tokens_per_s": round(tokens / max(dt, 1e-9), 1),
    }


def barrier_generate(params, cfg, items, steps: int,
                     bucket: int = 8) -> List[List[int]]:
    """The barrier coalescer's batch function: up to 4 prompts, each cut
    or padded (with 1s) to ``bucket`` tokens, decoded greedily together
    for ``steps`` tokens by ``gpt.generate``. Returns each item's new
    tokens (an item past the fourth gets the fourth row's)."""
    import numpy as np
    import torch

    from ..models import gpt

    batch = len(items)
    arr = np.ones((4, bucket), np.int64)
    for i, p in enumerate(items[:4]):
        arr[i, :len(p)] = p[:bucket]
    device = params["tok_embed"].device
    out = gpt.generate(params, cfg, torch.as_tensor(arr, device=device),
                       steps=steps, temperature=0.0)
    out = out.cpu().numpy()
    return [out[min(i, 3), bucket:bucket + steps].tolist()
            for i in range(batch)]


def _continuous_vs_barrier(mini: bool, device) -> Dict:
    """Tokens/s on staggered arrivals: the continuous engine vs the
    whole-batch barrier coalescer over the SAME model and budgets."""
    from ..serve.llm import ContinuousBatcher, DynamicBatcher

    gpt, cfg, params = _bench_model(device)
    steps = 16
    n_req = 6 if mini else 12
    gap_s = 0.01
    prompts = [[2 + (i % 40), 5, 7, 2, 9, 4, 6, 8] for i in range(n_req)]

    def run_engine(submit) -> float:
        done: List[int] = []

        def one(p):
            done.append(len(submit(p)))

        threads = [threading.Thread(target=one, args=(p,), daemon=True)
                   for p in prompts]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
            time.sleep(gap_s)  # staggered arrivals, open-loop shape
        for t in threads:
            t.join(timeout=120)
        dt = time.perf_counter() - t0
        return sum(done) / max(dt, 1e-9)

    eng = ContinuousBatcher(params, cfg, max_slots=4, max_new_tokens=steps,
                            pad_multiple=8, steps_per_iter=4)
    try:
        eng.submit(prompts[0])  # warm
        cont = run_engine(eng.submit)
    finally:
        eng.close()

    bat = DynamicBatcher(
        lambda items: barrier_generate(params, cfg, items, steps),
        max_batch_size=4, batch_wait_timeout_s=0.005)
    try:
        bat.submit(prompts[0])  # warm
        barrier = run_engine(bat.submit)
    finally:
        bat.close()
    return {
        "continuous_tokens_per_s": round(cont, 1),
        "barrier_tokens_per_s": round(barrier, 1),
        "continuous_vs_barrier": round(cont / max(barrier, 1e-9), 2),
    }


def _cold_start(device) -> Dict:
    """Replica init seconds: local param init vs quantized shipped
    weights (pack time charged to the ship path — it runs once on the
    driver, not per replica, but the honest cold-start story counts
    it)."""
    from ..serve.llm import LLMServer, pack_weights

    t0 = time.perf_counter()
    srv = LLMServer(preset="test", max_new_tokens=4, max_batch_size=2,
                    pad_multiple=8, device=device)
    init_s = time.perf_counter() - t0
    if srv._engine is not None:
        srv._engine.close()

    t0 = time.perf_counter()
    payload = pack_weights(srv.params, "bf16")
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv2 = LLMServer(preset="test", max_new_tokens=4, max_batch_size=2,
                     pad_multiple=8, weights=payload, device=device)
    shipped_s = time.perf_counter() - t0
    if srv2._engine is not None:
        srv2._engine.close()
    return {
        "cold_start_init_s": round(init_s, 4),
        "cold_start_shipped_s": round(shipped_s + pack_s, 4),
        "weights_pack_s": round(pack_s, 4),
    }


def _open_loop_suite(slo_ms: float, rps_levels, requests_per_level,
                     device) -> Dict:
    """Open-loop load against the real serve stack (handle -> p2c router
    -> replica actor -> continuous engine), one latency curve point per
    offered-RPS level. On the card the replica takes a ``num_gpus=1``
    lease; on the CPU it is told ``device="cpu"``."""
    from .. import api as rmt
    from .. import serve
    from ..serve.llm import llm_deployment

    on_card = device.type == "cuda"
    placement = ({"ray_actor_options": {"num_gpus": 1}} if on_card
                 else {"device": "cpu"})
    rmt.init(num_cpus=4, num_gpus=1 if on_card else 0)
    curve = []
    shed_total = 0.0
    try:
        serve.start(http_port=None)
        try:
            h = serve.run(llm_deployment(
                "test", max_new_tokens=4, max_batch_size=4,
                pad_multiple=8, max_concurrent_queries=8, **placement))
            rmt.get(h.remote({"tokens": [5, 3, 9]}), timeout=300)  # warm
            for rps in rps_levels:
                lat_ms: List[float] = []
                errors: List[str] = []
                lock = threading.Lock()

                def one():
                    t0 = time.perf_counter()
                    try:
                        ref = h.remote({"tokens": [5, 3, 9, 2, 7]})
                        rmt.get(ref, timeout=60)
                        ms = (time.perf_counter() - t0) * 1e3
                        with lock:
                            lat_ms.append(ms)
                    except Exception as e:  # noqa: BLE001 — count sheds
                        with lock:
                            errors.append(repr(e))

                threads = []
                for _ in range(requests_per_level):
                    t = threading.Thread(target=one, daemon=True)
                    t.start()
                    threads.append(t)
                    time.sleep(1.0 / rps)  # open loop: fixed arrivals
                for t in threads:
                    t.join(timeout=90)
                n_over = sum(1 for m in lat_ms if m > slo_ms)
                n = len(lat_ms) + len(errors)
                curve.append({
                    "offered_rps": rps,
                    "p50_ms": round(_percentile(lat_ms, 50), 1),
                    "p99_ms": round(_percentile(lat_ms, 99), 1),
                    # an error (shed/timeout) IS an SLO violation
                    "violation_pct": round(
                        100.0 * (n_over + len(errors)) / max(n, 1), 1),
                    "completed": len(lat_ms),
                    "errors": len(errors),
                })
            try:
                from ..core import metrics_defs as mdefs
                shed_total = sum(
                    mdefs.serve_shed().series().values())
            except Exception:  # noqa: BLE001
                pass
        finally:
            serve.shutdown()
    finally:
        rmt.shutdown()
    top = curve[-1] if curve else {}
    return {
        "latency_curve": curve,
        "offered_rps": top.get("offered_rps", 0.0),
        "p50_ms": top.get("p50_ms", 0.0),
        "p99_ms": top.get("p99_ms", 0.0),
        "slo_ms": slo_ms,
        "slo_violation_pct": top.get("violation_pct", 0.0),
        "n_requests": sum(c["completed"] + c["errors"] for c in curve),
        "shed_total": round(shed_total, 1),
    }


def run_serve_suite(mini: bool = False, slo_ms: float = None,
                    rps_levels=None, requests_per_level: int = None,
                    device=None) -> Dict:
    import torch

    from .device import resolve_device

    device = resolve_device(device)
    slo_ms = SERVE_DEFAULTS["slo_ms"] if slo_ms is None else slo_ms
    if rps_levels is None:
        rps_levels = (8.0,) if mini else SERVE_DEFAULTS["rps_levels"]
    if requests_per_level is None:
        requests_per_level = 6 if mini \
            else SERVE_DEFAULTS["requests_per_level"]

    out: Dict = {"mini": bool(mini)}
    out.update(_capacity_suite(mini, device))
    out.update(_continuous_vs_barrier(mini, device))
    out.update(_cold_start(device))
    out.update(_open_loop_suite(slo_ms, rps_levels, requests_per_level,
                                device))
    # tokens/s/chip: the concurrent-decode rate of the capacity run
    # normalized per visible card (CPU bench: one "chip")
    n_chips = (max(1, torch.cuda.device_count()) if device.type == "cuda"
               else 1)
    out["n_chips"] = n_chips
    out["tokens_per_s_per_chip"] = round(
        out["capacity_tokens_per_s"] / n_chips, 1)
    return out


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    print(json.dumps(run_serve_suite(mini=True, device=args.device),
                     indent=1))
