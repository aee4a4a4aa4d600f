"""The parallel strategies across cards: dp, fsdp, tp and fsdp+tp, and on
request the GPipe pipeline (pp, dp+pp); for a MoE preset ep, dp+ep, sp
with ring or Ulysses attention, the expert weights under fsdp, tp,
fsdp+tp and ep+tp, and dp+sp with ring or Ulysses attention.

    python3 -m ray_memory_management_tpu_torch.utils.strategy_bench
    python3 -m ray_memory_management_tpu_torch.utils.strategy_bench \\
        --strategies pp,dp+pp [--dtype float32]
    python3 -m ray_memory_management_tpu_torch.utils.strategy_bench \\
        --preset mixtral-tiny --batch 4 --seq 2048
    python3 -m ray_memory_management_tpu_torch.utils.strategy_bench \\
        --device cpu --preset test --batch 8 --seq 32      # gloo, no card

Spawns ``--ranks`` processes (4 by default), one card each, joined into
one NCCL world (gloo with ``--device cpu``). Every rank draws the same
weights and batch from ``gpu_bench``'s seed, and for each strategy —
``dp`` over all ranks, ``fsdp`` over all ranks, ``tp`` over all ranks
and ``fsdp+tp`` over half by half; for a MoE preset ``ep`` over all ranks
(the experts split among them), ``dp+ep`` (2 x half), ``sp-ring`` and
``sp-ulysses`` over all ranks, ``fsdp``, ``tp`` and ``fsdp+tp`` as for a
dense preset (the expert weights' fsdp shards gathered, tp within each
expert), ``ep+tp`` (2 x half) and ``dp+sp-ring`` and ``dp+sp-ulysses`` (2
x half); ``pp`` over all ranks and ``dp+pp`` (2 x half), the block stack
in as many stages with as many microbatches (``pipeline_loss_fn``) —
shards them with ``param_pspecs`` and
``shard_pytree`` and takes ``--steps`` AdamW steps through
``make_train_step`` (two warm-up steps first, on a copy of the same
start). Rank 0 first takes the same steps on one device with
``gpu_bench.train_step``, the unsharded reference. Per strategy it
prints the losses, their largest relative distance from the reference,
the best step time, tokens/s and every rank's kernel launches by
design; it fails on a non-finite loss, a distance above the JAX
package's own 5e-2 between strategies (``tests/test_parallel.py:70``),
or a rank whose kernels did not launch as often as its attention asks:
once per layer per step, under the ring once per K/V chunk a rank
attends (r + 1 of the causal ring's chunks on the ring's rank r), and
under a pipeline once per layer of its stage and microbatch. The
sharding of the pipeline rows and of the MoE rows without tp changes no
arithmetic but the order of sums and roundings, so every loss of theirs
is held to 1e-3; the dense preset's four rows and every row that shards
within a product (tp) to the 5e-2. Routing is discontinuous: a
rounding-sized change of a router input can move a token to another
expert, and AdamW turns the changed gradient into an lr-sized step. So
the reference run records its expert choices, rank 0 broadcasts them,
and each MoE row's measured steps replay them (``moe.pinned_routing``; a
data rank its own rows' groups): the rows compare the sharded arithmetic
with the unsharded, and print how many of rank 0's choices the replay
overrode.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any, Dict, List

STRATEGIES = ("dp", "fsdp", "tp", "fsdp+tp")
PP_STRATEGIES = ("pp", "dp+pp")  # dense presets, on request
MOE_STRATEGIES = ("ep", "dp+ep", "sp-ring", "sp-ulysses", "fsdp", "tp",
                  "fsdp+tp", "ep+tp", "dp+sp-ring", "dp+sp-ulysses")
TOL = 5e-2  # the JAX package's dp-against-tp bound
ORDER_TOL = 1e-3  # rows whose sharding changes only the order of sums


def strategies_for(preset: str):
    """The rows a preset runs by default."""
    from ..models import gpt

    return MOE_STRATEGIES if gpt.PRESETS[preset].n_experts else STRATEGIES


def strategies_allowed(preset: str):
    from ..models import gpt

    return (MOE_STRATEGIES if gpt.PRESETS[preset].n_experts
            else STRATEGIES + PP_STRATEGIES)


def strategy_axes(strategy: str, ranks: int) -> Dict[str, int]:
    if strategy == "fsdp+tp":
        return {"fsdp": ranks // 2, "tp": 2}
    if strategy == "dp+ep":
        return {"dp": 2, "ep": ranks // 2}
    if strategy == "dp+pp":
        return {"dp": 2, "pp": ranks // 2}
    if strategy == "ep+tp":
        return {"ep": 2, "tp": ranks // 2}
    if strategy.startswith("dp+sp-"):
        return {"dp": 2, "sp": ranks // 2}
    if strategy.startswith("sp-"):
        return {"sp": ranks}
    return {strategy: ranks}


def _attention(strategy: str) -> str:
    return strategy.split("sp-")[1] if "sp-" in strategy else "flash"


def row_tol(strategy: str, preset: str) -> float:
    """A row's bound on its losses' distance from the unsharded run's:
    :data:`TOL` for a dense preset's four rows and for every row with
    tp, which shards within a product; else :data:`ORDER_TOL`."""
    from ..models import gpt

    dense = not gpt.PRESETS[preset].n_experts
    return (TOL if (dense and strategy in STRATEGIES) or "tp" in strategy
            else ORDER_TOL)


def microbatches(strategy: str, ranks: int) -> int:
    """A pipeline row's microbatches: as many as stages (the JAX
    default); 1 for any other row."""
    return strategy_axes(strategy, ranks).get("pp", 1)


def launches_wanted(strategy: str, rank: int, n_layers: int, steps: int,
                    ranks: int) -> int:
    """Each kernel's launches on ``rank`` in ``steps`` steps: once per
    layer and step, the ring's once per chunk attended (its rank on the
    sp axis, the mesh's last, plus one), a pipeline stage's once per
    layer of its stage (L/S) and microbatch (M)."""
    axes = strategy_axes(strategy, ranks)
    per_layer = rank % axes["sp"] + 1 if strategy.endswith("sp-ring") else 1
    stages = axes.get("pp", 1)
    return (per_layer * n_layers // stages * microbatches(strategy, ranks)
            * steps)


def _setup(args, device, attention: str):
    """``gpu_bench.setup_training`` with ``--dtype`` applied."""
    import dataclasses

    import torch

    from . import gpu_bench

    params, opt, batch, cfg = gpu_bench.setup_training(
        args.preset, args.batch, args.seq, False, attention, device)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    return params, opt, batch, cfg


def _reference(args, device):
    """The unsharded run's losses and, for a MoE preset, its expert
    choices (uint8 on the CPU, one [G, g] tensor a top-k round)."""
    import torch

    from ..ops import moe
    from . import gpu_bench

    params, opt, batch, cfg = _setup(args, device, "flash")
    choices = []
    with moe.pinned_routing(record=choices):
        losses = [gpu_bench.train_step(params, opt, batch, cfg)
                  for _ in range(args.steps)]
    return (torch.stack(losses).tolist(),
            [c.to("cpu", torch.uint8) for c in choices])


def _local_choices(choices, mesh, device):
    """The reference's choices for this rank's rows: every group, or on a
    data axis this data rank's share of them (its rows are a contiguous
    share of the batch, and so of the dispatch groups)."""
    import torch

    from ..parallel.sharding import data_groups

    _, n, i = data_groups(mesh)
    return [c.chunk(n)[i].to(device, torch.long) for c in choices]


def _strategy(args, device, strategy: str, choices) -> Dict[str, Any]:
    import contextlib

    import torch

    from .. import parallel as par
    from ..models import gpt
    from ..ops import moe
    from ..ops.flash_attention import (bwd_design_counts, fwd_design_counts,
                                       reset_launch_count)
    from . import gpu_bench

    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    heads = gpt.PRESETS[args.preset].n_heads
    mesh = par.make_mesh(strategy_axes(strategy, args.ranks),
                         device_type=device.type)

    rule = "dp" if "sp-" in strategy or "pp" in strategy else strategy
    n_micro = microbatches(strategy, args.ranks)
    batch_axes = ("dp",) if strategy == "dp+pp" else ()

    def loss_fn(cfg):
        if "pp" in strategy:
            return lambda p, b: par.pipeline_loss_fn(
                p, b, cfg, mesh, n_microbatches=n_micro,
                batch_axes=batch_axes)
        return lambda p, b: gpt.loss_fn(p, b, cfg, mesh)

    def build():
        params, _, batch, cfg = _setup(args, device, _attention(strategy))
        sp = par.shard_pytree(params, mesh,
                              par.param_pspecs(params, mesh, rule))
        opt = torch.optim.AdamW(list(gpt.param_leaves(sp)),
                                **gpu_bench.ADAMW)
        step = par.make_train_step(loss_fn(cfg), opt, mesh)
        return sp, batch, step

    sp, batch, step = build()  # warm-up on a copy of the start
    for _ in range(2):
        step(sp, batch)
    sp, batch, step = build()
    replay = _local_choices(choices, mesh, device) if choices else None
    flips = []
    pinned = (moe.pinned_routing(replay=replay, flips=flips) if replay
              else contextlib.nullcontext())
    sync()
    reset_launch_count()
    losses, times = [], []
    with pinned:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            losses.append(step(sp, batch))
            sync()
            times.append(time.perf_counter() - t0)
    return {"losses": torch.stack(losses).tolist(),
            "step_ms": min(times) * 1e3,
            # (choices the replay overrode, choices) on this rank
            "routing_replayed": [int(sum(flips)),
                                 sum(c.numel() for c in replay)]
            if replay else None,
            "designs": {"fwd": fwd_design_counts(), **bwd_design_counts()},
            # heads each rank's attention kernel sees (tp, Ulysses)
            "local_heads": {"tp": heads // args.ranks, "fsdp+tp": heads // 2,
                            "ep+tp": heads // (args.ranks // 2),
                            "sp-ulysses": heads // args.ranks,
                            "dp+sp-ulysses": heads // (args.ranks // 2),
                            }.get(strategy)}


def _rank(rank: int, args, init_method: str, queue) -> None:
    import torch

    from ..collective.collective import init_dist_world

    try:
        if args.device == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        out: Dict[str, Any] = {"rank": rank}
        choices = None
        if rank == 0:
            out["reference"], choices = _reference(args, device)
        backend = init_dist_world(args.ranks, rank, init_method, args.device)
        box = [choices]
        torch.distributed.broadcast_object_list(box, src=0)
        out["backend"] = backend
        out["strategies"] = {s: _strategy(args, device, s, box[0])
                             for s in args.strategies}
        if args.device == "cuda":
            from .runtime_smoke import _device_uuid

            out["device_uuid"] = _device_uuid(device)
        queue.put(out)
    except BaseException as e:  # noqa: BLE001 — reported by the parent
        import traceback

        queue.put({"rank": rank, "error": f"{e!r}\n{traceback.format_exc()}"})


def run(args) -> Dict[str, Any]:
    import multiprocessing as mp

    from ..collective.collective import pick_address

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"tcp://{pick_address()}"
    procs = [ctx.Process(target=_rank, args=(r, args, init_method, queue))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(args.ranks):
            item = queue.get(timeout=args.timeout)
            results[item["rank"]] = item
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    errors = [r["error"] for r in results.values() if "error" in r]
    if errors:
        raise RuntimeError("strategy_bench: a rank failed:\n" +
                           "\n".join(errors))
    return results


def summarize(args, results) -> Dict[str, Any]:
    from ..models import gpt

    ref = results[0]["reference"]
    n_layers = gpt.PRESETS[args.preset].n_layers
    out = {"reference": ref, "ranks": args.ranks,
           "backend": results[0]["backend"],
           "device_uuids": sorted({r.get("device_uuid")
                                   for r in results.values()} - {None}),
           "strategies": {}}
    bad = []
    for s in args.strategies:
        rows = [results[r]["strategies"][s] for r in range(args.ranks)]
        losses = rows[0]["losses"]
        dist = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        step_ms = max(row["step_ms"] for row in rows)
        launches = [row["designs"] for row in rows]
        out["strategies"][s] = {
            "axes": strategy_axes(s, args.ranks), "losses": losses,
            "max_rel_to_reference": dist,
            "routing_replayed": rows[0]["routing_replayed"],
            "step_ms": step_ms,
            "tokens_per_s": args.batch * args.seq / step_ms * 1e3,
            "local_heads": rows[0]["local_heads"],
            "microbatches": microbatches(s, args.ranks),
            "launches": launches}
        launched = all(
            d["fwd"]["wgmma"] + d["fwd"]["simt"] == want
            and all(d[k]["wgmma"] + d[k]["simt"] == want
                    for k in d if k != "fwd")
            for d, want in ((d, launches_wanted(s, r, n_layers, args.steps,
                                                args.ranks))
                            for r, d in enumerate(launches))
        ) if args.device == "cuda" else True
        tol = row_tol(s, args.preset)
        if (not all(math.isfinite(x) for x in losses) or dist > tol
                or any(row["losses"] != losses for row in rows)
                or not launched):
            bad.append(s)
    out["failed"] = bad
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--preset", default="gpt2-small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="compute dtype (default: the preset's)")
    ap.add_argument("--strategies",
                    help="comma-separated rows to run (default: the "
                    "preset's: dp,fsdp,tp,fsdp+tp, or the MoE rows; a "
                    "dense preset also takes pp and dp+pp)")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    allowed = strategies_allowed(args.preset)
    args.strategies = (tuple(args.strategies.split(",")) if args.strategies
                       else strategies_for(args.preset))
    if not set(args.strategies) <= set(allowed):
        raise SystemExit(f"strategy_bench: {args.preset} runs "
                         f"{','.join(allowed)}; asked {args.strategies}")
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"strategy_bench: {args.ranks} ranks need "
                             f"{args.ranks} cards, "
                             f"{torch.cuda.device_count()} visible")
    if args.ranks % 2:
        raise SystemExit("strategy_bench: the rows over 2 x half the ranks "
                         "need an even rank count")
    summary = summarize(args, run(args))
    for s, row in summary["strategies"].items():
        print(f"{s} {row['axes']}: step_ms={row['step_ms']:.2f} "
              f"tokens_per_s={row['tokens_per_s']:.1f} losses "
              f"{[round(x, 5) for x in row['losses']]} max_rel_to_reference="
              f"{row['max_rel_to_reference']:.3g} routing_replayed (moved, "
              f"of) {row['routing_replayed']} local_heads="
              f"{row['local_heads']} microbatches={row['microbatches']} "
              f"forward launches per rank "
              f"{[sum(d['fwd'].values()) for d in row['launches']]}")
    print(json.dumps(summary))
    if summary["failed"]:
        print(f"strategy_bench: failed {summary['failed']}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
