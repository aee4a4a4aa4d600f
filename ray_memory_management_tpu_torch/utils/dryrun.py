# rmtcheck: disable-file=log-discipline — a dry run whose lines are its output
"""The port's entry points: a forward step of the TransformerLM, and a
multi-device dry run that trains one step of each parallel layout.

    python3 -m ray_memory_management_tpu_torch.utils.dryrun [N]

Counterpart of ``__graft_entry__.py`` in the JAX package. :func:`entry`
returns the ``test`` preset's forward and its example arguments.
:func:`dryrun_multichip` spawns ``n`` processes joined into one
``torch.distributed`` world (NCCL with one card per rank, or gloo with
``device="cpu"``) and trains one AdamW(1e-3) step (optax ``adamw``'s
other defaults) of each of the JAX dry run's five layouts, at its
factorings, presets and sizes:

  - dp x tp (tp the largest of 8, 4, 2 that leaves dp >= 2, else that
    divides n), the ``test`` preset widened to max(4, tp) heads of 32;
  - dp x pp (pp 2, n >= 4 and even): the GPipe schedule over 2 stages, 2
    microbatches a data shard;
  - dp x ep (ep 4, n a multiple of 4): ``test-moe``'s experts over ep;
  - dp x sp (sp 4): ring attention over sp, S = 32 * sp;
  - fsdp x tp (tp 4): the parameters over both axes.

Rank 0 prints one ``dryrun_multichip: mesh ... step ok, loss=...`` line
a layout, as the JAX dry run does. The attention is the port's flash
path (the kernels on the card, their plain versions on the CPU: the JAX
dry run's ``attention="ref"`` there), the ring's chunks through the same
kernels. The dispatch groups of the MoE layout hold at most one data
rank's rows (the port raises on a group across two ranks' rows; at n = 8
the JAX default of 256 tokens would put B = 2 rows of two ranks in one
group of 64).

Each layout function takes the start weights and batch as optional numpy
trees (a JAX tree through ``np.asarray``), so that a test can hold the
port's losses against the JAX dry run's on the same inputs.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Any, Dict, Optional, Tuple

SEQ = 32  # the dry run's sequence length (x sp for the ring)
LR = 1e-3
TIMEOUT_S = 600.0  # the parent's wait for each rank's result
LAYOUTS = ("dp_tp", "dp_pp", "dp_ep", "dp_sp", "fsdp_tp")


def entry(device=None):
    """(fn, example_args): the ``test`` preset's forward
    (``gpt.forward`` with plain attention) over 2 x 64 tokens, with
    weights and tokens drawn from seed 0 on ``device`` (the card unless
    told otherwise)."""
    import torch

    from ..models import gpt
    from .device import resolve_device

    device = resolve_device(device)
    cfg = dataclasses.replace(gpt.PRESETS["test"], attention="ref")
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device=device)
    return functools.partial(gpt.forward, cfg=cfg), (params, tokens)


def dp_tp_axes(n: int) -> Dict[str, int]:
    """n factored into dp x tp, tp innermost; a non-degenerate dp where
    one exists (the JAX dry run's rule)."""
    for cand in (8, 4, 2):
        if n % cand == 0 and n // cand >= 2:
            return {"dp": n // cand, "tp": cand}
    for cand in (8, 4, 2):
        if n % cand == 0:
            return {"dp": n // cand, "tp": cand}
    return {"dp": n, "tp": 1}


def layout_axes(name: str, n: int) -> Dict[str, int]:
    if name == "dp_tp":
        return dp_tp_axes(n)
    if name == "dp_pp":
        return {"dp": n // 2, "pp": 2}
    if name == "dp_ep":
        return {"dp": n // 4, "ep": 4}
    if name == "dp_sp":
        return {"dp": n // 4, "sp": 4}
    if name == "fsdp_tp":
        return {"fsdp": n // 4, "tp": 4}
    raise ValueError(f"unknown layout {name!r}")


def layouts_for(n: int):
    """The layouts the JAX dry run trains at n devices."""
    out = ["dp_tp"]
    if n >= 4 and n % 2 == 0:
        out.append("dp_pp")
    if n >= 4 and n % 4 == 0:
        out += ["dp_ep", "dp_sp", "fsdp_tp"]
    return out


def batch_size(name: str, n: int) -> int:
    axes = layout_axes(name, n)
    if name == "dp_pp":
        return max(4, 2 * axes["dp"])
    return max(2, axes.get("dp", axes.get("fsdp", 1)))


def layout_config(name: str, n: int, dtype=None):
    """The layout's TransformerConfig: the JAX dry run's preset and
    widths, the port's flash (or ring) attention, and for the MoE layout
    dispatch groups of at most one data rank's tokens; ``dtype`` (a
    torch dtype) replaces the preset's compute dtype."""
    from ..models import gpt

    axes = layout_axes(name, n)
    over = {} if dtype is None else {"dtype": dtype}
    if name in ("dp_tp", "fsdp_tp"):
        heads = max(4, axes["tp"])
        return dataclasses.replace(gpt.PRESETS["test"], attention="flash",
                                   n_heads=heads, d_model=32 * heads, **over)
    if name == "dp_ep":
        cfg = gpt.PRESETS["test-moe"]
        rank_tokens = batch_size(name, n) // axes["dp"] * SEQ
        return dataclasses.replace(
            cfg, attention="flash",
            expert_group_size=min(cfg.expert_group_size, rank_tokens),
            **over)
    if name == "dp_sp":
        return dataclasses.replace(gpt.PRESETS["test"], attention="ring",
                                   **over)
    return dataclasses.replace(gpt.PRESETS["test"], attention="flash",
                               **over)


def _strategy(name: str) -> str:
    return {"dp_tp": "tp", "dp_pp": "dp", "dp_ep": "ep", "dp_sp": "dp",
            "fsdp_tp": "fsdp+tp"}[name]


def _start(name: str, n: int, cfg, device, start):
    """(params, batch) on ``device``: ``start``'s numpy trees, or weights
    and tokens drawn from a seed of the layout's own."""
    import numpy as np
    import torch

    from ..models import gpt
    from ..models.convert import params_from_jax

    if start is not None:
        params_np, batch_np = start
        params = params_from_jax(params_np, device=device)
        batch = {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(
            device) for k, v in batch_np.items()}
        return params, batch
    seed = LAYOUTS.index(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = gpt.init_params(cfg, gen, device)
    seq = SEQ * layout_axes(name, n).get("sp", 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size(name, n), seq),
                           generator=gen, device=device)
    return params, {"tokens": tokens,
                    "targets": torch.roll(tokens, -1, dims=1)}


def train_layout(name: str, n: int, device, start=None,
                 dtype=None) -> float:
    """One AdamW(1e-3) step of layout ``name`` over the n-rank world this
    rank belongs to: the step's loss (the start's), equal on every rank.
    ``start``: optional (params, batch) numpy trees; ``dtype``: the
    compute dtype, the preset's (bf16) when None."""
    import math

    import torch

    from .. import parallel as par
    from ..models import gpt

    axes = layout_axes(name, n)
    cfg = layout_config(name, n, dtype)
    mesh = par.make_mesh(axes, device_type=device.type)
    params, batch = _start(name, n, cfg, device, start)
    sharded = par.shard_pytree(params, mesh,
                               par.param_pspecs(params, mesh,
                                                _strategy(name)))
    opt = torch.optim.AdamW(list(gpt.param_leaves(sharded)), lr=LR,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    if name == "dp_pp":
        def loss_fn(p, b):
            return par.pipeline_loss_fn(p, b, cfg, mesh, n_microbatches=2,
                                        batch_axes=("dp",))
    else:
        sp_axis = "sp" if name == "dp_sp" else None

        def loss_fn(p, b):
            return gpt.loss_fn(p, b, cfg, mesh, sp_axis)
    loss = float(par.make_train_step(loss_fn, opt, mesh)(sharded, batch))
    if not (math.isfinite(loss) and loss > 0):
        raise AssertionError(f"dryrun_multichip: bad {name} loss {loss}")
    return loss


def describe(name: str, n: int, loss: float) -> str:
    """The JAX dry run's line for a layout."""
    axes = " ".join(f"{k}={v}" for k, v in layout_axes(name, n).items())
    what = {"dp_tp": "step ok", "dp_pp": "pipelined step ok",
            "dp_ep": "MoE step ok", "dp_sp": "ring-attention step ok",
            "fsdp_tp": "step ok"}[name]
    return f"dryrun_multichip: mesh {axes} {what}, loss={loss:.4f}"


def _rank(rank: int, n: int, device_type: str, init_method: str, starts,
          dtype, queue) -> None:
    import torch

    from ..collective.collective import init_dist_world

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        init_dist_world(n, rank, init_method, device_type)
        losses = {name: train_layout(name, n, device,
                                     (starts or {}).get(name), dtype)
                  for name in layouts_for(n)}
        torch.distributed.destroy_process_group()
        queue.put({"rank": rank, "losses": losses})
    except BaseException as e:  # noqa: BLE001 — reported by the parent
        import traceback

        queue.put({"rank": rank, "error": f"{e!r}\n{traceback.format_exc()}"})


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     starts: Optional[Dict[str, Tuple[Any, Any]]] = None,
                     dtype=None) -> Dict[str, float]:
    """One train step of each layout of :func:`layouts_for` over an
    ``n_devices``-rank world: NCCL with one card a rank (``device`` None
    or "cuda"; raises without enough cards), gloo on the CPU with
    ``device="cpu"``. ``starts`` maps a layout's name to its (params,
    batch) numpy trees. ``dtype`` (a torch dtype) replaces the presets'
    bf16 compute; it exists for the parity test, which holds the fp32
    losses to the JAX dry run's tighter than bf16 allows. Prints each
    layout's line and returns {layout: loss}; raises if any rank failed,
    gave no result within :data:`TIMEOUT_S`, or two ranks' losses
    differ."""
    import multiprocessing as mp

    import torch

    from ..collective.collective import pick_address

    device_type = device or "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip: {n_devices} ranks need {n_devices} CUDA "
            f"cards, {torch.cuda.device_count()} visible; pass "
            "device='cpu' for a gloo world on the CPU")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"tcp://{pick_address()}"
    procs = [ctx.Process(target=_rank, args=(r, n_devices, device_type,
                                             init_method, starts, dtype,
                                             queue))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(n_devices):
            item = queue.get(timeout=TIMEOUT_S)
            results[item["rank"]] = item
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    errors = [r["error"] for r in results.values() if "error" in r]
    if errors:
        raise RuntimeError("dryrun_multichip: a rank failed:\n" +
                           "\n".join(errors))
    losses = results[0]["losses"]
    if any(r["losses"] != losses for r in results.values()):
        raise AssertionError(f"dryrun_multichip: the ranks' losses differ: "
                             f"{[r['losses'] for r in results.values()]}")
    for name, loss in losses.items():
        print(describe(name, n_devices, loss), flush=True)
    return losses


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else torch.cuda.device_count()
    fn, args = entry()
    print("entry forward:", tuple(fn(*args).shape), flush=True)
    dryrun_multichip(n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
