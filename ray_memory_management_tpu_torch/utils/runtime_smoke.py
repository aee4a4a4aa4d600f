"""Task and actor bodies that ``chip_smoke.py``'s runtime phase sends to
the port's workers.

They live in an importable module of the port, so the runtime pickles
them by reference (``serialization._needs_by_value`` is False for the
port's own modules) and a worker imports them as it would any library
code; nothing here runs at import.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

from ..collective import CollectiveGroupMixin
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
    this call, and the node it ran on."""
    from ..ops.flash_attention import (
        flash_attention, fwd_design_counts, launch_counts,
        reset_launch_count)

    _require_cuda(q, k, v)
    reset_launch_count()
    out = flash_attention(q, k, v, causal=causal)
    return {"out": out,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_uuid": _device_uuid(out.device),
            "node_id": os.environ.get("RMT_NODE_ID"),
            "launches": launch_counts(),
            "designs": fwd_design_counts()}


def echo(x) -> Dict[str, Any]:
    """Hand ``x`` back from the worker's card, with the wall-clock times
    at which it had landed there (``t_in``) and at which the task
    returned (``t_out``): on one host, the driver's clock splits a round
    trip into its two directions."""
    import torch

    _require_cuda(x)
    torch.cuda.synchronize(x.device)
    t_in = time.time()
    return {"x": x, "t_in": t_in, "node_id": os.environ.get("RMT_NODE_ID"),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "t_out": time.time()}


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
                "node_id": os.environ.get("RMT_NODE_ID"),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES")}


# ------------------------------------------------------------ train plane
def train_loop(config: Dict[str, Any]) -> None:
    """``chip_smoke.py`` phase 10's ``TorchTrainer`` loop: ``config``'s
    preset (gpt2-small on the card) trained through the port's parallel
    library — ``make_mesh({"dp": world})``, ``param_pspecs(..., "dp")``,
    ``shard_pytree`` and ``make_train_step`` with AdamW — from
    ``gpu_bench``'s seed, so its first loss is ``train_step_mfu``'s.

    Steps run as ``train_step_mfu`` times them: warm-up steps, then
    three timed windows of ``(steps - 1) // 3`` steps, each ending in a
    synchronise.
    After step ``ckpt_at - 1`` (between windows) it reports a checkpoint
    of the parameters and the optimizer state; resumed from it, the loop
    runs the remaining steps. Launch counts are zeroed just before the
    first step and read just after the last. The last report holds every
    step's loss, the windows' times and the worker's lease and card."""
    import torch

    from .. import parallel as par
    from ..models import gpt
    from ..ops.flash_attention import (bwd_design_counts, fwd_design_counts,
                                       launch_counts, reset_launch_count)
    from ..train import Checkpoint, session
    from . import gpu_bench

    t_loop = time.time()
    device = torch.device(config["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    world, rank = session.get_world_size(), session.get_world_rank()
    B, S, steps = config["batch"], config["seq"], config["steps"]
    mesh = par.make_mesh({"dp": world}, device_type=device.type)
    params, _, batch, cfg = gpu_bench.setup_training(
        config["preset"], B, S, False, "flash", device)
    start, ckpt = 0, session.get_checkpoint()
    if ckpt is not None:
        start, tree = ckpt.to_dict()["step"], ckpt.get_pytree()
        params = _tree_to(tree["params"], device)
    n_params = gpt.count_params(params)
    sp = par.shard_pytree(params, mesh, par.param_pspecs(params, mesh, "dp"))
    del params
    opt = torch.optim.AdamW(list(gpt.param_leaves(sp)), **gpu_bench.ADAMW)
    if ckpt is not None:
        par.load_optimizer_state(opt, tree["opt"])
    step = par.make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg), opt,
                               mesh)
    sync()
    t_ready = time.time()

    window = (steps - 1) // 3
    marks = {steps - 3 * window + k * window for k in range(3)}
    ends = sorted({e for e in marks | {config["ckpt_at"], steps}
                   if start < e <= steps})
    reset_launch_count()
    losses, segments, snapshot_s = [], [], None
    i = start
    for end in ends:
        sync()
        t0 = time.perf_counter()
        first = i
        while i < end:
            losses.append(step(sp, batch))
            i += 1
        sync()
        segments.append((first, end, time.perf_counter() - t0))
        if end == config["ckpt_at"] and end < steps:
            t0 = time.perf_counter()
            snap = Checkpoint.from_pytree(
                {"params": sp, "opt": opt.state_dict()},
                extra={"step": end})
            snapshot_s = time.perf_counter() - t0
            session.report({"step": end, "checkpoint_at": end},
                           checkpoint=snap if rank == 0 else None)
    counts = (launch_counts(), fwd_design_counts(), bwd_design_counts())
    losses = torch.stack(losses).tolist()
    timed = [s for s in segments if s[0] in marks and s[1] - s[0] == window]
    best = min((s[2] for s in timed), default=None)
    flops_per_token = 6 * n_params + 6 * cfg.n_layers * S * cfg.d_model
    # the batch of B rows is the global one: make_train_step shards it
    tokens_per_s = B * S * window / best if best else None
    session.report({
        "final": True, "start": start, "losses": losses,
        "segments": segments, "window": window,
        "step_ms": best / window * 1e3 if best else None,
        "tokens_per_s": tokens_per_s,
        "mfu": (tokens_per_s * flops_per_token / gpu_bench.PEAK_BF16_H100
                if on_card and tokens_per_s else None),
        "n_params": n_params, "launches": counts[0], "designs": counts[1],
        "bwd_designs": counts[2], "snapshot_s": snapshot_s,
        "t_loop": t_loop, "t_ready": t_ready,
        "backend": str(torch.distributed.get_backend()),
        "lease": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_uuid": _device_uuid(device) if on_card else None,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if on_card else None),
    })


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _collective_cases(x):
    """(op, reduce op, precision, the plain expectation) of every
    collective at world size 1, where each reduction of one rank is its
    own tensor (f32: bit-equal; bf16: one rounding; int8: the codec's
    numpy block quantization of the same tensor)."""
    import torch

    from ..core import codec

    bf16 = x.to(torch.bfloat16).float()
    int8 = torch.from_numpy(codec.dequantize_array(codec.quantize_array(
        x.float().cpu().numpy(), "int8"))).to(x.device)
    plain = {"f32": x, "bf16": bf16, "int8": int8}
    cases = []
    for p in ("f32", "bf16", "int8"):
        for op in ("sum", "max", "min", "product"):
            cases.append(("allreduce", op, p, plain[p]))
        cases.append(("reducescatter", "sum", p, plain[p]))
        cases.append(("reduce", "sum", p, plain[p]))
    cases += [("allgather", None, "f32", x[None]),
              ("broadcast", None, "f32", x),
              ("ppermute", None, "f32", x)]
    return cases


class CollectiveProbe(CollectiveGroupMixin):
    """An actor that joins a collective group (the mixin's hook) and runs
    every collective of it on its card (``chip_smoke.py`` phase 10),
    each result beside its plain expectation."""

    def probe(self, group_name: str, n: int) -> Dict[str, Any]:
        import statistics

        import torch

        from .. import collective as col
        from ..core import metrics_defs as mdefs

        group = col.collective._group_mgr.get(group_name)
        on_card = group.device_type == "cuda"
        device = torch.device("cuda", 0) if on_card else torch.device("cpu")
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(n, generator=gen).to(device)
        quantized = mdefs.collective_quantized_ops()

        def count(op, p):
            return quantized.get(tags={"op": op, "precision": p})

        def run(op, red, p):
            if op == "allreduce":
                return col.allreduce(x, group_name, red, precision=p)
            if op == "reducescatter":
                return col.reducescatter(x, group_name, red, precision=p)
            if op == "reduce":
                return col.reduce(x, 0, group_name, red, precision=p)
            if op == "allgather":
                return col.allgather(x, group_name)
            if op == "broadcast":
                return col.broadcast(x, 0, group_name)
            return group.ppermute(x, [(0, 0)])

        rows = []
        for op, red, p, want in _collective_cases(x):
            before = count(op, p)
            got = run(op, red, p)
            sync()
            counted = count(op, p) - before
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                run(op, red, p)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            rows.append({
                "op": op, "reduce": red, "precision": p,
                "device": str(got.device), "shape": list(got.shape),
                "bit_equal": bool(torch.equal(got, want)),
                "max_abs_err": float((got.float() - x.float()).abs().max())
                if got.shape == x.shape else 0.0,
                "counted": counted,
                "ms": statistics.median(times)})
        col.barrier(group_name)
        return {"rows": rows, "absmax": float(x.abs().max()),
                "backend": group.backend, "world": group.world_size,
                "lease": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_uuid": _device_uuid(device) if on_card else None}


# ----------------------------------------------------- data, tune, workflow
_SCORERS: Dict[tuple, Any] = {}


def _scoring_model(preset: str, seed: int, dtype: str, device):
    """``preset``'s params and config for :func:`score_batch`, drawn from
    ``seed`` once per process and device (a pool actor scores every batch
    with the same weights)."""
    import dataclasses

    import torch

    from ..models import gpt

    key = (preset, seed, dtype, str(device))
    if key not in _SCORERS:
        cfg = dataclasses.replace(gpt.PRESETS[preset],
                                  dtype=getattr(torch, dtype))
        gen = torch.Generator(device=device).manual_seed(seed)
        _SCORERS[key] = (gpt.init_params(cfg, gen, device), cfg)
    return _SCORERS[key]


def score_batch(batch, *, preset: str = "gpt2-small", seed: int = 0,
                dtype: str = "bfloat16", device=None) -> Dict[str, Any]:
    """Batch inference for ``Dataset.map_batches``: ``batch`` is a numpy
    array of token rows [b, S]; ``preset``'s forward (the flash forward
    kernel on the card) scores them on this process's card (``device``
    None; it raises without one). Returns host numpy columns:
    ``logprob`` (fp32, each row's mean log-probability of its next
    token), ``argmax`` (the most likely id after the last position), and
    per row the batch's reads of this process: ``launches`` and
    ``wgmma`` (flash forward launches and their wgmma share, counted
    from zero just before this batch's forward and read just after),
    ``batch_s`` (this call's seconds, the first call's including the
    model's draw), ``pid`` and ``device_uuid``."""
    import numpy as np
    import torch

    from ..models import gpt
    from ..ops.flash_attention import (fwd_design_counts, launch_count,
                                       reset_launch_count)
    from .device import resolve_device

    t0 = time.perf_counter()
    device = resolve_device(device)
    params, cfg = _scoring_model(preset, seed, dtype, device)
    tokens = torch.from_numpy(np.array(batch, np.int64)).to(device)
    with torch.inference_mode():
        reset_launch_count()
        logits = gpt.forward(params, tokens, cfg)
        launches, wgmma = launch_count(), fwd_design_counts()["wgmma"]
        head = logits[:, :-1]
        take = head.gather(-1, tokens[:, 1:, None])[..., 0]
        logprob = (take - torch.logsumexp(head, dim=-1)).mean(-1)
        argmax = logits[:, -1].argmax(-1)
        logprob, argmax = logprob.cpu().numpy(), argmax.cpu().numpy()
    n = len(logprob)
    uuid = _device_uuid(device) if device.type == "cuda" else ""
    return {"logprob": logprob.astype(np.float32),
            "argmax": argmax.astype(np.int64),
            "launches": np.full(n, launches, np.int64),
            "wgmma": np.full(n, wgmma, np.int64),
            "batch_s": np.full(n, time.perf_counter() - t0),
            "pid": np.full(n, os.getpid(), np.int64),
            "device_uuid": np.full(n, uuid)}


def split_next_token(batch) -> Dict[str, Any]:
    """``map_batches`` body: rows of S + 1 ids become ``tokens`` (the
    first S) and ``targets`` (the last S)."""
    return {"tokens": batch[:, :-1], "targets": batch[:, 1:]}


def data_train_loop(config: Dict[str, Any]) -> None:
    """A ``TorchTrainer`` loop fed by the Data library (``chip_smoke.py``
    phase 13 (b)): the worker's ``get_dataset_shard("train")`` yields
    ``{"tokens", "targets"}`` batches of ``config["batch"]`` rows through
    ``iter_batches(batch_format="numpy")``; each goes to the worker's
    device and through ``make_train_step`` (AdamW, ``gpu_bench.ADAMW``)
    over a ``{"dp": world}`` mesh. Params are ``config["params"]`` (a
    numpy tree of the JAX package's layout, through
    ``convert.params_from_jax``) or ``gpu_bench``'s seeded draw of
    ``config["preset"]``; ``config["dtype"]`` is the compute dtype.

    Every step is synchronised and timed from the end of the previous
    one, so its time holds the wait in ``iter_batches`` and the copy to
    the device; the wait is also timed alone. Launch counts are zeroed
    just before the first step and read just after the last. One final
    report holds every step's loss, times and waits, the launches, the
    worker's lease and card."""
    import dataclasses

    import torch

    from .. import parallel as par
    from ..models import gpt
    from ..models.convert import params_from_jax
    from ..ops.flash_attention import (bwd_design_counts, fwd_design_counts,
                                       launch_counts, reset_launch_count)
    from ..train import session
    from . import gpu_bench

    t_loop = time.time()
    device = torch.device(config["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    B, S = config["batch"], config["seq"]
    cfg = dataclasses.replace(gpt.PRESETS[config["preset"]], max_seq=S,
                              dtype=getattr(torch, config["dtype"]))
    if config.get("params") is not None:
        params = params_from_jax(config["params"], device=device)
    else:
        params = gpu_bench.setup_training(config["preset"], B, S, False,
                                          "flash", device)[0]
    mesh = par.make_mesh({"dp": session.get_world_size()},
                         device_type=device.type)
    n_params = gpt.count_params(params)
    sp = par.shard_pytree(params, mesh, par.param_pspecs(params, mesh, "dp"))
    del params
    opt = torch.optim.AdamW(list(gpt.param_leaves(sp)), **gpu_bench.ADAMW)
    step = par.make_train_step(lambda p, b: gpt.loss_fn(p, b, cfg), opt,
                               mesh)
    batches = session.get_dataset_shard("train").iter_batches(
        batch_size=B, batch_format="numpy", drop_last=True)
    sync()
    t_ready = time.time()

    reset_launch_count()
    losses, step_s, wait_s = [], [], []
    t_prev = time.perf_counter()
    for rows in batches:
        wait_s.append(time.perf_counter() - t_prev)
        batch = {k: torch.from_numpy(rows[k].astype("int64")).to(device)
                 for k in ("tokens", "targets")}
        losses.append(step(sp, batch))
        sync()
        t_now = time.perf_counter()
        step_s.append(t_now - t_prev)
        t_prev = t_now
    counts = (launch_counts(), fwd_design_counts(), bwd_design_counts())
    session.report({
        "final": True, "losses": torch.stack(losses).tolist(),
        "step_s": step_s, "wait_s": wait_s, "n_params": n_params,
        "flops_per_token": 6 * n_params + 6 * cfg.n_layers * S * cfg.d_model,
        "launches": counts[0], "designs": counts[1],
        "bwd_designs": counts[2], "t_loop": t_loop, "t_ready": t_ready,
        "backend": str(torch.distributed.get_backend()),
        "lease": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_uuid": _device_uuid(device) if on_card else None,
    })


def tune_trial(config: Dict[str, Any]) -> None:
    """A Tune function trainable that leases its card (``chip_smoke.py``
    phase 13 (c)): ``gpu_bench.setup_training``'s model and batch (phase
    6's seed) on this process's card (``config["device"]`` None; it
    raises without one), AdamW at ``config["lr"]``, ``config["steps"]``
    steps, ``session.report`` after each. The last report also holds the
    launches of the steps (counted from zero just before the first step,
    read just after the last), the trial's wall-clock marks, its lease
    and its card."""
    import torch

    from ..models import gpt
    from ..ops.flash_attention import (bwd_design_counts, fwd_design_counts,
                                       launch_counts, reset_launch_count)
    from ..train import session
    from . import gpu_bench
    from .device import resolve_device

    t_start = time.time()
    device = resolve_device(config.get("device"))
    params, _, batch, cfg = gpu_bench.setup_training(
        config["preset"], config["batch"], config["seq"],
        False, "flash", device)
    opt = torch.optim.AdamW(list(gpt.param_leaves(params)),
                            **dict(gpu_bench.ADAMW, lr=config["lr"]))
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    t_ready = time.time()
    reset_launch_count()
    steps = config["steps"]
    for i in range(steps):
        loss = float(gpu_bench.train_step(params, opt, batch, cfg))
        report = {"loss": loss, "step": i}
        if i == steps - 1:
            sync()
            report.update(
                launches=launch_counts(), designs=fwd_design_counts(),
                bwd_designs=bwd_design_counts(), t_start=t_start,
                t_ready=t_ready, t_end=time.time(),
                lease=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device_uuid=_device_uuid(device) if on_card else None)
        session.report(report)


def attend_step(q, k, v, log_path: str) -> Dict[str, Any]:
    """A ``workflow.step(num_gpus=1)`` body: :func:`attend` on the step's
    card, with one line per run appended to ``log_path`` (this process's
    pid and forward launches), so a caller can count the runs a
    workflow's resume made."""
    out = attend(q, k, v)
    with open(log_path, "a") as f:
        f.write(f"{os.getpid()} {out['launches']['flash_attention_fwd']}\n")
    return out


def row_sums(attended: Dict[str, Any],
             fail_marker: str = "") -> Dict[str, Any]:
    """The second step of ``chip_smoke.py``'s workflow: the fp32 sum of
    each row of the attention output [BH, S, D] -> [BH, S], computed on
    the CPU (the step holds no card). It raises once if ``fail_marker``
    names a file that does not exist yet (and creates it), so the caller
    can resume a failed workflow."""
    if fail_marker and not os.path.exists(fail_marker):
        open(fail_marker, "w").close()
        raise RuntimeError("injected failure of the workflow's second step")
    return {"sums": attended["out"].cpu().float().sum(-1),
            "device_uuid": attended["device_uuid"]}


# ------------------------------------------------------------- surfaces
def score_digest(scored: Dict[str, Any]) -> str:
    """sha256 over :func:`score_batch`'s argmax ids and log-probabilities:
    two forwards of the same weights on the same rows give the same
    digest only when both are bit-equal."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(scored["argmax"], np.int64).tobytes())
    h.update(np.ascontiguousarray(scored["logprob"], np.float32).tobytes())
    return h.hexdigest()


def pin_weights(preset: str = "gpt2-small", seed: int = 0,
                dtype: str = "bfloat16", device=None) -> Dict[str, Any]:
    """A GPU task's body: ``preset``'s weights, drawn from ``seed`` in
    ``dtype`` on this process's card (it raises without one; ``device=
    "cpu"`` asks for the CPU), packed into one flat tensor and pinned in
    this worker's device tier. The ref rides back inside the result, so
    the caller holds the pin (a serve deployment's ``placement_hint``
    names it) after the task and its lease are done."""
    import torch

    from .. import api
    from ..models import gpt
    from .device import resolve_device

    device = resolve_device(device)
    cfg = gpt.PRESETS[preset]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = gpt.init_params(cfg, gen, device)
    packed = torch.cat([t.reshape(-1).to(getattr(torch, dtype))
                        for t in gpt.param_leaves(params)])
    del params
    ref = api.put(packed, device=True)
    return {"ref": [ref], "object_id": ref.hex(),
            "nbytes": int(packed.nbytes),
            "node_id": os.environ.get("RMT_NODE_ID"),
            "device_uuid": (_device_uuid(device)
                            if device.type == "cuda" else None)}


# ------------------------------------------------------------ C++ frontend
CPP_NEW_TOKENS = 16   # the tokens cpp_generate adds to its prompt
CPP_SEED = 1          # its weights' seed (chip_smoke.py's engine parity)
# a file to which cpp_generate appends one JSON line per call (its
# launches, card and seconds): a named function returns only its bytes
CPP_GENERATE_LOG = "RMT_CPP_GENERATE_LOG"


def generate_text(params, cfg, prompt: bytes,
                  steps: int = CPP_NEW_TOKENS) -> bytes:
    """Greedy ``gpt.generate`` of ``steps`` tokens after a prompt whose
    ids are ``prompt``'s byte values, on the device of ``params``.
    Returns the new ids as ASCII, separated by commas."""
    import torch

    from ..models import gpt

    device = next(iter(gpt.param_leaves(params))).device
    ids = torch.tensor([list(prompt)], dtype=torch.int64, device=device)
    with torch.inference_mode():
        new = gpt.generate(params, cfg, ids, steps)[0, len(prompt):]
    return ",".join(str(t) for t in new.tolist()).encode()


def cpp_generate(a: bytes, b: bytes) -> bytes:
    """A named function for the C++ frontend (``register_named_function(
    "cpp_transform", cpp_generate, num_gpus=1)``): fp32 gpt2-small at full
    width, weights drawn from ``CPP_SEED`` on this process's card (once
    per process), greedily continues the prompt ``a + b`` by
    ``CPP_NEW_TOKENS`` tokens (:func:`generate_text`; the prefill runs
    through the flash forward kernel). It raises without a card. With
    ``CPP_GENERATE_LOG`` set in the environment, each call appends its
    flash launches (counted from zero just before the generate, read just
    after), its card and its seconds to that file."""
    import json

    from ..ops.flash_attention import (fwd_design_counts, launch_count,
                                       reset_launch_count)
    from .device import resolve_device

    t0 = time.perf_counter()
    device = resolve_device(None)
    params, cfg = _scoring_model("gpt2-small", CPP_SEED, "float32", device)
    reset_launch_count()
    text = generate_text(params, cfg, bytes(a) + bytes(b))
    log = os.environ.get(CPP_GENERATE_LOG)
    if log:
        with open(log, "a") as f:
            f.write(json.dumps({
                "pid": os.getpid(), "launches": launch_count(),
                "designs": fwd_design_counts(),
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "device_uuid": _device_uuid(device),
                "seconds": time.perf_counter() - t0}) + "\n")
    return text


def flip_on_card(data: bytes, device=None) -> Dict[str, Any]:
    """A ``num_gpus=1`` task body that takes a C++ task's ``bytes``
    result: the bytes go to this process's card (``device`` None; it
    raises without one, ``device="cpu"`` asks for the CPU) as a uint8
    tensor, are reversed and summed there, and come back with the
    worker's lease and card."""
    import torch

    from .device import resolve_device

    device = resolve_device(device)
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    flipped, total = t.flip(0).cpu(), int(t.sum(dtype=torch.int64))
    return {"value": bytes(flipped.numpy()), "sum": total,
            "device": str(t.device),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_uuid": (_device_uuid(t.device)
                            if t.is_cuda else None)}
