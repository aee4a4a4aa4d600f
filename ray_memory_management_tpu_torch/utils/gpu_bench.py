"""Card benchmarks: train-step time, tokens/s and model FLOPs
utilisation of the TransformerLM, images/s of the vision models, the
flash-attention kernels against their plain version, decode goodput
through the full serve stack, and the all-reduce bus bandwidth across
the visible cards.

Counterpart of ``utils/tpu_bench.py`` in the JAX package. A training
step is ``gpt.loss_fn``, ``loss.backward()`` (through the flash
attention backward kernels on the card) and one ``torch.optim.AdamW``
update with optax's ``adamw(3e-4)`` defaults.
:func:`vision_train_step` times ResNet-50 (SGD(0.1, momentum 0.9), as
the JAX package's ResNet test trains it) and ViT-S/16 (Adam(1e-3), as
its ViT test does) on one synthetic batch of 224x224 images.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..models import gpt
from ..utils.device import resolve_device

PEAK_BF16_H100 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
SEED = 0  # random weights and batch

# optax.adamw's defaults, written out: torch's own weight_decay default is
# 1e-2, optax's 1e-4
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


class LowPrecisionAdamW(torch.optim.Optimizer):
    """optax's ``adamw`` over parameters kept in a low-precision dtype
    (bf16), written out: both moments in the parameter's dtype (optax's
    ``mu_dtype=bf16``, and its ν takes the parameters' dtype), and every
    operation of optax's update in that dtype, in optax's order, each
    rounded: μ = (1 − β1)·g + β1·μ, ν = (1 − β2)·g² + β2·ν, the bias
    corrections 1 − β^t in fp32 cast to the dtype, μ̂ / (√ν̂ + ε), plus
    λ·p, times −lr, added to p. Its Python constants round to the dtype
    as JAX's weakly typed scalars do (β2 = 0.999 becomes 1.0 in bf16, as
    there). ``torch.optim.AdamW`` orders the same update otherwise (the
    decay first, a lerp, the step size folded into one constant), which
    in bf16 moves about 1.5 % of the elements by a rounding."""

    def __init__(self, params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=1e-4):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def _constants(group, dtype, t):
        """Step ``t``'s constants, each rounded to ``dtype``: (1 − β1, β1,
        1 − β2, β2, 1 − β1^t, 1 − β2^t, ε, λ, −lr), the corrections taken
        in fp32 first."""
        def c(x):  # a Python constant, rounded to the dtype
            return float(torch.tensor(x, dtype=dtype))

        b1, b2 = group["betas"]
        corrections = [c(float(torch.tensor(1.0) - torch.tensor(b) ** t))
                       for b in (b1, b2)]
        return (c(1 - b1), c(b1), c(1 - b2), c(b2), *corrections,
                c(group["eps"]), c(group["weight_decay"]), c(-group["lr"]))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LowPrecisionAdamW takes no closure")
        for group in self.param_groups:
            known = {}  # (dtype, step) -> constants
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                key = (p.dtype, state["step"])
                if key not in known:
                    known[key] = self._constants(group, *key)
                one_b1, b1, one_b2, b2, cor1, cor2, eps, wd, neg_lr = \
                    known[key]
                g, m, v = p.grad, state["exp_avg"], state["exp_avg_sq"]
                m.copy_(one_b1 * g + b1 * m)
                v.copy_(one_b2 * (g * g) + b2 * v)
                u = (m / cor1) / ((v / cor2).sqrt() + eps)
                p.add_((u + wd * p) * neg_lr)


def make_optimizer(params: gpt.Params) -> torch.optim.Optimizer:
    """Mark every parameter as trainable and return AdamW over all of them
    (optax ``adamw(3e-4)``: the decay applies to every leaf):
    ``torch.optim.AdamW``, or :class:`LowPrecisionAdamW` over bf16
    parameters (optax's ``adamw(3e-4, mu_dtype=bf16)``)."""
    leaves = list(gpt.param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    if all(t.dtype == torch.bfloat16 for t in leaves):
        return LowPrecisionAdamW(leaves, **ADAMW)
    return torch.optim.AdamW(leaves, **ADAMW)


def make_batch(cfg: gpt.TransformerConfig, batch_size: int, seq_len: int,
               generator: torch.Generator, device) -> Dict[str, Any]:
    """Random tokens and their next-token targets (``roll(tokens, -1)``,
    as the JAX benchmark builds its batch)."""
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=generator, device=device)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def train_step(params: gpt.Params, opt: torch.optim.Optimizer, batch,
               cfg: gpt.TransformerConfig) -> torch.Tensor:
    """One step: loss, backward, AdamW update (params change in place).
    Returns the step's loss as a detached scalar tensor (no host sync)."""
    opt.zero_grad(set_to_none=True)
    loss = gpt.loss_fn(params, batch, cfg)
    loss.backward()
    opt.step()
    return loss.detach()


def setup_training(preset: str, batch_size: int, seq_len: int,
                   remat: bool, attention: str, device: torch.device,
                   bf16_params: bool = False
                   ) -> Tuple[gpt.Params, torch.optim.AdamW, Dict[str, Any],
                              gpt.TransformerConfig]:
    """The benchmark's model, optimizer and batch: ``preset`` with
    ``max_seq = seq_len``, random weights and one random batch from
    :data:`SEED`. With ``bf16_params`` the parameters are drawn and kept
    in bf16 (``cfg.param_dtype``), and so are their gradients and both
    AdamW moments (:class:`LowPrecisionAdamW`: the JAX ``adamw(3e-4,
    mu_dtype=bf16)`` over bf16 parameters, whose ν takes the parameters'
    dtype too). Returns (params, opt, batch, cfg)."""
    over = {"param_dtype": torch.bfloat16} if bf16_params else {}
    cfg = dataclasses.replace(gpt.PRESETS[preset], attention=attention,
                              max_seq=seq_len, remat=remat, **over)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = gpt.init_params(cfg, gen, device)
    opt = make_optimizer(params)
    return params, opt, make_batch(cfg, batch_size, seq_len, gen,
                                   device), cfg


def train_step_mfu(preset: str = "gpt2-small", batch_size: int = 8,
                   seq_len: int = 1024, steps: int = 8,
                   remat: bool = False, attention: str = "flash",
                   device: Optional[Union[str, torch.device]] = None,
                   bf16_params: bool = False) -> Dict[str, Any]:
    """Train ``preset`` for exactly ``steps`` AdamW steps on one repeated
    batch and time them. ``bf16_params`` keeps the parameters, their
    gradients and both AdamW moments in bf16 (:func:`setup_training`),
    what lets llama-1b and its optimizer fit beside its activations.

    The first ``steps - 3 * w`` steps (w = (steps - 1) // 3) warm up the
    allocator and the kernel libraries; the rest run as three timed
    windows of ``w`` steps, each ending in a synchronise, and the best
    window is reported (the JAX function's best of 3). MFU uses the same
    PaLM accounting (6N per token plus causal attention 6·L·S·d_model)
    against the H100's dense bf16 peak; it is None off the card, where the
    other figures are host timings.

    Returns tokens_per_s, step_ms, loss (the last step's), losses (every
    step's), n_params, mfu, steps, bf16_params and device."""
    device = resolve_device(device)
    params, opt, batch, cfg = setup_training(preset, batch_size, seq_len,
                                             remat, attention, device,
                                             bf16_params)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    losses, best, window = _timed_windows(
        lambda: train_step(params, opt, batch, cfg), steps, sync)

    n_params = gpt.count_params(params)
    tokens_per_s = batch_size * seq_len * window / best
    flops_per_token = 6 * n_params + 6 * cfg.n_layers * seq_len * cfg.d_model
    losses = torch.stack(losses).tolist()
    return {
        "tokens_per_s": tokens_per_s,
        "step_ms": best / window * 1e3,
        "loss": losses[-1],
        "losses": losses,
        "n_params": n_params,
        "mfu": (tokens_per_s * flops_per_token / PEAK_BF16_H100
                if on_card else None),
        "steps": steps,
        "bf16_params": bf16_params,
        "device": (torch.cuda.get_device_name(device) if on_card
                   else str(device)),
    }


VISION_MODELS = ("resnet50", "vit-s16")


def _timed_windows(step, steps: int, sync):
    """``steps`` calls of ``step()``: the first ``steps - 3w`` warm up
    (w = (steps - 1) // 3), the rest run as three windows of w, each
    ending in ``sync()``. Returns (every result, the best window's
    seconds, w)."""
    if steps < 4:
        raise ValueError(f"steps must be >= 4 (a warm-up step and three "
                         f"timed windows), got {steps}")
    window = (steps - 1) // 3
    out = [step() for _ in range(steps - 3 * window)]
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out += [step() for _ in range(window)]
        sync()
        best = min(best, time.perf_counter() - t0)
    return out, best, window


def vision_train_step(model_name: str = "resnet50", batch_size: int = 128,
                      steps: int = 8,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[str, Any]:
    """Train ``model_name`` ("resnet50" or "vit-s16", bf16 compute, fp32
    parameters) for exactly ``steps`` steps on one synthetic batch of
    ``batch_size`` 224x224x3 images and 1000-class labels drawn from
    :data:`SEED`, timed as ``train_step_mfu`` times (best of three
    windows after the warm-up). ResNet-50 runs channels-last on the card
    (the same results, cuDNN's faster layout).

    Returns step_ms, images_per_s, losses (every step's), n_params,
    stats_moved (the largest change of a BatchNorm running statistic over
    the steps; None for ViT, which has none), peak_mem_gb (None off the
    card), steps and device."""
    from ..models import resnet, vit

    device = resolve_device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gen = torch.Generator().manual_seed(SEED)
    images = torch.randn(batch_size, 3, 224, 224, generator=gen)
    labels = torch.randint(0, 1000, (batch_size,), generator=gen)
    if model_name == "resnet50":
        model = resnet.init_resnet(resnet.resnet50(), gen, device)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        make_step = resnet.make_resnet_train_step
        if on_card:
            model = model.to(memory_format=torch.channels_last)
            images = images.contiguous(memory_format=torch.channels_last)
    elif model_name == "vit-s16":
        model = vit.init_vit(vit.PRESETS["vit-s16"], gen, device)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        make_step = vit.make_vit_train_step
    else:
        raise ValueError(f"unknown vision model {model_name!r}; "
                         f"one of {VISION_MODELS}")
    batch = {"image": images.to(device), "label": labels.to(device)}
    step = make_step(model, opt)
    stats0 = [b.clone() for b in model.buffers()]
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, best, window = _timed_windows(lambda: step(batch), steps, sync)
    moved = [(b - b0).abs().max().item()
             for b, b0 in zip(model.buffers(), stats0)]
    return {
        "step_ms": best / window * 1e3,
        "images_per_s": batch_size * window / best,
        "losses": torch.stack(losses).tolist(),
        "n_params": sum(p.numel() for p in model.parameters()),
        "stats_moved": max(moved) if moved else None,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if on_card else None),
        "steps": steps,
        "device": (torch.cuda.get_device_name(device) if on_card
                   else str(device)),
    }


def loop_timer(device: torch.device):
    """``timer(fn, n)``: milliseconds per call of ``fn()`` over ``n`` calls
    after one untimed call; CUDA events on the card, the host clock
    elsewhere."""
    def timer(fn, n: int) -> float:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    return timer


def flash_bench_step(q, k, v, acc, attention: str = "flash"):
    """One iteration of :func:`flash_attention_bench`'s loop: the loss
    Σ o² (o = causal attention of q, k, v, squared in fp32) and its
    gradients through the kernels (``attention="flash"``; the plain
    versions on CPU tensors) or through autograd of the plain attention
    (``"ref"``). The next iteration's q is ``q + 1e-6·dq`` and ``acc``
    gains Σ dv, so no iteration can be skipped.

    Returns (next q, next acc, loss, dq, dk, dv)."""
    from ..ops.flash_attention import flash_attention

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*leaves,
                        use_kernel="on" if attention == "flash" else "off")
    loss = torch.sum(o.float() ** 2)
    dq, dk, dv = torch.autograd.grad(loss, leaves)
    return (q + 1e-6 * dq.to(q.dtype), acc + torch.sum(dv.float()),
            loss.detach(), dq, dk, dv)


def flash_bench_inputs(bh: int, seq_len: int, head_dim: int,
                       device, dtype=torch.bfloat16):
    """q, k, v of shape [bh, seq_len, head_dim], standard normals drawn on
    a CPU generator seeded :data:`SEED` (a CUDA generator draws other
    numbers for one seed) and copied to ``device`` once."""
    gen = torch.Generator().manual_seed(SEED)
    return tuple(torch.randn(bh, seq_len, head_dim, generator=gen)
                 .to(dtype).to(device) for _ in range(3))


def flash_attention_bench(seq_lens=(1024, 4096, 8192), bh: int = 4,
                          head_dim: int = 128, iters: int = 8,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[int, Dict[str, float]]:
    """Flash kernels vs the plain attention, forward and backward, per
    sequence length: bf16, causal, ``bh`` heads of ``head_dim``. Each
    timed call is one :func:`flash_bench_step` (loss Σ o², its three
    gradients, the q update); the plain version runs ``max(2, iters //
    4)`` iterations at S >= 8192 (its fp32 scores are [bh, S, S]).
    Returns {S: {flash_ms, ref_ms, speedup}}."""
    device = resolve_device(device)
    timer = loop_timer(device)
    out: Dict[int, Dict[str, float]] = {}
    for S in seq_lens:
        q, k, v = flash_bench_inputs(bh, S, head_dim, device)

        def timed(attention: str, n: int) -> float:
            state = {"q": q, "acc": torch.zeros((), device=device)}

            def step():
                state["q"], state["acc"], *_ = flash_bench_step(
                    state["q"], k, v, state["acc"], attention)

            ms = timer(step, n)
            if not torch.isfinite(state["acc"]).item():
                raise RuntimeError(f"flash_attention_bench: {attention} "
                                   f"gradients at S={S} are not finite")
            return ms

        n_ref = max(2, iters // 4) if S >= 8192 else iters
        flash_ms = timed("flash", iters)
        ref_ms = timed("ref", n_ref)
        out[S] = {"flash_ms": flash_ms, "ref_ms": ref_ms,
                  "speedup": ref_ms / flash_ms}
        del q, k, v
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def llm_serving_bench(preset: str = "gpt2-small", n_requests: int = 32,
                      prompt_len: int = 128, max_new_tokens: int = 64,
                      max_batch_size: int = 8,
                      device: Optional[Union[str, torch.device]] = None,
                      app_wrapper=None, on_mode=None) -> Dict[str, float]:
    """Decode goodput (REQUESTED tokens/s) through the FULL serve stack
    on the card: handle -> router -> replica (``num_gpus=1`` card lease)
    -> batching engine -> the KV-cached decode (serve/llm.py). Runs BOTH
    batching modes over the same Poisson arrival schedule of a MIXED
    workload (budgets alternate max_new_tokens and a quarter of it) —
    "continuous" (decode-step join/leave, per-request budgets honored,
    the default) vs the legacy "barrier" (whole-batch: every request
    pays the full deployment budget and new arrivals park behind the
    longest running batch) — and reports the speedup.

    With ``device="cpu"`` the replica takes no lease and serves on the
    CPU. ``app_wrapper(app)``, when given, returns the application to
    run in place of the ``llm_deployment`` (say, the same deployment
    with a subclass of ``LLMServer``); ``on_mode(mode, handle,
    budgets, replies)`` is called after each mode's timed run, with
    each request's reply tokens in request order, before the replica
    shuts down."""
    import threading

    import numpy as np

    from .. import api as rmt
    from .. import serve
    from ..serve.llm import llm_deployment

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    placement = ({"ray_actor_options": {"num_gpus": 1}} if on_card
                 else {"device": "cpu"})
    rmt.init(num_cpus=4, num_gpus=1 if on_card else 0)
    try:
        out: Dict[str, float] = {}
        prompt = list(range(2, 2 + prompt_len))
        # Poisson arrivals at ~2x the barrier's drain rate so queueing
        # pressure is real; same arrival schedule for both modes
        rng = np.random.default_rng(0)
        gaps = rng.exponential(0.05, n_requests)  # drawn ONCE: both
        # mixed budgets: half the requests want a quarter the tokens
        budgets = [max_new_tokens if i % 2 == 0 else
                   max(1, max_new_tokens // 4)
                   for i in range(n_requests)]
        requested = sum(budgets)
        for mode in ("continuous", "barrier"):    # modes see the same
            # arrival schedule, so the ratio measures the batching
            # mode, not arrival-pattern noise
            serve.start(http_port=None)
            app = llm_deployment(
                preset, max_new_tokens=max_new_tokens,
                max_batch_size=max_batch_size,
                batch_wait_timeout_s=0.02,
                batching=mode, **placement)
            handle = serve.run(app_wrapper(app) if app_wrapper else app)
            # warm: the replica's first kernels and allocations
            warm = rmt.get(handle.remote({"tokens": prompt}),
                           timeout=900)
            assert len(warm["tokens"]) == max_new_tokens

            replies: list = [None] * n_requests

            def one(i, budget):
                r = rmt.get(handle.remote(
                    {"tokens": prompt, "max_new_tokens": budget}),
                    timeout=900)
                replies[i] = r["tokens"]

            t0 = time.perf_counter()
            threads = []
            for i in range(n_requests):
                th = threading.Thread(target=one, args=(i, budgets[i]))
                th.start()
                threads.append(th)
                time.sleep(float(gaps[i]))
            for th in threads:
                th.join()
            dt = time.perf_counter() - t0
            assert all(r is not None for r in replies)
            # goodput: tokens the CLIENTS asked for per second
            # (barrier mode over-generates for short requests; those
            # surplus tokens are waste, not throughput)
            key = ("decode_tokens_per_s" if mode == "continuous"
                   else "decode_tokens_per_s_barrier")
            out[key] = requested / dt
            if mode == "continuous":
                out["requests_per_s"] = n_requests / dt
                try:
                    stats = rmt.get(handle.stats.remote(), timeout=60)
                    out["decode_steps"] = stats["batches"]
                except Exception:
                    pass
            if on_mode is not None:
                on_mode(mode, handle, budgets, replies)
            serve.shutdown()
        if out.get("decode_tokens_per_s_barrier"):
            out["continuous_vs_barrier"] = (
                out["decode_tokens_per_s"]
                / out["decode_tokens_per_s_barrier"])
        return out
    finally:
        try:
            serve.shutdown()
        except Exception:
            pass
        rmt.shutdown()


def allreduce_busbw(size_mb: int = 64, iters: int = 8,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Optional[Dict[str, float]]:
    """Bus bandwidth of a sum all-reduce over all visible cards: one
    process, one fp32 tensor of ``size_mb`` MiB per card,
    ``torch.cuda.nccl.all_reduce`` over them, each result divided by the
    card count to keep magnitudes bounded (as the JAX function's psum
    loop does). Returns None below 2 cards (a single card has no
    interconnect to measure) and with ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    from torch.cuda import nccl

    elems = size_mb * (1 << 20) // 4
    xs = [torch.ones(elems, dtype=torch.float32, device=f"cuda:{i}")
          for i in range(n)]

    def run(k: int) -> None:
        for _ in range(k):
            nccl.all_reduce(xs)
            for i, x in enumerate(xs):
                with torch.cuda.device(i):
                    x.div_(n)
        for i in range(n):
            torch.cuda.synchronize(i)

    run(1)
    t0 = time.perf_counter()
    run(iters)
    dt = (time.perf_counter() - t0) / iters
    if not all(bool((x == 1.0).all()) for x in xs):
        raise RuntimeError("allreduce_busbw: the all-reduce's sum is wrong")
    bytes_moved = size_mb * (1 << 20)
    # ring-allreduce bus bytes: 2*(n-1)/n per byte of payload
    busbw = bytes_moved * 2 * (n - 1) / n / dt
    return {"busbw_gbps": busbw / 1e9, "world": n,
            "alg_bw_gbps": bytes_moved / dt / 1e9}


def rl_learner_bench(n_workers: int = 2, iters: int = 4,
                     train_batch: int = 4096, fragment: int = 512,
                     num_sgd_iter: int = 6, minibatch: int = 512,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[str, Any]:
    """RL throughput with the learner on the card: PPO through the full
    stack — CPU rollout actors sample CartPole fragments in worker
    processes, the driver-side learner runs minibatch SGD on ``device``
    (the card unless the caller asks for the CPU). The reference's analog
    keeps learner threads off the rollout path
    (rllib/execution/multi_gpu_learner_thread.py).

    Reports overall env_steps_per_s (sample+learn, the headline),
    learner-only learner_env_steps_per_s, and learner_ms per minibatch
    update (the epoch loop's wall time, which ends on a host read of the
    last update's loss, over the updates it ran)."""
    from .. import api as rmt
    from ..rllib.ppo import PPOConfig

    dev = resolve_device(device)
    rmt.init(num_cpus=max(2, n_workers))
    try:
        algo = (PPOConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=n_workers,
                          rollout_fragment_length=fragment)
                .training(train_batch_size=train_batch, lr=3e-4,
                          num_sgd_iter=num_sgd_iter,
                          sgd_minibatch_size=minibatch,
                          donate_learner_state=True)
                .resources(device=str(dev))
                .debugging(seed=0)
                .build())
        try:
            algo.train()  # warm: the first kernels, the workers' spawn
            steps = 0
            sample_s = learn_s = 0.0
            updates = 0
            t0 = time.perf_counter()
            for _ in range(iters):
                r = algo.train()
                steps += r["num_env_steps_sampled"]
                sample_s += r["sample_time_s"]
                learn_s += r["learn_time_s"]
                updates += num_sgd_iter * max(
                    1, r["num_env_steps_sampled"] // minibatch)
            dt = time.perf_counter() - t0
            return {
                "env_steps_per_s": steps / dt,
                "learner_env_steps_per_s": steps / max(learn_s, 1e-9),
                "learner_ms": learn_s / max(updates, 1) * 1e3,
                "sample_s": sample_s, "learn_s": learn_s,
                "algo": "ppo", "n_workers": n_workers,
                "device": str(dev),
                # episode_reward_mean is None when no episode completed
                # in the window — keep the persisted row JSON-numeric
                "final_reward": r.get("episode_reward_mean") or 0.0,
            }
        finally:
            algo.stop()
    finally:
        rmt.shutdown()
