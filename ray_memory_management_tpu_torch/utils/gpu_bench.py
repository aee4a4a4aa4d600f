"""Single-card training benchmark: train-step time, tokens/s and model
FLOPs utilisation of the TransformerLM, and images/s of the vision
models.

Counterpart of ``utils/tpu_bench.py`` ``train_step_mfu`` in the JAX
package. A step is ``gpt.loss_fn``, ``loss.backward()`` (through the
flash attention backward kernels on the card) and one
``torch.optim.AdamW`` update with optax's ``adamw(3e-4)`` defaults.
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


def make_optimizer(params: gpt.Params) -> torch.optim.AdamW:
    """Mark every parameter as trainable and return AdamW over all of them
    (optax ``adamw(3e-4)``: the decay applies to every leaf)."""
    leaves = list(gpt.param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
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
                   remat: bool, attention: str, device: torch.device
                   ) -> Tuple[gpt.Params, torch.optim.AdamW, Dict[str, Any],
                              gpt.TransformerConfig]:
    """The benchmark's model, optimizer and batch: ``preset`` with
    ``max_seq = seq_len``, random weights and one random batch from
    :data:`SEED`. Returns (params, opt, batch, cfg)."""
    cfg = dataclasses.replace(gpt.PRESETS[preset], attention=attention,
                              max_seq=seq_len, remat=remat)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = gpt.init_params(cfg, gen, device)
    opt = make_optimizer(params)
    return params, opt, make_batch(cfg, batch_size, seq_len, gen,
                                   device), cfg


def train_step_mfu(preset: str = "gpt2-small", batch_size: int = 8,
                   seq_len: int = 1024, steps: int = 8,
                   remat: bool = False, attention: str = "flash",
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, Any]:
    """Train ``preset`` for exactly ``steps`` AdamW steps on one repeated
    batch and time them.

    The first ``steps - 3 * w`` steps (w = (steps - 1) // 3) warm up the
    allocator and the kernel libraries; the rest run as three timed
    windows of ``w`` steps, each ending in a synchronise, and the best
    window is reported (the JAX function's best of 3). MFU uses the same
    PaLM accounting (6N per token plus causal attention 6·L·S·d_model)
    against the H100's dense bf16 peak; it is None off the card, where the
    other figures are host timings.

    Returns tokens_per_s, step_ms, loss (the last step's), losses (every
    step's), n_params, mfu, steps and device."""
    device = resolve_device(device)
    params, opt, batch, cfg = setup_training(preset, batch_size, seq_len,
                                             remat, attention, device)
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
