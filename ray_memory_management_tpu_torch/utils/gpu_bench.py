"""Single-card training benchmark: train-step time, tokens/s and model
FLOPs utilisation of the TransformerLM.

Counterpart of ``utils/tpu_bench.py`` ``train_step_mfu`` in the JAX
package. A step is ``gpt.loss_fn``, ``loss.backward()`` (through the
flash attention backward kernels on the card) and one
``torch.optim.AdamW`` update with optax's ``adamw(3e-4)`` defaults.
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
    if steps < 4:
        raise ValueError(f"steps must be >= 4 (a warm-up step and three "
                         f"timed windows), got {steps}")
    device = resolve_device(device)
    params, opt, batch, cfg = setup_training(preset, batch_size, seq_len,
                                             remat, attention, device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    window = (steps - 1) // 3
    losses = [train_step(params, opt, batch, cfg)
              for _ in range(steps - 3 * window)]
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        losses += [train_step(params, opt, batch, cfg)
                   for _ in range(window)]
        sync()
        best = min(best, time.perf_counter() - t0)

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
