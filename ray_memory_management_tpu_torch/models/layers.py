"""The flax layers the vision models use, as the port computes them.

Counterparts of flax ``nn.Conv``, ``nn.Dense``, ``nn.BatchNorm`` and
``nn.LayerNorm`` with the arithmetic flax gives them, so that
``models/resnet.py`` and ``models/vit.py`` hold their JAX models to
rounding:

  - ``Conv`` and ``Dense`` cast input, weight and bias to the compute
    dtype, take the product there, then add the bias there (two roundings
    in bf16, as flax's ``y = dot(x, w); y += b``);
  - ``Conv``'s ``"SAME"`` padding is XLA's: the output has ceil(n / s)
    positions and the padding, max((out - 1)·s + k - n, 0) in all, is
    split (total // 2, the rest), so a stride-2 3x3 window pads (0, 1)
    on an even input and (1, 1) on an odd one (``padding=1`` would give
    the same output size from the wrong windows);
  - the normalisations take their statistics in fp32 as flax's
    ``_compute_stats`` does (mean and E[x²] - mean², clipped at 0) and
    normalise as its ``_normalize`` does: (x - mean) · (rsqrt(var + eps)
    · scale) + bias, in fp32;
  - weights are drawn as flax's default initialisers draw them (LeCun
    normal, truncated at two deviations, over the fan-in), from a
    ``torch.Generator``.

Images are NCHW and conv kernels OIHW (the JAX package's are NHWC and
HWIO; ``models/convert.py`` moves them). :func:`dp_train_step` is the
vision models' train step, alone or data-parallel over a mesh.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import _regions

# flax's variance_scaling(1.0, "fan_in", "truncated_normal"): the
# deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (lo, hi) of a length-``n`` dim under a window
    ``k`` with stride ``s``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW: an OIHW ``weight`` (and a ``bias`` if
    asked), computed in ``dtype``; ``padding`` "SAME" (XLA's) or explicit
    ((lo, hi), (lo, hi))."""

    def __init__(self, c_in: int, c_out: int, kernel: int, strides: int = 1,
                 padding="SAME", bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.kernel, self.strides = kernel, strides
        self.padding, self.dtype = padding, dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        k, s = self.kernel, self.strides
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], k, s)
            pw = same_pads(x.shape[3], k, s)
        else:
            ph, pw = self.padding
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            y = F.conv2d(x, w, stride=s, padding=(ph[0], pw[0]))
        else:
            y = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=s)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


def max_pool_same(x, k: int, s: int):
    """flax ``nn.max_pool`` with "SAME" padding: XLA's pads, filled with
    -inf."""
    ph, pw = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out] and ``bias``, computed in
    ``dtype``."""

    def __init__(self, d_in: int, d_out: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype) \
            + self.bias.to(self.dtype)


def _normalize(x, mean, var, scale, bias, eps: float):
    """flax ``_normalize`` in fp32; every operand broadcasts against x."""
    mul = torch.rsqrt(var + eps) * scale
    return (x.float() - mean) * mul + bias


def _stats(x, dims, group=None, n: int = 1):
    """flax ``_compute_stats`` (fast variance) in fp32 over ``dims``; with
    ``group`` (the process groups of the data axes, ``n`` ranks in all),
    over the global batch (each rank's means summed over the groups,
    whose backward sums the gradients)."""
    xf = x.float()
    mu, mu2 = xf.mean(dim=dims), xf.square().mean(dim=dims)
    if group is not None:
        both = torch.stack([mu, mu2])
        for g in group:
            both = _regions.sum_over(both, g)
        mu, mu2 = both / n
    return mu, torch.clamp_min(mu2 - mu.square(), 0.0)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, fp32 output."""

    EPS = 1e-6

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        mean, var = _stats(x, -1)
        return _normalize(x, mean[..., None], var[..., None], self.scale,
                          self.bias, self.EPS)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``
    over NCHW: ``scale`` (zeros where ``zero_scale``), ``bias``, and the
    running ``mean`` and ``var`` buffers. With ``train`` it normalises
    by the batch statistics (the global batch's over ``group``) and
    moves the running ones by ra = 0.9·ra + 0.1·batch, the biased
    variance too; without, by the running ones."""

    MOMENTUM, EPS = 0.9, 1e-5

    def __init__(self, c: int, zero_scale: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(c) if zero_scale
                                  else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool = True, group=None, n: int = 1):
        if train:
            mean, var = _stats(x, (0, 2, 3), group, n)
            m = self.MOMENTUM
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        c = (-1, 1, 1)
        return _normalize(x, mean.reshape(c), var.reshape(c),
                          self.scale.reshape(c), self.bias.reshape(c),
                          self.EPS)


def _data_mesh(mesh):
    """(groups, size, rank) of a mesh whose every axis is a data axis (dp,
    fsdp or both): the process groups of the axes that split the batch,
    the number of data ranks and this rank's share of the batch's rows
    (``batch_pspec``'s order); (None, 1, 0) without a mesh."""
    from ..parallel.sharding import DATA_AXES, data_groups

    if mesh is None:
        return None, 1, 0
    names = tuple(mesh.mesh_dim_names or ())
    if not names or any(name not in DATA_AXES for name in names):
        raise ValueError(f"the vision train steps shard the batch over data "
                         f"axes ({DATA_AXES}) alone; the mesh has {names}")
    groups, n, rank = data_groups(mesh)
    return groups or None, n, rank


def dp_train_step(model: nn.Module, optimizer, mesh, loss_fn):
    """The vision models' train step: ``step(batch)`` runs ``loss_fn(batch,
    group, n)`` -> (loss, ...) forward and backward, steps ``optimizer``
    (over ``model``'s parameters, updated in place) and returns the loss.

    With ``mesh`` (data axes only: dp, fsdp or both) the step is
    data-parallel as the JAX step over a batch sharded on the data axes
    is under jit: the batch is the GLOBAL one, the same on every rank
    (checked); each rank runs its rows, with the batch statistics of the
    global batch (``group``: the data axes' groups, ``n`` ranks in all),
    and the gradients and the loss are averaged over the ranks. The
    parameters stay replicated: the replicas start from rank 0's
    parameters and buffers."""
    import torch.distributed as dist

    from ..parallel.sharding import _all_reduce_mean, _check_same_batch

    group, n, rank = _data_mesh(mesh)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if group is not None:
        with torch.no_grad():
            for g in group:
                src = dist.get_global_rank(g, 0)
                for t in list(model.parameters()) + list(model.buffers()):
                    dist.broadcast(t, src=src, group=g)

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {n} ranks")
        return x.chunk(n)[rank]

    def step(batch: dict):
        if group is not None:
            _check_same_batch(list(batch.values()), mesh)
            batch = {k: rows(v) for k, v in batch.items()}
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, group, n)[0]
        loss.backward()
        loss = loss.detach()
        if group is not None:
            _all_reduce_mean([p.grad for p in params if p.grad is not None]
                             + [loss], mesh)
        optimizer.step()
        return loss

    return step


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every Conv and Dense weight of ``model`` from ``generator`` (a
    CPU generator), in module order."""
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            m.reset_parameters(generator)
