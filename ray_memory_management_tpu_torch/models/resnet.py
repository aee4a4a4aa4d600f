"""ResNet-50, in PyTorch: the vision benchmark model.

Counterpart of ``models/resnet.py`` in the JAX package (flax.linen),
module for module and under flax's names (``Conv_0``, ``BatchNorm_0``,
``Bottleneck_i``, ``proj``, ``proj_bn``, ``Dense_0``), so that a flax
tree converts leaf for leaf (``convert.resnet_state_from_flax``):

  - bf16 convolutions, fp32 BatchNorm (``models/layers.py``: flax's
    statistics, its biased running variance, momentum 0.9, eps 1e-5), the
    last BatchNorm of each block starting at scale 0;
  - the dtype flow of the flax model: each conv casts its input to
    ``dtype``, each BatchNorm returns fp32, the residual sum is fp32;
  - XLA's "SAME" padding on the stride-2 3x3 conv of each stage's first
    block (ResNet v1.5) and on the stride-2 3x3 max pool (-inf pads);
    the stem's (3, 3) padding is symmetric;
  - NCHW images and OIHW kernels (the JAX model's are NHWC and HWIO).

With a mesh, :func:`make_resnet_train_step` takes the BatchNorm
statistics over the GLOBAL batch (each rank's sums all-reduced over the
data axis), as jit gives the JAX step over a dp-sharded batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from .layers import (BatchNorm, Conv, Dense, dp_train_step, max_pool_same,
                     reset_parameters)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(c_in, features, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = Conv(features, features * 4, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(features * 4, zero_scale=True)
        self.proj = self.proj_bn = None
        if c_in != features * 4:  # the flax block's shape test
            self.proj = Conv(c_in, features * 4, 1, strides, dtype=dtype)
            self.proj_bn = BatchNorm(features * 4)

    def forward(self, x, train: bool = True, group=None, n: int = 1):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train, group, n))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train, group, n))
        y = self.BatchNorm_2(self.Conv_2(y), train, group, n)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(self.proj(x), train, group, n)
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(3, 64, 7, 2, padding=((3, 3), (3, 3)),
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(64)
        c, i_block = 64, 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                setattr(self, f"Bottleneck_{i_block}",
                        Bottleneck(c, 64 * 2 ** i, strides, dtype))
                c, i_block = 64 * 2 ** i * 4, i_block + 1
        self.n_blocks = i_block
        self.Dense_0 = Dense(c, num_classes, dtype=torch.float32)

    def forward(self, x, train: bool = True, group=None, n: int = 1):
        """images [B, 3, H, W] -> logits [B, classes] fp32; ``group`` (the
        data axes' process groups, ``n`` ranks in all) makes the batch
        statistics global."""
        x = self.Conv_0(x.to(self.dtype))
        x = F.relu(self.BatchNorm_0(x, train, group, n))
        x = max_pool_same(x, 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{i}")(x, train, group, n)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes)


def resnet18_like(num_classes: int = 10) -> ResNet:
    """Small variant for tests."""
    return ResNet((1, 1, 1, 1), num_classes)


def init_resnet(model: ResNet, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> ResNet:
    """Draw ``model``'s weights from ``generator`` (a CPU generator, seeded
    0 when None) as flax draws them, and put it on ``device`` (the card
    unless told otherwise). The BatchNorm statistics start at 0 and 1."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    reset_parameters(model, generator)
    return model.to(device)


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics, by buffer name (flax's
    ``batch_stats``: ``Bottleneck_0.BatchNorm_0.mean`` ...), copied."""
    return {k: v.detach().clone() for k, v in model.named_buffers()}


def resnet_loss_fn(model: ResNet, batch, group=None, n: int = 1):
    """Cross-entropy over {"image": [B, 3, H, W], "label": [B]} in train
    mode: returns (loss, new_batch_stats). The forward moves the model's
    running statistics (flax threads them through as mutable state)."""
    logits = model(batch["image"], True, group, n)
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, batch["label"][:, None]).mean()
    return loss, batch_stats(model)


def make_resnet_train_step(model: ResNet, optimizer, mesh=None):
    """The train step: ``step(batch)`` -> loss, the model and its running
    statistics updated in place. With a mesh (data axes only) the batch is
    the global one, each rank runs its rows, the BatchNorm statistics are
    the global batch's and the gradients are averaged
    (``layers.dp_train_step``)."""
    return dp_train_step(model, optimizer, mesh,
                         lambda batch, group, n: resnet_loss_fn(
                             model, batch, group, n))
