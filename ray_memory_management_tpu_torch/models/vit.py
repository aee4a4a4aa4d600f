"""Vision Transformer, in PyTorch: the second vision family.

Counterpart of ``models/vit.py`` in the JAX package (flax.linen), module
for module and under flax's names (``patch_embed``, ``cls_token``,
``pos_embed``, ``block_i`` with ``LayerNorm_0``, ``SelfAttention_0``,
``LayerNorm_1``, ``Dense_0``, ``Dense_1``; ``LayerNorm_0``, ``head``), so
that a flax tree converts leaf for leaf (``convert.vit_state_from_flax``):

  - patchify is one strided conv (stride = kernel = patch; XLA's "SAME"
    pads nothing where the patch divides the image), the CLS token first,
    a learned position embedding added in ``dtype``;
  - pre-norm encoder blocks: LayerNorm in fp32 with flax's eps 1e-6;
    flax ``SelfAttention``'s biased q/k/v/out projections in ``dtype``,
    the query scaled by 1/sqrt(head_dim) before the product, the scores,
    their softmax and the product with v in ``dtype`` (flax takes the
    softmax in bf16: ``force_fp32_for_softmax`` is False); the MLP's GELU
    is the tanh approximation (flax ``nn.gelu``);
  - the head is fp32 on the CLS row.

Attention is plain matmul/softmax, as in the JAX model, which calls no
Pallas kernel: bidirectional attention over 197 tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from .layers import (Conv, Dense, LayerNorm, dp_train_step,
                     reset_parameters)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    mlp_ratio: int = 4
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


PRESETS: Dict[str, ViTConfig] = {
    # standard model card sizes (ViT-S/16, ViT-B/16)
    "vit-s16": ViTConfig(d_model=384, n_layers=12, n_heads=6),
    "vit-b16": ViTConfig(d_model=768, n_layers=12, n_heads=12),
    # CI-scale: 32x32 inputs, a few layers
    "vit-tiny-test": ViTConfig(image_size=32, patch_size=8, d_model=64,
                               n_layers=2, n_heads=4, num_classes=10),
}


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention(num_heads, dtype)``: q/k/v/out as Dense
    [d, d] (flax's DenseGeneral kernels [d, heads, head_dim] and [heads,
    head_dim, d], flattened)."""

    def __init__(self, d: int, n_heads: int, dtype: torch.dtype):
        super().__init__()
        self.n_heads = n_heads
        self.query = Dense(d, d, dtype)
        self.key = Dense(d, d, dtype)
        self.value = Dense(d, d, dtype)
        self.out = Dense(d, d, dtype)

    def forward(self, x):
        B, S, d = x.shape
        H = self.n_heads
        q, k, v = (f(x).reshape(B, S, H, d // H).transpose(1, 2)
                   for f in (self.query, self.key, self.value))
        q = q / q.new_tensor((d // H) ** 0.5)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        o = (w @ v).transpose(1, 2).reshape(B, S, d)
        return self.out(o)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.d_model
        self.LayerNorm_0 = LayerNorm(d)
        self.SelfAttention_0 = SelfAttention(d, cfg.n_heads, cfg.dtype)
        self.LayerNorm_1 = LayerNorm(d)
        self.Dense_0 = Dense(d, d * cfg.mlp_ratio, cfg.dtype)
        self.Dense_1 = Dense(d * cfg.mlp_ratio, d, cfg.dtype)

    def forward(self, x):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.patch_embed = Conv(3, d, cfg.patch_size, cfg.patch_size,
                                bias=True, dtype=cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.n_patches + 1, d))
        for i in range(cfg.n_layers):
            setattr(self, f"block_{i}", EncoderBlock(cfg))
        self.LayerNorm_0 = LayerNorm(d)
        self.head = Dense(d, cfg.num_classes, torch.float32)

    def forward(self, images):
        """images [B, 3, H, W] -> logits [B, classes] fp32."""
        cfg = self.cfg
        B = images.shape[0]
        x = self.patch_embed(images.to(cfg.dtype))
        x = x.flatten(2).transpose(1, 2)                # [B, patches, d]
        cls = self.cls_token.to(cfg.dtype).expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for i in range(cfg.n_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.LayerNorm_0(x)
        # classify from the CLS token; the head stays fp32
        return self.head(x[:, 0].float())


def init_vit(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
             device: Optional[Union[str, torch.device]] = None) -> ViT:
    """A ViT of ``cfg`` with weights drawn from ``generator`` (a CPU
    generator, seeded 0 when None) as flax draws them (the position
    embedding from N(0, 0.02²), the CLS token at 0), on ``device`` (the
    card unless told otherwise)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = ViT(cfg)
    reset_parameters(model, generator)
    with torch.no_grad():
        model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model.to(device)


def vit_loss_fn(model: ViT, batch):
    """Cross-entropy over {"image": [B, 3, H, W], "label": [B]}."""
    logits = model(batch["image"])
    labels = F.one_hot(batch["label"], logits.shape[-1]).float()
    return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def make_vit_train_step(model: ViT, optimizer, mesh=None):
    """The train step: ``step(batch)`` -> loss, the model updated in
    place; with a mesh (data axes only) each rank runs its rows of the
    global batch and the gradients are averaged
    (``layers.dp_train_step``)."""
    return dp_train_step(model, optimizer, mesh,
                         lambda batch, group, n: (vit_loss_fn(model, batch),))
