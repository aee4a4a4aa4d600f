"""Ops: hand-written CUDA kernels with their plain PyTorch versions, the
MoE FFN, and sequence-parallel attention on the kernels."""

from .flash_attention import flash_attention, reference_attention  # noqa: F401
from .moe import moe_ffn  # noqa: F401
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401
