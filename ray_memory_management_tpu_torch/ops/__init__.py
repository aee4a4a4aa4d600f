"""Ops: hand-written CUDA kernels with their plain PyTorch versions."""

from .flash_attention import flash_attention, reference_attention  # noqa: F401
