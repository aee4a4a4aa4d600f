"""Parameters between the JAX package and the port, leaf for leaf.

The JAX model's parameter tree (nested dicts, layer-stacked ``[L, ...]``
weights) crosses as numpy arrays: the caller converts each JAX leaf with
``np.asarray`` (or hands the arrays of :func:`params_to_numpy` to
``jnp.asarray``), so this module never imports JAX. Keys, shapes and
dtypes are kept both ways.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # an owned, writable, C-contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart to
        # from_numpy: carry the bits through int16 and view them back
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, Any]:
    """Map a nested dict of numpy arrays to the same dict of tensors."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, device)

    return walk(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # the bits through int16, viewed as numpy's bfloat16 (ml_dtypes)
        import ml_dtypes

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: the same nested dict of
    owned numpy arrays, bit for bit (bf16 leaves as ml_dtypes bfloat16)."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_numpy(node)

    return walk(tree)
