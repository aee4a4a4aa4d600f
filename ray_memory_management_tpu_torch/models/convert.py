"""Parameters between the JAX package and the port, leaf for leaf.

The JAX model's parameter tree (nested dicts, layer-stacked ``[L, ...]``
weights) crosses as numpy arrays: the caller converts each JAX leaf with
``np.asarray`` (or hands the arrays of :func:`params_to_numpy` to
``jnp.asarray``), so this module never imports JAX. Keys, shapes and
dtypes are kept both ways, for every leaf the model has: the MoE
leaves too (``router`` [L, D, E], ``w1``/``w3`` [L, E, D, F], ``w2``
[L, E, F, D]). The vision models' flax trees become ``state_dict``s of
the port's modules (:func:`resnet_state_from_flax`,
:func:`vit_state_from_flax`). RLlib's nets cross with
:func:`rl_params_from_jax`, and ``optax.adam``'s moments with
:func:`adam_state_from_optax`.
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


def _flat_state(tree, leaf_fn, prefix=""):
    """A flax tree's leaves as {dotted port name: tensor}: ``leaf_fn(path,
    name, array)`` -> (port name, array) for each leaf."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_state(v, leaf_fn, path + "."))
        else:
            name, a = leaf_fn(prefix, k, np.asarray(v))
            out[prefix + name] = torch.from_numpy(np.array(a))
    return out


def _conv_or_same(prefix, name, a):
    """A flax Conv's HWIO ``kernel`` as an OIHW ``weight``; Dense kernels,
    biases, scales and the statistics as they are."""
    if name == "kernel" and a.ndim == 4:
        return "weight", a.transpose(3, 2, 0, 1)
    if name in ("kernel", "bias", "scale", "mean", "var") and a.ndim <= 2:
        return name, a
    raise ValueError(f"no port leaf for the flax leaf {prefix}{name} of "
                     f"shape {a.shape}")


def resnet_state_from_flax(params, batch_stats):
    """The ``state_dict`` of ``models.resnet.ResNet`` (strict) from a flax
    ResNet's ``params`` and ``batch_stats`` (numpy arrays, or anything
    ``np.asarray`` takes): conv kernels HWIO -> OIHW, the statistics into
    the BatchNorm buffers; a leaf with no port counterpart raises."""
    state = _flat_state(params, _conv_or_same)
    state.update(_flat_state(batch_stats, _conv_or_same))
    return state


def _vit_leaf(prefix, name, a):
    """flax ViT leaves: SelfAttention's DenseGeneral kernels [d, heads,
    head_dim] / [heads, head_dim, d] and biases [heads, head_dim] as the
    port's Dense [d, d] and [d]; the embeddings as they are."""
    if name in ("cls_token", "pos_embed") and a.ndim == 3:
        return name, a
    if ".SelfAttention_0." in f".{prefix}":
        if name == "kernel" and a.ndim == 3:
            # out: [heads, head_dim, d] -> [d, d]; q/k/v: [d, heads,
            # head_dim] -> [d, d]
            return name, (a.reshape(-1, a.shape[-1])
                          if prefix.endswith(".out.")
                          else a.reshape(a.shape[0], -1))
        if name == "bias" and a.ndim in (1, 2):
            return name, a.reshape(-1)
    return _conv_or_same(prefix, name, a)


def vit_state_from_flax(params):
    """The ``state_dict`` of ``models.vit.ViT`` (strict) from a flax ViT's
    ``params``: the patch conv's kernel HWIO -> OIHW, SelfAttention's
    DenseGeneral kernels flattened to [d, d]; a leaf with no port
    counterpart raises."""
    return _flat_state(params, _vit_leaf)


def rl_params_from_jax(tree, device: Optional[Union[str, torch.device]] = None
                       ) -> Any:
    """An RLlib net's tree — the actor-critic ``{"pi": [{"w", "b"}, ...],
    "vf": [...]}``, DQN's ``{"q": [...]}``, the LSTM policy's
    ``{"embed", "lstm": {"w", "b"}, "pi", "vf"}``, SAC's and TD3's
    ``{"pi", "q1", "q2"}``, QMIX's agent net and hypernetworks, SlateQ's
    bare layer list, MBPETS's ensemble and MADDPG's agents stacked along
    a leading ``[E, ...]`` or ``[N, ...]`` axis — as the same tree of
    fp32 tensors on ``device``. The port's layers compute ``x @ w + b``
    as the JAX ones do (stacked ones as batched matmuls), so no leaf is
    transposed."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return torch.tensor(np.asarray(node), dtype=torch.float32,
                            device=device)

    return walk(tree)


def _sorted_leaves(tree) -> list:
    """Leaves in JAX's flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _find_adam(state):
    """The ``ScaleByAdamState`` (an object with ``count``, ``mu`` and
    ``nu``) inside an optax state's chain of tuples."""
    if all(hasattr(state, k) for k in ("count", "mu", "nu")):
        return state
    if isinstance(state, (list, tuple)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, select=None) -> Dict[str, Any]:
    """``optax.adam``'s state (``(ScaleByAdamState(count, mu, nu), ...)``,
    with numpy or JAX leaves) as ``torch.optim.Adam``'s per-parameter
    state: ``{"state": {i: {"step", "exp_avg", "exp_avg_sq"}}}`` with
    ``i`` the leaf's index in flatten order (the order the port's
    ``rllib.models.make_adam`` hands its leaves to the optimizer).
    ``mu`` becomes ``exp_avg``, ``nu`` ``exp_avg_sq``, ``count`` ``step``:
    both libraries bump the count before the bias correction, so the next
    step of either divides by the same ``1 - beta ** (count + 1)``.

    ``select`` names the top-level keys of the tree the optax state spans
    whose leaves the port's optimizer holds: SAC's and TD3's critic
    optimizers span the whole ``{"pi", "q1", "q2"}`` tree in JAX (the
    ``pi`` entries never move), the port's hold ``("q1", "q2")`` only.
    The leaves may be stacked (``[E, ...]`` ensembles, ``[N, ...]``
    agents) or scalars (SAC's ``log_alpha``)."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    mu, nu = adam.mu, adam.nu
    if select is not None:
        mu = {k: mu[k] for k in select}
        nu = {k: nu[k] for k in select}
    mus, nus = _sorted_leaves(mu), _sorted_leaves(nu)
    return {"state": {
        i: {"step": step.clone(),
            "exp_avg": torch.tensor(np.asarray(m), dtype=torch.float32),
            "exp_avg_sq": torch.tensor(np.asarray(v), dtype=torch.float32)}
        for i, (m, v) in enumerate(zip(mus, nus))}}


def rl_opt_states_from_jax(opt_states, selects) -> list:
    """Several optimizer states at once (SAC's actor, critic and
    temperature states, TD3's actor and critic states), each
    either the port's own (``{"state": ...}``, kept as it is) or an optax
    state converted by ``adam_state_from_optax`` with its ``select``."""
    out = []
    for state, select in zip(opt_states, selects):
        if isinstance(state, dict) and "state" in state:
            out.append(state)
        else:
            out.append(adam_state_from_optax(state, select))
    return out


def flat_params_from_jax(theta) -> np.ndarray:
    """The flat fp32 parameter vector of ES and ARS (the leaves of the
    policy's tree, raveled in flatten order and concatenated; the same
    layout in both packages)."""
    return np.asarray(theta, np.float32).ravel().copy()
