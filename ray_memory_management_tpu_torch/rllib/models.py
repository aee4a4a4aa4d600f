"""Policy/value networks as trees of tensors and plain apply functions.

The reference's model catalog builds torch/tf nets (rllib/models/catalog.py).
Here a net is a tree of tensors in the layout RLlib's JAX learner uses —
``{"pi": [{"w": [fan_in, fan_out], "b": [fan_out]}, ...], "vf": [...]}``
— and module-level apply functions, so weights cross to rollout actors
and checkpoints as the same nested dict of numpy arrays either way.
``w`` is the transpose of an ``nn.Linear`` weight: a layer is
``x @ w + b``.

Trees flatten in sorted-key order (lists in order), the order JAX's
``tree_leaves`` uses, so an optimizer's per-leaf state lines up with
the JAX learner's leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


# ------------------------------------------------------------------ trees
def tree_leaves(tree) -> List[Any]:
    """Leaves of a nested dict/list/tuple tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_to_numpy(params) -> Any:
    """The tree as owned numpy arrays (what crosses to actors and into
    checkpoints: never a device tensor)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), params)


def params_from_numpy(params) -> Any:
    """A numpy tree as CPU tensors (a rollout worker's copy)."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32), params)


def copy_into(dst, src) -> None:
    """Overwrite ``dst``'s leaves in place with ``src``'s values (the
    optimizer keeps pointing at ``dst``'s tensors)."""
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s if torch.is_tensor(s)
                    else torch.tensor(np.asarray(s), dtype=d.dtype))


def make_generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


# ------------------------------------------------------------------ nets
def mlp_init(generator: torch.Generator,
             sizes: Sequence[int]) -> List[Dict[str, torch.Tensor]]:
    """Scaled-normal (He) init for a relu MLP, drawn on the CPU from
    ``generator``."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(fan_in, fan_out, generator=generator) \
            * float(np.sqrt(2.0 / fan_in))
        params.append({"w": w, "b": torch.zeros(fan_out)})
    return params


def mlp_apply(params: List[Dict[str, torch.Tensor]],
              x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def ac_init(generator: torch.Generator, obs_dim: int, num_actions: int,
            hidden: Sequence[int] = (64, 64)) -> Dict[str, Any]:
    """Separate policy and value towers (the reference's default
    fcnet_hiddens=[256,256] shape, scaled down)."""
    return {
        "pi": mlp_init(generator, [obs_dim, *hidden, num_actions]),
        "vf": mlp_init(generator, [obs_dim, *hidden, 1]),
    }


def ac_apply(params: Dict[str, Any],
             obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, A], values [B])."""
    logits = mlp_apply(params["pi"], obs)
    values = mlp_apply(params["vf"], obs)[..., 0]
    return logits, values


def logp_of(logits: torch.Tensor, actions: torch.Tensor):
    """(log-probabilities of ``actions`` [...], all log-probs [..., A])."""
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, actions.long()[..., None])[..., 0]
    return logp, logp_all


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    return -(torch.exp(logp_all) * logp_all).sum(-1).mean()


def normalize(adv: torch.Tensor) -> torch.Tensor:
    """Advantage whitening with the population std (ddof 0)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


@torch.no_grad()
def sample_actions(params: Dict[str, Any], obs, generator: torch.Generator):
    """Sample actions + logp + value for a batch of observations (the
    rollout hot path): a categorical draw from the policy's softmax."""
    obs = torch.as_tensor(obs, dtype=torch.float32)
    logits, values = ac_apply(params, obs)
    logp_all = torch.log_softmax(logits, dim=-1)
    actions = torch.multinomial(torch.exp(logp_all), 1,
                                generator=generator)[:, 0]
    logp = torch.gather(logp_all, -1, actions[:, None])[:, 0]
    return actions, logp, values


def stacked_mlp_init(generator: torch.Generator, n: int,
                     sizes: Sequence[int]) -> List[Dict[str, torch.Tensor]]:
    """``n`` independent MLPs (an ensemble, or one net per agent) with
    every leaf stacked along a leading axis: ``w`` [n, fan_in, fan_out],
    ``b`` [n, fan_out] (the layout of a ``jax.vmap``-ed ``mlp_init``)."""
    members = [mlp_init(generator, sizes) for _ in range(n)]
    return [{k: torch.stack([m[i][k] for m in members])
             for k in ("w", "b")} for i in range(len(sizes) - 1)]


def stacked_mlp_apply(params: List[Dict[str, torch.Tensor]],
                      x: torch.Tensor) -> torch.Tensor:
    """``mlp_apply`` of each stacked member on its own slice: x [n, B, in]
    (or one [B, in] shared by every member) -> [n, B, out], as batched
    matmuls."""
    for i, layer in enumerate(params):
        x = torch.matmul(x, layer["w"]) + layer["b"][:, None, :]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def trainable(tree, device) -> Any:
    """A CPU-initialised tree as leaf tensors on ``device`` that require
    gradients."""
    return tree_map(lambda t: t.to(device).requires_grad_(True), tree)


def detached_copy(tree) -> Any:
    """A copy of the tree that never takes gradients (a target net)."""
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def polyak_(target, params, tau: float) -> None:
    """``target <- (1 - tau) * target + tau * params``, leaf by leaf, in
    place."""
    t, p = tree_leaves(target), tree_leaves(params)
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, [x.detach() for x in p], alpha=tau)


def step_on(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
            leaves: List[torch.Tensor]) -> None:
    """One optimizer step on the gradient of ``loss`` with respect to
    ``leaves`` only (the leaves the optimizer holds): no other leaf's
    gradient is computed or kept, so several optimizers over one tree
    never see each other's gradients."""
    grads = torch.autograd.grad(loss, leaves)
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    optimizer.step()


def make_adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s update rule (b1 0.9, b2 0.999, eps 1e-8) over
    the tree's leaves, in tree-flatten order."""
    return torch.optim.Adam(tree_leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def adam_state_to_cpu(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The optimizer's per-leaf state with every tensor on the CPU (what a
    checkpoint holds; the hyperparameters come from the config)."""
    return {"state": {
        i: {k: (v.detach().cpu().clone() if torch.is_tensor(v) else v)
            for k, v in s.items()}
        for i, s in optimizer.state_dict()["state"].items()}}


def load_adam_state(optimizer: torch.optim.Optimizer, state) -> None:
    """Load a per-leaf Adam state (``{"state": {leaf index: {"step",
    "exp_avg", "exp_avg_sq"}}}``) into ``optimizer``, keeping its own
    param groups; an optax ``ScaleByAdamState`` tree is converted first."""
    if not (isinstance(state, dict) and "state" in state):
        from ..models.convert import adam_state_from_optax

        state = adam_state_from_optax(state)
    sd = optimizer.state_dict()
    sd["state"] = {int(i): dict(s) for i, s in state["state"].items()}
    optimizer.load_state_dict(sd)


def apply_update(optimizer: torch.optim.Optimizer,
                 loss: torch.Tensor) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
