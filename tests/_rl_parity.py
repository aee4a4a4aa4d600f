"""Helpers the port's RLlib parity tests share (import them by name).

Tolerance of every parity check of params, Adam moments and outputs, in
fp32: each element within ``1e-5 * max|leaf| + 1e-6`` of the JAX value;
an update's reported statistics within 1e-4 of their own size.
"""

import numpy as np
import pytest
import torch

from ray_memory_management_tpu_torch.models.convert import (
    adam_state_from_optax, rl_params_from_jax,
)
from ray_memory_management_tpu_torch.rllib import models as tm

# the statistics an update reports are means over the minibatch whose
# terms can cancel (mean Q, a loss), so they are held relative to their
# own size
STAT_TOL = dict(rel=1e-4, abs=1e-6)


def jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def to_numpy(tree):
    """A JAX tree (params, optax state) with numpy leaves."""
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want):
    """Each element within 1e-5 * max|want| + 1e-6 of the JAX value."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max(initial=0.0)) + 1e-6
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def assert_tree_close(port_tree, jax_tree):
    got = tm.tree_leaves(port_tree)
    want = jax_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_close(g, w)


def assert_stats_close(stats, jstats):
    for k, v in jstats.items():
        assert float(stats[k]) == pytest.approx(float(v), **STAT_TOL), k


def port_tree(jax_tree, device="cpu", grad=True):
    """A JAX tree as the port's tree on ``device`` (trainable leaves
    unless ``grad`` is False)."""
    tree = rl_params_from_jax(to_numpy(jax_tree), device)
    if grad:
        tree = tm.tree_map(lambda t: t.requires_grad_(True), tree)
    return tree


def port_adam(leaves_tree, jax_opt_state, lr, select=None):
    """``torch.optim.Adam`` over the port tree's leaves, holding the optax
    state's moments (``select``: the subtrees the port's optimizer
    holds)."""
    opt = tm.make_adam(leaves_tree, lr)
    tm.load_adam_state(opt, adam_state_from_optax(to_numpy(jax_opt_state),
                                                  select))
    return opt


def assert_adam_close(opt, jax_opt_state, select=None):
    """The optimizer's moments and step against optax's. Each moment
    (``mu``, ``nu``) is held as one vector over all the optimizer's
    leaves, at ``assert_close``'s rule on that vector: a one-element
    leaf such as a critic's output bias holds a batch mean whose terms
    cancel, and its rounding is set by the size of the gradients around
    it, not by its own."""
    from ray_memory_management_tpu_torch.models.convert import _find_adam

    adam = _find_adam(jax_opt_state)
    mu, nu = adam.mu, adam.nu
    if select is not None:
        mu = {k: mu[k] for k in select}
        nu = {k: nu[k] for k in select}
    state = opt.state_dict()["state"]
    mus, nus = jax_leaves(mu), jax_leaves(nu)
    assert len(state) == len(mus)
    for key, want in (("exp_avg", mus), ("exp_avg_sq", nus)):
        got = [state[i][key].detach().cpu().numpy() for i in range(len(want))]
        for g, w in zip(got, want):
            assert g.shape == w.shape
        assert_close(np.concatenate([g.ravel() for g in got]),
                     np.concatenate([w.ravel() for w in want]))
    for i in range(len(mus)):
        assert int(state[i]["step"]) == int(np.asarray(adam.count))


def t(x, dtype=None):
    """A numpy array as a CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)
