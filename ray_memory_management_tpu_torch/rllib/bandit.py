"""Contextual bandits: LinUCB and linear Thompson sampling.

The reference's bandit family (rllib/algorithms/bandit/bandit.py —
BanditLinUCB / BanditLinTS configs; bandit_torch_model.py the disjoint
per-arm linear models with UCB exploration per Li et al. 2010 and
posterior sampling per Agrawal & Goyal 2013). All K per-arm models live
as one stacked tensor on the learner's device ([K, d, d] precision
matrices, [K, d] response vectors), arm selection is one batched solve
over the stacked arms + argmax, and the rank-1 posterior update is an
indexed add into the chosen arm — there is no per-arm Python loop
anywhere. An environment step reads one number back: the chosen arm.

Bandits interact step-by-step (no episodes): the env exposes a context
per step, the policy picks an arm, the env returns that arm's reward.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import register_env


class LinearDiscreteBandit:
    """K-armed contextual bandit with linear payoffs: reward =
    theta_arm . context + noise (the reference's
    LinearDiscreteEnv, rllib/examples/env/bandit_envs_discrete.py)."""

    def __init__(self, num_arms: int = 5, context_dim: int = 8,
                 noise: float = 0.1, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.num_arms = num_arms
        self.context_dim = context_dim
        self.noise = noise
        self.theta = rng.normal(size=(num_arms, context_dim))
        self.theta /= np.linalg.norm(self.theta, axis=1, keepdims=True)
        self._rng = rng
        self._ctx: Optional[np.ndarray] = None

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        return self._next_context()

    def _next_context(self) -> np.ndarray:
        self._ctx = self._rng.normal(
            size=self.context_dim).astype(np.float32)
        self._ctx /= max(np.linalg.norm(self._ctx), 1e-8)
        return self._ctx

    def step(self, arm: int):
        means = self.theta @ self._ctx
        reward = float(means[arm] + self.noise * self._rng.normal())
        regret = float(means.max() - means[arm])
        ctx = self._next_context()
        return ctx, reward, regret

    @property
    def observation_dim(self) -> int:
        return self.context_dim

    @property
    def num_actions(self) -> int:
        # the shared env registry makes this env discoverable by every
        # algorithm; fail LOUDLY at the probe (Algorithm.setup reads
        # num_actions) instead of letting a rollout worker mis-unpack
        # the bandit step's (ctx, reward, regret) return
        raise TypeError(
            "LinearBandit is a contextual-bandit env (step-level "
            "context/arm/reward, no episodes); train it with "
            "BanditLinUCB / BanditLinTS, not an RL algorithm")


register_env("LinearBandit", LinearDiscreteBandit)


def make_bandit_programs(num_arms: int, dim: int, alpha: float,
                         lam: float, mode: str):
    """Two functions over the stacked per-arm state:
    select(state, ctx, noise) -> arm (a 0-d tensor);
    update(state, ctx, arm, r) -> state (in place). ``mode``: "ucb"
    (deterministic bonus) or "ts" (posterior draw; ``noise`` [K] is the
    standard-normal draw per arm)."""
    if mode not in ("ucb", "ts"):
        raise ValueError(
            f"unknown bandit exploration mode {mode!r}; use 'ucb' "
            "(LinUCB bonus) or 'ts' (Thompson posterior draw)")

    def init_state(device=None):
        A = (lam * torch.eye(dim, device=device))[None].repeat(
            num_arms, 1, 1)
        b = torch.zeros((num_arms, dim), device=device)
        return {"A": A, "b": b}

    @torch.no_grad()
    def select(state, ctx, noise=None):
        # one batched solve across all arms: A_k theta_k = b_k and
        # A_k u_k = ctx (for the variance term) in a single call
        rhs = torch.stack(
            [state["b"], ctx[None].expand(num_arms, dim)], -1)  # [K, d, 2]
        sol = torch.linalg.solve(state["A"], rhs)
        theta, u = sol[..., 0], sol[..., 1]
        # a row-wise product and sum: arms in the same state score
        # exactly alike (a matrix-vector product may round its rows
        # apart), so ties go to the lowest arm as in the JAX learner
        means = (theta * ctx).sum(-1)
        variances = torch.clamp((u * ctx).sum(-1), min=1e-12)
        if mode == "ts":
            # Thompson: one Gaussian draw per arm from the posterior
            # payoff distribution N(mean, alpha^2 * var)
            scores = means + alpha * torch.sqrt(variances) * noise
        else:
            scores = means + alpha * torch.sqrt(variances)
        return torch.argmax(scores)

    @torch.no_grad()
    def update(state, ctx, arm, reward):
        # rank-1 update of the chosen arm only (an indexed add)
        idx = torch.as_tensor(arm, device=ctx.device).reshape(1)
        state["A"].index_add_(0, idx, torch.outer(ctx, ctx)[None])
        state["b"].index_add_(0, idx, (reward * ctx)[None])
        return state

    return init_state, select, update


class BanditLinUCB(Algorithm):
    """Disjoint LinUCB (mode="ucb"); BanditLinTS flips the config's
    exploration mode to posterior sampling."""

    _mode = "ucb"

    def setup(self, config: Dict[str, Any]) -> None:
        from .env import make_env

        self.cfg = config
        self.device = resolve_device(config.get("device"))
        if config.get("connectors"):
            raise ValueError(
                "connectors are not supported by the bandit algorithms; "
                "transform contexts in the env instead")
        seed = config.get("seed", 0)
        self.env = make_env(config["env_spec"], config.get("env_config"))
        if not hasattr(self.env, "num_arms"):
            raise TypeError(
                f"{config['env_spec']!r} is not a contextual-bandit env "
                "(needs num_arms / step(arm) -> (ctx, reward, regret))")
        self.num_arms = self.env.num_arms
        dim = self.env.observation_dim
        self._explore = config.get("exploration", self._mode)
        init_state, self._select, self._update = make_bandit_programs(
            self.num_arms, dim, config.get("alpha", 1.0),
            config.get("lambda_reg", 1.0), self._explore)
        self.state = init_state(self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._ctx = self.env.reset(seed=seed)
        self.steps_per_iter = config.get("steps_per_iter", 100)
        self._timesteps_total = 0
        self.cumulative_reward = 0.0
        self.cumulative_regret = 0.0
        self.workers = None
        self.local_worker = None

    def select(self, ctx: torch.Tensor) -> int:
        """One arm for the context ``ctx`` on the device: the one host
        read of an environment step."""
        noise = None
        if self._explore == "ts":
            noise = torch.randn(self.num_arms, generator=self._gen,
                                device=self.device)
        return int(self._select(self.state, ctx, noise))

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        window_reward = window_regret = 0.0
        for _ in range(self.steps_per_iter):
            ctx = torch.as_tensor(self._ctx, device=self.device)
            arm = self.select(ctx)
            next_ctx, reward, regret = self.env.step(arm)
            self._update(self.state, ctx, arm, float(np.float32(reward)))
            self._ctx = next_ctx
            window_reward += reward
            window_regret += regret
            self._timesteps_total += 1
        self.cumulative_reward += window_reward
        self.cumulative_regret += window_regret
        return {
            "num_env_steps_sampled": self.steps_per_iter,
            "episode_reward_mean": window_reward / self.steps_per_iter,
            "regret_mean": window_regret / self.steps_per_iter,
            "cumulative_reward": self.cumulative_reward,
            "cumulative_regret": self.cumulative_regret,
            "time_this_iter_s": time.time() - t0,
        }

    def compute_single_action(self, obs: np.ndarray) -> int:
        return self.select(torch.as_tensor(np.asarray(obs, np.float32),
                                           device=self.device))

    def _episode_metrics(self) -> Dict[str, Any]:
        return {}  # bandits: per-iter means reported by training_step

    def _sync_weights(self) -> None:
        pass  # no rollout workers: bandits interact synchronously

    def get_weights(self):
        return {k: v.cpu().numpy() for k, v in self.state.items()}

    def set_weights(self, weights) -> None:
        self.state = {k: torch.as_tensor(np.asarray(v, np.float32),
                                         device=self.device)
                      for k, v in weights.items()}

    def _save_extra_state(self):
        # A/b already persist as the checkpoint's weights (the .params
        # property); duplicating them here would double checkpoint size
        return {"cumulative_reward": self.cumulative_reward,
                "cumulative_regret": self.cumulative_regret,
                "timesteps": self._timesteps_total}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        self.cumulative_reward = state.get("cumulative_reward", 0.0)
        self.cumulative_regret = state.get("cumulative_regret", 0.0)
        self._timesteps_total = state.get("timesteps", 0)

    # Trainable save path reads .params on algorithms; bandits keep the
    # stacked linear state instead
    @property
    def params(self):
        return self.state

    @params.setter
    def params(self, value):
        self.state = value


class BanditLinTS(BanditLinUCB):
    _mode = "ts"


class BanditLinUCBConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(BanditLinUCB)
        self.env_spec = "LinearBandit"
        self.extra.update({"alpha": 1.0, "lambda_reg": 1.0,
                           "steps_per_iter": 100})

    def training(self, *, alpha=None, lambda_reg=None, steps_per_iter=None,
                 **kwargs) -> "BanditLinUCBConfig":
        super().training(**kwargs)
        for k, v in (("alpha", alpha), ("lambda_reg", lambda_reg),
                     ("steps_per_iter", steps_per_iter)):
            if v is not None:
                self.extra[k] = v
        return self


class BanditLinTSConfig(BanditLinUCBConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = BanditLinTS
