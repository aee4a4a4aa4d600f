"""MBPETS: model-based RL — learned dynamics ensemble + CEM planning.

The reference's model-based family (rllib/algorithms/dreamer,
rllib/algorithms/mbmpo — learn a dynamics model from real transitions,
then get the policy from the MODEL instead of more environment samples).
This implements the family's PETS-shaped core (Chua et al. 2018, the
algorithm MBMPO's model stack builds on): a probabilistic-ensemble
dynamics model trained by supervised regression, with the acting policy
a cross-entropy-method (CEM) planner that rolls action sequences
through the model and executes the first action of the best plan (MPC).

Planning is the hot loop. One plan — population rollouts through every
ensemble member across every CEM round — runs on the learner's device:
each horizon step is one batched MLP over [ensemble, population] rows
(batched matmuls over the stacked members), a Python loop over the
horizon runs inside a loop over CEM rounds, and ``torch.topk`` picks the
elites. The round's Gaussian draws come from a generator on the device
(all rounds in one draw) or, through ``noise=``, from the caller. The
warm-started plan mean stays on the device; an environment step reads
back only the action it executes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .models import (
    apply_update, make_adam, make_generator, stacked_mlp_apply,
    stacked_mlp_init, trainable,
)
from .replay import ReplayBuffer


def mb_init(generator: torch.Generator, n_models: int, obs_dim: int,
            act_dim: int, hidden=(128, 128)):
    """Dynamics ensemble, stacked along axis 0: each member maps
    [obs, act] -> [delta_obs, reward] (delta prediction — the standard
    trick that makes the regression target near-stationary)."""
    return stacked_mlp_init(generator, n_models,
                            [obs_dim + act_dim, *hidden, obs_dim + 1])


def make_model_update(opt):
    """``update(params, obs, act, delta, rew) -> loss``: one Adam step of
    the whole ensemble in place."""

    def update(params, obs, act, delta, rew):
        x = torch.cat([obs, act], -1)
        # every member trains on every sample (bootstrap disagreement
        # comes from init + SGD noise; PETS's per-member bootstrap
        # resampling adds little at this scale)
        out = stacked_mlp_apply(params, x)                # [E, B, d+1]
        tgt = torch.cat([delta, rew[:, None]], -1)[None]
        loss = torch.mean((out - tgt) ** 2)
        apply_update(opt, loss)
        return loss.detach()

    return update


def discounts(horizon: int, gamma: float) -> np.ndarray:
    """Each step's discount, accumulated in fp32 as the JAX scan carries
    it."""
    disc = np.ones(horizon, np.float32)
    for h in range(1, horizon):
        disc[h] = disc[h - 1] * np.float32(gamma)
    return disc


def plan_scores(params, obs0, plans, disc, disagreement_coeff: float):
    """Disagreement-penalized return of each candidate plan [P, H, act]
    from obs0 [D] under the stacked ensemble: every horizon step is one
    batched MLP over [E, P] rows."""
    E = params[0]["w"].shape[0]
    obs = obs0.expand(E, plans.shape[0], obs0.shape[-1])       # [E, P, D]
    rewards = []
    for h in range(plans.shape[1]):
        a = plans[:, h].expand(E, -1, -1)                       # [E, P, A]
        out = stacked_mlp_apply(params, torch.cat([obs, a], -1))
        obs = obs + out[..., :-1]
        rewards.append(out[..., -1])
    per = (torch.stack(rewards, -1) * disc).sum(-1)             # [E, P]
    return per.mean(0) - disagreement_coeff * per.std(0, correction=0)


@torch.no_grad()
def cem_round(params, obs0, mean, std, noise, disc, elites: int,
              bound: float, disagreement_coeff: float):
    """One CEM refinement: candidates ``mean + std * noise`` ([P, H, act]
    draws) clipped to the action range, scored through the ensemble,
    the ``elites`` best kept. Returns (new mean, new std, the elites'
    candidate indices)."""
    cand = torch.clamp(mean[None] + std[None] * noise, -bound, bound)
    returns = plan_scores(params, obs0, cand, disc, disagreement_coeff)
    top = torch.topk(returns, elites).indices
    elite = cand[top]                                          # [K, H, A]
    return elite.mean(0), elite.std(0, correction=0) + 1e-3, top


def make_cem_planner(horizon: int, population: int, elites: int,
                     cem_iters: int, act_dim: int, bound: float,
                     gamma: float, disagreement_coeff: float = 1.0):
    """The whole MPC action choice: CEM refinement over action sequences,
    each candidate scored by rolling through every ensemble member —
    mean return MINUS a disagreement penalty (``disagreement_coeff`` x
    the across-member return std). Without the penalty CEM reliably
    finds plans that exploit the model's out-of-distribution optimism
    (unvisited states extrapolate toward reward 0 in a task whose true
    rewards are all negative); member disagreement is highest exactly
    there, so penalizing it keeps plans inside the data the model
    actually fits.

    ``plan(params, obs0, init_mean, noise=None, generator=None) -> mean
    [H, act]``: ``noise`` holds every round's standard-normal draw
    [cem_iters, population, H, act]; without it one draw from
    ``generator`` on the device supplies them."""
    disc_np = discounts(horizon, gamma)

    @torch.no_grad()
    def plan(params, obs0, init_mean, noise=None, generator=None):
        dev = init_mean.device
        if noise is None:
            noise = torch.randn((cem_iters, population, horizon, act_dim),
                                generator=generator, device=dev)
        disc = torch.as_tensor(disc_np, device=dev)
        mean = init_mean
        std = torch.full((horizon, act_dim), bound / 2.0, device=dev)
        for i in range(cem_iters):
            mean, std, _ = cem_round(params, obs0, mean, std, noise[i], disc,
                                     elites, bound, disagreement_coeff)
        return mean  # [H, act]: execute mean[0], warm-start with rest

    return plan


class MBPETS(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.env = make_env(config["env_spec"], config.get("env_config"))
        if hasattr(self.env, "num_actions") and self.env.num_actions:
            raise ValueError("MBPETS plans continuous torques; discrete "
                             "envs train through DQN-family algorithms")
        self.obs_dim = self.env.observation_dim
        self.act_dim = int(getattr(self.env, "action_dim", 1))
        self.bound = float(getattr(self.env, "action_bound", 1.0))
        self.n_models = config.get("ensemble_size", 4)
        self.horizon = config.get("horizon", 12)
        self.params = trainable(mb_init(
            make_generator(seed), self.n_models, self.obs_dim,
            self.act_dim, config.get("hidden", (128, 128))), self.device)
        self.opt = make_adam(self.params, config.get("lr", 1e-3))
        self._update = make_model_update(self.opt)
        self._plan = make_cem_planner(
            self.horizon, config.get("population", 128),
            config.get("elites", 16), config.get("cem_iters", 4),
            self.act_dim, self.bound, config.get("gamma", 0.99),
            config.get("disagreement_coeff", 1.0))
        self.buffer = ReplayBuffer(config.get("buffer_size", 100_000))
        self.batch_size = config.get("train_batch_size", 256)
        self.model_updates = config.get("model_updates_per_iter", 80)
        self.rollout_steps = config.get("rollout_fragment_length", 200)
        self.random_steps = config.get("random_steps", 200)
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._obs = self.env.reset(seed=seed)
        self._plan_mean = torch.zeros((self.horizon, self.act_dim),
                                      device=self.device)
        self._ep_reward = 0.0
        self.episode_rewards: List[float] = []
        self._timesteps_total = 0
        self._updates_done = 0
        self.plans_done = 0
        self.workers = None
        self.local_worker = None

    # -------------------------------------------------------------- acting
    def plan(self, obs, noise: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """One CEM plan from ``obs`` warm-started at the current plan
        mean; returns the refined mean [H, act] on the device."""
        self.plans_done += 1
        return self._plan(
            self.params, torch.as_tensor(np.asarray(obs, np.float32),
                                         device=self.device),
            self._plan_mean, noise, self._gen)

    def _act(self, obs, explore: bool) -> np.ndarray:
        if explore and self._timesteps_total < self.random_steps:
            return self._rng.uniform(
                -self.bound, self.bound, self.act_dim).astype(np.float32)
        mean = self.plan(obs)
        # MPC warm start: shift the plan one step, repeat the tail
        self._plan_mean = torch.cat([mean[1:], mean[-1:]])
        a = mean[0].cpu().numpy()  # the one read back a step
        if explore:
            a = a + 0.1 * self.bound * self._rng.standard_normal(
                self.act_dim).astype(np.float32)
        return np.clip(a, -self.bound, self.bound)

    def compute_single_action(self, obs) -> np.ndarray:
        return self._act(np.asarray(obs, np.float32), explore=False)

    # ------------------------------------------------------------- training
    def _collect(self, n: int) -> None:
        cols = {"obs": [], "act": [], "delta": [], "rew": []}
        for _ in range(n):
            a = self._act(self._obs, explore=True)
            nxt, r, term, trunc, _ = self.env.step(
                a if self.act_dim > 1 else float(a[0]))
            cols["obs"].append(np.asarray(self._obs, np.float32))
            cols["act"].append(np.asarray(a, np.float32).reshape(
                self.act_dim))
            cols["delta"].append(
                np.asarray(nxt, np.float32)
                - np.asarray(self._obs, np.float32))
            cols["rew"].append(np.float32(r))
            self._ep_reward += float(r)
            self._timesteps_total += 1
            if term or trunc:
                self.episode_rewards.append(self._ep_reward)
                self._ep_reward = 0.0
                self._obs = self.env.reset(
                    seed=int(self._rng.integers(1 << 31)))
                self._plan_mean = torch.zeros_like(self._plan_mean)
            else:
                self._obs = nxt
        self.buffer.add_batch({k: np.stack(v) for k, v in cols.items()})

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        self._collect(self.rollout_steps)
        model_loss = float("nan")
        if len(self.buffer) >= self.batch_size:
            for _ in range(self.model_updates):
                loss = self.learn_on_minibatch(
                    self.buffer.sample(self.batch_size))
            model_loss = float(loss)
        recent = self.episode_rewards[-10:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else float("nan"),
            "model_loss": model_loss,
            "episodes_total": len(self.episode_rewards),
            "num_updates": self._updates_done,
            "time_this_iter_s": time.time() - t0,
        }

    def learn_on_minibatch(self, cols: Dict[str, np.ndarray]
                           ) -> torch.Tensor:
        loss = self._update(
            self.params, *(torch.as_tensor(cols[k], device=self.device)
                           for k in ("obs", "act", "delta", "rew")))
        self._updates_done += 1
        return loss

    def _episode_metrics(self) -> Dict[str, Any]:
        recent = self.episode_rewards[-10:]
        return {
            "episode_reward_mean": float(np.mean(recent)) if recent
            else None,
            "episode_len_mean": None,
            "episodes_total": len(self.episode_rewards),
        }

    def _sync_weights(self) -> None:
        pass  # planning runs in-process

    def _save_extra_state(self):
        return {"params": self.get_weights(),
                "updates": self._updates_done}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        self.set_weights(state["params"])
        self.opt.state.clear()  # afresh, as the JAX learner's on restore
        self._updates_done = state.get("updates", 0)


class MBPETSConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(MBPETS)
        self.train_batch_size = 256  # model-regression minibatch, not
        # the on-policy 4000-sample fragment the base default serves
        self.extra.update({
            "ensemble_size": 4, "horizon": 12, "population": 128,
            "elites": 16, "cem_iters": 4, "model_updates_per_iter": 80,
            "random_steps": 200, "rollout_fragment_length": 200,
            "buffer_size": 100_000,
        })

    def training(self, *, ensemble_size=None, horizon=None,
                 population=None, cem_iters=None,
                 model_updates_per_iter=None, **kwargs) -> "MBPETSConfig":
        super().training(**kwargs)
        for k, v in (("ensemble_size", ensemble_size),
                     ("horizon", horizon), ("population", population),
                     ("cem_iters", cem_iters),
                     ("model_updates_per_iter", model_updates_per_iter)):
            if v is not None:
                self.extra[k] = v
        return self
