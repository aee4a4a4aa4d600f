"""TD3 / DDPG: deterministic-policy continuous control.

The reference ships DDPG and TD3 as one family (rllib/algorithms/ddpg/
ddpg_tf_policy.py — deterministic actor + Q critic, Ornstein-Uhlenbeck or
Gaussian exploration; rllib/algorithms/td3/td3.py — the three TD3 deltas
over DDPG: twin critics with a min backup, delayed policy updates, and
target-policy smoothing per Fujimoto et al. 2018). Same family shape here:
``TD3`` implements the general algorithm; ``DDPGConfig`` is the preset that
turns the three deltas off (single critic, every-step policy update, no
smoothing noise).

Like sac.py, the update — critic TD step, the (possibly skipped) actor
step, polyak target syncs — runs on the learner's device. The delayed
policy update is a Python branch on the learner's host-side update
counter: the card is never asked whether to take it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import api
from ..utils.device import resolve_device
from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .collector import NEXT_OBS, OffPolicyCollector
from .env import make_env
from .models import (
    adam_state_to_cpu, copy_into, detached_copy, load_adam_state, make_adam,
    make_generator, mlp_apply, mlp_init, params_from_numpy, params_to_numpy,
    polyak_, step_on, trainable, tree_leaves,
)
from .ppo import stats_to_floats
from .replay import ReplayBuffer
from .rollout_worker import WorkerSet


def td3_init(generator: torch.Generator, obs_dim: int, act_dim: int,
             hidden=(64, 64), twin_q: bool = True):
    params = {
        "pi": mlp_init(generator, [obs_dim, *hidden, act_dim]),
        "q1": mlp_init(generator, [obs_dim + act_dim, *hidden, 1]),
    }
    if twin_q:
        params["q2"] = mlp_init(generator, [obs_dim + act_dim, *hidden, 1])
    return params


def critic_keys(twin_q: bool):
    return ("q1", "q2") if twin_q else ("q1",)


def pi_apply(params, obs, bound: float):
    """Deterministic squashed action: a = bound * tanh(mlp(s))."""
    return bound * torch.tanh(mlp_apply(params["pi"], obs))


def _q(params, which: str, obs, act):
    return mlp_apply(params[which], torch.cat([obs, act], -1))[..., 0]


def make_td3_update(pi_opt, q_opt, gamma: float, tau: float, bound: float,
                    twin_q: bool, smooth_sigma: float, smooth_clip: float,
                    generator: Optional[torch.Generator] = None):
    """``update(params, target_params, batch, do_actor, noise=None) ->
    stats``, in place. ``do_actor`` is a host bool (the delay schedule);
    ``noise`` is the standard-normal draw [B, act_dim] of the target
    smoothing, from ``generator`` when not given."""
    critics = critic_keys(twin_q)

    def update(params, target_params, batch, do_actor: bool, noise=None):
        obs, act, rew, nxt, done = batch
        with torch.no_grad():
            next_a = pi_apply(target_params, nxt, bound)
            if smooth_sigma > 0:
                # target-policy smoothing: clipped Gaussian on the TARGET
                # action, re-clipped to the action range (td3.py's
                # target_noise/target_noise_clip)
                if noise is None:
                    noise = torch.randn(next_a.shape, generator=generator,
                                        device=next_a.device)
                next_a = torch.clamp(
                    next_a + torch.clamp(smooth_sigma * noise,
                                         -smooth_clip, smooth_clip),
                    -bound, bound)
            tq = _q(target_params, "q1", nxt, next_a)
            if twin_q:
                tq = torch.minimum(tq, _q(target_params, "q2", nxt, next_a))
            target = rew + gamma * (1.0 - done) * tq
        q1 = _q(params, "q1", obs, act)
        c_loss = torch.mean((q1 - target) ** 2)
        if twin_q:
            c_loss = c_loss + torch.mean(
                (_q(params, "q2", obs, act) - target) ** 2)
        step_on(q_opt, c_loss,
                tree_leaves({k: params[k] for k in critics}))
        stats = {"critic_loss": c_loss.detach(), "mean_q": q1.detach().mean()}

        if do_actor:
            a_loss = -torch.mean(_q(params, "q1", obs,
                                    pi_apply(params, obs, bound)))
            step_on(pi_opt, a_loss, tree_leaves(params["pi"]))
            polyak_(target_params, params, tau)
            stats["actor_loss"] = a_loss.detach()
        else:
            stats["actor_loss"] = 0.0
        return stats

    return update


class TD3RolloutWorker(OffPolicyCollector):
    """Deterministic-policy collector: exploration is ADDITIVE Gaussian
    action noise (ddpg.py's exploration_config gaussian sigma), with a
    uniform-random warmup seeding the replay buffer."""

    def __init__(self, env_spec, env_config: Optional[dict], hidden,
                 twin_q: bool, sigma: float, seed: int):
        self._setup_env(env_spec, env_config, seed)
        self.bound = float(getattr(self.env, "action_bound", 1.0))
        self.act_dim = int(getattr(self.env, "action_dim", 1))
        self.sigma = sigma
        self.params = td3_init(make_generator(0), self.env.observation_dim,
                               self.act_dim, hidden, twin_q)
        self._random_steps = 0

    def set_weights(self, weights) -> None:
        self.params = {**self.params,
                       "pi": params_from_numpy(weights["pi"])}

    def sample(self, num_steps: int,
               random_steps: int = 0) -> Dict[str, np.ndarray]:
        self._random_steps = random_steps
        return self._collect(num_steps)

    def _action_buffer(self, num_steps: int) -> np.ndarray:
        return np.zeros((num_steps, self.act_dim), np.float32)

    def _select_action(self) -> np.ndarray:
        if self._steps_done < self._random_steps:
            return self.rng.uniform(-self.bound, self.bound, self.act_dim)
        with torch.no_grad():
            a = pi_apply(self.params, torch.from_numpy(
                np.asarray(self._obs, np.float32)[None, :]),
                self.bound)[0].numpy()
        return np.clip(
            a + self.sigma * self.bound
            * self.rng.standard_normal(self.act_dim),
            -self.bound, self.bound)


class _TD3WorkerSet(WorkerSet):
    def __init__(self, env_spec, env_config, hidden, twin_q, sigma,
                 num_workers: int, seed: int):
        cls = api.remote(TD3RolloutWorker)
        self.remote_workers = [
            cls.options(num_cpus=1).remote(
                env_spec, env_config, hidden, twin_q, sigma,
                seed + 1000 * (i + 1))
            for i in range(num_workers)
        ]
        api.get([w.ready.remote() for w in self.remote_workers])


class TD3(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        if config.get("connectors"):
            raise ValueError(
                "connectors are not supported by this algorithm's "
                "custom rollout collectors yet; use PPO/IMPALA or "
                "drop the connectors config")
        seed = config.get("seed", 0)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        self.obs_dim = probe_env.observation_dim
        self.act_dim = int(getattr(probe_env, "action_dim", 1))
        self.bound = float(getattr(probe_env, "action_bound", 1.0))
        hidden = config.get("hidden", (64, 64))
        self.twin_q = bool(config.get("twin_q", True))
        self.params = trainable(td3_init(
            make_generator(seed), self.obs_dim, self.act_dim, hidden,
            self.twin_q), self.device)
        self.target_params = detached_copy(self.params)
        self.gamma = config.get("gamma", 0.99)
        self.tau = config.get("tau", 0.005)
        self.policy_delay = int(config.get("policy_delay", 2))
        lr = config.get("lr", 1e-3)
        self._critics = critic_keys(self.twin_q)
        self._pi_opt = make_adam(self.params["pi"],
                                 config.get("actor_lr", lr))
        self._q_opt = make_adam({k: self.params[k] for k in self._critics},
                                config.get("critic_lr", lr))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 7)
        self._update = make_td3_update(
            self._pi_opt, self._q_opt, self.gamma, self.tau, self.bound,
            self.twin_q, config.get("smooth_sigma", 0.2),
            config.get("smooth_clip", 0.5), self._gen)
        self.replay = ReplayBuffer(
            config.get("replay_buffer_capacity", 100_000), seed=seed)
        self.learning_starts = config.get("learning_starts", 500)
        self.random_steps = config.get("random_steps", 500)
        self.train_batch_size = config.get("train_batch_size", 128)
        self.updates_per_step = config.get("updates_per_step", 32)
        self.explore_sigma = config.get("explore_sigma", 0.1)
        self._updates_done = 0
        self._timesteps_total = 0

        n_workers = config.get("num_rollout_workers", 0)
        self.workers = None
        self.local_worker = None
        if n_workers > 0:
            self.workers = _TD3WorkerSet(
                config["env_spec"], config.get("env_config"), hidden,
                self.twin_q, self.explore_sigma, n_workers, seed)
        else:
            self.local_worker = TD3RolloutWorker(
                config["env_spec"], config.get("env_config"), hidden,
                self.twin_q, self.explore_sigma, seed)

    @property
    def opt_states(self):
        """The two optimizers (actor, critics), in the JAX learner's
        order."""
        return (self._pi_opt, self._q_opt)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        fragment = self.cfg.get("rollout_fragment_length", 64)
        self._sync_weights()
        if self.workers is not None:
            batches = api.get(
                self.workers.sample(fragment, self.random_steps))
        else:
            batches = [self.local_worker.sample(
                fragment, self.random_steps)]
        n = 0
        for b in batches:
            self.replay.add_batch(b)
            n += len(b[sb.ACTIONS])
        self._timesteps_total += n
        sample_time = time.time() - t0

        stats: Dict[str, Any] = {}
        t1 = time.time()
        if len(self.replay) >= self.learning_starts:
            for _ in range(self.updates_per_step):
                stats = self.learn_on_minibatch(
                    self.replay.sample(self.train_batch_size))
        out = stats_to_floats(stats)
        learn_time = time.time() - t1
        out.update({
            "num_env_steps_sampled": n,
            "replay_size": len(self.replay),
            "num_updates": self._updates_done,
            "sample_time_s": sample_time,
            "learn_time_s": learn_time,
        })
        return out

    def learn_on_minibatch(self, mb: Dict[str, np.ndarray],
                           noise=None) -> Dict[str, Any]:
        batch = tuple(torch.as_tensor(mb[k], device=self.device)
                      for k in (sb.OBS, sb.ACTIONS, sb.REWARDS, NEXT_OBS,
                                sb.DONES))
        do_actor = self._updates_done % self.policy_delay == 0
        stats = self._update(self.params, self.target_params, batch,
                             do_actor, noise)
        self._updates_done += 1
        return stats

    def compute_single_action(self, obs: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None, :]
        with torch.no_grad():
            return pi_apply(self.params, x, self.bound)[0].cpu().numpy()

    def _sync_weights(self) -> None:
        weights = {"pi": params_to_numpy(self.params["pi"])}
        if self.workers is not None:
            self.workers.set_weights(weights)
        else:
            self.local_worker.set_weights(weights)

    def _save_extra_state(self):
        return {
            "target_params": params_to_numpy(self.target_params),
            "opt_states": tuple(adam_state_to_cpu(o)
                                for o in self.opt_states),
            "generator": self._gen.get_state(),
            "updates_done": self._updates_done,
        }

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "target_params" in state:
            copy_into(self.target_params, state["target_params"])
        if "opt_states" in state:
            from ..models.convert import rl_opt_states_from_jax

            for opt, s in zip(self.opt_states, rl_opt_states_from_jax(
                    state["opt_states"], (None, self._critics))):
                load_adam_state(opt, s)
        if "generator" in state:
            self._gen.set_state(state["generator"])
        self._updates_done = state.get("updates_done", 0)


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(TD3)
        self.extra.update({
            "replay_buffer_capacity": 100_000, "learning_starts": 500,
            "random_steps": 500, "updates_per_step": 32, "tau": 0.005,
            "twin_q": True, "policy_delay": 2, "smooth_sigma": 0.2,
            "smooth_clip": 0.5, "explore_sigma": 0.1,
        })

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 random_steps=None, updates_per_step=None, tau=None,
                 policy_delay=None, smooth_sigma=None, smooth_clip=None,
                 explore_sigma=None, twin_q=None, actor_lr=None,
                 critic_lr=None, **kwargs) -> "TD3Config":
        super().training(**kwargs)
        for k, v in (
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("learning_starts", learning_starts),
                ("random_steps", random_steps),
                ("updates_per_step", updates_per_step),
                ("tau", tau), ("policy_delay", policy_delay),
                ("smooth_sigma", smooth_sigma),
                ("smooth_clip", smooth_clip),
                ("explore_sigma", explore_sigma), ("twin_q", twin_q),
                ("actor_lr", actor_lr), ("critic_lr", critic_lr)):
            if v is not None:
                self.extra[k] = v
        return self


class DDPGConfig(TD3Config):
    """DDPG = TD3 minus the three TD3 deltas (the reference keeps DDPG as
    its own algorithm, rllib/algorithms/ddpg/ddpg.py; here it is the
    degenerate preset: single critic, policy updated every step, no
    target smoothing — Lillicrap et al. 2015 with Gaussian exploration)."""

    def __init__(self):
        super().__init__()
        self.extra.update({
            "twin_q": False, "policy_delay": 1, "smooth_sigma": 0.0,
        })
