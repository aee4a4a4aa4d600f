"""SAC: soft actor-critic for continuous control.

The reference's SAC (rllib/algorithms/sac/sac.py — config + training_step
wiring; rllib/algorithms/sac/sac_tf_policy.py:268 the twin-Q + squashed-
Gaussian losses; target entropy auto-tuning per Haarnoja et al. 2018).
One update — actor forward, twin-Q targets with the entropy bonus, three
losses (critic, actor, temperature), Adam on each, and the polyak
target-network update — runs on the learner's device, in that order;
stochastic rollouts run on CPU actors; the replay buffer is host-side
numpy feeding one contiguous minibatch per update.

The critic optimizer holds the two critics' leaves (``q1``, ``q2``) and
the actor's holds ``pi``; the temperature ``log_alpha`` is a scalar leaf
with its own Adam. The learner's Gaussian draws come from a generator on
its device; an update also takes them as ``noise`` so that two devices
can be held to one another.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

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

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2 * math.pi)
_LOG_2 = math.log(2.0)

# which subtrees each optimizer holds (the JAX critic optimizer's state
# spans the whole tree; its ``pi`` entries never move)
CRITICS = ("q1", "q2")


def sac_init(generator: torch.Generator, obs_dim: int, act_dim: int,
             hidden=(64, 64)):
    """Policy emits (mean, log_std) per action dim; twin Q critics score
    (obs, action) pairs (sac_tf_policy.py's SquashedGaussian + twin_q)."""
    return {
        "pi": mlp_init(generator, [obs_dim, *hidden, 2 * act_dim]),
        "q1": mlp_init(generator, [obs_dim + act_dim, *hidden, 1]),
        "q2": mlp_init(generator, [obs_dim + act_dim, *hidden, 1]),
    }


def pi_sample(params, obs, eps, bound: float):
    """Squashed-Gaussian sample at the standard-normal draw ``eps``
    ([..., act_dim]): a = bound * tanh(mu + sigma eps), with the tanh
    change-of-variables log-prob correction."""
    out = mlp_apply(params["pi"], obs)
    mu, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)
    std = torch.exp(log_std)
    pre = mu + std * eps
    a = torch.tanh(pre)
    # N(pre; mu, std) log-density, then tanh correction (numerically
    # stable form: log(1 - tanh^2 x) = 2(log 2 - x - softplus(-2x)))
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2 * log_std + _LOG_2PI)
        - 2 * (_LOG_2 - pre - F.softplus(-2 * pre)),
        dim=-1)
    return bound * a, logp


def q_value(params, which: str, obs, act):
    return mlp_apply(params[which], torch.cat([obs, act], -1))[..., 0]


def make_sac_update(pi_opt, q_opt, a_opt, gamma: float, tau: float,
                    target_entropy: float, bound: float,
                    generator: Optional[torch.Generator] = None):
    """``update(params, target_params, log_alpha, batch, noise=None) ->
    stats``: critic, then actor on the updated critics, then temperature,
    then polyak, all in place. ``noise`` is the pair of standard-normal
    draws ([B, act_dim] each) for the target's next actions and the
    actor's actions; without it they come from ``generator``."""

    def update(params, target_params, log_alpha, batch, noise=None):
        obs, act, rew, nxt, done = batch
        if noise is None:
            shape = (obs.shape[0], act.shape[-1])
            noise = tuple(torch.randn(shape, generator=generator,
                                      device=obs.device) for _ in range(2))
        eps_next, eps_pi = noise
        q_leaves = tree_leaves({k: params[k] for k in CRITICS})

        # critics (gradients to q1/q2 only; the target is a constant)
        with torch.no_grad():
            next_a, next_logp = pi_sample(params, nxt, eps_next, bound)
            tq = torch.minimum(q_value(target_params, "q1", nxt, next_a),
                               q_value(target_params, "q2", nxt, next_a))
            alpha = torch.exp(log_alpha)
            target = rew + gamma * (1.0 - done) * (tq - alpha * next_logp)
        q1 = q_value(params, "q1", obs, act)
        q2 = q_value(params, "q2", obs, act)
        c_loss = torch.mean((q1 - target) ** 2) \
            + torch.mean((q2 - target) ** 2)
        step_on(q_opt, c_loss, q_leaves)

        # actor on the updated critics (gradients to pi only)
        a, logp = pi_sample(params, obs, eps_pi, bound)
        q = torch.minimum(q_value(params, "q1", obs, a),
                          q_value(params, "q2", obs, a))
        a_loss = torch.mean(alpha * logp - q)
        step_on(pi_opt, a_loss, tree_leaves(params["pi"]))

        # temperature toward the entropy target
        logp = logp.detach()
        al_loss = -torch.mean(log_alpha * (logp + target_entropy))
        step_on(a_opt, al_loss, [log_alpha])

        # polyak target update (the reference's tau soft sync)
        polyak_(target_params, params, tau)
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                "alpha_loss": al_loss.detach(),
                "alpha": torch.exp(log_alpha.detach()),
                "mean_q": q1.detach().mean(), "entropy": -logp.mean()}

    return update


class SACRolloutWorker(OffPolicyCollector):
    """Stochastic-policy transition collector for continuous actions:
    samples from the squashed Gaussian (exploration IS the policy noise);
    the first ``random_steps`` draw uniform actions to seed the replay
    (the reference's initial random exploration)."""

    def __init__(self, env_spec, env_config: Optional[dict], hidden,
                 seed: int):
        self._setup_env(env_spec, env_config, seed)
        self.bound = float(getattr(self.env, "action_bound", 1.0))
        self.act_dim = int(getattr(self.env, "action_dim", 1))
        self._gen = make_generator(seed)
        self.params = sac_init(make_generator(0), self.env.observation_dim,
                               self.act_dim, hidden)
        self._random_steps = 0

    def set_weights(self, weights) -> None:
        # the learner broadcasts only the pi subtree (all a rollout
        # worker ever evaluates); merge it over the local placeholder
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
        eps = torch.randn((1, self.act_dim), generator=self._gen)
        with torch.no_grad():
            a, _ = pi_sample(self.params, torch.from_numpy(
                np.asarray(self._obs, np.float32)[None, :]), eps,
                self.bound)
        return a[0].numpy()


class SAC(Algorithm):
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
        self.params = trainable(sac_init(
            make_generator(seed), self.obs_dim, self.act_dim, hidden),
            self.device)
        self.target_params = detached_copy(self.params)
        self.log_alpha = torch.tensor(
            float(np.log(config.get("initial_alpha", 1.0))),
            dtype=torch.float32, device=self.device, requires_grad=True)
        self.gamma = config.get("gamma", 0.99)
        self.tau = config.get("tau", 0.005)
        # the standard heuristic target: -|A|
        self.target_entropy = config.get(
            "target_entropy", -float(self.act_dim))
        lr = config.get("lr", 3e-4)
        self._pi_opt = make_adam(self.params["pi"],
                                 config.get("actor_lr", lr))
        self._q_opt = make_adam({k: self.params[k] for k in CRITICS},
                                config.get("critic_lr", lr))
        self._a_opt = make_adam([self.log_alpha],
                                config.get("alpha_lr", lr))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 7)
        self._update = make_sac_update(
            self._pi_opt, self._q_opt, self._a_opt, self.gamma, self.tau,
            self.target_entropy, self.bound, self._gen)
        self.replay = ReplayBuffer(
            config.get("replay_buffer_capacity", 100_000), seed=seed)
        self.learning_starts = config.get("learning_starts", 500)
        self.random_steps = config.get("random_steps", 500)
        self.train_batch_size = config.get("train_batch_size", 128)
        self.updates_per_step = config.get("updates_per_step", 32)
        self._updates_done = 0
        self._timesteps_total = 0

        n_workers = config.get("num_rollout_workers", 0)
        self.workers = None
        self.local_worker = None
        if n_workers > 0:
            self.workers = WorkerSet(
                config["env_spec"], config.get("env_config"), hidden,
                n_workers, seed, worker_cls=SACRolloutWorker,
                worker_args=())
        else:
            self.local_worker = SACRolloutWorker(
                config["env_spec"], config.get("env_config"), hidden, seed)

    @property
    def opt_states(self):
        """The three optimizers (actor, critics, temperature), in the JAX
        learner's order."""
        return (self._pi_opt, self._q_opt, self._a_opt)

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
        # one host read of the statistics (alpha among them) an iteration
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
        stats = self._update(self.params, self.target_params,
                             self.log_alpha, batch, noise)
        self._updates_done += 1
        return stats

    def compute_single_action(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic (mean) action for evaluation."""
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None, :]
        with torch.no_grad():
            out = mlp_apply(self.params["pi"], x)
        mu = out[0, : self.act_dim].cpu().numpy()
        return self.bound * np.tanh(mu)

    def _sync_weights(self) -> None:
        """Rollout workers only run the policy — ship just the pi subtree
        (a third of the full twin-Q tree) per broadcast."""
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
            "log_alpha": float(self.log_alpha.detach()),
            "generator": self._gen.get_state(),
            "updates_done": self._updates_done,
        }

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "target_params" in state:
            copy_into(self.target_params, state["target_params"])
        if "opt_states" in state:
            # Adam moments restore too — resetting them on restore is an
            # effective learning-rate spike mid-run. A JAX checkpoint's
            # optax states convert leaf for leaf (models/convert.py)
            from ..models.convert import rl_opt_states_from_jax

            for opt, s in zip(self.opt_states, rl_opt_states_from_jax(
                    state["opt_states"], (None, CRITICS, None))):
                load_adam_state(opt, s)
        if "log_alpha" in state:
            with torch.no_grad():
                self.log_alpha.fill_(float(state["log_alpha"]))
        if "generator" in state:
            self._gen.set_state(state["generator"])
        self._updates_done = state.get("updates_done", 0)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(SAC)
        self.extra.update({
            "replay_buffer_capacity": 100_000, "learning_starts": 500,
            "random_steps": 500, "updates_per_step": 32, "tau": 0.005,
            "initial_alpha": 1.0,
        })

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 random_steps=None, updates_per_step=None, tau=None,
                 target_entropy=None, actor_lr=None, critic_lr=None,
                 alpha_lr=None, initial_alpha=None, **kwargs) -> "SACConfig":
        super().training(**kwargs)
        for k, v in (
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("learning_starts", learning_starts),
                ("random_steps", random_steps),
                ("updates_per_step", updates_per_step),
                ("tau", tau), ("target_entropy", target_entropy),
                ("actor_lr", actor_lr), ("critic_lr", critic_lr),
                ("alpha_lr", alpha_lr), ("initial_alpha", initial_alpha)):
            if v is not None:
                self.extra[k] = v
        return self
