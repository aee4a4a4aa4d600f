"""DQN: off-policy Q-learning with a replay buffer on the learner.

The reference's DQN (rllib/algorithms/dqn/dqn.py:394 training_step:
store-to-replay, sample, TD update, periodic target-network sync;
rllib/algorithms/dqn/dqn_tf_policy.py:237 the double-Q TD loss). The
minibatch update — online forward, DOUBLE-Q target (argmax from the
online net, value from the target net), Huber TD loss, Adam — runs on
the learner's device; epsilon-greedy rollouts run on CPU actors; the
replay buffer is host-side numpy (replay.py), feeding the device one
contiguous minibatch per step.
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
    adam_state_to_cpu, apply_update, copy_into, load_adam_state, make_adam,
    make_generator, mlp_apply, mlp_init, params_from_numpy, params_to_numpy,
    tree_map,
)
from .ppo import stats_to_floats
from .replay import ReplayBuffer
from .rollout_worker import WorkerSet


def q_init(generator: torch.Generator, obs_dim: int, num_actions: int,
           hidden=(64, 64)):
    return {"q": mlp_init(generator, [obs_dim, *hidden, num_actions])}


def q_apply(params, obs):
    return mlp_apply(params["q"], obs)


def huber_loss(predictions, targets, delta: float = 1.0):
    """Elementwise Huber loss, ``optax.huber_loss``'s formula."""
    abs_error = torch.abs(predictions - targets)
    quadratic = torch.clamp(abs_error, max=delta)
    return 0.5 * quadratic * quadratic + delta * (abs_error - quadratic)


def make_dqn_update(optimizer: torch.optim.Optimizer, gamma: float):
    """``update(params, target_params, obs, actions, rewards, next_obs,
    dones) -> stats``: one Adam step of the online net in place."""

    def update(params, target_params, obs, actions, rewards, next_obs,
               dones):
        q = q_apply(params, obs)
        q_taken = torch.gather(q, -1, actions.long()[:, None])[:, 0]
        # double-Q: the ONLINE net picks the next action, the TARGET net
        # scores it (dqn_tf_policy.py:237 double_q branch); no gradient
        # flows through the target
        with torch.no_grad():
            next_a = torch.argmax(q_apply(params, next_obs), dim=-1)
            next_val = torch.gather(
                q_apply(target_params, next_obs), -1, next_a[:, None])[:, 0]
            td_target = rewards + gamma * (1.0 - dones) * next_val
        td_error = q_taken - td_target
        loss = huber_loss(q_taken, td_target).mean()
        apply_update(optimizer, loss)
        return {
            "mean_q": q_taken.mean().detach(),
            "mean_td_error": torch.abs(td_error).mean().detach(),
            "loss": loss.detach(),
        }

    return update


class DQNRolloutWorker(OffPolicyCollector):
    """Epsilon-greedy transition collector (the exploration half of the
    reference's EpsilonGreedy rllib/utils/exploration/epsilon_greedy.py:26,
    with the worker loop of rollout_worker.py:124). Emits raw
    (obs, action, reward, next_obs, done) transitions — DQN's replay
    consumes transitions, not GAE fragments."""

    def __init__(self, env_spec, env_config: Optional[dict], hidden,
                 seed: int):
        self._setup_env(env_spec, env_config, seed)
        self.params = q_init(
            make_generator(0), self.env.observation_dim,
            self.env.num_actions, hidden)
        self._epsilon = 1.0

    def set_weights(self, weights) -> None:
        self.params = params_from_numpy(weights)

    def sample(self, num_steps: int, epsilon: float) -> Dict[str, np.ndarray]:
        self._epsilon = epsilon
        return self._collect(num_steps)

    def _action_buffer(self, num_steps: int) -> np.ndarray:
        return np.zeros(num_steps, np.int32)

    def _select_action(self) -> int:
        if self.rng.random() < self._epsilon:
            return int(self.rng.integers(self.env.num_actions))
        with torch.no_grad():
            q = q_apply(self.params, torch.from_numpy(
                np.asarray(self._obs, np.float32)[None, :]))
        return int(torch.argmax(q[0]))


class DQN(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        # Algorithm.setup builds actor-critic params + PG-shaped rollout
        # workers; DQN needs a Q-net and epsilon-greedy transition
        # collectors, so it wires its own (same env/seed plumbing).
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        if config.get("connectors"):
            raise ValueError(
                "connectors are not supported by this algorithm's "
                "custom rollout collectors yet; use PPO/IMPALA or "
                "drop the connectors config")
        seed = config.get("seed", 0)
        self.np_rng = np.random.default_rng(seed)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        self.obs_dim = probe_env.observation_dim
        self.num_actions = probe_env.num_actions
        hidden = config.get("hidden", (64, 64))
        self.params = self._to_learner(q_init(
            make_generator(seed), self.obs_dim, self.num_actions, hidden))
        self.target_params = tree_map(lambda t: t.detach().clone(),
                                      self.params)
        self.gamma = config.get("gamma", 0.99)
        self.optimizer = make_adam(self.params, config.get("lr", 1e-3))
        self._update = make_dqn_update(self.optimizer, self.gamma)
        self.replay = ReplayBuffer(
            config.get("replay_buffer_capacity", 50_000), seed=seed)
        self.learning_starts = config.get("learning_starts", 1_000)
        self.train_batch_size = config.get("train_batch_size", 64)
        self.target_update_freq = config.get(
            "target_network_update_freq", 500)
        self.updates_per_step = config.get("updates_per_step", 32)
        self.eps_initial = config.get("epsilon_initial", 1.0)
        self.eps_final = config.get("epsilon_final", 0.02)
        self.eps_timesteps = config.get("epsilon_timesteps", 10_000)
        self._updates_done = 0
        self._timesteps_total = 0

        n_workers = config.get("num_rollout_workers", 0)
        self.workers = None
        self.local_worker = None
        if n_workers > 0:
            self.workers = WorkerSet(
                config["env_spec"], config.get("env_config"), hidden,
                n_workers, seed, worker_cls=DQNRolloutWorker,
                worker_args=())
        else:
            self.local_worker = DQNRolloutWorker(
                config["env_spec"], config.get("env_config"), hidden, seed)

    # -- exploration schedule --------------------------------------------------
    def _epsilon(self) -> float:
        frac = min(1.0, self._timesteps_total / max(1, self.eps_timesteps))
        return self.eps_initial + frac * (self.eps_final - self.eps_initial)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        fragment = self.cfg.get("rollout_fragment_length", 64)
        eps = self._epsilon()
        self._sync_weights()
        if self.workers is not None:
            batches = api.get(self.workers.sample(fragment, eps))
        else:
            batches = [self.local_worker.sample(fragment, eps)]
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
        learn_time = time.time() - t1

        out = stats_to_floats(stats)
        out.update({
            "num_env_steps_sampled": n,
            "replay_size": len(self.replay),
            "epsilon": eps,
            "num_updates": self._updates_done,
            "sample_time_s": sample_time,
            "learn_time_s": learn_time,
        })
        return out

    def learn_on_minibatch(self, mb: Dict[str, np.ndarray]
                           ) -> Dict[str, Any]:
        """One TD update on the learner's device, then the target sync
        every ``target_network_update_freq`` updates."""
        cols = [torch.as_tensor(mb[k], device=self.device)
                for k in (sb.OBS, sb.ACTIONS, sb.REWARDS, NEXT_OBS,
                          sb.DONES)]
        stats = self._update(self.params, self.target_params, *cols)
        self._updates_done += 1
        if self._updates_done % self.target_update_freq == 0:
            copy_into(self.target_params, self.params)
        return stats

    def compute_single_action(self, obs: np.ndarray) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None, :]
        with torch.no_grad():
            return int(torch.argmax(q_apply(self.params, x)[0]))

    def _save_extra_state(self):
        return {
            "opt_state": adam_state_to_cpu(self.optimizer),
            "target_params": params_to_numpy(self.target_params),
            "updates_done": self._updates_done,
        }

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "opt_state" in state:
            load_adam_state(self.optimizer, state["opt_state"])
        if "target_params" in state:
            copy_into(self.target_params, state["target_params"])
        self._updates_done = state.get("updates_done", 0)


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(DQN)
        self.extra.update({
            "replay_buffer_capacity": 50_000, "learning_starts": 1_000,
            "target_network_update_freq": 500, "updates_per_step": 32,
            "epsilon_initial": 1.0, "epsilon_final": 0.02,
            "epsilon_timesteps": 10_000,
        })

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 target_network_update_freq=None, updates_per_step=None,
                 epsilon_initial=None, epsilon_final=None,
                 epsilon_timesteps=None, **kwargs) -> "DQNConfig":
        super().training(**kwargs)
        for k, v in (
                ("replay_buffer_capacity", replay_buffer_capacity),
                ("learning_starts", learning_starts),
                ("target_network_update_freq", target_network_update_freq),
                ("updates_per_step", updates_per_step),
                ("epsilon_initial", epsilon_initial),
                ("epsilon_final", epsilon_final),
                ("epsilon_timesteps", epsilon_timesteps)):
            if v is not None:
                self.extra[k] = v
        return self
