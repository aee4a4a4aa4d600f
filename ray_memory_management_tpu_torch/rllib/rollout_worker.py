"""Rollout workers: CPU actors stepping envs with the current policy.

The reference's RolloutWorker (rllib/evaluation/rollout_worker.py:124) +
WorkerSet (worker_set.py:50): the algorithm broadcasts weights, workers
sample fixed-length fragments and return batches through the object
store. A worker keeps its own CPU copy of the policy, in local mode too:
cards belong to the learner (the reference's sampler/learner split), and
weights reach a worker as numpy, never as device tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import api
from . import sample_batch as sb
from .env import make_env
from .models import (
    ac_init, make_generator, params_from_numpy, params_to_numpy,
    sample_actions,
)


def pin_rollout_threads() -> None:
    """A dedicated worker process holds one CPU (``num_cpus=1``): one
    intra-op thread, so several workers do not oversubscribe the host.
    In local mode the learner's process keeps its own setting."""
    from .. import _worker_context

    if _worker_context.in_worker():
        torch.set_num_threads(1)


class RolloutWorker:
    def __init__(self, env_spec, env_config: Optional[dict],
                 hidden, seed: int, gamma: float = 0.99,
                 lam: float = 0.95, connectors=None):
        from .connectors import build_pipeline

        pin_rollout_threads()
        self.env = make_env(env_spec, env_config)
        self.gamma = gamma
        self.lam = lam
        # env -> policy transform pipeline (rllib/connectors/ analog);
        # the model is sized for the TRANSFORMED observation
        self.connectors = build_pipeline(connectors)
        self.obs_dim = self.connectors.obs_dim(self.env.observation_dim)
        self.rng = np.random.default_rng(seed)
        self._gen = make_generator(seed)
        self.params = ac_init(
            make_generator(0), self.obs_dim, self.env.num_actions, hidden)
        self._obs = self.connectors.on_reset(self.env.reset(seed=seed))
        self._episode_reward = 0.0
        self._episode_len = 0
        self.episode_rewards: List[float] = []
        self.episode_lengths: List[int] = []

    def ready(self) -> str:
        return "ok"

    def set_weights(self, weights) -> None:
        self.params = params_from_numpy(weights)

    def get_weights(self):
        return params_to_numpy(self.params)

    def _act(self, obs):
        action, logp, value = sample_actions(
            self.params, obs[None, :], self._gen)
        return int(action[0]), float(logp[0]), float(value[0])

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect one fragment of ``num_steps`` transitions (the
        rollout_fragment_length contract; sampler.py SyncSampler)."""
        obs_buf = np.zeros((num_steps, self.obs_dim), dtype=np.float32)
        act_buf = np.zeros(num_steps, dtype=np.int32)
        rew_buf = np.zeros(num_steps, dtype=np.float32)
        done_buf = np.zeros(num_steps, dtype=np.float32)
        logp_buf = np.zeros(num_steps, dtype=np.float32)
        val_buf = np.zeros(num_steps, dtype=np.float32)

        for t in range(num_steps):
            a, logp_buf[t], val_buf[t] = self._act(self._obs)
            obs_buf[t] = self._obs
            act_buf[t] = a
            next_obs, reward, terminated, truncated, _ = self.env.step(a)
            next_obs = self.connectors.observe(next_obs)
            rew_buf[t] = self.connectors.reward(reward)
            done_buf[t] = float(terminated)
            self._episode_reward += reward  # metrics report RAW reward
            self._episode_len += 1
            if truncated and not terminated:
                # time-limit truncation is not a true terminal: fold the
                # bootstrap V(s_next) into the reward BEFORE the reset
                # replaces next_obs, then cut the trace (done=1) so GAE /
                # V-trace never discount across the episode boundary
                rew_buf[t] += self.gamma * self._act(next_obs)[2]
                done_buf[t] = 1.0
            if terminated or truncated:
                self.episode_rewards.append(self._episode_reward)
                self.episode_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                next_obs = self.connectors.on_reset(self.env.reset(
                    seed=int(self.rng.integers(1 << 31))))
            self._obs = next_obs

        # bootstrap value for a fragment ending mid-episode
        bootstrap = self._act(self._obs)[2]
        adv, targets = sb.compute_gae(
            rew_buf, val_buf, done_buf, bootstrap,
            gamma=self.gamma, lam=self.lam)
        return {
            sb.OBS: obs_buf, sb.ACTIONS: act_buf, sb.REWARDS: rew_buf,
            sb.DONES: done_buf, sb.LOGP: logp_buf, sb.VALUES: val_buf,
            sb.ADVANTAGES: adv, sb.TARGETS: targets,
            sb.BOOTSTRAP: np.array([bootstrap], dtype=np.float32),
        }

    def get_connector_state(self):
        return self.connectors.state()

    def set_connector_state(self, state) -> None:
        self.connectors.set_state(state)

    def episode_stats(self, window: int = 100) -> Dict[str, Any]:
        return sb.episode_stats_summary(
            self.episode_rewards, self.episode_lengths, window)


class WorkerSet:
    """Remote rollout workers + broadcast/gather helpers
    (worker_set.py:50)."""

    def __init__(self, env_spec, env_config, hidden, num_workers: int,
                 seed: int, gamma: float = 0.99, lam: float = 0.95,
                 connectors=None, worker_cls=None, worker_kwargs=None,
                 worker_args=None):
        # worker_cls swaps the collector while keeping the broadcast/
        # stats plumbing (multi_agent.MultiAgentRolloutWorker,
        # recurrent.RecurrentRolloutWorker and dqn.DQNRolloutWorker plug
        # in here); worker_kwargs carries collector-specific extras
        # (e.g. lstm dims); worker_args replaces the on-policy
        # positional arguments after the seed
        cls = api.remote(worker_cls or RolloutWorker)
        rest = (gamma, lam, connectors) if worker_args is None \
            else tuple(worker_args)
        self.remote_workers = [
            cls.options(num_cpus=1).remote(
                env_spec, env_config, hidden, seed + 1000 * (i + 1),
                *rest, **(worker_kwargs or {}))
            for i in range(num_workers)
        ]
        api.get([w.ready.remote() for w in self.remote_workers])

    def set_weights(self, weights) -> None:
        # one put, many readers: the broadcast rides the object store
        ref = api.put(weights)
        api.get([w.set_weights.remote(ref) for w in self.remote_workers])

    def sample(self, num_steps: int, *args) -> List:
        return [w.sample.remote(num_steps, *args)
                for w in self.remote_workers]

    def set_connector_state(self, state) -> None:
        api.get([w.set_connector_state.remote(state)
                 for w in self.remote_workers])

    def stats(self) -> List[Dict[str, Any]]:
        return api.get(
            [w.episode_stats.remote() for w in self.remote_workers])

    def stop(self) -> None:
        for w in self.remote_workers:
            api.kill(w)
