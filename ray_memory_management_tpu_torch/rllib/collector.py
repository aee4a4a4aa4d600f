"""Shared transition-collector loop for the off-policy algorithms.

DQN/SAC/TD3 rollout workers all collect raw (obs, action, reward,
next_obs, done) transitions with the same loop (the worker half of the
reference's rollout_worker.py:124 plus the truncation-vs-termination
bootstrap rule of postprocessing.py); only action selection and the
action-buffer spec differ. This base owns the loop so the bootstrap and
reseed-on-reset semantics exist in exactly one place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from . import sample_batch as sb
from .env import make_env

NEXT_OBS = "next_obs"


class OffPolicyCollector:
    """Base transition collector. Subclasses implement ``_select_action``
    (reading whatever exploration state they stashed on ``self``) and
    ``_action_buffer``; the base runs the env loop, applies the
    truncation-is-not-terminal bootstrap rule, and keeps episode stats."""

    def _setup_env(self, env_spec, env_config: Optional[dict],
                   seed: int) -> None:
        from .rollout_worker import pin_rollout_threads

        pin_rollout_threads()
        self.env = make_env(env_spec, env_config)
        from .multi_agent import MultiAgentEnv

        if isinstance(self.env, MultiAgentEnv):
            raise ValueError(
                "multi-agent envs train through the on-policy algorithms "
                "(PPO/PG/IMPALA/APPO) with the shared-policy collector; "
                "the replay-buffer algorithms need single-agent envs")
        self.rng = np.random.default_rng(seed)
        self._obs = self.env.reset(seed=seed)
        self._episode_reward = 0.0
        self._episode_len = 0
        self.episode_rewards: List[float] = []
        self.episode_lengths: List[int] = []
        self._steps_done = 0

    def ready(self) -> str:
        return "ok"

    def _action_buffer(self, num_steps: int) -> np.ndarray:
        raise NotImplementedError

    def _select_action(self):
        raise NotImplementedError

    def _collect(self, num_steps: int) -> Dict[str, np.ndarray]:
        D = self.env.observation_dim
        obs_buf = np.zeros((num_steps, D), np.float32)
        next_buf = np.zeros((num_steps, D), np.float32)
        act_buf = self._action_buffer(num_steps)
        rew_buf = np.zeros(num_steps, np.float32)
        done_buf = np.zeros(num_steps, np.float32)
        for t in range(num_steps):
            a = self._select_action()
            next_obs, reward, terminated, truncated, _ = self.env.step(a)
            obs_buf[t] = self._obs
            act_buf[t] = a
            rew_buf[t] = reward
            # a time-limit truncation is NOT a terminal: the TD target
            # must still bootstrap from next_obs (postprocessing.py
            # treats truncations the same way)
            done_buf[t] = float(terminated)
            next_buf[t] = next_obs
            self._episode_reward += reward
            self._episode_len += 1
            self._steps_done += 1
            if terminated or truncated:
                self.episode_rewards.append(self._episode_reward)
                self.episode_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                next_obs = self.env.reset(
                    seed=int(self.rng.integers(1 << 31)))
            self._obs = next_obs
        return {
            sb.OBS: obs_buf, sb.ACTIONS: act_buf, sb.REWARDS: rew_buf,
            NEXT_OBS: next_buf, sb.DONES: done_buf,
        }

    def episode_stats(self, window: int = 100) -> Dict[str, Any]:
        return sb.episode_stats_summary(
            self.episode_rewards, self.episode_lengths, window)
