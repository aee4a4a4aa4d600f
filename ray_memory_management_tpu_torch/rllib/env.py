"""Environment API + built-in envs.

The reference wraps gym environments (rllib/env/); this image has no gym,
so the classic-control envs used by the reference's smoke tests are
implemented in-repo with the same reset/step contract
(obs, reward, terminated, truncated, info). Envs are numpy-only — rollouts
run on CPU actors; the learner owns the accelerator (the reference's
CPU-sampler/GPU-learner split, e.g. impala.py's learner thread).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Env:
    """Minimal env contract (gymnasium-style step tuple)."""

    observation_dim: int
    num_actions: int
    max_episode_steps: int = 500

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int
             ) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        raise NotImplementedError


class CartPole(Env):
    """Classic cart-pole balancing (the dynamics of gym CartPole-v1:
    4-dim observation, 2 actions, reward 1 per step, fails past
    ±12° / ±2.4m, truncates at max_episode_steps)."""

    observation_dim = 4
    num_actions = 2

    GRAVITY = 9.8
    MASS_CART = 1.0
    MASS_POLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4

    def __init__(self, max_episode_steps: int = 500):
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng(0)
        self._state = np.zeros(4, dtype=np.float64)
        self._steps = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        total_mass = self.MASS_CART + self.MASS_POLE
        polemass_length = self.MASS_POLE * self.LENGTH
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASS_POLE * cos_t**2 / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * cos_t / total_mass
        x += self.TAU * x_dot
        x_dot += self.TAU * x_acc
        theta += self.TAU * theta_dot
        theta_dot += self.TAU * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.max_episode_steps
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})


class Pendulum(Env):
    """Classic inverted-pendulum swing-up (the dynamics of gym
    Pendulum-v1: obs [cos th, sin th, thdot], one torque action in
    [-2, 2], reward -(th^2 + 0.1 thdot^2 + 0.001 u^2), 200-step episodes,
    never terminates). The standard continuous-control smoke env — the
    reference's SAC regression runs on it
    (rllib/tuned_examples/sac/pendulum-sac.yaml)."""

    observation_dim = 3
    num_actions = 0          # continuous: no discrete action set
    action_dim = 1
    action_bound = 2.0
    max_episode_steps = 200

    G = 10.0
    MASS = 1.0
    LENGTH = 1.0
    DT = 0.05
    MAX_SPEED = 8.0

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng(0)
        self._th = 0.0
        self._thdot = 0.0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot],
                        np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._thdot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.action_bound, self.action_bound))
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        reward = -(norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2)
        thdot = thdot + (
            3 * self.G / (2 * self.LENGTH) * np.sin(th)
            + 3.0 / (self.MASS * self.LENGTH ** 2) * u) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + thdot * self.DT
        self._th, self._thdot = th, thdot
        self._steps += 1
        truncated = self._steps >= self.max_episode_steps
        return self._obs(), float(reward), False, truncated, {}


ENV_REGISTRY: Dict[str, Callable[..., Env]] = {
    "CartPole": CartPole,
    "Pendulum": Pendulum,
}


def register_env(name: str, creator: Callable[..., Env]) -> None:
    """User env registration (the reference's tune.register_env analog)."""
    ENV_REGISTRY[name] = creator


def make_env(spec, env_config: Optional[dict] = None) -> Env:
    env_config = env_config or {}
    if isinstance(spec, str):
        if spec not in ENV_REGISTRY:
            raise ValueError(
                f"unknown env {spec!r}; register it with register_env")
        return ENV_REGISTRY[spec](**env_config)
    if callable(spec):
        return spec(**env_config)
    raise TypeError(f"env spec must be a name or callable, got {type(spec)}")
