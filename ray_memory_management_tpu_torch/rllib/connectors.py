"""Connectors: composable observation/reward transforms between env and
policy.

The reference's connector framework (rllib/connectors/ — agent-side
pipelines transform observations before the policy sees them, with
get_state/set_state so the transforms travel with checkpoints and
worker weight broadcasts). TPU-first shape: connectors are small numpy
state machines living in the CPU rollout workers; the policy network
only ever sees transformed observations, so the jit'd learner programs
stay shape-static (a FrameStack widens the observation dimension once,
at build time).

Pipelines are constructed from declarative SPECS — ``[("obs_norm", {}),
("frame_stack", {"k": 4})]`` — because the pipeline must be rebuilt
inside remote rollout actors (specs pickle; live numpy state does not
need to).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Spec = Tuple[str, Dict[str, Any]]


class Connector:
    """One transform stage. Subclasses override what they need."""

    def obs_dim(self, dim: int) -> int:
        """Output observation width given the input width."""
        return dim

    def on_reset(self, obs: np.ndarray) -> np.ndarray:
        return self.observe(obs)

    def observe(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        """Transform one observation. ``update=False`` applies the
        transform WITHOUT learning from it (inference/eval: the policy
        must see the same normalization it trained with, but eval
        observations must not perturb the statistics)."""
        return obs

    def reward(self, r: float) -> float:
        return r

    def state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ObsNormalizer(Connector):
    """Running mean/std observation normalization (Welford), the
    reference's MeanStdFilter connector. Stats update during sampling
    and ride state()/set_state() through checkpoints."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def observe(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self._mean is None:
            self._mean = np.zeros_like(obs)
            self._m2 = np.zeros_like(obs)
        if update:
            self._count += 1.0
            delta = obs - self._mean
            self._mean = self._mean + delta / self._count
            self._m2 = self._m2 + delta * (obs - self._mean)
        var = self._m2 / max(self._count - 1.0, 1.0)
        out = (obs - self._mean) / np.sqrt(var + self.eps)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def state(self) -> Dict[str, Any]:
        return {"count": self._count, "mean": self._mean, "m2": self._m2}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class FrameStack(Connector):
    """Concatenate the last ``k`` observations (the classic partial-
    observability connector; reference frame-stacking trajectory view)."""

    def __init__(self, k: int = 4):
        self.k = int(k)
        self._frames: List[np.ndarray] = []

    def obs_dim(self, dim: int) -> int:
        return dim * self.k

    def on_reset(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        self._frames = [obs] * self.k
        return np.concatenate(self._frames)

    def observe(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        # the frame window always advances — it is episode state, not
        # learned statistics, so `update` does not gate it
        obs = np.asarray(obs, np.float32)
        if not self._frames:
            return self.on_reset(obs)
        self._frames = self._frames[1:] + [obs]
        return np.concatenate(self._frames)

    def state(self) -> Dict[str, Any]:
        return {"frames": list(self._frames)}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._frames = list(state["frames"])


class ClipReward(Connector):
    """Clip rewards into [-limit, limit] (the reference's clip_rewards
    agent connector)."""

    def __init__(self, limit: float = 1.0):
        self.limit = float(limit)

    def reward(self, r: float) -> float:
        return float(np.clip(r, -self.limit, self.limit))


_REGISTRY = {
    "obs_norm": ObsNormalizer,
    "frame_stack": FrameStack,
    "clip_reward": ClipReward,
}


def register_connector(name: str, cls) -> None:
    _REGISTRY[name] = cls


class ConnectorPipeline:
    """Ordered connector stages applied env -> policy."""

    def __init__(self, specs: Sequence[Spec]):
        self.specs = list(specs or ())
        self.stages: List[Connector] = []
        for name, kwargs in self.specs:
            if isinstance(name, type) and issubclass(name, Connector):
                # class-valued spec: custom connectors pickle BY VALUE
                # into remote rollout actors (a name registered only in
                # the driver's _REGISTRY would be unknown there)
                self.stages.append(name(**(kwargs or {})))
                continue
            if name not in _REGISTRY:
                raise ValueError(
                    f"unknown connector {name!r}; register it with "
                    "register_connector, or pass the Connector CLASS "
                    "itself in the spec (required for remote workers)")
            self.stages.append(_REGISTRY[name](**(kwargs or {})))

    def obs_dim(self, dim: int) -> int:
        for s in self.stages:
            dim = s.obs_dim(dim)
        return dim

    def on_reset(self, obs: np.ndarray) -> np.ndarray:
        for s in self.stages:
            obs = s.on_reset(obs)
        return obs

    def observe(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        for s in self.stages:
            obs = s.observe(obs, update)
        return obs

    def reward(self, r: float) -> float:
        for s in self.stages:
            r = s.reward(r)
        return r

    def state(self) -> List[Dict[str, Any]]:
        return [s.state() for s in self.stages]

    def set_state(self, states: Sequence[Dict[str, Any]]) -> None:
        for s, st in zip(self.stages, states):
            s.set_state(st)


def build_pipeline(specs: Optional[Sequence[Spec]]) -> ConnectorPipeline:
    return ConnectorPipeline(specs or ())
