"""Multi-agent environments with shared-policy training.

The reference's MultiAgentEnv (rllib/env/multi_agent_env.py:23 — dict
obs/rewards/dones keyed by agent id, "__all__" signalling episode end;
rllib/evaluation/episode.py tracks per-agent trajectories; the common
"parameter sharing" configuration maps every agent to one policy). This
module implements that contract for the shared-policy case, which every
on-policy algorithm here (PPO/PG/IMPALA/APPO) trains without learner
changes:

- per env step, ALL live agents' observations stack into ONE policy
  forward (a single `sample_actions` batch);
- each agent accumulates its own trajectory segment; when the agent
  terminates (or the fragment ends mid-episode) the segment closes with
  the truncation rule the single-agent worker uses — fold
  gamma * V(s_next) into the last reward and cut the trace (done=1) —
  so concatenated segments remain a valid flat fragment: GAE's reverse
  scan resets at each segment boundary and the fragment-level bootstrap
  is exactly 0.0 (V-trace consumers see the same contract).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from . import sample_batch as sb
from .env import CartPole, register_env
from .models import (
    ac_init, make_generator, params_from_numpy, params_to_numpy,
    sample_actions,
)

ALL_DONE = "__all__"


class MultiAgentEnv:
    """Contract: agents share observation_dim / num_actions (the shared-
    policy case); ids may drop out as agents terminate mid-episode."""

    agent_ids: List[str] = []
    observation_dim: int = 0
    num_actions: int = 0

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        """-> (obs, rewards, terminateds, truncateds, info), each a dict
        keyed by agent id; terminateds/truncateds also carry "__all__"."""
        raise NotImplementedError


class MultiCartPole(MultiAgentEnv):
    """N independent CartPole instances under one episode clock — the
    reference's multi-agent cartpole example (examples/env/
    multi_agent.py:17). An agent whose pole falls drops out; the episode
    ends when every agent is done or the time limit hits."""

    def __init__(self, n_agents: int = 2, max_episode_steps: int = 200):
        self.agent_ids = [f"agent_{i}" for i in range(n_agents)]
        self._envs = {aid: CartPole(max_episode_steps=max_episode_steps)
                      for aid in self.agent_ids}
        self.observation_dim = 4
        self.num_actions = 2
        self.max_episode_steps = max_episode_steps
        self._live: List[str] = []
        self._t = 0

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        self._live = list(self.agent_ids)
        self._t = 0
        return {aid: env.reset(
            seed=None if seed is None else seed + i)
            for i, (aid, env) in enumerate(self._envs.items())}

    def step(self, actions: Dict[str, Any]):
        obs, rewards, terms, truncs = {}, {}, {}, {}
        self._t += 1
        for aid in list(self._live):
            o, r, term, trunc, _ = self._envs[aid].step(actions[aid])
            obs[aid], rewards[aid] = o, r
            terms[aid], truncs[aid] = term, trunc
            if term or trunc:
                self._live.remove(aid)
        terms[ALL_DONE] = not self._live
        truncs[ALL_DONE] = self._t >= self.max_episode_steps
        return obs, rewards, terms, truncs, {}


register_env("MultiCartPole", MultiCartPole)


class _Segment:
    """One agent's in-progress trajectory within one episode."""

    __slots__ = ("obs", "act", "rew", "logp", "val")

    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.act: List[int] = []
        self.rew: List[float] = []
        self.logp: List[float] = []
        self.val: List[float] = []


class MultiAgentRolloutWorker:
    """Drop-in for RolloutWorker over a MultiAgentEnv: same interface,
    same flat-fragment output; ``num_steps`` counts AGENT transitions so
    train_batch_size keeps its meaning."""

    def __init__(self, env_spec, env_config: Optional[dict],
                 hidden, seed: int, gamma: float = 0.99,
                 lam: float = 0.95, connectors=None):
        from .env import make_env
        from .rollout_worker import pin_rollout_threads

        if connectors:
            raise ValueError(
                "connectors are not supported with multi-agent envs yet")
        pin_rollout_threads()
        self.env = make_env(env_spec, env_config)
        if not isinstance(self.env, MultiAgentEnv):
            raise TypeError("MultiAgentRolloutWorker needs a MultiAgentEnv")
        self.gamma = gamma
        self.lam = lam
        self.obs_dim = self.env.observation_dim
        self.rng = np.random.default_rng(seed)
        self._gen = make_generator(seed)
        self.params = ac_init(
            make_generator(0), self.obs_dim, self.env.num_actions, hidden)
        self._obs = self.env.reset(seed=seed)
        self._segments: Dict[str, _Segment] = {
            aid: _Segment() for aid in self._obs}
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

    def _values_of(self, obs_batch: List[np.ndarray]) -> np.ndarray:
        """One stacked value forward for a batch of bootstrap
        observations — closing agents at an episode/fragment boundary
        share a single dispatch, like the action forward."""
        _, _, v = sample_actions(self.params, np.stack(obs_batch),
                                 self._gen)
        return v.numpy()

    def _close_segment(self, seg: _Segment, bootstrap: float,
                       out: list) -> None:
        """Finalize one agent-trajectory: non-terminal ends fold the
        bootstrap into the last reward (the single-agent worker's
        truncation rule), so every emitted segment ends done=1."""
        if not seg.act:
            return
        seg.rew[-1] += self.gamma * bootstrap
        n = len(seg.act)
        done = np.zeros(n, np.float32)
        done[-1] = 1.0
        out.append({
            sb.OBS: np.asarray(seg.obs, np.float32),
            sb.ACTIONS: np.asarray(seg.act, np.int32),
            sb.REWARDS: np.asarray(seg.rew, np.float32),
            sb.DONES: done,
            sb.LOGP: np.asarray(seg.logp, np.float32),
            sb.VALUES: np.asarray(seg.val, np.float32),
        })

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        closed: list = []
        collected = 0
        while collected < num_steps:
            live = [aid for aid in self._obs if aid in self._segments]
            stacked = np.stack([self._obs[aid] for aid in live])
            acts, logps, vals = (t.tolist() for t in sample_actions(
                self.params, stacked, self._gen))
            actions = {aid: int(acts[i]) for i, aid in enumerate(live)}
            for i, aid in enumerate(live):
                seg = self._segments[aid]
                seg.obs.append(self._obs[aid])
                seg.act.append(int(acts[i]))
                seg.logp.append(float(logps[i]))
                seg.val.append(float(vals[i]))
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            for aid in live:
                self._segments[aid].rew.append(float(rewards[aid]))
                self._episode_reward += float(rewards[aid])
            collected += len(live)
            self._episode_len += 1

            episode_over = terms.get(ALL_DONE) or truncs.get(ALL_DONE)
            closing = [aid for aid in live
                       if terms.get(aid) or truncs.get(aid)
                       or episode_over]
            # one stacked forward covers every non-terminal closer
            need_v = [aid for aid in closing
                      if not terms.get(aid)
                      and next_obs.get(aid) is not None]
            values = {}
            if need_v:
                vs = self._values_of([next_obs[aid] for aid in need_v])
                values = dict(zip(need_v, (float(x) for x in vs)))
            for aid in closing:
                self._close_segment(self._segments.pop(aid),
                                    values.get(aid, 0.0), closed)
            self._obs = {aid: o for aid, o in next_obs.items()
                         if aid in self._segments}
            if episode_over or not self._segments:
                self.episode_rewards.append(self._episode_reward)
                self.episode_lengths.append(self._episode_len)
                self._episode_reward = 0.0
                self._episode_len = 0
                self._obs = self.env.reset(
                    seed=int(self.rng.integers(1 << 31)))
                self._segments = {aid: _Segment() for aid in self._obs}

        # fragment boundary: close live segments with their bootstraps
        open_aids = [aid for aid in self._segments
                     if self._segments[aid].act
                     and self._obs.get(aid) is not None]
        values = {}
        if open_aids:
            vs = self._values_of([self._obs[aid] for aid in open_aids])
            values = dict(zip(open_aids, (float(x) for x in vs)))
        for aid in list(self._segments):
            seg = self._segments[aid]
            if seg.act:
                self._close_segment(seg, values.get(aid, 0.0), closed)
                self._segments[aid] = _Segment()

        batch = sb.concat_batches(closed)
        adv, targets = sb.compute_gae(
            batch[sb.REWARDS], batch[sb.VALUES], batch[sb.DONES],
            last_value=0.0, gamma=self.gamma, lam=self.lam)
        batch[sb.ADVANTAGES] = adv
        batch[sb.TARGETS] = targets
        # every segment ends done=1, so the flat-fragment bootstrap is 0
        batch[sb.BOOTSTRAP] = np.array([0.0], np.float32)
        return batch

    def get_connector_state(self):
        return None

    def set_connector_state(self, state) -> None:
        pass

    def episode_stats(self, window: int = 100) -> Dict[str, Any]:
        return sb.episode_stats_summary(
            self.episode_rewards, self.episode_lengths, window)
