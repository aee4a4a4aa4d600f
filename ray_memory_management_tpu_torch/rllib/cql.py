"""CQL: conservative Q-learning from a recorded dataset.

The reference's CQL (rllib/algorithms/cql/cql.py — offline input wiring
over a Q-learner; cql_tf_policy.py:137 the conservative penalty
min_Q alpha·E[logsumexp_a Q(s,a) − Q(s,a_data)] of Kumar et al. 2020,
there on top of SAC for continuous control). This is the DISCRETE form on
top of the double-Q TD learner (dqn.py): exact logsumexp over the action
set instead of sampled actions. The penalty pushes down Q on actions the
dataset never took, which is what stops offline Q-learning from chasing
its own out-of-distribution overestimates — plain DQN on a fixed buffer
diverges exactly there.

The whole update — online/target forwards, double-Q TD loss, the
conservative penalty, Adam — runs on the learner's device, fed
contiguous minibatches from the host-side dataset; there is no
environment interaction during training.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from . import sample_batch as sb
from .algorithm import AlgorithmConfig
from .collector import NEXT_OBS
from ..utils.device import resolve_device
from .dqn import huber_loss, q_apply, q_init
from .env import make_env
from .models import (
    adam_state_to_cpu, apply_update, copy_into, detached_copy,
    load_adam_state, make_adam, make_generator, params_to_numpy, trainable,
)
from .ppo import stats_to_floats
from .offline import TERMINATED, DatasetReader, OfflineAlgorithm


def derive_next_obs(data: Dict[str, np.ndarray],
                    recording_starts: np.ndarray = None,
                    ) -> Dict[str, np.ndarray]:
    """Back-fill a missing next_obs column from time-ordered recordings:
    next_obs[t] = obs[t+1] within an episode. The last row of EACH
    recording (DatasetReader.recording_starts — appended recordings are
    independent streams) has no successor: it is kept only if terminal
    (done masks the bootstrap); a non-terminal recording tail is dropped,
    since rolling across the boundary would hand it the NEXT recording's
    reset observation as a live TD successor."""
    if NEXT_OBS in data:
        return data
    T = len(data[sb.DONES])
    nxt = np.roll(data[sb.OBS], -1, axis=0)
    keep = np.ones(T, bool)
    if recording_starts is None or len(recording_starts) == 0:
        recording_starts = np.asarray([0])
    last_rows = list(recording_starts[1:] - 1) + [T - 1]
    for t in last_rows:
        if T and not data[sb.DONES][t]:
            keep[t] = False  # truncated tail: no successor, no terminal
    out = {k: v[keep] for k, v in data.items()}
    out[NEXT_OBS] = nxt[keep]
    return out


def make_cql_update(optimizer, gamma: float, cql_alpha: float):
    """``update(params, target_params, obs, actions, rewards, nxt, dones)
    -> stats``: one Adam step of the online net in place."""

    def update(params, target_params, obs, actions, rewards, nxt, dones):
        q = q_apply(params, obs)
        q_taken = torch.gather(q, -1, actions.long()[:, None])[:, 0]
        # double-Q target: online net picks, target net evaluates
        with torch.no_grad():
            next_a = torch.argmax(q_apply(params, nxt), dim=-1)
            next_q = torch.gather(q_apply(target_params, nxt), -1,
                                  next_a[:, None])[:, 0]
            target = rewards + gamma * (1.0 - dones) * next_q
        td_loss = huber_loss(q_taken, target).mean()
        # the conservative term: logsumexp over ALL actions minus the
        # dataset action's Q — exact for a discrete action set
        penalty = torch.mean(torch.logsumexp(q, dim=-1) - q_taken)
        total = td_loss + cql_alpha * penalty
        apply_update(optimizer, total)
        return {"td_loss": td_loss.detach(), "cql_penalty": penalty.detach(),
                "mean_q": q_taken.detach().mean(),
                "total_loss": total.detach()}

    return update


class CQL(OfflineAlgorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.reader = DatasetReader(config["input_path"], seed=seed)
        self.reader.data = derive_next_obs(self.reader.data,
                                           self.reader.recording_starts)
        self.reader.num_samples = sb.batch_size(self.reader.data)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        self.eval_env = probe_env
        hidden = config.get("hidden", (64, 64))
        self.params = trainable(q_init(
            make_generator(seed), probe_env.observation_dim,
            probe_env.num_actions, hidden), self.device)
        self.target_params = detached_copy(self.params)
        self.optimizer = make_adam(self.params, config.get("lr", 1e-3))
        self._update = make_cql_update(
            self.optimizer, config.get("gamma", 0.99),
            config.get("cql_alpha", 1.0))
        self.train_batch_size = config.get("train_batch_size", 256)
        self.updates_per_step = config.get("updates_per_step", 64)
        self.target_update_freq = config.get("target_update_freq", 100)
        self.eval_episodes = config.get("eval_episodes", 2)
        self._rng = np.random.default_rng(seed)
        self._updates_done = 0
        self._timesteps_total = 0
        self.workers = None
        self.local_worker = None

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        stats: Dict[str, Any] = {}
        d = self.reader.data
        n = self.reader.num_samples
        # bootstrap mask: TRUE terminals only — a time-limit truncation
        # still bootstraps from its recorded next_obs (offline.py's
        # TERMINATED column; legacy recordings only have the conflated
        # DONES, which over-masks at truncations — the old bias)
        term_col = TERMINATED if TERMINATED in d else sb.DONES
        dev = self.device
        for _ in range(self.updates_per_step):
            idx = self._rng.integers(0, n, size=self.train_batch_size)
            stats = self._update(
                self.params, self.target_params,
                torch.as_tensor(d[sb.OBS][idx], device=dev),
                torch.as_tensor(d[sb.ACTIONS][idx].astype(np.int64),
                                device=dev),
                torch.as_tensor(d[sb.REWARDS][idx], device=dev),
                torch.as_tensor(d[NEXT_OBS][idx], device=dev),
                torch.as_tensor(d[term_col][idx], device=dev))
            self._updates_done += 1
            if self._updates_done % self.target_update_freq == 0:
                copy_into(self.target_params, self.params)
        out = stats_to_floats(stats)
        out.update({
            "num_updates": self._updates_done,
            "dataset_size": n,
            "learn_time_s": time.time() - t0,
        })
        out.update(self._evaluate())
        return out

    def compute_single_action(self, obs: np.ndarray) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None, :]
        with torch.no_grad():
            return int(torch.argmax(q_apply(self.params, x)[0]))

    def _save_extra_state(self):
        return {"target_params": params_to_numpy(self.target_params),
                "opt_state": adam_state_to_cpu(self.optimizer),
                "updates_done": self._updates_done}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "target_params" in state:
            copy_into(self.target_params, state["target_params"])
        if "opt_state" in state:
            load_adam_state(self.optimizer, state["opt_state"])
        self._updates_done = state.get("updates_done", 0)


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(CQL)
        self.extra.update({"cql_alpha": 1.0, "updates_per_step": 64,
                           "target_update_freq": 100, "eval_episodes": 2})

    def offline_data(self, *, input_path: str) -> "CQLConfig":
        self.extra["input_path"] = input_path
        return self

    def training(self, *, cql_alpha=None, updates_per_step=None,
                 target_update_freq=None, eval_episodes=None,
                 **kwargs) -> "CQLConfig":
        super().training(**kwargs)
        for k, v in (("cql_alpha", cql_alpha),
                     ("updates_per_step", updates_per_step),
                     ("target_update_freq", target_update_freq),
                     ("eval_episodes", eval_episodes)):
            if v is not None:
                self.extra[k] = v
        return self
