"""MARWIL: monotonic advantage re-weighted imitation learning.

The reference's MARWIL (rllib/algorithms/marwil/marwil.py — config and the
offline input wiring; marwil_tf_policy.py:38 the loss: a learned value
baseline, advantages = returns − V(s), and a BC cross-entropy term weighted
by exp(beta · advantage / c) with c a running scale so the exponent stays
O(1); beta = 0 degenerates to plain BC). Per Wang et al. 2018, the
re-weighting lets cloning from MIXED-quality data follow the good
trajectories and ignore the bad ones — the case where plain BC fails.

Like offline.py's BC: per-timestep discounted returns are precomputed
once on the host from the recorded episodes; the whole update (value
forward, advantage, running-scale update, weighted cross-entropy, Adam)
runs on the learner's device over contiguous minibatches, and the running
scale stays there as a scalar tensor.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from . import sample_batch as sb
from .algorithm import AlgorithmConfig
from .env import make_env
from ..utils.device import resolve_device
from .models import (
    adam_state_to_cpu, apply_update, load_adam_state, make_adam,
    make_generator, mlp_apply, mlp_init, trainable,
)
from .ppo import stats_to_floats
from .offline import DatasetReader, OfflineAlgorithm


def episode_returns(
        rewards: np.ndarray, dones: np.ndarray, gamma: float,
        recording_starts: np.ndarray = None,
) -> "tuple[np.ndarray, np.ndarray]":
    """Per-timestep discounted return-to-go within each recorded episode,
    with a validity mask. ``recording_starts`` marks where independent
    recordings begin (DatasetReader.recording_starts): the accumulator
    must reset there, and each recording's trailing run with no terminal
    is a TRUNCATED recording — its tail return is biased low — so those
    rows are flagged invalid (weight 0) rather than trained on. Without
    boundaries the reverse accumulation would run one recording's tail
    straight into the previous recording's episodes."""
    T = len(rewards)
    if recording_starts is None or len(recording_starts) == 0:
        recording_starts = np.asarray([0])
    returns = np.zeros(T, np.float32)
    valid = np.zeros(T, np.float32)
    bounds = list(recording_starts[1:]) + [T]
    for s, e in zip(recording_starts, bounds):
        acc = 0.0
        for t in range(e - 1, s - 1, -1):
            if dones[t]:
                acc = 0.0
            acc = rewards[t] + gamma * acc
            returns[t] = acc
        nz = np.nonzero(dones[s:e])[0]
        if len(nz):
            valid[s: s + nz[-1] + 1] = 1.0
    return returns, valid


def make_marwil_update(optimizer, beta: float, vf_coeff: float,
                       ma_rate: float = 1e-2, weight_clip: float = 20.0):
    """``update(params, c_sq, obs, actions, returns, valid) -> (c_sq,
    stats)``: one Adam step in place; ``c_sq`` is the running squared
    advantage scale (a scalar tensor on the learner's device)."""
    log_clip = float(np.log(np.float32(weight_clip)))

    def update(params, c_sq, obs, actions, returns, valid):
        logits = mlp_apply(params["pi"], obs)
        values = mlp_apply(params["vf"], obs)[..., 0]
        adv = returns - values
        n = torch.clamp(valid.sum(), min=1.0)
        vf_loss = torch.sum(torch.square(adv) * valid) / n
        # running scale of the advantage magnitude (marwil_tf_policy.py's
        # moving-average norm): keeps beta·adv/c O(1) as V(s) improves
        adv_d = adv.detach()
        new_c_sq = c_sq + ma_rate * (
            torch.sum(torch.square(adv_d) * valid) / n - c_sq)
        c = torch.sqrt(new_c_sq) + 1e-8
        w = torch.exp(torch.clamp(beta * adv_d / c, max=log_clip))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, actions.long()[:, None])[:, 0]
        pi_loss = torch.sum(w * nll * valid) / n
        acc = torch.sum((torch.argmax(logits, -1) == actions) * valid) / n
        total = pi_loss + vf_coeff * vf_loss
        apply_update(optimizer, total)
        return new_c_sq.detach(), {
            "policy_loss": pi_loss.detach(), "vf_loss": vf_loss.detach(),
            "action_match": acc, "mean_weight": (w * valid).sum() / n,
            "total_loss": total.detach()}

    return update


class MARWIL(OfflineAlgorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.reader = DatasetReader(config["input_path"], seed=seed)
        gamma = config.get("gamma", 0.99)
        self._returns, self._valid = episode_returns(
            self.reader.data[sb.REWARDS], self.reader.data[sb.DONES],
            gamma, self.reader.recording_starts)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        self.eval_env = probe_env
        hidden = config.get("hidden", (64, 64))
        gen = make_generator(seed)
        self.params = trainable({
            "pi": mlp_init(gen, [probe_env.observation_dim, *hidden,
                                 probe_env.num_actions]),
            "vf": mlp_init(gen, [probe_env.observation_dim, *hidden, 1]),
        }, self.device)
        self.optimizer = make_adam(self.params, config.get("lr", 1e-3))
        self.c_sq = torch.tensor(1.0, device=self.device)
        self._update = make_marwil_update(
            self.optimizer, config.get("beta", 1.0),
            config.get("vf_coeff", 1.0),
            config.get("moving_average_rate", 1e-2))
        self.train_batch_size = config.get("train_batch_size", 256)
        self.updates_per_step = config.get("updates_per_step", 64)
        self.eval_episodes = config.get("eval_episodes", 2)
        self._rng = np.random.default_rng(seed)
        self._updates_done = 0
        self._timesteps_total = 0
        self.workers = None
        self.local_worker = None

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        stats: Dict[str, Any] = {}
        n = self.reader.num_samples
        d, dev = self.reader.data, self.device
        for _ in range(self.updates_per_step):
            idx = self._rng.integers(0, n, size=self.train_batch_size)
            self.c_sq, stats = self._update(
                self.params, self.c_sq,
                torch.as_tensor(d[sb.OBS][idx], device=dev),
                torch.as_tensor(d[sb.ACTIONS][idx].astype(np.int64),
                                device=dev),
                torch.as_tensor(self._returns[idx], device=dev),
                torch.as_tensor(self._valid[idx], device=dev))
            self._updates_done += 1
        out = stats_to_floats(stats)
        out.update({
            "num_updates": self._updates_done,
            "dataset_size": n,
            "adv_scale": float(np.sqrt(float(self.c_sq))),
            "learn_time_s": time.time() - t0,
        })
        out.update(self._evaluate())
        return out

    def compute_single_action(self, obs: np.ndarray) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None, :]
        with torch.no_grad():
            return int(torch.argmax(mlp_apply(self.params["pi"], x)[0]))

    def _save_extra_state(self):
        return {"opt_state": adam_state_to_cpu(self.optimizer),
                "c_sq": float(self.c_sq),
                "updates_done": self._updates_done}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "opt_state" in state:
            load_adam_state(self.optimizer, state["opt_state"])
        if "c_sq" in state:
            self.c_sq = torch.tensor(float(state["c_sq"]),
                                     device=self.device)
        self._updates_done = state.get("updates_done", 0)


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(MARWIL)
        self.extra.update({"beta": 1.0, "vf_coeff": 1.0,
                           "updates_per_step": 64, "eval_episodes": 2})

    def offline_data(self, *, input_path: str) -> "MARWILConfig":
        self.extra["input_path"] = input_path
        return self

    def training(self, *, beta=None, vf_coeff=None, updates_per_step=None,
                 eval_episodes=None, moving_average_rate=None,
                 **kwargs) -> "MARWILConfig":
        super().training(**kwargs)
        for k, v in (("beta", beta), ("vf_coeff", vf_coeff),
                     ("updates_per_step", updates_per_step),
                     ("eval_episodes", eval_episodes),
                     ("moving_average_rate", moving_average_rate)):
            if v is not None:
                self.extra[k] = v
        return self
