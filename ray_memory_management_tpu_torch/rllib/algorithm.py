"""Algorithm base + config builder.

The reference's Algorithm(Trainable) (rllib/algorithms/algorithm.py:145,
step:631, training_step:1154) and AlgorithmConfig builder
(algorithm_config.py: .environment()/.rollouts()/.training()/.resources()).
Algorithms implement ``training_step``; the Trainable contract
(train/save/restore) comes from the tune library, so any algorithm drops
straight into the Tuner.

The learner runs on the card unless the config's ``device`` asks for
another (``"cpu"``); without a card and without that key it raises
(``utils.device.resolve_device``). Rollouts always run on the CPU.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Sequence, Type

import numpy as np
import torch

from .. import api
from ..tune.trainable import Trainable
from ..utils.device import resolve_device
from .env import make_env
from .models import (
    ac_apply, ac_init, copy_into, make_generator, params_to_numpy,
    tree_map,
)
from .rollout_worker import RolloutWorker, WorkerSet


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self.env_spec: Any = "CartPole"
        self.env_config: Dict[str, Any] = {}
        self.num_rollout_workers = 2
        self.rollout_fragment_length = 200
        self.train_batch_size = 4000
        self.lr = 5e-4
        self.gamma = 0.99
        self.seed = 0
        self.hidden: Sequence[int] = (64, 64)
        self.device: Optional[str] = None
        self.extra: Dict[str, Any] = {}

    # builder surface (each returns self, like the reference)
    def environment(self, env=None, *, env_config=None) -> "AlgorithmConfig":
        if env is not None:
            self.env_spec = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def rollouts(self, *, num_rollout_workers=None,
                 rollout_fragment_length=None) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, gamma=None, train_batch_size=None,
                 model=None, **extra) -> "AlgorithmConfig":
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if model is not None and "fcnet_hiddens" in model:
            self.hidden = tuple(model["fcnet_hiddens"])
        self.extra.update(extra)
        return self

    def connectors(self, specs) -> "AlgorithmConfig":
        """Env->policy transform pipeline specs, e.g.
        [("obs_norm", {}), ("frame_stack", {"k": 4})] — see
        rllib/connectors.py (the reference's connector framework,
        rllib/connectors/)."""
        self.extra["connectors"] = list(specs)
        return self

    def debugging(self, *, seed=None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def resources(self, *, device=None) -> "AlgorithmConfig":
        """The learner's device (``"cuda"``, ``"cuda:1"``, ``"cpu"``);
        None means the card."""
        self.device = device
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "env_spec": self.env_spec,
            "env_config": self.env_config,
            "num_rollout_workers": self.num_rollout_workers,
            "rollout_fragment_length": self.rollout_fragment_length,
            "train_batch_size": self.train_batch_size,
            "lr": self.lr,
            "gamma": self.gamma,
            "seed": self.seed,
            "hidden": tuple(self.hidden),
            "device": self.device,
            **self.extra,
        }

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algorithm class")
        return self.algo_class(config=self.to_dict())


class Algorithm(Trainable):
    """Common setup: local policy params + remote rollout workers.
    Subclasses implement ``training_step`` returning metrics."""

    # class-level defaults: subclasses with custom setup() (DQN/SAC/BC)
    # reject the connectors config and never populate these
    _connector_specs = None
    _infer_pipeline = None

    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.np_rng = np.random.default_rng(seed)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        connectors = config.get("connectors")
        from .connectors import build_pipeline

        self._connector_specs = connectors
        # the model is sized for the CONNECTOR-TRANSFORMED observation
        # (e.g. frame stacking widens it; rllib/connectors/ analog)
        self.obs_dim = build_pipeline(connectors).obs_dim(
            probe_env.observation_dim)
        self.num_actions = probe_env.num_actions
        self.params = self._to_learner(ac_init(
            make_generator(seed), self.obs_dim, self.num_actions,
            config.get("hidden", (64, 64))))
        self.workers: Optional[WorkerSet] = None
        self.local_worker: Optional[RolloutWorker] = None
        gamma = config.get("gamma", 0.99)
        lam = config.get("lambda_", 0.95)
        # a MultiAgentEnv spec swaps in the shared-policy multi-agent
        # collector; the learner is unchanged (the fragments it emits
        # honor the same flat-fragment contract)
        from .multi_agent import MultiAgentEnv, MultiAgentRolloutWorker

        worker_cls = (MultiAgentRolloutWorker
                      if isinstance(probe_env, MultiAgentEnv) else
                      RolloutWorker)
        if config.get("num_rollout_workers", 0) > 0:
            self.workers = WorkerSet(
                config["env_spec"], config.get("env_config"),
                config.get("hidden", (64, 64)),
                config["num_rollout_workers"], seed, gamma, lam,
                connectors=connectors, worker_cls=worker_cls)
        else:
            self.local_worker = worker_cls(
                config["env_spec"], config.get("env_config"),
                config.get("hidden", (64, 64)), seed, gamma, lam,
                connectors=connectors)
        # inference pipeline: the local worker's (shared object, stats
        # always warm) or a learner-side copy synced from worker 0 (see
        # _sync_connector_state) — compute_single_action must see the
        # SAME transform the policy trained with
        if worker_cls is MultiAgentRolloutWorker:
            self._infer_pipeline = build_pipeline(None)
        elif self.local_worker is not None:
            self._infer_pipeline = self.local_worker.connectors
        else:
            self._infer_pipeline = build_pipeline(connectors)
        self._timesteps_total = 0

    def _sync_connector_state(self) -> None:
        """Pull connector state (e.g. running obs-norm stats) from worker
        0 into the learner's inference pipeline. No-op without connectors
        or with a shared local worker."""
        if not self._connector_specs or self.workers is None:
            return
        try:
            state = api.get(self.workers.remote_workers[0]
                            .get_connector_state.remote())
            self._infer_pipeline.set_state(state)
        except Exception:  # noqa: BLE001 — eval freshness is best-effort
            pass

    def _to_learner(self, params):
        """A CPU-initialised tree as trainable leaves on the learner's
        device."""
        return tree_map(
            lambda t: t.to(self.device).requires_grad_(True), params)

    # -- subclass hook ---------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        result = self.training_step()
        result.setdefault("timesteps_total", self._timesteps_total)
        result.update(self._episode_metrics())
        self._sync_connector_state()  # keep eval/checkpoints warm
        return result

    def _episode_metrics(self) -> Dict[str, Any]:
        if self.workers is not None:
            stats = self.workers.stats()
        else:
            stats = [self.local_worker.episode_stats()]
        rewards = [s["episode_reward_mean"] for s in stats
                   if s["episode_reward_mean"] is not None]
        lengths = [s["episode_len_mean"] for s in stats
                   if s["episode_len_mean"] is not None]
        return {
            "episode_reward_mean": float(np.mean(rewards)) if rewards
            else None,
            "episode_len_mean": float(np.mean(lengths)) if lengths else None,
            "episodes_total": sum(s["episodes"] for s in stats),
        }

    # -- weights ---------------------------------------------------------------
    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, weights) -> None:
        # in place: the optimizer holds these very tensors
        copy_into(self.params, weights)

    def compute_single_action(self, obs: np.ndarray) -> int:
        """Greedy action for inference/eval (Algorithm.compute_single_action
        in the reference). Observations pass through the connector
        pipeline WITHOUT updating its statistics — the policy trained on
        transformed observations and must see the same transform here."""
        if self._connector_specs:
            obs = self._infer_pipeline.observe(
                np.asarray(obs), update=False)
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None, :]
        with torch.no_grad():
            logits, _ = ac_apply(self.params, x)
        return int(torch.argmax(logits[0]))

    # -- checkpointing ---------------------------------------------------------
    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = {
            "weights": self.get_weights(),
            "timesteps_total": self._timesteps_total,
            "extra": self._save_extra_state(),
        }
        if getattr(self, "_connector_specs", None):
            # connector statistics (e.g. running obs-norm) travel with
            # the weights: restored policies must see the SAME transform
            self._sync_connector_state()
            state["connectors"] = self._infer_pipeline.state()
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.set_weights(state["weights"])
        self._timesteps_total = state["timesteps_total"]
        self._load_extra_state(state.get("extra"))
        if state.get("connectors") is not None \
                and getattr(self, "_connector_specs", None):
            self._infer_pipeline.set_state(state["connectors"])
            if self.workers is not None:
                self.workers.set_connector_state(state["connectors"])
            # local mode: _infer_pipeline IS the worker's pipeline
        self._sync_weights()

    def _save_extra_state(self) -> Any:
        return None

    def _load_extra_state(self, state: Any) -> None:
        pass

    def _sync_weights(self) -> None:
        weights = self.get_weights()
        if self.workers is not None:
            self.workers.set_weights(weights)
        else:
            self.local_worker.set_weights(weights)

    def cleanup(self) -> None:
        if self.workers is not None:
            self.workers.stop()
