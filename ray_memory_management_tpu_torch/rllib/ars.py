"""ARS: augmented random search (Mania et al. 2018) — gradient-free
linear/MLP policy search with three augmentations over vanilla random
search (the reference's rllib/algorithms/ars/ars.py): divide the step by
the std of the selected returns, keep only the top-k best perturbation
directions, and normalize observations with a running mean/std filter
shared across workers (ars.py's MeanStdFilter synchronization).

Shares ES's redesign (es.py): NO shared noise table — every perturbation
is its seed, regenerated worker-side for the rollout and learner-side
for the update, both from a CPU generator (the learner then moves the
rebuilt eps to its device in one copy). The extra ARS state
that must stay consistent is the observation filter: workers return
(count, sum, sumsq) increments and the learner folds them into the
master filter broadcast with the next weight sync — the same
delta-merge the reference's filter sync does.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import api
from ..utils.device import resolve_device
from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .es import (
    ESRolloutWorker, flatten_params, perturbations, unflatten_params,
)
from .models import make_generator, mlp_apply, mlp_init
from .rollout_worker import WorkerSet


class _ObsFilter:
    """Running mean/std observation normalizer (MeanStdFilter analog).
    Tracks (count, sum, sumsq); normalization uses the fixed snapshot at
    the start of each rollout round so every worker normalizes
    identically, while increments accumulate for the next merge."""

    def __init__(self, dim: int):
        self.count = 0.0
        self.sum = np.zeros(dim, np.float64)
        self.sumsq = np.zeros(dim, np.float64)

    def snapshot(self) -> Dict[str, np.ndarray]:
        if self.count < 2:
            dim = len(self.sum)
            return {"mean": np.zeros(dim, np.float32),
                    "std": np.ones(dim, np.float32)}
        mean = self.sum / self.count
        var = np.maximum(self.sumsq / self.count - mean * mean, 1e-8)
        return {"mean": mean.astype(np.float32),
                "std": np.sqrt(var).astype(np.float32)}

    def merge(self, delta: Dict[str, Any]) -> None:
        self.count += float(delta["count"])
        self.sum += np.asarray(delta["sum"], np.float64)
        self.sumsq += np.asarray(delta["sumsq"], np.float64)


class ARSRolloutWorker(ESRolloutWorker):
    """ES worker + observation filtering: normalizes each observation
    with the master filter snapshot and records raw-obs increments to
    ship back (ars.py workers sync filter deltas the same way)."""

    def __init__(self, env_spec, env_config: Optional[dict], hidden,
                 sigma: float, seed: int):
        super().__init__(env_spec, env_config, hidden, sigma, seed)
        dim = self.env.observation_dim
        self._f_mean = np.zeros(dim, np.float32)
        self._f_std = np.ones(dim, np.float32)
        self._inc_count = 0.0
        self._inc_sum = np.zeros(dim, np.float64)
        self._inc_sumsq = np.zeros(dim, np.float64)

    def set_filter(self, mean: np.ndarray, std: np.ndarray) -> None:
        self._f_mean = np.asarray(mean, np.float32)
        self._f_std = np.maximum(np.asarray(std, np.float32), 1e-4)

    def take_filter_delta(self) -> Dict[str, Any]:
        out = {"count": self._inc_count, "sum": self._inc_sum.copy(),
               "sumsq": self._inc_sumsq.copy()}
        self._inc_count = 0.0
        self._inc_sum[:] = 0.0
        self._inc_sumsq[:] = 0.0
        return out

    @torch.no_grad()
    def _episode(self, flat: np.ndarray) -> float:
        params = unflatten_params(flat, self.template)
        obs = self.env.reset(seed=int(self.rng.integers(1 << 31)))
        total, steps, done = 0.0, 0, False
        while not done:
            o = np.asarray(obs, np.float64)
            self._inc_count += 1.0
            self._inc_sum += o
            self._inc_sumsq += o * o
            norm = (obs - self._f_mean) / self._f_std
            out = mlp_apply(params, torch.from_numpy(
                np.asarray(norm, np.float32)[None, :]))[0].numpy()
            if self.discrete:
                a = int(out.argmax())
            else:
                bound = float(getattr(self.env, "action_bound", 1.0))
                a = bound * np.tanh(out)
            obs, r, term, trunc, _ = self.env.step(a)
            total += r
            steps += 1
            done = term or trunc
        self.episode_rewards.append(total)
        self.episode_lengths.append(steps)
        return total


class _ARSWorkerSet(WorkerSet):
    def __init__(self, env_spec, env_config, hidden, sigma,
                 num_workers: int, seed: int):
        cls = api.remote(ARSRolloutWorker)
        self.remote_workers = [
            cls.options(num_cpus=1).remote(
                env_spec, env_config, hidden, sigma,
                seed + 1000 * (i + 1))
            for i in range(num_workers)
        ]
        api.get([w.ready.remote() for w in self.remote_workers])


def make_ars_update(lr: float, sigma: float):
    """``update(theta, eps, pos, neg, ret_std) -> theta``: the top-k
    direction step, grad = sum_k (pos_k - neg_k) * eps_k, scaled by
    1/(k * sigma * std(selected returns)) (ars.py's sgd step over the
    deltas of the kept directions), on the device of ``eps`` [k, dim]."""

    def update(theta, eps, pos, neg, ret_std: float):
        grad = ((pos - neg) @ eps) / (len(pos) * sigma)
        return theta + (lr / max(ret_std, 1e-6)) * grad

    return update


class ARS(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        if config.get("connectors"):
            raise ValueError(
                "connectors are not supported by ARS's episode-return "
                "evaluation workers")
        seed = config.get("seed", 0)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        # the ARS paper's headline results use LINEAR policies; hidden=()
        # gives exactly that, deeper nets remain available
        hidden = config.get("hidden", ())
        discrete = hasattr(probe_env, "num_actions")
        out_dim = (probe_env.num_actions if discrete
                   else int(getattr(probe_env, "action_dim", 1)))
        self.template = mlp_init(
            make_generator(seed),
            [probe_env.observation_dim, *hidden, out_dim])
        self.theta = flatten_params(self.template)
        self.sigma = config.get("sigma", 0.05)
        self.n_directions = config.get("num_directions", 32)
        self.top_k = min(config.get("top_directions", 16),
                         self.n_directions)
        self._update = make_ars_update(config.get("lr", 0.02), self.sigma)
        self.filter = _ObsFilter(probe_env.observation_dim)
        self._rng = np.random.default_rng(seed)
        self._discrete = discrete
        self._probe_env = probe_env
        self._timesteps_total = 0
        self._updates_done = 0

        n_workers = config.get("num_rollout_workers", 0)
        self.workers = None
        self.local_worker = None
        if n_workers > 0:
            self.workers = _ARSWorkerSet(
                config["env_spec"], config.get("env_config"), hidden,
                self.sigma, n_workers, seed)
        else:
            self.local_worker = ARSRolloutWorker(
                config["env_spec"], config.get("env_config"), hidden,
                self.sigma, seed)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        seeds = [int(s) for s in
                 self._rng.integers(0, 1 << 31, size=self.n_directions)]
        snap = self.filter.snapshot()
        if self.workers is not None:
            ws = self.workers.remote_workers
            api.get([w.set_filter.remote(snap["mean"], snap["std"])
                     for w in ws])
            self.workers.set_weights(self.theta)
            shards = np.array_split(np.asarray(seeds), len(ws))
            results = api.get([
                w.evaluate.remote([int(s) for s in shard])
                for w, shard in zip(ws, shards) if len(shard)])
            for delta in api.get(
                    [w.take_filter_delta.remote() for w in ws]):
                self.filter.merge(delta)
        else:
            self.local_worker.set_filter(snap["mean"], snap["std"])
            self.local_worker.set_weights(self.theta)
            results = [self.local_worker.evaluate(seeds)]
            self.filter.merge(self.local_worker.take_filter_delta())
        all_seeds = np.concatenate([r["seeds"] for r in results])
        pos = np.concatenate([r["pos"] for r in results])
        neg = np.concatenate([r["neg"] for r in results])
        self._timesteps_total += int(sum(r["steps"] for r in results))

        # keep the top_k directions by max(pos, neg) (ars.py's deltas_idx
        # selection), scale the step by the std of the kept returns
        score = np.maximum(pos, neg)
        keep = np.argsort(score)[-self.top_k:]
        kept_returns = np.concatenate([pos[keep], neg[keep]])
        self.theta = self.learn(all_seeds[keep], pos[keep], neg[keep],
                                np.std(kept_returns))
        self._updates_done += 1

        return {
            "episodes_this_iter": 2 * len(all_seeds),
            "fitness_mean": float(np.mean(np.concatenate([pos, neg]))),
            "fitness_max": float(max(pos.max(), neg.max())),
            "filter_count": float(self.filter.count),
            "num_updates": self._updates_done,
            "theta_norm": float(np.linalg.norm(self.theta)),
            "time_this_iter_s": time.time() - t0,
        }

    def learn(self, seeds, pos: np.ndarray, neg: np.ndarray,
              ret_std: float) -> np.ndarray:
        """The top-k step on the learner's device from the kept seeds'
        eps; the new theta comes back as numpy."""
        dev = self.device
        theta = self._update(
            torch.as_tensor(self.theta, device=dev),
            perturbations(seeds, len(self.theta), dev),
            torch.as_tensor(np.asarray(pos, np.float32), device=dev),
            torch.as_tensor(np.asarray(neg, np.float32), device=dev),
            float(np.float32(ret_std)))
        return theta.cpu().numpy()

    def compute_single_action(self, obs: np.ndarray):
        snap = self.filter.snapshot()
        norm = (np.asarray(obs, np.float32) - snap["mean"]) / \
            np.maximum(snap["std"], 1e-4)
        params = unflatten_params(self.theta, self.template)
        with torch.no_grad():
            out = mlp_apply(params, torch.from_numpy(
                np.asarray(norm, np.float32)[None, :]))[0].numpy()
        if self._discrete:
            return int(out.argmax())
        bound = float(getattr(self._probe_env, "action_bound", 1.0))
        return bound * np.tanh(out)

    def get_weights(self):
        return self.theta

    def set_weights(self, weights) -> None:
        self.theta = np.asarray(weights, np.float32)

    def _sync_weights(self) -> None:
        pass  # theta broadcasts inside training_step

    def _save_extra_state(self):
        return {"theta": self.theta, "updates_done": self._updates_done,
                "filter": {"count": self.filter.count,
                           "sum": self.filter.sum,
                           "sumsq": self.filter.sumsq}}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "theta" in state:
            self.theta = np.asarray(state["theta"], np.float32)
        self._updates_done = state.get("updates_done", 0)
        f = state.get("filter")
        if f:
            self.filter.count = float(f["count"])
            self.filter.sum = np.asarray(f["sum"], np.float64)
            self.filter.sumsq = np.asarray(f["sumsq"], np.float64)


class ARSConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(ARS)
        self.extra.update({"sigma": 0.05, "num_directions": 32,
                           "top_directions": 16, "hidden": ()})

    def training(self, *, sigma=None, num_directions=None,
                 top_directions=None, **kwargs) -> "ARSConfig":
        super().training(**kwargs)
        for k, v in (("sigma", sigma),
                     ("num_directions", num_directions),
                     ("top_directions", top_directions)):
            if v is not None:
                self.extra[k] = v
        return self
