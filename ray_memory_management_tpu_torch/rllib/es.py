"""ES: OpenAI evolution strategies — gradient-free, embarrassingly parallel.

The reference's ES (rllib/algorithms/es/es.py — Salimans et al. 2017:
perturb a flat parameter vector with antithetic Gaussian noise, evaluate
each perturbation as a full episode on a worker, update with the
centered-rank-weighted sum of the noise; rllib/algorithms/es/optimizers.py
the SGD/Adam step on that pseudo-gradient; utils.py:14 the shared noise
table workers index into).

Redesigned for this runtime's strengths: there is NO noise table. The
reference ships a 250 MB shared noise block to every worker and exchanges
indices into it; here each perturbation is identified by its SEED —
workers regenerate eps from a CPU ``torch.Generator`` seeded with it,
evaluate theta ± sigma * eps, and return (seed, fitness+, fitness-)
tuples. The broadcast is just the base parameter vector, the collection
is a few floats per rollout, and the learner rebuilds every eps from its
seed and applies the rank-weighted update on its device — communication
drops from O(noise table) to O(params + 3 floats per perturbation).

The learner draws eps exactly as the workers do: on a CPU generator,
then one copy to its device. A card's generator gives other numbers for
the same seed, so it never draws them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import api
from ..utils.device import resolve_device
from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .env import make_env
from .models import make_generator, mlp_apply, mlp_init, tree_leaves
from .rollout_worker import WorkerSet, pin_rollout_threads


def flatten_params(params) -> np.ndarray:
    """The tree's leaves raveled in flatten order and concatenated."""
    return np.concatenate([np.asarray(p).ravel()
                           for p in tree_leaves(params)])


def unflatten_params(flat: np.ndarray, template):
    """``flat`` as a tree of CPU tensors shaped like ``template``."""
    pos = 0

    def take(leaf):
        nonlocal pos
        n = int(np.prod(leaf.shape)) if leaf.dim() else 1
        out = torch.from_numpy(np.asarray(
            flat[pos:pos + n], np.float32).reshape(tuple(leaf.shape)))
        pos += n
        return out

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return take(node)

    return walk(template)


def centered_ranks(fitness: np.ndarray) -> np.ndarray:
    """Map fitnesses to centered ranks in [-0.5, 0.5] (es.py's
    compute_centered_ranks) — scale-free, outlier-robust weighting."""
    ranks = np.empty(len(fitness), dtype=np.float32)
    ranks[fitness.argsort()] = np.arange(len(fitness), dtype=np.float32)
    return ranks / (len(fitness) - 1) - 0.5


def _perturbation(seed: int, dim: int) -> torch.Tensor:
    """The noise for one perturbation, derived from its seed — identical
    on worker (rollout) and learner (update): always a CPU generator."""
    return torch.randn(dim, generator=make_generator(seed))


def perturbations(seeds, dim: int, device) -> torch.Tensor:
    """Every seed's eps [n, dim], drawn on the CPU as the workers draw
    them and moved to ``device`` in one copy."""
    eps = torch.stack([_perturbation(int(s), dim) for s in seeds])
    return eps.to(device)


class ESRolloutWorker:
    """Evaluates antithetic perturbation pairs: for each seed, one
    episode with theta + sigma*eps and one with theta - sigma*eps
    (es.py's do_rollouts with antithetic sampling)."""

    def __init__(self, env_spec, env_config: Optional[dict], hidden,
                 sigma: float, seed: int):
        pin_rollout_threads()
        self.env = make_env(env_spec, env_config)
        from .multi_agent import MultiAgentEnv

        if isinstance(self.env, MultiAgentEnv):
            raise ValueError(
                "multi-agent envs train through the on-policy algorithms "
                "(PPO/PG/IMPALA/APPO); ES evaluates single-agent episodes")
        self.sigma = sigma
        self.discrete = hasattr(self.env, "num_actions")
        out_dim = (self.env.num_actions if self.discrete
                   else int(getattr(self.env, "action_dim", 1)))
        self.template = mlp_init(
            make_generator(0),
            [self.env.observation_dim, *hidden, out_dim])
        self.theta = flatten_params(self.template)
        self.rng = np.random.default_rng(seed)
        self.episode_rewards: List[float] = []
        self.episode_lengths: List[int] = []

    def ready(self) -> str:
        return "ok"

    def set_weights(self, theta: np.ndarray) -> None:
        self.theta = np.asarray(theta, np.float32)

    @torch.no_grad()
    def _episode(self, flat: np.ndarray) -> float:
        params = unflatten_params(flat, self.template)
        obs = self.env.reset(seed=int(self.rng.integers(1 << 31)))
        total, steps, done = 0.0, 0, False
        while not done:
            out = mlp_apply(params, torch.from_numpy(
                np.asarray(obs, np.float32)[None, :]))[0].numpy()
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

    def evaluate(self, seeds: List[int]) -> Dict[str, np.ndarray]:
        """One antithetic pair of episodes per seed."""
        steps_before = sum(self.episode_lengths)
        pos = np.zeros(len(seeds), np.float32)
        neg = np.zeros(len(seeds), np.float32)
        for i, s in enumerate(seeds):
            eps = _perturbation(s, len(self.theta)).numpy()
            pos[i] = self._episode(self.theta + self.sigma * eps)
            neg[i] = self._episode(self.theta - self.sigma * eps)
        return {"seeds": np.asarray(seeds, np.int64),
                "pos": pos, "neg": neg,
                "steps": sum(self.episode_lengths) - steps_before}

    def episode_stats(self, window: int = 100) -> Dict[str, Any]:
        return sb.episode_stats_summary(
            self.episode_rewards, self.episode_lengths, window)


class _ESWorkerSet(WorkerSet):
    def __init__(self, env_spec, env_config, hidden, sigma,
                 num_workers: int, seed: int):
        cls = api.remote(ESRolloutWorker)
        self.remote_workers = [
            cls.options(num_cpus=1).remote(
                env_spec, env_config, hidden, sigma,
                seed + 1000 * (i + 1))
            for i in range(num_workers)
        ]
        api.get([w.ready.remote() for w in self.remote_workers])


def make_es_update(lr: float, sigma: float, l2: float):
    """``update(theta, eps, weights) -> theta``: the rank-weighted
    pseudo-gradient step over the rebuilt perturbations ``eps`` [n, dim],
    on their device."""

    def update(theta, eps, weights):
        grad = (weights @ eps) / (len(weights) * sigma)
        return theta + lr * (grad - l2 * theta)

    return update


class ES(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        if config.get("connectors"):
            raise ValueError(
                "connectors are not supported by ES's episode-return "
                "evaluation workers")
        seed = config.get("seed", 0)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        hidden = config.get("hidden", (32,))
        discrete = hasattr(probe_env, "num_actions")
        out_dim = (probe_env.num_actions if discrete
                   else int(getattr(probe_env, "action_dim", 1)))
        self.template = mlp_init(
            make_generator(seed),
            [probe_env.observation_dim, *hidden, out_dim])
        self.theta = flatten_params(self.template)
        self.sigma = config.get("sigma", 0.05)
        self.episodes_per_step = config.get("episodes_per_batch", 64)
        self._update = make_es_update(
            config.get("lr", 0.02), self.sigma,
            config.get("l2_coeff", 0.005))
        self._rng = np.random.default_rng(seed)
        self._discrete = discrete
        self._probe_env = probe_env
        self._timesteps_total = 0
        self._updates_done = 0

        n_workers = config.get("num_rollout_workers", 0)
        self.workers = None
        self.local_worker = None
        if n_workers > 0:
            self.workers = _ESWorkerSet(
                config["env_spec"], config.get("env_config"), hidden,
                self.sigma, n_workers, seed)
        else:
            self.local_worker = ESRolloutWorker(
                config["env_spec"], config.get("env_config"), hidden,
                self.sigma, seed)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        n_pairs = max(1, self.episodes_per_step // 2)
        seeds = [int(s) for s in
                 self._rng.integers(0, 1 << 31, size=n_pairs)]
        if self.workers is not None:
            ws = self.workers.remote_workers
            # one put, many readers, completion-synced (WorkerSet helper)
            self.workers.set_weights(self.theta)
            shards = np.array_split(np.asarray(seeds), len(ws))
            results = api.get([
                w.evaluate.remote([int(s) for s in shard])
                for w, shard in zip(ws, shards) if len(shard)])
        else:
            self.local_worker.set_weights(self.theta)
            results = [self.local_worker.evaluate(seeds)]
        all_seeds = np.concatenate([r["seeds"] for r in results])
        pos = np.concatenate([r["pos"] for r in results])
        neg = np.concatenate([r["neg"] for r in results])
        self._timesteps_total += int(sum(r["steps"] for r in results))

        # antithetic rank weighting: rank ALL 2n returns together, then
        # weight each eps by (rank+ - rank-) (es.py's batched_weighted_sum
        # over compute_centered_ranks of the full return set)
        ranks = centered_ranks(np.concatenate([pos, neg]))
        weights = ranks[: len(pos)] - ranks[len(pos):]
        self.theta = self.learn(all_seeds, weights)
        self._updates_done += 1

        out = {
            "episodes_this_iter": 2 * len(all_seeds),
            "fitness_mean": float(np.mean(np.concatenate([pos, neg]))),
            "fitness_max": float(max(pos.max(), neg.max())),
            "num_updates": self._updates_done,
            "theta_norm": float(np.linalg.norm(self.theta)),
            "time_this_iter_s": time.time() - t0,
        }
        return out

    def learn(self, seeds, weights: np.ndarray) -> np.ndarray:
        """The update on the learner's device from the seeds' eps; the
        new theta comes back as numpy (what the workers receive)."""
        dev = self.device
        theta = self._update(
            torch.as_tensor(self.theta, device=dev),
            perturbations(seeds, len(self.theta), dev),
            torch.as_tensor(np.asarray(weights, np.float32), device=dev))
        return theta.cpu().numpy()

    def compute_single_action(self, obs: np.ndarray):
        params = unflatten_params(self.theta, self.template)
        with torch.no_grad():
            out = mlp_apply(params, torch.from_numpy(
                np.asarray(obs, np.float32)[None, :]))[0].numpy()
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
        return {"theta": self.theta, "updates_done": self._updates_done}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "theta" in state:
            self.theta = np.asarray(state["theta"], np.float32)
        self._updates_done = state.get("updates_done", 0)


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(ES)
        self.extra.update({"sigma": 0.05, "episodes_per_batch": 64,
                           "l2_coeff": 0.005})

    def training(self, *, sigma=None, episodes_per_batch=None,
                 l2_coeff=None, **kwargs) -> "ESConfig":
        super().training(**kwargs)
        for k, v in (("sigma", sigma),
                     ("episodes_per_batch", episodes_per_batch),
                     ("l2_coeff", l2_coeff)):
            if v is not None:
                self.extra[k] = v
        return self
