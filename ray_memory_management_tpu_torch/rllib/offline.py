"""Offline RL: dataset IO, behavior cloning, and off-policy evaluation.

The reference's offline stack (rllib/offline/: json_writer.py:31 /
json_reader.py:198 dataset IO, estimators/importance_sampling.py off-policy
evaluation; BC is the reference's simplest offline algorithm, built on the
same input pipeline). Datasets are columnar ``.npz`` shards, written zero-copy from sample
batches, rather than row-wise JSON; the format is the JAX package's, byte
for byte, so either package reads what the other wrote. The BC update
(policy forward, cross-entropy, Adam) runs on the learner's device
(``device`` in the config; ``"cpu"`` to run without a card), fed one
contiguous minibatch per step.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from . import sample_batch as sb
from .algorithm import Algorithm, AlgorithmConfig
from .collector import NEXT_OBS
from .env import make_env
from ..utils.device import resolve_device
from .models import (
    adam_state_to_cpu, apply_update, load_adam_state, make_adam,
    make_generator, mlp_apply, mlp_init, trainable,
)

# behavior-policy action log-prob column (needed for off-policy evaluation)
BEHAVIOR_LOGP = sb.LOGP
# true environment termination, distinct from the episode-boundary DONES
# (which also marks time-limit truncations): TD learners must bootstrap
# through a truncation but not through a termination (collector.py applies
# the same rule to live rollouts)
TERMINATED = "terminated"


class DatasetWriter:
    """Append sample batches to a directory of columnar ``.npz`` shards
    (the OutputWriter/JsonWriter contract, json_writer.py:31,72 — with
    arrays instead of rows)."""

    def __init__(self, path: str, shard_size: int = 10_000):
        self.path = path
        self.shard_size = shard_size
        os.makedirs(path, exist_ok=True)
        self._buf: List[Dict[str, np.ndarray]] = []
        self._buffered = 0
        self._shard = 0
        # per-writer token: two writers appending to one directory (same
        # pid or not) must never collide — shard-{pid}-{n} alone made a
        # second same-process writer silently overwrite the first's
        # shards, turning "append a second recording" into "replace"
        self._uid = os.urandom(4).hex()

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self._buf.append({k: np.asarray(v) for k, v in batch.items()})
        self._buffered += sb.batch_size(batch)
        if self._buffered >= self.shard_size:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        merged = sb.concat_batches(self._buf)
        fname = os.path.join(
            self.path,
            f"shard-{os.getpid()}-{self._uid}-{self._shard:05d}.npz")
        np.savez_compressed(fname + ".tmp.npz", **merged)
        os.replace(fname + ".tmp.npz", fname)  # readers never see partials
        self._shard += 1
        self._buf = []
        self._buffered = 0

    def close(self) -> None:
        self.flush()


class DatasetReader:
    """Load a shard directory; serve shuffled minibatches (the
    InputReader/JsonReader contract, json_reader.py:198,264).

    A directory may hold several independent RECORDINGS (one per
    DatasetWriter — appended runs, parallel collectors). Shards are
    grouped by their writer prefix so each recording's shards concatenate
    in write order, and ``recording_starts`` marks where each recording
    begins in the concatenated arrays: time order exists only WITHIN a
    recording, and everything trajectory-shaped (episode splits, returns,
    TD successors) must stop at those boundaries rather than bleed one
    recording's truncated tail into the next recording's first episode.
    Mixed schemas (a legacy recording without next_obs beside a new one)
    keep the INTERSECTION of columns, so the reader never crashes or
    keeps a column only some rows actually have."""

    def __init__(self, path: str, seed: int = 0):
        import re

        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".npz") and not f.endswith(".tmp.npz"))
        if not files:
            raise FileNotFoundError(f"no dataset shards under {path}")
        groups: Dict[str, list] = {}
        for f in files:
            m = re.match(r"(.+)-(\d+)\.npz$", os.path.basename(f))
            prefix, num = ((m.group(1), int(m.group(2))) if m
                           else (os.path.basename(f), 0))
            groups.setdefault(prefix, []).append((num, f))
        loaded = [[dict(np.load(f)) for _, f in sorted(groups[p])]
                  for p in sorted(groups)]
        keys = None
        for arrs in loaded:
            for a in arrs:
                keys = set(a) if keys is None else keys & set(a)
        shards, starts, offset = [], [], 0
        for arrs in loaded:
            starts.append(offset)
            for a in arrs:
                shards.append({k: a[k] for k in keys})
                offset += sb.batch_size(a)
        self.data = sb.concat_batches(shards)
        self.num_samples = sb.batch_size(self.data)
        self.recording_starts = np.asarray(starts, np.int64)
        self._rng = np.random.default_rng(seed)

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self.num_samples, size=n)
        return {k: v[idx] for k, v in self.data.items()}

    def iter_episodes(self, include_partial: bool = False
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Split at terminal flags WITHIN each recording — what the
        trajectory-level OPE estimators consume. A fragment that reaches
        a recording boundary with no terminal flag is a TRUNCATED
        recording, not an episode: it is excluded by default (treating
        it as complete biases per-episode return estimates low; the
        reference's estimators likewise consume only completed
        episodes)."""
        dones = self.data[sb.DONES]
        bounds = list(self.recording_starts[1:]) + [len(dones)]
        start = 0
        for rec_end in bounds:
            for t in range(start, rec_end):
                if dones[t]:
                    yield {k: v[start:t + 1]
                           for k, v in self.data.items()}
                    start = t + 1
            if start < rec_end:
                if include_partial:
                    yield {k: v[start:rec_end]
                           for k, v in self.data.items()}
                start = rec_end


def collect_dataset(env_spec, path: str, num_steps: int = 10_000,
                    policy=None, env_config: Optional[dict] = None,
                    seed: int = 0, shard_size: int = 10_000) -> str:
    """Roll a policy (default: uniform random) through the env and write
    (obs, action, reward, next_obs, done, behavior logp) shards — the
    offline counterpart of the reference's ``output`` rollout recording.
    next_obs makes the recording sufficient for TD-based offline
    learners (CQL); return-based ones (BC/MARWIL) ignore it."""
    env = make_env(env_spec, env_config)
    rng = np.random.default_rng(seed)
    writer = DatasetWriter(path, shard_size=shard_size)
    obs = env.reset(seed=seed)
    n_act = env.num_actions

    def fresh() -> Dict[str, List]:
        return {sb.OBS: [], sb.ACTIONS: [], sb.REWARDS: [],
                NEXT_OBS: [], sb.DONES: [], TERMINATED: [],
                BEHAVIOR_LOGP: []}

    def emit(cols: Dict[str, List]) -> None:
        writer.write({
            sb.OBS: np.asarray(cols[sb.OBS], np.float32),
            sb.ACTIONS: np.asarray(cols[sb.ACTIONS], np.int32),
            sb.REWARDS: np.asarray(cols[sb.REWARDS], np.float32),
            NEXT_OBS: np.asarray(cols[NEXT_OBS], np.float32),
            sb.DONES: np.asarray(cols[sb.DONES], np.float32),
            TERMINATED: np.asarray(cols[TERMINATED], np.float32),
            BEHAVIOR_LOGP: np.asarray(cols[BEHAVIOR_LOGP], np.float32),
        })

    cols = fresh()
    for _ in range(num_steps):
        if policy is None:
            a = int(rng.integers(n_act))
            logp = -float(np.log(n_act))
        else:
            a, logp = policy(obs)
        nxt, reward, terminated, truncated, _ = env.step(a)
        cols[sb.OBS].append(obs)
        cols[sb.ACTIONS].append(a)
        cols[sb.REWARDS].append(reward)
        cols[NEXT_OBS].append(nxt)
        # DONES marks the episode boundary (terminal OR time-limit);
        # TERMINATED carries the true-terminal flag TD learners mask on
        cols[sb.DONES].append(float(terminated or truncated))
        cols[TERMINATED].append(float(terminated))
        cols[BEHAVIOR_LOGP].append(logp)
        obs = nxt
        if terminated or truncated:
            obs = env.reset(seed=int(rng.integers(1 << 31)))
        if len(cols[sb.ACTIONS]) >= shard_size:
            # hand rows to the writer as we go: memory stays O(shard),
            # not O(num_steps), and shard_size actually shards
            emit(cols)
            cols = fresh()
    if cols[sb.ACTIONS]:
        emit(cols)
    writer.close()
    return path


class OfflineAlgorithm(Algorithm):
    """Base for dataset-trained algorithms (BC/MARWIL/CQL): no rollout
    workers, no weight broadcast; episode metrics come from periodic
    greedy eval rollouts against a local env (the reference's
    ``evaluation_interval`` rollouts for its offline family)."""

    def _evaluate(self) -> Dict[str, Any]:
        rewards = []
        for ep in range(self.eval_episodes):
            obs = self.eval_env.reset(seed=1000 + ep)
            total, done = 0.0, False
            while not done:
                a = self.compute_single_action(obs)
                obs, r, term, trunc, _ = self.eval_env.step(a)
                total += r
                done = term or trunc
            rewards.append(total)
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episodes_total": len(rewards)}

    def _episode_metrics(self) -> Dict[str, Any]:
        return {}  # offline: metrics come from the eval rollouts above

    def _sync_weights(self) -> None:
        pass  # offline: no rollout workers exist to receive weights


class BC(OfflineAlgorithm):
    """Behavior cloning: supervised cross-entropy on a recorded dataset —
    the reference's BC algorithm (rllib/algorithms/bc), the simplest
    member of its offline family. No environment interaction during
    training; periodic greedy eval rollouts supply episode metrics."""

    def setup(self, config: Dict[str, Any]) -> None:
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        seed = config.get("seed", 0)
        self.reader = DatasetReader(config["input_path"], seed=seed)
        probe_env = make_env(config["env_spec"], config.get("env_config"))
        self.eval_env = probe_env
        hidden = config.get("hidden", (64, 64))
        self.params = trainable({"pi": mlp_init(
            make_generator(seed),
            [probe_env.observation_dim, *hidden, probe_env.num_actions])},
            self.device)
        self.optimizer = make_adam(self.params, config.get("lr", 1e-3))
        self.train_batch_size = config.get("train_batch_size", 256)
        self.updates_per_step = config.get("updates_per_step", 64)
        self.eval_episodes = config.get("eval_episodes", 2)
        self._updates_done = 0
        self._timesteps_total = 0  # offline: no env steps are sampled
        self.workers = None
        self.local_worker = None
        self._update = make_bc_update(self.optimizer)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        stats: Dict[str, Any] = {"loss": 0.0, "acc": 0.0}
        for _ in range(self.updates_per_step):
            mb = self.reader.sample(self.train_batch_size)
            stats = self._update(
                self.params,
                torch.as_tensor(mb[sb.OBS], device=self.device),
                torch.as_tensor(mb[sb.ACTIONS].astype(np.int64),
                                device=self.device))
            self._updates_done += 1
        out = {
            "bc_loss": float(stats["loss"]),
            "action_match": float(stats["acc"]),
            "num_updates": self._updates_done,
            "dataset_size": self.reader.num_samples,
            "learn_time_s": time.time() - t0,
        }
        out.update(self._evaluate())
        return out

    def compute_single_action(self, obs: np.ndarray) -> int:
        x = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None, :]
        with torch.no_grad():
            return int(torch.argmax(mlp_apply(self.params["pi"], x)[0]))

    def _save_extra_state(self):
        return {"opt_state": adam_state_to_cpu(self.optimizer),
                "updates_done": self._updates_done}

    def _load_extra_state(self, state) -> None:
        if not state:
            return
        if "opt_state" in state:
            load_adam_state(self.optimizer, state["opt_state"])
        self._updates_done = state.get("updates_done", 0)


def make_bc_update(optimizer: torch.optim.Optimizer):
    """``update(params, obs, actions) -> {"loss", "acc"}``: one Adam step
    of the cross-entropy against the dataset's actions, in place."""

    def update(params, obs, actions):
        logits = mlp_apply(params["pi"], obs)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, actions.long()[:, None])[:, 0]
        loss = nll.mean()
        apply_update(optimizer, loss)
        acc = (torch.argmax(logits, -1) == actions).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return update


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(BC)
        self.extra.update({"updates_per_step": 64, "eval_episodes": 2})

    def offline_data(self, *, input_path: str) -> "BCConfig":
        self.extra["input_path"] = input_path
        return self

    def training(self, *, updates_per_step=None, eval_episodes=None,
                 **kwargs) -> "BCConfig":
        super().training(**kwargs)
        if updates_per_step is not None:
            self.extra["updates_per_step"] = updates_per_step
        if eval_episodes is not None:
            self.extra["eval_episodes"] = eval_episodes
        return self


def importance_sampling_estimate(reader: DatasetReader, target_logp,
                                 gamma: float = 0.99) -> Dict[str, float]:
    """Off-policy evaluation of a target policy from behavior data:
    ordinary (IS) and weighted (WIS) per-episode importance sampling
    (rllib/offline/estimators/importance_sampling.py). ``target_logp``
    maps (obs [T, D], actions [T]) -> log-probs [T] under the policy
    being evaluated; the dataset supplies the behavior log-probs."""
    ep_returns = []
    ep_weights = []
    for ep in reader.iter_episodes():
        T = sb.batch_size(ep)
        discounts = gamma ** np.arange(T)
        ret = float(np.sum(ep[sb.REWARDS] * discounts))
        logp_t = np.asarray(target_logp(ep[sb.OBS], ep[sb.ACTIONS]),
                            np.float64)
        log_ratio = np.clip(logp_t - ep[BEHAVIOR_LOGP], -30.0, 30.0)
        ep_weights.append(float(np.exp(np.sum(log_ratio))))
        ep_returns.append(ret)
    w = np.asarray(ep_weights)
    r = np.asarray(ep_returns)
    return {
        "behavior_mean_return": float(r.mean()),
        "is_estimate": float(np.mean(w * r)),
        "wis_estimate": float(np.sum(w * r) / max(np.sum(w), 1e-12)),
        "episodes": len(r),
        "effective_sample_size": float(
            np.sum(w) ** 2 / max(np.sum(w ** 2), 1e-12)),
    }
