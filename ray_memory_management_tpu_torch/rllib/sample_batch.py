"""Sample batches + advantage estimation.

The reference's SampleBatch (rllib/policy/sample_batch.py) and GAE
postprocessing (rllib/evaluation/postprocessing.py compute_advantages).
Batches are plain dicts of contiguous numpy arrays — the shape the object
store moves zero-copy and jax consumes directly.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
LOGP = "logp"
VALUES = "values"
ADVANTAGES = "advantages"
TARGETS = "value_targets"
BOOTSTRAP = "bootstrap_value"  # V(s_T) after the fragment's last step


def concat_batches(batches: List[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    if not batches:
        return {}
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}


def batch_size(batch: Dict[str, np.ndarray]) -> int:
    return len(next(iter(batch.values()))) if batch else 0


def compute_gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
                last_value: float, gamma: float = 0.99,
                lam: float = 0.95) -> tuple:
    """Generalized Advantage Estimation over one rollout fragment
    (postprocessing.py compute_advantages). ``dones`` marks terminal
    steps; bootstrap from ``last_value`` when the fragment ends
    mid-episode."""
    n = len(rewards)
    adv = np.zeros(n, dtype=np.float32)
    last_gae = 0.0
    next_value = last_value
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    targets = adv + values
    return adv, targets


def minibatch_indices(n: int, minibatch_size: int,
                      rng: np.random.Generator):
    """Shuffled minibatch index iterator for SGD epochs."""
    perm = rng.permutation(n)
    for start in range(0, n - minibatch_size + 1, minibatch_size):
        yield perm[start:start + minibatch_size]


def episode_stats_summary(episode_rewards, episode_lengths,
                          window: int = 100):
    """Windowed episode metrics every collector reports (the reference's
    metrics.py summarize_episodes) — one implementation shared by the
    on-policy, off-policy, ES, and multi-agent collectors."""
    rewards = episode_rewards[-window:]
    lengths = episode_lengths[-window:]
    return {
        "episodes": len(episode_rewards),
        "episode_reward_mean": float(np.mean(rewards)) if rewards
        else None,
        "episode_len_mean": float(np.mean(lengths)) if lengths else None,
    }
