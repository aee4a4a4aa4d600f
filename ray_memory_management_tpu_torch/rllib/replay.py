"""Replay buffers for off-policy algorithms.

The reference's replay buffer suite (rllib/utils/replay_buffers/):
uniform ring-buffer replay plus proportional prioritized replay
(Schaul et al.), stored as columnar numpy so sampled batches feed jax
without per-row boxing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform FIFO replay over columnar transition storage."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: Dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if not self._storage:
            for k, v in batch.items():
                v = np.asarray(v)
                self._storage[k] = np.zeros(
                    (self.capacity, *v.shape[1:]), dtype=v.dtype)
        for start in range(0, n, self.capacity):
            chunk = {k: np.asarray(v)[start:start + self.capacity]
                     for k, v in batch.items()}
            m = len(next(iter(chunk.values())))
            end = self._idx + m
            for k, v in chunk.items():
                if end <= self.capacity:
                    self._storage[k][self._idx:end] = v
                else:
                    split = self.capacity - self._idx
                    self._storage[k][self._idx:] = v[:split]
                    self._storage[k][:end - self.capacity] = v[split:]
            self._idx = end % self.capacity
            self._size = min(self._size + m, self.capacity)

    def sample(self, num_items: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=num_items)
        return {k: v[idx] for k, v in self._storage.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization: P(i) ∝ priority_i^alpha, with
    importance-sampling weights beta-annealed by the caller."""

    def __init__(self, capacity: int, alpha: float = 0.6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._priorities = np.zeros(capacity, dtype=np.float64)
        self._max_priority = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        start_idx = self._idx
        super().add_batch(batch)
        for i in range(n):
            self._priorities[(start_idx + i) % self.capacity] = \
                self._max_priority

    def sample(self, num_items: int, beta: float = 0.4):
        prios = self._priorities[: self._size] ** self.alpha
        probs = prios / prios.sum()
        idx = self._rng.choice(self._size, size=num_items, p=probs)
        weights = (self._size * probs[idx]) ** (-beta)
        weights /= weights.max()
        out = {k: v[idx] for k, v in self._storage.items()}
        out["_weights"] = weights.astype(np.float32)
        out["_indices"] = idx
        return out

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        for i, p in zip(indices, priorities):
            self._priorities[i] = max(float(p), 1e-8)
            self._max_priority = max(self._max_priority, float(p))
