"""Replay buffers (parity: rllib/utils/replay_buffers — ReplayBuffer +
prioritized variant with sum-tree sampling).

A copy of ``ray_tpu/rl/replay_buffer.py`` (pure numpy; the port imports
nothing of the JAX package). Given the same seed and the same adds, both
stacks' buffers return identical samples, priorities and weights, which the
off-policy algorithms' parity with the JAX package rests on. The buffer
stays on the host; a learner moves each sampled minibatch to its device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ray_tpu_torch.rl.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO ring buffer over flat transition columns."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity, *v.shape[1:]),
                                         v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, num_items)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (alpha) + importance weights (beta)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._prio = np.zeros(capacity, dtype=np.float64)
        self._max_prio = 1.0

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        idx = (self._next + np.arange(n)) % self.capacity
        super().add(batch)
        self._prio[idx] = self._max_prio

    def sample(self, num_items: int) -> SampleBatch:
        p = self._prio[:self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, num_items, p=p)
        weights = (self._size * p[idx]) ** (-self.beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(priorities) + 1e-6
        self._prio[idx] = priorities
        self._max_prio = max(self._max_prio, float(priorities.max()))
