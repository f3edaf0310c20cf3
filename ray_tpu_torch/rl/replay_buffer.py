"""Replay buffers for off-policy algorithms.

A copy of ``ray_tpu/rl/replay_buffer.py`` (numpy only): the port imports
nothing of the JAX package, not even its framework-free modules.

Reference: rllib/utils/replay_buffers/ — ReplayBuffer (uniform ring
buffer) and PrioritizedEpisodeReplayBuffer (proportional prioritization,
Schaul et al. 2015).  Stored column-wise in preallocated numpy arrays so
``sample`` is a single fancy-index — the throughput-relevant layout for
feeding jit'd update steps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, **transition: np.ndarray) -> None:
        """Add a batch of transitions (first axis = batch)."""
        n = len(next(iter(transition.values())))
        if not self._cols:
            for k, v in transition.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity, *v.shape[1:]),
                                         v.dtype)
        for k, v in transition.items():
            v = np.asarray(v)
            idx = (self._next + np.arange(n)) % self.capacity
            self._cols[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: c[idx] for k, c in self._cols.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay with importance weights."""

    def __init__(self, capacity: int, *, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._prio = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add(self, **transition: np.ndarray) -> None:
        n = len(next(iter(transition.values())))
        idx = (self._next + np.arange(n)) % self.capacity
        super().add(**transition)
        self._prio[idx] = self._max_prio

    def sample(self, batch_size: int
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Returns (batch, indices, importance_weights)."""
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        p = self._prio[:self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, batch_size, p=p)
        weights = (self._size * p[idx]) ** (-self.beta)
        weights = weights / weights.max()
        batch = {k: c[idx] for k, c in self._cols.items()}
        return batch, idx, weights.astype(np.float32)

    def update_priorities(self, idx: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prio = np.abs(td_errors) + 1e-6
        self._prio[idx] = prio
        self._max_prio = max(self._max_prio, float(prio.max()))
