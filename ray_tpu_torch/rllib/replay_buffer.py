"""Replay buffers (reference: ray rllib/utils/replay_buffers/replay_buffer.py:66
uniform ring buffer; prioritized_episode variant — here a proportional
prioritized buffer with sum-tree-free numpy sampling, adequate to ~1M).

The port's copy of `ray_tpu/rllib/replay_buffer.py` (which imports no JAX; the
port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._storage: List[Dict[str, Any]] = []
        self._next_idx = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._storage)

    def add(self, transition: Dict[str, Any]) -> None:
        if len(self._storage) < self.capacity:
            self._storage.append(transition)
        else:
            self._storage[self._next_idx] = transition
        self._next_idx = (self._next_idx + 1) % self.capacity

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        for i in range(n):
            self.add({k: v[i] for k, v in batch.items()})

    def sample(self, num_items: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self._storage), size=num_items)
        return self._stack([self._storage[i] for i in idx])

    @staticmethod
    def _stack(items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        keys = items[0].keys()
        return {k: np.stack([it[k] for it in items]) for k in keys}


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros(capacity, dtype=np.float64)
        self._max_priority = 1.0

    def add(self, transition: Dict[str, Any]) -> None:
        idx = self._next_idx
        super().add(transition)
        self._priorities[idx] = self._max_priority ** self.alpha

    def sample(self, num_items: int) -> Dict[str, np.ndarray]:
        n = len(self._storage)
        prios = self._priorities[:n]
        probs = prios / prios.sum()
        idx = self._rng.choice(n, size=num_items, p=probs)
        weights = (n * probs[idx]) ** (-self.beta)
        weights /= weights.max()
        batch = self._stack([self._storage[i] for i in idx])
        batch["weights"] = weights.astype(np.float32)
        batch["batch_indexes"] = idx
        return batch

    def update_priorities(self, indexes: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(priorities) + 1e-6
        self._priorities[indexes] = priorities ** self.alpha
        self._max_priority = max(self._max_priority, priorities.max())
