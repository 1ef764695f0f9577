"""Replay buffer (reference: rllib/utils/replay_buffers/) — flat numpy
ring buffer over transition dicts; uniform sampling.

The port of ``ray_tpu/rl/utils/replay_buffer.py``, a copy: the buffer
lives on the host and hands the learner numpy batches, which the learner
moves to its device (``learner.batch_to_device``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]):
        """batch: dict of [N, ...] transition arrays."""
        n = len(next(iter(batch.values())))
        if self._storage is None:
            self._storage = {
                k: np.zeros((self.capacity, *v.shape[1:]), v.dtype)
                for k, v in batch.items()
            }
        for k, v in batch.items():
            idx = (self._idx + np.arange(n)) % self.capacity
            self._storage[k][idx] = v
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: v[idx] for k, v in self._storage.items()}
