"""Env-to-module connectors: observation preprocessing before the
module's forward pass (reference: rllib/connectors/env_to_module/ —
flatten_observations.py, mean_std_filter.py, numpy_to_tensor.py).  The
port of ``ray_tpu/rl/connectors/env_to_module.py``: each connector acts
on numpy arrays and on torch tensors alike.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .connector import ConnectorPipeline, ConnectorV2


def _host(obs) -> np.ndarray:
    if hasattr(obs, "detach"):          # a torch tensor, maybe on a card
        obs = obs.detach().cpu().numpy()
    return np.asarray(obs, np.float32)


class ObsToFloat32(ConnectorV2):
    """Cast observations to float32 (reference: numpy_to_tensor.py role —
    the module's input dtype contract)."""

    def __call__(self, obs: Any, ctx: Optional[dict] = None) -> Any:
        if isinstance(obs, np.ndarray):
            return obs.astype(np.float32, copy=False)
        import torch

        if isinstance(obs, torch.Tensor):
            return obs.to(torch.float32)
        return torch.as_tensor(np.asarray(obs, np.float32))


class FlattenObs(ConnectorV2):
    """Flatten per-step observation trees/arrays to [B, -1] vectors
    (reference: flatten_observations.py)."""

    def __call__(self, obs: Any, ctx: Optional[dict] = None) -> Any:
        return obs.reshape(obs.shape[0], -1)


class ClipObs(ConnectorV2):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs: Any, ctx: Optional[dict] = None) -> Any:
        return obs.clip(self.low, self.high)

    def __repr__(self):
        return f"ClipObs[{self.low}, {self.high}]"


class NormalizeObs(ConnectorV2):
    """Running mean/std observation filter (reference:
    mean_std_filter.py MeanStdObservationFilter — Welford accumulation,
    update during sampling, frozen at evaluation).

    Stateful, therefore host-side only (gym runner path): the device
    rollout loop of the jax-env runner must not read its batch back to
    the host each step.
    """

    traceable = False

    def __init__(self, eps: float = 1e-8, update: bool = True):
        self.eps = eps
        self.update = update
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs: Any, ctx: Optional[dict] = None) -> Any:
        x = _host(obs)
        flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[None]
        if self.update and not (ctx or {}).get("no_update"):
            # Chan's batched merge: one vectorized update per call, not a
            # Python loop per sample (this sits on the hot sampling path)
            n_b = float(flat.shape[0])
            mean_b = flat.mean(0)
            m2_b = ((flat - mean_b) ** 2).sum(0)
            if self._mean is None:
                self._count, self._mean, self._m2 = n_b, mean_b, m2_b
            else:
                n_a = self._count
                delta = mean_b - self._mean
                tot = n_a + n_b
                self._mean = self._mean + delta * (n_b / tot)
                self._m2 = self._m2 + m2_b + delta ** 2 * (n_a * n_b / tot)
                self._count = tot
        if self._mean is None or self._count < 2:
            return x
        std = np.sqrt(self._m2 / (self._count - 1) + self.eps)
        return (x - self._mean) / std

    def state(self) -> dict:
        return {"count": self._count, "mean": self._mean, "m2": self._m2}


def default_env_to_module() -> ConnectorPipeline:
    """The default stack every runner starts from (reference:
    env_to_module_pipeline.py defaults); users splice into it via
    insert_before/after."""
    return ConnectorPipeline(ObsToFloat32())
