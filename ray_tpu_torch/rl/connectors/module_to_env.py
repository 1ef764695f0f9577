"""Module-to-env connectors: action postprocessing between the module's
output and env.step (reference: rllib/connectors/module_to_env/ —
get_actions.py, unsquash_and_clip_actions.py, listify_data_for_vector_env).
The port of ``ray_tpu/rl/connectors/module_to_env.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from .connector import ConnectorPipeline, ConnectorV2


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):            # a torch tensor, maybe on a card
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class ToNumpy(ConnectorV2):
    """Device tensors -> host numpy for env.step (the gym boundary)."""

    traceable = False

    def __call__(self, action: Any, ctx: Optional[dict] = None) -> Any:
        return _host(action)


class ClipActions(ConnectorV2):
    """Clip continuous actions into the env's bounds (reference:
    unsquash_and_clip_actions.py clip mode)."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, action: Any, ctx: Optional[dict] = None) -> Any:
        return action.clip(self.low, self.high)

    def __repr__(self):
        return f"ClipActions[{self.low}, {self.high}]"


class UnbatchToInt(ConnectorV2):
    """Discrete actions to the integer dtype vector envs expect."""

    traceable = False

    def __call__(self, action: Any, ctx: Optional[dict] = None) -> Any:
        return _host(action).astype(np.int64, copy=False)


def default_module_to_env() -> ConnectorPipeline:
    return ConnectorPipeline(ToNumpy())
