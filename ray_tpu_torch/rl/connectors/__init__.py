"""Connector pipelines (reference: rllib/connectors/connector_v2.py,
env_to_module/, module_to_env/ — obs/action preprocessing as composable,
inspectable pipelines instead of logic hardcoded in env runners).  The
port of ``ray_tpu/rl/connectors/``."""

from .connector import ConnectorPipeline, ConnectorV2
from .env_to_module import (ClipObs, FlattenObs, NormalizeObs, ObsToFloat32,
                            default_env_to_module)
from .module_to_env import (ClipActions, ToNumpy, UnbatchToInt,
                            default_module_to_env)

__all__ = [
    "ConnectorV2", "ConnectorPipeline",
    "ObsToFloat32", "FlattenObs", "NormalizeObs", "ClipObs",
    "default_env_to_module",
    "ClipActions", "ToNumpy", "UnbatchToInt", "default_module_to_env",
]
