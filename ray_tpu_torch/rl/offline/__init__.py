"""Offline-RL data path (reference: rllib/offline/ — OfflineData reads
datasets of logged experience into learners; offline_env_runner records
rollouts back out as files).  The port of ``ray_tpu/rl/offline``, over
the port's Data (``ray_tpu_torch.data``)."""

from .offline_data import (OfflineData, record_rollouts,
                           resolve_offline_data)

__all__ = ["OfflineData", "record_rollouts", "resolve_offline_data"]
