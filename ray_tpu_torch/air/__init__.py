"""ray_tpu_torch.air: shared train/tune runtime pieces (reference:
python/ray/air/ — RunConfig & co. live in train/config.py here; this
package carries the experiment-tracking integrations).  The port's copy
of ``ray_tpu/air``: ``mlflow`` and ``wandb`` import their libraries only
when a callback is made without an injected client."""

from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        RunConfig, ScalingConfig)

from . import integrations

__all__ = ["CheckpointConfig", "FailureConfig", "RunConfig",
           "ScalingConfig", "integrations"]
