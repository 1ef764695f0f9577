"""Experiment-tracking logger callbacks (reference:
python/ray/air/integrations/wandb.py:453 WandbLoggerCallback,
python/ray/air/integrations/mlflow.py MlflowLoggerCallback,
python/ray/tune/logger/tensorboardx.py TBXLoggerCallback).

All three attach via ``RunConfig(callbacks=[...])`` (or directly on a
Tuner) and are duck-typed over their client libraries: pass a fake
module/client for tests, or install the real library — resolution order
is (injected object) > (importable library) > loud ImportError.
"""

from .mlflow import MLflowLoggerCallback
from .tbx import TBXLoggerCallback
from .wandb import WandbLoggerCallback

MlflowLoggerCallback = MLflowLoggerCallback  # reference spelling

__all__ = ["MLflowLoggerCallback", "MlflowLoggerCallback",
           "TBXLoggerCallback", "WandbLoggerCallback"]
