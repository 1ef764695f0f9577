"""Result: what Trainer.fit / Tuner.fit hand back per trial.

Mirrors the reference (reference: python/ray/train/_internal/result.py /
air Result): final metrics, latest + best checkpoints, run path, error.
The port's copy of ``ray_tpu/train/result.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: List[Tuple[Checkpoint, Dict[str, Any]]] = field(
        default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return (self.metrics or {}).get("config")
