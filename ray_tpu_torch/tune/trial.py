"""Trial: one hyperparameter configuration's run state.

Mirrors the reference (reference: python/ray/tune/experiment/trial.py):
status machine PENDING -> RUNNING -> {TERMINATED, ERROR, PAUSED}, last
result, checkpoint, and serialization for experiment resume.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any],
                 experiment_dir: str, experiment_name: str):
        self.trial_id = trial_id
        self.config = config
        self.experiment_name = experiment_name
        self.status = PENDING
        self.last_result: Optional[Dict[str, Any]] = None
        self.results: List[Dict[str, Any]] = []
        self.checkpoint_path: Optional[str] = None
        self.error_msg: Optional[str] = None
        self.iteration = 0
        self.num_failures = 0
        self.start_time = time.time()
        from ray_tpu_torch.train import storage

        self.trial_dir = storage.join(experiment_dir, trial_id)
        storage.makedirs(self.trial_dir)

    @property
    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def metric(self, name: str, default: float = float("nan")) -> float:
        if not self.last_result:
            return default
        v = self.last_result.get(name, default)
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    def to_json(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "checkpoint_path": self.checkpoint_path,
            "error_msg": self.error_msg,
            "iteration": self.iteration,
            "num_failures": self.num_failures,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any], experiment_dir: str,
                  experiment_name: str) -> "Trial":
        t = cls(d["trial_id"], d["config"], experiment_dir, experiment_name)
        t.status = d["status"]
        t.last_result = d.get("last_result")
        t.checkpoint_path = d.get("checkpoint_path")
        t.error_msg = d.get("error_msg")
        t.iteration = d.get("iteration", 0)
        t.num_failures = d.get("num_failures", 0)
        return t

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status})"
