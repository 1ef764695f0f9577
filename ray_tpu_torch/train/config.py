"""Train run configuration dataclasses.

Mirrors the reference's air configs (reference: python/ray/air/config.py —
ScalingConfig :102, FailureConfig :394, CheckpointConfig :444, RunConfig
:593).  The port's copy of ``ray_tpu/train/config.py``: workers ask for
cards with Ray's own names, ``use_gpu`` / ``gpus_per_worker`` (a
``"GPU"`` entry in each bundle), where the reference asks for chips with
``use_tpu`` / ``tpus_per_worker``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Gradient-sync compression config lives with the collective subsystem;
# re-exported here so training code configures it next to the other run
# configs (JaxConfig(compression=CompressionConfig(...))).
from ray_tpu_torch.collective.compression import CompressionConfig


@dataclass
class ScalingConfig:
    """How many training workers and what each needs.

    num_workers: actor count (one per card in GPU runs).
    use_gpu: give each worker `gpus_per_worker` cards (default 1).  A
        worker with a GPU lease sees every card the raylet sees and picks
        ``cuda:<local rank>`` (train.torch.get_device).
    resources_per_worker: extra custom resources per worker.
    placement_strategy: bundle strategy for the gang placement group —
        PACK keeps workers on one node when possible.
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 1.0
    cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    trainer_resources: Optional[Dict[str, float]] = None

    def bundle(self) -> Dict[str, float]:
        b: Dict[str, float] = dict(self.resources_per_worker or {})
        if self.cpus_per_worker:
            b["CPU"] = float(self.cpus_per_worker)
        if self.use_gpu and self.gpus_per_worker:
            b["GPU"] = float(self.gpus_per_worker)
        return b

    def as_placement_group_bundles(self):
        return [self.bundle() for _ in range(self.num_workers)]


@dataclass
class FailureConfig:
    """max_failures: worker-group restarts tolerated before the run fails;
    -1 means unlimited (reference: air/config.py:394)."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Checkpoint retention policy (reference: air/config.py:444).

    num_to_keep: keep at most N checkpoints (None = all).
    checkpoint_score_attribute/order: which metric ranks checkpoints for
    retention and `Result.best_checkpoints`.
    """

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be >= 1 or None")
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Run-level config (reference: air/config.py:593).

    storage_path: where checkpoints/results persist — a local directory
    or a remote filesystem URI (s3://, gs://, or any fsspec scheme);
    workers upload checkpoints straight to it, which is how multi-node
    runs (no shared local disk) persist state (see train/storage.py,
    reference: train/_internal/storage.py:358 StorageContext).
    """

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None  # e.g. {"training_iteration": 10}
    verbose: int = 1
    #: experiment callbacks (tune.Callback subclasses — e.g. the
    #: TBX/W&B/MLflow logger callbacks of ray_tpu_torch.air.integrations);
    #: fire per result in Tuner runs AND standalone trainer.fit()
    #: (reference: air/config.py RunConfig.callbacks)
    callbacks: List[Any] = field(default_factory=list)

    def resolved_storage_path(self) -> str:
        from . import storage

        path = (self.storage_path
                or os.environ.get("RAY_TPU_TORCH_STORAGE", "~/ray_tpu_torch_results"))
        return path if storage.is_uri(path) else os.path.expanduser(path)
