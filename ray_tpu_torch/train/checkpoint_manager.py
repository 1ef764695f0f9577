"""Checkpoint retention + best-checkpoint tracking.

Mirrors the reference (reference: python/ray/train/_internal/
checkpoint_manager.py): every reported checkpoint is registered with its
metrics; retention keeps the `num_to_keep` best by the configured score
attribute (or the most recent, when no attribute is set).  The port's
copy of ``ray_tpu/train/checkpoint_manager.py``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from .checkpoint import Checkpoint
from .config import CheckpointConfig

logger = logging.getLogger(__name__)


class _TrackedCheckpoint:
    __slots__ = ("checkpoint", "metrics", "index")

    def __init__(self, checkpoint: Checkpoint, metrics: Dict[str, Any],
                 index: int):
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.index = index


class CheckpointManager:
    def __init__(self, config: Optional[CheckpointConfig] = None):
        self.config = config or CheckpointConfig()
        self._checkpoints: List[_TrackedCheckpoint] = []
        self._next_index = 0
        # emergency (in-memory, peer-replicated) tier: recovery events are
        # recorded, not retained — the payloads live in worker vaults, not
        # in run storage, so retention/scoring never applies to them
        self._emergency_events: List[Dict[str, Any]] = []

    def register_checkpoint(self, checkpoint: Checkpoint,
                            metrics: Dict[str, Any]) -> None:
        self._checkpoints.append(
            _TrackedCheckpoint(checkpoint, dict(metrics), self._next_index))
        self._next_index += 1
        self._enforce_retention()

    def _score(self, t: _TrackedCheckpoint) -> float:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return float(t.index)  # newest wins
        v = t.metrics.get(attr)
        if v is None:
            logger.warning("checkpoint %s lacks score attribute %r",
                           t.checkpoint.path, attr)
            return float("-inf")
        return float(v) if self.config.checkpoint_score_order == "max" else -float(v)

    def _enforce_retention(self) -> None:
        keep = self.config.num_to_keep
        if keep is None or len(self._checkpoints) <= keep:
            return
        # the most recent checkpoint is the resume point: never evicted
        latest = max(self._checkpoints, key=lambda t: t.index)
        ranked = sorted((t for t in self._checkpoints if t is not latest),
                        key=self._score, reverse=True)
        from . import storage

        while len(self._checkpoints) > keep and ranked:
            t = ranked.pop()
            self._checkpoints.remove(t)
            storage.rmtree(t.checkpoint.path)

    def note_emergency(self, step: int,
                       metadata: Optional[Dict[str, Any]] = None) -> None:
        """Record an emergency-tier recovery (elastic restart restored
        from peer-replicated shards at `step`)."""
        import time

        self._emergency_events.append({
            "step": int(step), "tier": "emergency", "ts": time.time(),
            **(metadata or {})})

    @property
    def emergency_events(self) -> List[Dict[str, Any]]:
        return list(self._emergency_events)

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=lambda t: t.index).checkpoint

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=self._score).checkpoint

    def best_checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        return [(t.checkpoint, t.metrics)
                for t in sorted(self._checkpoints, key=self._score,
                                reverse=True)]
