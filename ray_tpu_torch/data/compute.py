"""Compute strategies for map operations.

Reference: python/ray/data/_internal/compute.py (TaskPoolStrategy,
ActorPoolStrategy) — the knob deciding whether a `map_batches` fans out
as stateless tasks or runs on a pool of long-lived actors holding warm
per-actor state (the batch-inference pattern: load a model / build a
program once per actor, reuse it for every block).

The port's copy of ``ray_tpu/data/compute.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union


@dataclass
class TaskPoolStrategy:
    """Stateless tasks; `size` caps this operator's concurrent tasks."""

    size: Optional[int] = None


@dataclass
class ActorPoolStrategy:
    """Autoscaling pool of worker actors (reference: compute.py
    ActorPoolStrategy).  min_size actors start up front; the pool grows
    toward max_size while inputs queue faster than the pool drains, and
    dead actors are replaced with their in-flight blocks resubmitted."""

    min_size: int = 1
    max_size: Optional[int] = None
    max_tasks_in_flight_per_actor: int = 2

    def __post_init__(self):
        if self.max_size is None:
            self.max_size = self.min_size
        if self.min_size < 1 or self.max_size < self.min_size:
            raise ValueError(
                f"invalid actor pool bounds ({self.min_size}, "
                f"{self.max_size})")


def strategy_from_concurrency(
        concurrency: Union[int, Tuple[int, int], None],
        is_class_udf: bool):
    """Map the user-facing `concurrency` argument onto a strategy
    (reference: dataset.py map_batches `concurrency` semantics)."""
    if concurrency is None:
        if is_class_udf:
            raise ValueError(
                "a callable-class UDF requires `concurrency` (int for a "
                "fixed-size actor pool, (min, max) for autoscaling)")
        return TaskPoolStrategy()
    if isinstance(concurrency, int):
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        if is_class_udf:
            return ActorPoolStrategy(concurrency, concurrency)
        return TaskPoolStrategy(size=concurrency)
    if (isinstance(concurrency, tuple) and len(concurrency) == 2
            and all(isinstance(x, int) for x in concurrency)):
        if not is_class_udf:
            raise ValueError(
                "(min, max) concurrency is only valid for callable-class "
                "UDFs; pass an int to cap task concurrency")
        return ActorPoolStrategy(concurrency[0], concurrency[1])
    raise ValueError(
        f"concurrency must be an int or (min, max) tuple, got "
        f"{concurrency!r}")
