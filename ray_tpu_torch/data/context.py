"""Execution context / knobs for ray_tpu_torch.data.

Equivalent of the reference's DataContext (reference:
python/ray/data/context.py) — a process-wide singleton of execution
options consulted at plan/execution time.

The port's copy of ``ray_tpu/data/context.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class DataContext:
    # Target size for blocks produced by reads and maps (bytes).
    target_max_block_size: int = 128 * 1024 * 1024
    # Shuffle ops aim for this many output partitions when not specified.
    default_shuffle_partitions: Optional[int] = None
    # Streaming executor: global cap on concurrently in-flight tasks.
    max_concurrent_tasks: int = 16
    # Per-operator cap on in-flight tasks (None = no per-op cap).
    max_tasks_per_operator: Optional[int] = None
    # Backpressure: pause upstream submission when this many output bundles
    # are buffered but not yet consumed (reference: backpressure policies in
    # python/ray/data/_internal/execution/backpressure_policy/).
    max_buffered_output_bundles: int = 32
    # Default batch format for map_batches / iter_batches.
    default_batch_format: str = "numpy"
    # iter_batches prefetch depth (batches).
    prefetch_batches: int = 2
    # Whether to eagerly free consumed intermediate blocks.
    eager_free: bool = True
    # Seed used by random_shuffle / random_sample when not given.
    seed: Optional[int] = None
    # Extra resources to attach to data tasks.
    task_resources: Dict[str, float] = field(default_factory=dict)
    # Stream blocks out of read/map tasks as they are produced instead of
    # buffering whole task outputs (reference: streaming generator returns
    # in the streaming executor); bounds per-task memory.
    use_streaming_generators: bool = True
    # Emit output bundles in dataset order (take/iter_rows return the
    # FIRST rows; tasks still run fully parallel — only the final yield
    # is sequenced).  False trades order for lower first-output latency
    # (reference: ExecutionOptions.preserve_order).
    preserve_order: bool = True
    # Max unconsumed streamed items (block+meta pairs count as 2) before
    # the producing task pauses (reference:
    # _generator_backpressure_num_objects).
    generator_backpressure_num_objects: int = 8

    _lock = threading.Lock()
    _current: Optional["DataContext"] = None

    @staticmethod
    def get_current() -> "DataContext":
        with DataContext._lock:
            if DataContext._current is None:
                DataContext._current = DataContext()
            return DataContext._current
