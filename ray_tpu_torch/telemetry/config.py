"""Telemetry configuration.

``TelemetryConfig`` rides into workers through ``TrainContext.extra``
(serialized via ``to_dict``), the same channel the elastic subsystem
uses for per-replica batch math, so enabling the flight recorder needs
no new plumbing: ``JaxConfig(telemetry=TelemetryConfig(...))``.

The port's copy of ``ray_tpu/telemetry/config.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Dict, Optional

DEFAULT_RING_SIZE = 512
DEFAULT_FLUSH_INTERVAL_S = 2.0
DEFAULT_STRAGGLER_MULTIPLE = 2.0
DEFAULT_STRAGGLER_SUSTAIN = 3


@dataclass
class TelemetryConfig:
    """Knobs for the training flight recorder.

    Attributes:
        enabled: master switch; telemetry defaults ON (near-zero cost —
            a perf_counter pair per phase and a bounded deque append).
        ring_size: per-worker step-record ring buffer capacity.
        flush_interval_s: min seconds between KV snapshot flushes from a
            worker (0 flushes on every report — used by tests).
        straggler_multiple: a worker is suspect when its busy step time
            exceeds this multiple of the gang median.
        straggler_sustain: consecutive suspect steps before the
            aggregator emits a ``straggler_detected`` advisory
            (hysteresis: one GC pause must not page anyone).
    """

    enabled: bool = True
    ring_size: int = DEFAULT_RING_SIZE
    flush_interval_s: float = DEFAULT_FLUSH_INTERVAL_S
    straggler_multiple: float = DEFAULT_STRAGGLER_MULTIPLE
    straggler_sustain: int = DEFAULT_STRAGGLER_SUSTAIN

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError("ring_size must be >= 1")
        if self.flush_interval_s < 0:
            raise ValueError("flush_interval_s must be >= 0")
        if self.straggler_multiple <= 1.0:
            raise ValueError("straggler_multiple must be > 1.0")
        if self.straggler_sustain < 1:
            raise ValueError("straggler_sustain must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TelemetryConfig":
        known = {k: v for k, v in (d or {}).items()
                 if k in cls.__dataclass_fields__}
        return cls(**known)


def resolve_telemetry(value: Any) -> TelemetryConfig:
    """Normalize the user-facing ``telemetry=`` knob.

    Accepts None (default: enabled), bool, dict, or TelemetryConfig.
    """
    if value is None:
        return TelemetryConfig()
    if isinstance(value, TelemetryConfig):
        return value
    if isinstance(value, bool):
        return TelemetryConfig(enabled=value)
    if isinstance(value, dict):
        return TelemetryConfig.from_dict(value)
    raise TypeError(f"telemetry must be None/bool/dict/TelemetryConfig, "
                    f"got {type(value).__name__}")
