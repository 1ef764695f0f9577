"""Goodput accounting across elastic incarnations.

Goodput = wall-clock fraction spent making forward progress
(state "productive") versus lost to drain notices ("draining"),
shrink/recover cycles ("recovering"), and in-between gaps ("idle").
The elastic subsystem stamps transitions through the module-level
current accountant so BackendExecutor/trainer need no handle plumbing.

The port's copy of ``ray_tpu/telemetry/goodput.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

STATES = ("productive", "draining", "recovering", "idle")


class GoodputAccountant:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "idle"
        self._t0 = clock()
        self._seg0 = self._t0
        self._seconds: Dict[str, float] = {s: 0.0 for s in STATES}
        self._transitions: List[Dict[str, Any]] = []
        self._incarnations: List[int] = []

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def transition(self, state: str, **meta: Any) -> None:
        if state not in STATES:
            raise ValueError(f"unknown goodput state {state!r}; "
                             f"expected one of {STATES}")
        with self._lock:
            inc = meta.get("incarnation")
            if inc is not None and inc not in self._incarnations:
                self._incarnations.append(inc)
            if state == self._state:
                return
            now = self._clock()
            self._seconds[self._state] += now - self._seg0
            self._seg0 = now
            self._state = state
            self._transitions.append(
                {"ts": now - self._t0, "state": state, **meta})
        self._export_gauge()

    def note_incarnation(self, incarnation: int) -> None:
        with self._lock:
            if incarnation not in self._incarnations:
                self._incarnations.append(incarnation)

    def report(self) -> Dict[str, Any]:
        with self._lock:
            now = self._clock()
            seconds = dict(self._seconds)
            seconds[self._state] += now - self._seg0  # in-progress segment
            wall = now - self._t0
            return {
                "state": self._state,
                "goodput": (seconds["productive"] / wall) if wall > 0
                else 0.0,
                "seconds": {k: round(v, 6) for k, v in seconds.items()},
                "wall_s": round(wall, 6),
                "transitions": list(self._transitions),
                "incarnations": list(self._incarnations),
            }

    def _export_gauge(self) -> None:
        try:
            from . import recorder
            from ..util import metrics as metrics_mod

            g = recorder._get_metric(
                "goodput_gauge", lambda: metrics_mod.Gauge(
                    "ray_tpu_train_goodput",
                    description="Fraction of wall-clock in productive "
                                "training"))
            g.set(self.report()["goodput"])
        except Exception:
            pass


_lock = threading.Lock()
_current: Optional[GoodputAccountant] = None


def set_current_accountant(acct: Optional[GoodputAccountant]) -> None:
    global _current
    with _lock:
        _current = acct


def current_accountant() -> Optional[GoodputAccountant]:
    return _current


def stamp(state: str, **meta: Any) -> None:
    """Transition the current accountant, if any (elastic hooks call
    this so telemetry-off runs cost one attribute read)."""
    acct = _current
    if acct is not None:
        try:
            acct.transition(state, **meta)
        except Exception:
            pass
