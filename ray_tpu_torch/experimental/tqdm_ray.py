"""Distributed-safe progress bars (reference:
python/ray/experimental/tqdm_ray.py): remote workers report progress
through the driver instead of fighting over the terminal.

Worker side: tqdm(...) returns a bar whose updates publish to the control
pubsub "tqdm" topic.  Driver side: call install_driver_listener() once to
subscribe and render per-bar lines on stderr; without a listener the
updates are dropped by the pubsub hub (and a bar created outside any
cluster renders locally).  The port's copy of
``ray_tpu/experimental/tqdm_ray.py``."""

from __future__ import annotations

import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, Iterable, Optional

_lock = threading.Lock()


class tqdm:
    """API-compatible subset of tqdm.tqdm (total/desc/update/close,
    iterable wrapping)."""

    def __init__(self, iterable: Optional[Iterable] = None, *,
                 desc: str = "", total: Optional[int] = None,
                 position: Optional[int] = None, flush_interval_s: float = 0.5,
                 **_ignored):
        self.iterable = iterable
        self.desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.n = 0
        self.bar_id = uuid.uuid4().hex[:12]
        self._last_flush = 0.0
        self._flush_interval = flush_interval_s
        self._closed = False

    # -- core --------------------------------------------------------------

    def update(self, n: int = 1):
        self.n += n
        now = time.monotonic()
        if now - self._last_flush >= self._flush_interval:
            self._last_flush = now
            self._publish()

    def close(self):
        if not self._closed:
            self._closed = True
            self._publish(final=True)

    def __iter__(self):
        if self.iterable is None:
            raise TypeError("tqdm() was not given an iterable")
        try:
            for x in self.iterable:
                yield x
                self.update(1)
        finally:
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def set_description(self, desc: str):
        self.desc = desc

    # -- reporting ---------------------------------------------------------

    def _state(self) -> Dict[str, Any]:
        return {"bar_id": self.bar_id, "desc": self.desc, "n": self.n,
                "total": self.total, "pid": os.getpid(),
                "closed": self._closed}

    def _publish(self, final: bool = False):
        state = self._state()
        try:
            from .._private.api import current_core

            core = current_core()
            core.control.notify("publish", {"topic": "tqdm",
                                            "payload": state})
        except Exception:
            # no cluster: render locally like plain tqdm would
            with _lock:
                pct = ""
                if self.total:
                    pct = f" {100.0 * self.n / max(1, self.total):5.1f}%"
                sys.stderr.write(
                    f"\r{self.desc}: {self.n}/{self.total or '?'}{pct}")
                if final:
                    sys.stderr.write("\n")
                sys.stderr.flush()


def safe_print(*values, **kwargs):
    """Print that won't interleave with bar rendering."""
    with _lock:
        print(*values, **kwargs)


_listener_installed = False
_bars: Dict[str, Dict[str, Any]] = {}


def _render(state: Dict[str, Any]):
    with _lock:
        _bars[state["bar_id"]] = state
        pct = ""
        if state.get("total"):
            pct = f" {100.0 * state['n'] / max(1, state['total']):5.1f}%"
        end = "\n" if state.get("closed") else ""
        sys.stderr.write(
            f"\r[{state.get('pid')}] {state.get('desc') or 'progress'}: "
            f"{state['n']}/{state.get('total') or '?'}{pct}{end}")
        sys.stderr.flush()
        if state.get("closed"):
            _bars.pop(state["bar_id"], None)


def install_driver_listener() -> bool:
    """Subscribe the driver to remote bars and render them on stderr.
    Returns False when no cluster connection exists."""
    global _listener_installed
    if _listener_installed:
        return True
    try:
        from .._private.api import current_core

        core = current_core()
        core.control.call("subscribe", {"topics": ["tqdm"]}, timeout=30.0)
        core.add_push_handler("pub:tqdm", _render)
        _listener_installed = True
        return True
    except Exception:
        return False
