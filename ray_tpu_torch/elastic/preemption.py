"""Preemption notices: learn a host is going away BEFORE it dies.

Cloud VMs get advance warning of maintenance events and spot reclamation;
this module polls such a source on every raylet
and turns a positive reading into a ``report_draining`` call to the
control plane, which broadcasts a ``node_draining`` advisory over pubsub.
Consumers (the Train BackendExecutor's drain listener) then checkpoint
and shrink *proactively* — well inside the grace window — instead of
discovering the loss via the heartbeat timeout after the fact.

Sources are injectable so CPU tier-1 tests exercise the whole path:
``FakePreemptionSource`` (in-process trigger), ``FilePreemptionSource``
(a sentinel file, which also works across processes — the raylet side is
driven this way via the ``RAY_TPU_TORCH_PREEMPTION_FILE`` env var).

The port's copy of ``ray_tpu/elastic/preemption.py`` (imported by the
raylet).  The reference's ``TpuMetadataSource``, which polls the GCE
metadata server of a TPU VM, has no single-host GPU counterpart and is
left out.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Callable, Optional

logger = logging.getLogger(__name__)

@dataclass
class PreemptionNotice:
    """One impending-loss advisory from a preemption source."""

    reason: str = "preemption"
    #: seconds until the host is expected to go away (advisory)
    grace_s: Optional[float] = None
    #: opaque per-event identity stamped by the source.  The watcher
    #: never re-fires the identity it last consumed: a source that
    #: re-arms while still holding the SAME event (a file renamed back,
    #: a stale re-read) is a replay, not a new edge.  None opts out
    #: (sources that cannot distinguish events keep pure edge semantics).
    key: Optional[object] = None


class PreemptionSource:
    """Poll interface.  ``poll()`` returns the currently pending notice,
    or None when the host is healthy.  Sources are level-triggered; the
    watcher edge-detects so one pending event fires one callback."""

    def poll(self) -> Optional[PreemptionNotice]:
        raise NotImplementedError


class FakePreemptionSource(PreemptionSource):
    """In-process source for tests: arm with trigger(), clear()."""

    def __init__(self):
        self._lock = threading.Lock()
        self._notice: Optional[PreemptionNotice] = None
        self._seq = 0  # guarded-by: _lock

    def trigger(self, reason: str = "test-preemption",
                grace_s: Optional[float] = None):
        with self._lock:
            self._seq += 1
            self._notice = PreemptionNotice(reason=reason, grace_s=grace_s,
                                            key=("fake", self._seq))

    def clear(self):
        with self._lock:
            self._notice = None

    def poll(self) -> Optional[PreemptionNotice]:
        with self._lock:
            return self._notice


class FilePreemptionSource(PreemptionSource):
    """A sentinel file arms the notice — works across process boundaries
    (tests touch the file; the raylet's watcher sees it).  The file body
    may be empty or a JSON object {"reason": ..., "grace_s": ...}."""

    def __init__(self, path: str):
        self.path = path

    def poll(self) -> Optional[PreemptionNotice]:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        reason, grace = "preemption", None
        try:
            with open(self.path) as f:
                body = f.read().strip()
            if body:
                spec = json.loads(body)
                reason = str(spec.get("reason", reason))
                if spec.get("grace_s") is not None:
                    grace = float(spec["grace_s"])
        except Exception:
            pass  # an empty/garbled sentinel still means "draining"
        # identity rides the mtime: the same untouched sentinel seen again
        # after a re-arm is the SAME event; a rewritten file is a new one
        return PreemptionNotice(reason=reason, grace_s=grace,
                                key=("file", st.st_mtime_ns))


def source_from_env() -> Optional[PreemptionSource]:
    """The raylet's source, chosen by env: RAY_TPU_TORCH_PREEMPTION_FILE names
    a sentinel file.  None disables the watcher (the default)."""
    path = os.environ.get("RAY_TPU_TORCH_PREEMPTION_FILE")
    if path:
        return FilePreemptionSource(path)
    return None


class PreemptionWatcher:
    """Polls a source on its own thread; fires ``on_notice`` once per
    event edge (armed after being clear), so a level-held maintenance
    event produces exactly one drain report until it clears.

    ``debounce_s`` suppresses flapping: a notice edge arriving within
    the window after the last fired notice is swallowed instead of
    fired.  A drain→cancel→drain flap inside one window therefore costs
    ONE drain report, not two (and one elastic recovery, not two).  If
    the re-trigger is still pending when the window closes, the watcher
    fires it then — a real second event is delayed, never lost."""

    def __init__(self, source: PreemptionSource,
                 on_notice: Callable[[PreemptionNotice], None],
                 poll_interval_s: float = 1.0,
                 debounce_s: float = 0.0,
                 clock: Callable[[], float] = None):
        import time
        self.source = source
        self.on_notice = on_notice
        self.poll_interval_s = poll_interval_s
        self.debounce_s = debounce_s
        self._clock = clock or time.monotonic
        self._stop = threading.Event()
        self._armed = True  # fire on the first positive poll
        self._last_fired_at: Optional[float] = None
        self._last_fired_key: Optional[object] = None
        self._replay_logged = False
        self._pending_flap = False  # edge swallowed inside the window
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="preemption-watcher")
        self.notices_fired = 0
        self.notices_suppressed = 0

    def start(self):
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def poll_once(self) -> bool:
        """One synchronous poll+edge-detect (also used by tests)."""
        try:
            notice = self.source.poll()
        except Exception:
            logger.exception("preemption source poll failed")
            return False
        if notice is None:
            self._armed = True
            self._pending_flap = False  # the flap cleared: nothing owed
            self._replay_logged = False
            return False
        if (notice.key is not None
                and notice.key == self._last_fired_key):
            # the source re-armed but still holds the identity we already
            # consumed (e.g. a sentinel file briefly unreadable, then the
            # same bytes again): a replay, never an edge — do NOT fire it
            # into the fresh incarnation.  Stay armed so a genuinely new
            # identity fires on its next poll.
            if self._armed and not self._replay_logged:
                self._replay_logged = True
                self.notices_suppressed += 1
                logger.info(
                    "preemption notice (%s) is a replay of the already-"
                    "consumed event: suppressed", notice.reason)
            return False
        in_window = (self.debounce_s > 0.0
                     and self._last_fired_at is not None
                     and (self._clock() - self._last_fired_at)
                     < self.debounce_s)
        if not self._armed and not self._pending_flap:
            return False
        if in_window:
            # a fresh edge inside the debounce window: swallow it, but
            # remember it so a still-pending notice fires when the
            # window closes
            if self._armed:
                self._armed = False
                self._pending_flap = True
                self.notices_suppressed += 1
                logger.info(
                    "preemption notice (%s) debounced: within %.1fs of "
                    "the previous notice", notice.reason, self.debounce_s)
            return False
        self._armed = False
        self._pending_flap = False
        self._last_fired_at = self._clock()
        self._last_fired_key = notice.key
        self._replay_logged = False
        self.notices_fired += 1
        try:
            self.on_notice(notice)
        except Exception:
            logger.exception("preemption notice callback failed")
        return True

    def _loop(self):
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_interval_s)
