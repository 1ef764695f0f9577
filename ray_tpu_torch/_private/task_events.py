"""Buffered export of task lifecycle + profile events to the control plane.

Analog of the reference's TaskEventBuffer (reference:
src/ray/core_worker/task_event_buffer.h:220): every task submission and
execution transition is recorded locally and flushed in batches to the
control plane's task-event manager (reference: GcsTaskManager,
src/ray/gcs/gcs_server/gcs_task_manager.h), which the state API
(`ray_tpu_torch.util.state`) and the Chrome-trace timeline read back.

States follow the reference's task lifecycle (common.proto TaskStatus):
PENDING_ARGS_AVAIL -> SUBMITTED_TO_WORKER -> RUNNING -> FINISHED | FAILED.
Profile events (named spans inside a task) feed the timeline view
(reference: `ray timeline` -> chrome://tracing).

The port's copy of ``ray_tpu/_private/task_events.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, Optional

FLUSH_INTERVAL_S = 1.0
MAX_BUFFERED = 10_000  # drop-oldest beyond this (reference: task_events_max_buffer_size)
# submit-path ring -> event conversion per flush window: bounds the dict
# building a 100k-task burst would otherwise pay inside one flush tick
SUBMIT_DRAIN_MAX = 5_000


class TaskEventBuffer:
    """Thread-safe accumulator; a daemon thread flushes to the control plane."""

    def __init__(self, control_client, *, worker_id: str = "",
                 node_id: str = "", job_id: str = "",
                 transport=None):
        self._client = control_client
        # optional transport override: fn(payload) sending the batch
        # somewhere other than the direct control call.  Workers pass a
        # raylet-relay notify here so each node makes ONE control write
        # per flush window instead of one per worker (satellite of
        # ROADMAP item 5's per-node batching direction).
        self._transport = transport
        self._worker_id = worker_id
        self._node_id = node_id
        self._job_id = job_id
        self._flushed_batches = 0
        self._flushed_events = 0
        self._lock = threading.Lock()
        # deque, NOT list: drop-oldest at capacity must stay O(1) —
        # list.pop(0) shifts the whole buffer per append once saturated,
        # which throttled 100k-task submission bursts ~14x (every
        # submission records events; found by the scalability envelope)
        self._events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=MAX_BUFFERED)
        self._dropped = 0
        # submit-path ring: the owner's .remote() hot loop appends bare
        # tuples here (no dict build, no per-call time formatting beyond
        # one clock read); the flush thread converts them to full status
        # events off the hot path, rate-limited per window
        self._submit_ring: Deque[tuple] = collections.deque(
            maxlen=MAX_BUFFERED)
        self._submit_dropped = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._flush_loop,
                                        name="task-events-flush", daemon=True)
        self._thread.start()

    # -- recording ---------------------------------------------------------

    def record_status(self, task_id: str, state: str, *,
                      name: str = "", actor_id: Optional[str] = None,
                      error: Optional[str] = None,
                      extra: Optional[Dict[str, Any]] = None):
        # per-process constants (job/node/worker) ride once per batch as
        # the flush header, not per event — the control merges them back
        ev = {
            "kind": "status",
            "task_id": task_id,
            "state": state,
            "name": name,
            "actor_id": actor_id,
            "ts": time.time(),
        }
        if error:
            ev["error"] = error[:2000]
        if extra:
            ev.update(extra)
        self._append(ev)

    def record_submit(self, task_id: str, name: str, type_: str,
                      actor_id: Optional[str] = None):
        """Hot-path submission record (state PENDING_ARGS_AVAIL).  A bare
        tuple append into a bounded ring; the flush loop builds the event
        dict.  The deque append is atomic under the GIL, so no lock is
        taken here — the full/drop check races benignly (the counter is a
        metric, the maxlen deque enforces the bound regardless)."""
        ring = self._submit_ring
        if len(ring) == ring.maxlen:
            self._submit_dropped += 1  # maxlen evicts the oldest
        ring.append((task_id, name, type_, actor_id, time.time()))

    def _drain_submit_ring(self):
        """Convert up to SUBMIT_DRAIN_MAX staged submissions into status
        events (called from the flush thread).  Anything beyond the rate
        limit stays ringed for the next window; sustained overflow falls
        off the ring's tail into the dropped counter."""
        ring = self._submit_ring
        for _ in range(SUBMIT_DRAIN_MAX):
            try:
                task_id, name, type_, actor_id, ts = ring.popleft()
            except IndexError:
                break
            self._append({
                "kind": "status",
                "task_id": task_id,
                "state": "PENDING_ARGS_AVAIL",
                "name": name,
                "actor_id": actor_id,
                "ts": ts,
                "type": type_,
            })

    def record_profile(self, task_id: str, event_name: str,
                       start_ts: float, end_ts: float,
                       extra: Optional[Dict[str, Any]] = None):
        ev = {
            "kind": "profile",
            "task_id": task_id,
            "event_name": event_name,
            "start_ts": start_ts,
            "end_ts": end_ts,
        }
        if extra:
            ev.update(extra)
        self._append(ev)

    def _append(self, ev: Dict[str, Any]):
        with self._lock:
            if len(self._events) == MAX_BUFFERED:
                self._dropped += 1   # maxlen evicts the oldest on append
            self._events.append(ev)

    # -- flushing ----------------------------------------------------------

    def _flush_loop(self):
        while not self._stop.wait(FLUSH_INTERVAL_S):
            self.flush()

    def flush(self):
        self._drain_submit_ring()
        with self._lock:
            if not self._events and not self._submit_dropped:
                return
            batch = list(self._events)
            self._events.clear()
            dropped = self._dropped + self._submit_dropped
            self._dropped = 0
            self._submit_dropped = 0
            if not batch and not dropped:
                return
        payload = {"events": batch, "dropped": dropped,
                   "common": {"job_id": self._job_id,
                              "node_id": self._node_id,
                              "worker_id": self._worker_id}}
        try:
            if self._transport is not None:
                self._transport(payload)
            else:
                self._client.call("report_task_events", payload,
                                  timeout=5.0)
            with self._lock:
                self._flushed_batches += 1
                self._flushed_events += len(batch)
        except Exception:
            # control plane unreachable: re-queue (bounded) so a blip
            # doesn't lose the whole window; anything truncated off the
            # front counts as dropped, and the unsent dropped-count is
            # restored so it reaches control on the next success
            with self._lock:
                merged = batch + list(self._events)
                cut = max(0, len(merged) - MAX_BUFFERED)
                self._events = collections.deque(merged[cut:],
                                                 maxlen=MAX_BUFFERED)
                self._dropped += dropped + cut

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "buffered": len(self._events) + len(self._submit_ring),
                "flushed_batches": self._flushed_batches,
                "flushed_events": self._flushed_events,
                "dropped": self._dropped + self._submit_dropped,
            }

    def stop(self):
        self._stop.set()
        self.flush()


class _NullBuffer:
    """No-op stand-in before init / after shutdown."""

    def record_status(self, *a, **k):
        pass

    def record_submit(self, *a, **k):
        pass

    def record_profile(self, *a, **k):
        pass

    def flush(self):
        pass

    def stats(self):
        return {"buffered": 0, "flushed_batches": 0,
                "flushed_events": 0, "dropped": 0}

    def stop(self):
        pass


NULL_BUFFER = _NullBuffer()
