"""Flight-recorder primitives for the framed RPC layer.

Reference: src/ray/stats/metric_defs.cc + event_stats.h — the reference
instruments every gRPC handler with count/queueing/execution stats and a
per-handler "expected latency" warning threshold.  This module holds the
shared pieces: a fixed-bucket log-scale latency histogram cheap enough
for the dispatch hot path, the per-method stat record kept by
``protocol.Server`` and the per-handler latency *budget table* the
runtime warns against and ``ray_tpu_torch.analysis`` promotes lock-held
blocking warnings with.

Everything here is stdlib-only and import-cycle-free: ``protocol.py``,
the analyzer and the bench harness all import it.

The port's copy of ``ray_tpu/_private/rpc_stats.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

# Log-scale bucket upper bounds in seconds (25us .. 10s + overflow).
# Fixed for every histogram so snapshots merge bucket-by-bucket.
BOUNDS_S = (
    25e-6, 50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3, 100e-3, 250e-3, 500e-3,
    1.0, 2.5, 5.0, 10.0,
)
BOUNDS_MS = tuple(round(b * 1e3, 3) for b in BOUNDS_S)


class LatencyHist:
    """Fixed-bucket latency histogram (seconds in, ms out).

    Not internally locked: the owner serializes writes (the Server's
    stats lock, or a single recording thread).
    """

    __slots__ = ("counts", "count", "sum_s", "max_s")

    def __init__(self):
        self.counts = [0] * (len(BOUNDS_S) + 1)  # +1 = overflow bucket
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def observe(self, dt_s: float) -> None:
        if dt_s < 0.0:
            dt_s = 0.0
        self.count += 1
        self.sum_s += dt_s
        if dt_s > self.max_s:
            self.max_s = dt_s
        for i, b in enumerate(BOUNDS_S):
            if dt_s <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def merge(self, other: "LatencyHist") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum_s += other.sum_s
        if other.max_s > self.max_s:
            self.max_s = other.max_s

    def percentile_s(self, q: float) -> float:
        """Upper bucket bound at quantile q (0..1); max_s for overflow."""
        if self.count == 0:
            return 0.0
        target = max(1, int(q * self.count + 0.5))
        acc = 0
        for i, c in enumerate(self.counts[:-1]):
            acc += c
            if acc >= target:
                return BOUNDS_S[i]
        return self.max_s

    def snapshot(self) -> Dict[str, object]:
        ms = 1e3
        return {
            "count": self.count,
            "sum_ms": round(self.sum_s * ms, 3),
            "max_ms": round(self.max_s * ms, 3),
            "p50_ms": round(self.percentile_s(0.50) * ms, 3),
            "p90_ms": round(self.percentile_s(0.90) * ms, 3),
            "p99_ms": round(self.percentile_s(0.99) * ms, 3),
            "buckets": list(self.counts),
        }


class MethodStats:
    """Per-RPC-method server-side record (see protocol.Server)."""

    __slots__ = ("count", "errors", "inflight", "bytes_in", "bytes_out",
                 "replays", "budget_ms", "budget_exceeded", "last_warn",
                 "qwait", "handle")

    def __init__(self, budget_ms: Optional[float] = None):
        self.count = 0
        self.errors = 0
        self.inflight = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.replays = 0
        self.budget_ms = budget_ms
        self.budget_exceeded = 0
        self.last_warn = 0.0
        self.qwait = LatencyHist()    # recv -> dispatch start
        self.handle = LatencyHist()   # dispatch start -> reply sent

    def snapshot(self) -> Dict[str, object]:
        h = self.handle
        out = {
            # legacy surface (pre-flight-recorder consumers)
            "count": self.count,
            "total_s": round(h.sum_s, 6),
            "mean_us": round(h.sum_s / h.count * 1e6, 1) if h.count else 0.0,
            "max_us": round(h.max_s * 1e6, 1),
            # flight recorder
            "errors": self.errors,
            "in_flight": self.inflight,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "replays": self.replays,
            "queue_ms": self.qwait.snapshot(),
            "handle_ms": h.snapshot(),
        }
        if self.budget_ms is not None:
            out["budget_ms"] = self.budget_ms
            out["budget_exceeded"] = self.budget_exceeded
        return out


# ---------------------------------------------------------------------------
# Per-handler latency budgets (milliseconds), seeded from bench.py
# --control-only measurements on a shared 8-vCPU host (generous ~10x
# headroom over observed p99 so shared-host jitter does not page anyone).
#
# A budgeted handler runs ON the server event loop and stalls every
# connection while it executes: exceeding the budget logs a warning at
# runtime, and `ray-tpu analyze` PROMOTES a lock-held-across-blocking-call
# warning inside a budgeted handler to a gating finding
# (`budget-held-blocking`).  Long-poll / admission handlers whose latency
# is dominated by legitimate waiting (wait_actor_alive, create_actor,
# create_pg, remove_pg, request_lease*) are deliberately absent: a wall
# budget is meaningless for them and their known lock-held warnings stay
# baselined warnings.
# ---------------------------------------------------------------------------

HANDLER_BUDGETS_MS = {
    # shared
    "ping": 5.0,
    "rpc_stats": 50.0,
    # control plane
    "kv_put": 25.0,
    "kv_get": 10.0,
    "kv_del": 10.0,
    "kv_keys": 25.0,
    "kv_exists": 5.0,
    "register_node": 100.0,
    "unregister_node": 50.0,
    "heartbeat": 10.0,
    "report_draining": 10.0,
    "report_quarantine": 10.0,
    "get_nodes": 25.0,
    "pick_node": 10.0,
    "pick_nodes": 25.0,
    "register_function": 50.0,
    "get_function": 25.0,
    "register_job": 25.0,
    "get_actor": 10.0,
    "get_actor_spec": 10.0,
    "list_actors": 50.0,
    "actor_ready": 10.0,
    "actor_failed": 25.0,
    "subscribe": 10.0,
    "publish": 25.0,
    "get_pg": 10.0,
    "list_pgs": 50.0,
    "cluster_resources": 25.0,
    "state_dump": 250.0,
    "report_task_events": 50.0,
    "list_events": 50.0,
    "report_event": 10.0,
    "control_stats": 50.0,
    # raylet
    "register_worker": 25.0,
    "return_lease": 10.0,
    "cancel_lease_requests": 10.0,
    "task_blocked": 10.0,
    "task_unblocked": 10.0,
    "kill_actor_worker": 50.0,
    "prepare_bundle": 100.0,
    "commit_bundle": 50.0,
    "release_bundle": 50.0,
    "fetch_object": 100.0,
    "delete_objects": 50.0,
    "store_stats": 25.0,
    "node_info": 25.0,
    "list_leases": 50.0,
    "list_workers": 25.0,
    "list_logs": 50.0,
    "read_log": 100.0,
    "pending_demands": 25.0,
}


def budget_ms(method: str) -> Optional[float]:
    return HANDLER_BUDGETS_MS.get(method)


# ---------------------------------------------------------------------------
# Process-local pubsub delivery aggregator.  The publisher stamps a
# wall-clock send time on the wire (frame meta "ts"); every subscribing
# Client in this process records publish->deliver latency here, keyed by
# topic.  The swarm bench and raylet-resident subscribers read it back
# via pubsub_delivery_snapshot().
# ---------------------------------------------------------------------------

_pubsub_lock = threading.Lock()
_pubsub: Dict[str, LatencyHist] = {}


def record_pubsub_delivery(topic: str, latency_s: float) -> None:
    with _pubsub_lock:
        h = _pubsub.get(topic)
        if h is None:
            h = _pubsub[topic] = LatencyHist()
        h.observe(latency_s)


def pubsub_delivery_snapshot(reset: bool = False) -> Dict[str, Dict]:
    with _pubsub_lock:
        out = {t: h.snapshot() for t, h in _pubsub.items()}
        if reset:
            _pubsub.clear()
    return out


def merge_client_stats(agg: Dict[str, List[int]],
                       raw: Dict[str, List[int]]) -> None:
    """Accumulate one Client.stats_raw() into an aggregate (in place)."""
    for m, s in raw.items():
        a = agg.setdefault(m, [0] * len(s))
        for i, v in enumerate(s):
            a[i] += v
