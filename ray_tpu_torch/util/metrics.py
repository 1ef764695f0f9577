"""User-defined metrics API: Counter / Gauge / Histogram.

Analog of the reference's ray.util.metrics (reference:
python/ray/util/metrics.py backed by the C++ opencensus registry,
src/ray/stats/metric.h): metrics register in a process-local registry; a
flusher thread publishes snapshots into the control-plane KV under the
``_metrics`` namespace keyed by worker id; the dashboard merges all
snapshots and serves Prometheus text exposition (reference: metric
exporter -> agent -> Prometheus endpoint).

The port's copy of ``ray_tpu/util/metrics.py`` (imports renamed): the
series keep the reference's ``ray_tpu_*`` names, so one scrape config
serves both runtimes (ROADMAP §C).  Loads no torch.
"""

from __future__ import annotations

import json
import pickle
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

METRICS_NS = "_metrics"
FLUSH_INTERVAL_S = 2.0

_DEFAULT_HIST_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000,
]


class _Registry:
    """Process-local metric registry.

    Holds metrics by *weak* reference: user code that drops its last
    strong ref (e.g. metrics created in a prior init/shutdown epoch)
    gets swept instead of flushing stale series forever.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.metrics: List["weakref.ref[Metric]"] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def register(self, metric: "Metric"):
        with self.lock:
            self.metrics.append(weakref.ref(metric))
        self._ensure_flusher()

    def deregister(self, metric: "Metric"):
        """Explicitly drop a metric from future snapshots."""
        with self.lock:
            self.metrics = [r for r in self.metrics
                            if r() is not None and r() is not metric]

    def _live(self) -> List["Metric"]:
        """Prune dead refs; caller must hold self.lock."""
        live, refs = [], []
        for r in self.metrics:
            m = r()
            if m is not None:
                live.append(m)
                refs.append(r)
        self.metrics = refs
        return live

    def restart_if_needed(self):
        """Re-arm the flusher after a shutdown()/init() cycle so metrics
        created in a previous epoch keep flushing."""
        self._ensure_flusher()

    def snapshot(self) -> List[Dict]:
        with self.lock:
            return [m._snapshot() for m in self._live()]

    def _ensure_flusher(self):
        with self.lock:
            if self._thread is not None:
                return
            if not self._live():
                return
            stop = self._stop = threading.Event()  # fresh after a stop()
            self._thread = threading.Thread(
                target=self._flush_loop, args=(stop,),
                # not the reference's "metrics-flush": both runtimes'
                # flushers may live in one process
                name="ray_tpu_torch-metrics-flush", daemon=True)
            self._thread.start()

    def _flush_loop(self, stop: threading.Event):
        while not stop.wait(FLUSH_INTERVAL_S):
            try:
                self.flush()
            except Exception:
                pass  # never let a flush race with shutdown kill the loop

    def stop(self):
        """Stop the flusher (called from ray_tpu_torch.shutdown()); a later
        metric registration restarts it."""
        with self.lock:
            self._stop.set()
            thread, self._thread = self._thread, None
            self._live()  # sweep dead epoch refs while we hold the lock
        if thread is not None:
            # the set event makes stop.wait return immediately, so this
            # join is bounded by one in-flight flush at most
            thread.join(timeout=1.0)

    def flush(self):
        # non-raising core lookup: the flusher may fire after shutdown
        from ray_tpu_torch._private import core as core_mod

        core = core_mod._current_core
        if core is None or getattr(core, "_shutdown", False):
            return
        snap = self.snapshot()
        if not snap:
            return
        try:
            core.control.call("kv_put", {
                "ns": METRICS_NS,
                "key": core.worker_id,
                "val": pickle.dumps({"ts": time.time(), "metrics": snap}),
            }, timeout=5.0)
        except Exception:
            pass


_registry = _Registry()


def collect_cluster_metrics(control_client) -> List[Dict]:
    """Merge every process's last snapshot (dashboard-side helper)."""
    merged: List[Dict] = []
    try:
        keys = control_client.call("kv_keys",
                                   {"ns": METRICS_NS, "prefix": ""},
                                   timeout=5.0)
        for k in keys:
            raw = control_client.call("kv_get",
                                      {"ns": METRICS_NS, "key": k},
                                      timeout=5.0)
            if raw:
                snap = pickle.loads(raw)
                for m in snap["metrics"]:
                    m["worker_id"] = k
                    merged.append(m)
    except Exception:
        pass
    return merged


def control_stats_metrics(stats: Dict) -> List[Dict]:
    """Synthesize ``ray_tpu_control_*`` metric dicts from one
    ``control_stats`` RPC reply.

    The control daemon has no CoreWorker, so it cannot flush through the
    KV path like user processes do — the dashboard calls this instead and
    merges the result into ``/metrics`` alongside the cluster snapshots.
    Output shape matches registry snapshots (prometheus_text input).
    """
    from ray_tpu_torch._private.rpc_stats import BOUNDS_MS

    out: List[Dict] = []

    def metric(name: str, type_: str, desc: str, series: Dict,
               boundaries: Optional[List[float]] = None):
        if not series:
            return
        m = {"name": name, "type": type_, "description": desc,
             "series": series, "worker_id": "control"}
        if boundaries is not None:
            m["boundaries"] = boundaries
        out.append(m)

    def key(**tags) -> str:
        return json.dumps(tags, sort_keys=True)

    def hist_val(snap: Dict) -> Tuple[List[int], float, int]:
        # LatencyHist snapshot -> (bucket_counts, sum, count); the
        # overflow bucket folds into +Inf via the total count
        return (list(snap["buckets"][:len(BOUNDS_MS)]),
                snap["sum_ms"], snap["count"])

    bounds = list(BOUNDS_MS)
    counts: Dict[str, float] = {}
    errors: Dict[str, float] = {}
    inflight: Dict[str, float] = {}
    rpc_bytes: Dict[str, float] = {}
    budget_exc: Dict[str, float] = {}
    handle_h: Dict[str, Tuple] = {}
    queue_h: Dict[str, Tuple] = {}
    for method, s in (stats.get("handlers") or {}).items():
        k = key(Method=method)
        counts[k] = s.get("count", 0)
        errors[k] = s.get("errors", 0)
        inflight[k] = s.get("in_flight", 0)
        rpc_bytes[key(Method=method, Direction="in")] = s.get("bytes_in", 0)
        rpc_bytes[key(Method=method, Direction="out")] = s.get("bytes_out", 0)
        if "budget_exceeded" in s:
            budget_exc[k] = s["budget_exceeded"]
        if s.get("handle_ms"):
            handle_h[k] = hist_val(s["handle_ms"])
        if s.get("queue_ms"):
            queue_h[k] = hist_val(s["queue_ms"])
    metric("ray_tpu_control_rpc_total", "counter",
           "RPCs dispatched per control-plane handler", counts)
    metric("ray_tpu_control_rpc_errors_total", "counter",
           "Handler invocations that raised", errors)
    metric("ray_tpu_control_rpc_in_flight", "gauge",
           "Requests currently being handled", inflight)
    metric("ray_tpu_control_rpc_bytes_total", "counter",
           "Request/reply payload bytes per handler", rpc_bytes)
    metric("ray_tpu_control_rpc_budget_exceeded_total", "counter",
           "Handler completions over their latency budget", budget_exc)
    metric("ray_tpu_control_rpc_handle_ms", "histogram",
           "Handler execution latency (dispatch start -> reply)",
           handle_h, bounds)
    metric("ray_tpu_control_rpc_queue_ms", "histogram",
           "Dispatch-queue wait (frame received -> dispatch start)",
           queue_h, bounds)

    loop = stats.get("loop") or {}
    if loop.get("lag_ms"):
        metric("ray_tpu_control_loop_lag_ms", "histogram",
               "Event-loop tick lag (scheduled vs actual)",
               {key(): hist_val(loop["lag_ms"])}, bounds)

    kv_ops: Dict[str, float] = {}
    kv_bytes: Dict[str, float] = {}
    for ns, s in (stats.get("kv") or {}).items():
        kv_ops[key(Namespace=ns)] = s.get("ops", 0)
        kv_bytes[key(Namespace=ns, Direction="in")] = s.get("bytes_in", 0)
        kv_bytes[key(Namespace=ns, Direction="out")] = s.get("bytes_out", 0)
    metric("ray_tpu_control_kv_ops_total", "counter",
           "KV operations per namespace", kv_ops)
    metric("ray_tpu_control_kv_bytes_total", "counter",
           "KV payload bytes per namespace", kv_bytes)

    pub: Dict[str, float] = {}
    deliv: Dict[str, float] = {}
    pdrop: Dict[str, float] = {}
    for topic, s in (stats.get("pubsub") or {}).items():
        k = key(Topic=topic)
        pub[k] = s.get("publishes", 0)
        deliv[k] = s.get("deliveries", 0)
        pdrop[k] = s.get("dropped_subscribers", 0)
    metric("ray_tpu_control_pubsub_publishes_total", "counter",
           "Messages published per topic", pub)
    metric("ray_tpu_control_pubsub_deliveries_total", "counter",
           "Per-subscriber deliveries per topic", deliv)
    metric("ray_tpu_control_pubsub_dropped_subscribers_total", "counter",
           "Deliveries dropped on dead subscriber connections", pdrop)

    ev = stats.get("events") or {}
    if ev:
        metric("ray_tpu_control_event_queue_depth", "gauge",
               "Buffered task-event batches awaiting drain",
               {key(): ev.get("queue_depth", 0)})
        metric("ray_tpu_control_task_events_dropped_total", "counter",
               "Task events dropped cluster-wide",
               {key(): ev.get("dropped", 0)})
    nodes = stats.get("nodes") or {}
    if nodes:
        metric("ray_tpu_control_nodes_alive", "gauge",
               "Nodes currently ALIVE", {key(): nodes.get("alive", 0)})
    return out


def prometheus_text(metric_dicts: List[Dict]) -> str:
    """Render merged snapshots in Prometheus exposition format."""
    by_name: Dict[str, List[Dict]] = {}
    for m in metric_dicts:
        by_name.setdefault(m["name"], []).append(m)
    lines = []
    for name, ms in sorted(by_name.items()):
        kind = ms[0]["type"]
        prom_type = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}[kind]
        desc = ms[0].get("description", "")
        lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {prom_type}")
        for m in ms:
            for tags_json, value in m["series"].items():
                tags = json.loads(tags_json)
                tags["WorkerId"] = m.get("worker_id", "")[:16]
                label = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
                if kind == "histogram":
                    counts, total, num = value
                    acc = 0
                    for b, c in zip(m["boundaries"], counts):
                        acc += c
                        lines.append(
                            f'{name}_bucket{{{label},le="{b}"}} {acc}')
                    lines.append(
                        f'{name}_bucket{{{label},le="+Inf"}} {num}')
                    lines.append(f"{name}_sum{{{label}}} {total}")
                    lines.append(f"{name}_count{{{label}}} {num}")
                else:
                    lines.append(f"{name}{{{label}}} {value}")
    return "\n".join(lines) + "\n"


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._series: Dict[str, object] = {}  # json(tags) -> value
        _registry.register(self)

    def deregister(self):
        """Remove this metric from the registry (stops future flushes)."""
        _registry.deregister(self)

    def set_default_tags(self, default_tags: Dict[str, str]):
        self._default_tags = dict(default_tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> str:
        merged = {**self._default_tags, **(tags or {})}
        extra = set(merged) - set(self._tag_keys)
        if extra:
            raise ValueError(f"tags {extra} not in tag_keys "
                             f"{self._tag_keys} of metric {self._name}")
        return json.dumps(merged, sort_keys=True)

    @property
    def info(self) -> Dict:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys,
                "default_tags": dict(self._default_tags)}


class Counter(Metric):
    """Monotonic counter (reference: util/metrics.py Counter)."""

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc requires value > 0")
        k = self._key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def _snapshot(self):
        with self._lock:
            return {"name": self._name, "type": "counter",
                    "description": self._description,
                    "series": dict(self._series)}


class Gauge(Metric):
    """Last-value gauge."""

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._lock:
            self._series[k] = float(value)

    def _snapshot(self):
        with self._lock:
            return {"name": self._name, "type": "gauge",
                    "description": self._description,
                    "series": dict(self._series)}


class Histogram(Metric):
    """Bucketed histogram; series value = (bucket_counts, sum, count)."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        self._boundaries = sorted(boundaries or _DEFAULT_HIST_BOUNDARIES)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._lock:
            counts, total, num = self._series.get(
                k, ([0] * len(self._boundaries), 0.0, 0))
            counts = list(counts)
            for i, b in enumerate(self._boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            self._series[k] = (counts, total + value, num + 1)

    def _snapshot(self):
        with self._lock:
            return {"name": self._name, "type": "histogram",
                    "description": self._description,
                    "boundaries": list(self._boundaries),
                    "series": dict(self._series)}
