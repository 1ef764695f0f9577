"""Timeline export: ring-buffer snapshots -> Chrome trace-event JSON.

The dashboard's ``GET /api/train/timeline`` and the
``python -m ray_tpu_torch timeline <job>`` CLI both route through here. Output follows
the Trace Event Format ("X" complete events, µs timestamps) so the
payload drops straight into Perfetto / chrome://tracing.

The port's copy of ``ray_tpu/telemetry/timeline.py``.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

from .recorder import PHASE_ORDER, TELEMETRY_KEY_PREFIX
from ..util.metrics import METRICS_NS


def collect_snapshots(control_client,
                      trial: Optional[str] = None) -> List[Dict[str, Any]]:
    """Pull every worker's last flushed ring snapshot from control KV."""
    snaps: List[Dict[str, Any]] = []
    try:
        keys = control_client.call(
            "kv_keys", {"ns": METRICS_NS, "prefix": TELEMETRY_KEY_PREFIX},
            timeout=5.0)
        for k in keys:
            raw = control_client.call(
                "kv_get", {"ns": METRICS_NS, "key": k}, timeout=5.0)
            if not raw:
                continue
            try:
                snap = pickle.loads(raw)
            except Exception:
                continue
            tel = snap.get("telemetry")
            if not isinstance(tel, dict):
                continue
            if trial and tel.get("trial") != trial:
                continue
            tel["worker_id"] = k[len(TELEMETRY_KEY_PREFIX):]
            snaps.append(tel)
    except Exception:
        pass
    return snaps


def collect_remediations(control_client,
                         trial: Optional[str] = None) -> List[Dict[str, Any]]:
    """Pull the trial's cause→action→effect remediation records (see
    elastic/remediation.py) for overlay onto the trace timeline."""
    try:
        from ray_tpu_torch.elastic.remediation import fetch_records

        return fetch_records(control_client, trial or "")
    except Exception:
        return []


def _phase_sorted(phases: Dict[str, float]) -> List[str]:
    known = [p for p in PHASE_ORDER if p in phases]
    extra = sorted(p for p in phases if p not in PHASE_ORDER)
    return known + extra


def _top_level(phases: Dict[str, float]) -> List[str]:
    """Canonical-order top-level phase names (dotted sub-phases are laid
    out nested inside their parent, not on the sequential cursor)."""
    return [p for p in _phase_sorted(phases) if "." not in p]


def _children_of(phases: Dict[str, float], parent: str) -> List[str]:
    pre = parent + "."
    return [p for p in _phase_sorted(phases) if p.startswith(pre)]


def collect_device_workers(control_client) -> Dict[str, Dict[str, Any]]:
    """Pull every worker's ``_device`` snapshot for compile-slice
    overlay (see telemetry/device.py)."""
    try:
        from .device import collect_device_stats

        return collect_device_stats(control_client).get("workers", {})
    except Exception:
        return {}


def chrome_trace(snapshots: List[Dict[str, Any]],
                 remediations: Optional[List[Dict[str, Any]]] = None,
                 device_workers: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
    """Render snapshots as a Chrome trace: one process per worker rank,
    an "X" span per step plus sequential per-phase child spans.
    Remediation records land as global instant events ("i") at their
    cause/action/effect wall timestamps, so the timeline answers "why
    did the cluster change shape right here".  ``device_workers``
    (from ``collect_device_workers``) adds one process of XLA-compile
    slices per worker so a recompile storm is visible against the very
    steps it stalled."""
    events: List[Dict[str, Any]] = []
    for snap in sorted(snapshots, key=lambda s: s.get("rank", 0)):
        rank = snap.get("rank", 0)
        pid = rank
        label = f"worker {rank}"
        if snap.get("trial"):
            label = f"{snap['trial']} / {label}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": "train step"}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 1, "args": {"name": "phases"}})
        for rec in snap.get("steps", []):
            ts_us = rec["ts"] * 1e6
            dur_us = max(rec["dur"] * 1e6, 0.001)
            step = rec.get("step")
            events.append({
                "name": f"step {step}" if step is not None else "step",
                "ph": "X", "ts": ts_us, "dur": dur_us,
                "pid": pid, "tid": 0,
                "args": {"step": step, "dur_s": rec["dur"],
                         "incarnation": rec.get("incarnation"),
                         "phases": rec.get("phases", {})},
            })
            # phases have durations, not start offsets — lay them out
            # sequentially in canonical order on a sibling track; dotted
            # sub-phases (collective.quantize/transfer/dequantize) nest
            # INSIDE their parent's span (same tid, contained ts range ->
            # Perfetto renders them as child slices), so the track's
            # sequential cursor never double-counts them
            cursor = ts_us
            phases = rec.get("phases") or {}
            for name in _top_level(phases):
                p_us = max(phases[name] * 1e6, 0.001)
                events.append({
                    "name": name, "ph": "X", "ts": cursor, "dur": p_us,
                    "pid": pid, "tid": 1,
                    "args": {"step": step, "seconds": phases[name]},
                })
                sub_cursor = cursor
                for child in _children_of(phases, name):
                    c_us = max(phases[child] * 1e6, 0.001)
                    # clip to the parent span: measured sub-stages can
                    # overshoot the async parent's dispatch time by a
                    # rounding hair, and an escaping child breaks nesting
                    c_us = min(c_us, cursor + p_us - sub_cursor)
                    if c_us <= 0:
                        break
                    events.append({
                        "name": child, "ph": "X", "ts": sub_cursor,
                        "dur": c_us, "pid": pid, "tid": 1,
                        "args": {"step": step, "seconds": phases[child]},
                    })
                    sub_cursor += c_us
                cursor += p_us
    for rec in remediations or []:
        rid = rec.get("id", "rem")
        kind = (rec.get("action") or {}).get("kind", "remediation")
        marks = [("cause", rec.get("ts"))]
        marks.append(("action", (rec.get("action") or {}).get("ts")))
        marks.append(("effect", (rec.get("effect") or {}).get("ts")))
        for phase, ts in marks:
            if ts is None:
                continue
            events.append({
                "name": f"{rid}:{kind}:{phase}",
                "ph": "i", "ts": float(ts) * 1e6,
                "pid": 0, "tid": 0, "s": "g",  # global-scope instant
                "args": {"remediation": rec, "phase": phase},
            })
    if device_workers:
        try:
            from .device import compile_trace_events

            events.extend(compile_trace_events(device_workers))
        except Exception:
            pass
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: Dict[str, Any]) -> bool:
    """Structural check used by tests/CLI: is this loadable trace JSON?"""
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        return False
    for ev in trace["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            return False
        if ev["ph"] == "X" and not ("ts" in ev and "dur" in ev):
            return False
    return True
