"""Distributed-trace reassembly and critical-path attribution.

The span collector (``util/tracing.py`` -> ``_private/control.py``)
stores every sampled trace as a JSON span list in the ``_tracing`` KV
namespace under ``trace:<trace_id>``.  This module turns that list back
into an analysis: the span tree, a critical-path breakdown that
attributes the trace's wall time to named phases (driver.stage_wait,
raylet.relay, worker.queue_wait, task.execute ... plus synthesized
``wire:a->b`` segments for uninstrumented inter-phase gaps), per-process
totals, and a Perfetto/Chrome trace-event export.

Served by ``python -m ray_tpu_torch trace <trace_id>`` / ``python -m ray_tpu_torch trace --summary``
and the dashboard's ``GET /api/traces/<id>``.

Attribution model: sweep the trace's wall-clock interval over the
elementary segments induced by all span boundaries; each segment is
charged to the *most specific* covering span (deepest in the tree,
latest-started on ties) so a ``worker.queue_wait`` child wins over the
enclosing ``task.execute``, which wins over the root ``task`` span.
Segments covered by no span become ``wire:<prev>-><next>`` — the
network/scheduling gap between the phase that ended and the phase that
started — so the breakdown always sums to the full wall time.

The port's copy of ``ray_tpu/telemetry/trace_assembly.py``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

KV_NS = "_tracing"
TRACE_KEY_PREFIX = "trace:"


# -- fetch -------------------------------------------------------------------

def normalize_trace_id(trace_id: str) -> str:
    """Accept ``0x``-prefixed / short-hex ids and return the canonical
    32-hex key form the collector stores under."""
    tid = trace_id.strip().lower()
    if tid.startswith("0x"):
        tid = tid[2:]
    try:
        return f"{int(tid, 16):032x}"
    except ValueError:
        return tid


def fetch_trace(control_client, trace_id: str,
                timeout: float = 10.0) -> List[Dict[str, Any]]:
    """Pull one trace's span list from the control KV (empty if absent
    or evicted)."""
    key = TRACE_KEY_PREFIX + normalize_trace_id(trace_id)
    raw = control_client.call("kv_get", {"ns": KV_NS, "key": key},
                              timeout=timeout)
    if not raw:
        return []
    try:
        spans = json.loads(raw.decode() if isinstance(raw, bytes) else raw)
    except Exception:
        return []
    return spans if isinstance(spans, list) else []


def list_trace_ids(control_client, timeout: float = 10.0) -> List[str]:
    """All trace ids currently in the collector's KV mirror."""
    try:
        keys = control_client.call(
            "kv_keys", {"ns": KV_NS, "prefix": TRACE_KEY_PREFIX},
            timeout=timeout)
    except Exception:
        return []
    return [k[len(TRACE_KEY_PREFIX):] for k in keys or []]


# -- assembly ----------------------------------------------------------------

def _usable(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out = []
    for s in spans:
        if s.get("start_ns") is None or s.get("end_ns") is None:
            continue
        if s["end_ns"] < s["start_ns"]:
            continue
        out.append(s)
    return out


def _depths(spans: List[Dict[str, Any]]) -> Dict[str, int]:
    """Tree depth per span id (roots and orphan parents are depth 0).
    Clock-skewed children are still *structurally* deeper than their
    parents, which is what specificity needs."""
    by_id = {s["span_id"]: s for s in spans}
    depth: Dict[str, int] = {}

    def resolve(sid: str) -> int:
        chain = []
        d: Optional[int] = None
        while sid is not None and sid not in depth:
            if sid in chain:        # defensive: a cycle would hang us
                d = 0
                break
            chain.append(sid)
            parent = by_id.get(sid, {}).get("parent_id")
            if parent is None or parent not in by_id:
                d = 0
                sid = None
            else:
                sid = parent
        if d is None:
            d = depth.get(sid, -1) + 1 if sid is not None else 0
        for c in reversed(chain):
            depth[c] = d
            d += 1
        return depth[chain[0]] if chain else depth.get(sid, 0)

    for s in spans:
        resolve(s["span_id"])
    return depth


def assemble(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Span list -> ordered tree summary: spans sorted by start time,
    each annotated with its depth, plus participating processes."""
    spans = sorted(_usable(spans), key=lambda s: (s["start_ns"],
                                                  s["end_ns"]))
    depth = _depths(spans)
    for s in spans:
        s["depth"] = depth.get(s["span_id"], 0)
    procs = sorted({s.get("proc", "?") for s in spans})
    return {
        "trace_id": spans[0]["trace_id"] if spans else None,
        "spans": spans,
        "span_count": len(spans),
        "procs": procs,
    }


# -- critical path -----------------------------------------------------------

def critical_path(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Attribute the trace's wall-clock interval to named phases.

    Returns ``{"wall_ns", "segments", "phases", "procs", "covered_ns",
    "coverage"}`` where ``segments`` is the merged sweep (each with
    name/proc/span_id/start_ns/end_ns), ``phases`` sums segment time per
    phase name (including ``wire:*`` gaps — the dict totals exactly
    ``wall_ns``), ``procs`` per process, and ``coverage`` is the span-
    covered (non-wire) fraction.
    """
    spans = _usable(spans)
    if not spans:
        return {"wall_ns": 0, "segments": [], "phases": {}, "procs": {},
                "covered_ns": 0, "coverage": 0.0}
    depth = _depths(spans)
    t0 = min(s["start_ns"] for s in spans)
    t1 = max(s["end_ns"] for s in spans)
    bounds = sorted({t0, t1} | {s["start_ns"] for s in spans}
                    | {s["end_ns"] for s in spans})
    # spans sorted by start for the sweep; ends for gap naming
    by_start = sorted(spans, key=lambda s: s["start_ns"])
    by_end = sorted(spans, key=lambda s: s["end_ns"])

    segments: List[Dict[str, Any]] = []
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        best = None
        best_key: Tuple[int, int] = (-1, -1)
        for s in by_start:
            if s["start_ns"] > a:
                break
            if s["end_ns"] < b:
                continue
            key = (depth.get(s["span_id"], 0), s["start_ns"])
            if key > best_key:
                best, best_key = s, key
        if best is not None:
            seg = {"start_ns": a, "end_ns": b, "name": best["name"],
                   "proc": best.get("proc", "?"),
                   "span_id": best["span_id"]}
        else:
            prev = next((s for s in reversed(by_end)
                         if s["end_ns"] <= a), None)
            nxt = next((s for s in by_start if s["start_ns"] >= b), None)
            seg = {"start_ns": a, "end_ns": b,
                   "name": "wire:%s->%s" % (
                       prev["name"] if prev else "start",
                       nxt["name"] if nxt else "end"),
                   "proc": "wire", "span_id": None}
        last = segments[-1] if segments else None
        if last is not None and last["span_id"] == seg["span_id"] \
                and last["name"] == seg["name"] \
                and last["end_ns"] == seg["start_ns"]:
            last["end_ns"] = seg["end_ns"]
        else:
            segments.append(seg)

    phases: Dict[str, int] = {}
    procs: Dict[str, int] = {}
    covered = 0
    for seg in segments:
        dur = seg["end_ns"] - seg["start_ns"]
        phases[seg["name"]] = phases.get(seg["name"], 0) + dur
        procs[seg["proc"]] = procs.get(seg["proc"], 0) + dur
        if seg["span_id"] is not None:
            covered += dur
    wall = t1 - t0
    return {
        "wall_ns": wall,
        "segments": segments,
        "phases": dict(sorted(phases.items(), key=lambda kv: -kv[1])),
        "procs": dict(sorted(procs.items(), key=lambda kv: -kv[1])),
        "covered_ns": covered,
        "coverage": (covered / wall) if wall else 0.0,
    }


def analyze(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One-call wrapper: tree + critical path for a span list."""
    tree = assemble(spans)
    tree["critical_path"] = critical_path(tree["spans"])
    return tree


def summarize(control_client, job_id: Optional[str] = None,
              limit: int = 200) -> Dict[str, Any]:
    """Aggregate phase attribution across every stored trace: mean wall
    time plus per-phase total/mean — the "where does a task's latency
    go, on average" answer for ``python -m ray_tpu_torch trace --summary``."""
    ids = list_trace_ids(control_client)[:limit]
    agg: Dict[str, Dict[str, float]] = {}
    walls: List[int] = []
    used = 0
    for tid in ids:
        spans = fetch_trace(control_client, tid)
        if job_id and not any(
                (s.get("attributes") or {}).get("job_id") == job_id
                or s.get("job_id") == job_id for s in spans):
            if job_id != "*":
                continue
        cp = critical_path(spans)
        if not cp["wall_ns"]:
            continue
        used += 1
        walls.append(cp["wall_ns"])
        for name, ns in cp["phases"].items():
            ent = agg.setdefault(name, {"total_ns": 0, "count": 0})
            ent["total_ns"] += ns
            ent["count"] += 1
    total_wall = sum(walls)
    for name, ent in agg.items():
        ent["mean_ns"] = ent["total_ns"] / ent["count"]
        ent["share"] = (ent["total_ns"] / total_wall) if total_wall else 0.0
    return {
        "traces": used,
        "mean_wall_ns": (total_wall / used) if used else 0,
        "phases": dict(sorted(agg.items(),
                              key=lambda kv: -kv[1]["total_ns"])),
    }


# -- export ------------------------------------------------------------------

def chrome_trace(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Span list -> Chrome trace-event JSON: one pid per process label
    ("M" process_name metadata), one "X" complete event per span with
    its attributes, nested per-depth tids so Perfetto stacks the tree."""
    spans = sorted(_usable(spans), key=lambda s: (s["start_ns"],
                                                  s["end_ns"]))
    depth = _depths(spans)
    pids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        proc = s.get("proc", "?")
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids)
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": proc}})
        events.append({
            "name": s["name"], "ph": "X",
            "ts": s["start_ns"] / 1e3,
            "dur": max((s["end_ns"] - s["start_ns"]) / 1e3, 0.001),
            "pid": pid, "tid": depth.get(s["span_id"], 0),
            "args": {
                "span_id": s["span_id"],
                "parent_id": s.get("parent_id"),
                "kind": s.get("kind"),
                **(s.get("attributes") or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- text rendering (CLI) ----------------------------------------------------

def _fmt_ns(ns: float) -> str:
    if ns >= 1e9:
        return f"{ns / 1e9:.3f}s"
    if ns >= 1e6:
        return f"{ns / 1e6:.2f}ms"
    return f"{ns / 1e3:.1f}us"


def render_text(analysis: Dict[str, Any]) -> str:
    """Human-readable trace report: span tree then the critical-path
    phase/process breakdown."""
    lines: List[str] = []
    spans = analysis.get("spans") or []
    cp = analysis.get("critical_path") or {}
    lines.append("trace %s  spans=%d  procs=%s  wall=%s" % (
        analysis.get("trace_id"), len(spans),
        ",".join(analysis.get("procs") or []),
        _fmt_ns(cp.get("wall_ns", 0))))
    t0 = min((s["start_ns"] for s in spans), default=0)
    for s in spans:
        lines.append("  %s%-8s %-38s %10s  +%s  [%s]" % (
            "  " * s.get("depth", 0), s.get("kind", "?"),
            s["name"][:38], _fmt_ns(s["end_ns"] - s["start_ns"]),
            _fmt_ns(s["start_ns"] - t0), s.get("proc", "?")))
    wall = cp.get("wall_ns") or 0
    if wall:
        lines.append("critical path (phase attribution):")
        for name, ns in (cp.get("phases") or {}).items():
            lines.append("  %-44s %10s  %5.1f%%" % (
                name[:44], _fmt_ns(ns), 100.0 * ns / wall))
        lines.append("by process:")
        for proc, ns in (cp.get("procs") or {}).items():
            lines.append("  %-44s %10s  %5.1f%%" % (
                proc, _fmt_ns(ns), 100.0 * ns / wall))
        lines.append("span coverage: %.1f%% (rest attributed to wire:*)"
                     % (100.0 * cp.get("coverage", 0.0)))
    return "\n".join(lines)


def render_summary_text(summary: Dict[str, Any]) -> str:
    lines = ["%d trace(s), mean wall %s" % (
        summary.get("traces", 0), _fmt_ns(summary.get("mean_wall_ns", 0)))]
    for name, ent in (summary.get("phases") or {}).items():
        lines.append("  %-44s total %10s  mean %10s  %5.1f%%" % (
            name[:44], _fmt_ns(ent["total_ns"]), _fmt_ns(ent["mean_ns"]),
            100.0 * ent.get("share", 0.0)))
    return "\n".join(lines)
