"""Driver-side cross-worker step aggregation + straggler detection.

``StepAggregator`` ingests each lockstep round's per-worker telemetry
records (every worker's ``session.report()`` already carries one — no
KV polling needed on the hot path), builds per-step views, and flags
stragglers: a worker whose *busy* time (step duration minus collective
sync) exceeds ``straggler_multiple`` × the gang median for
``straggler_sustain`` consecutive steps. Busy time is the right signal
because lockstep collectives equalize wall durations — fast ranks
absorb the slow rank's lag as collective wait, so raw step time can't
tell who is slow (arXiv:1909.09756's central diagnosis problem).

On detection the aggregator publishes a ``straggler_detected`` advisory
on the "train" pubsub topic (one per episode, reset when the worker
recovers) which also lands in the structured cluster event log.

The port's copy of ``ray_tpu/telemetry/aggregator.py``.
"""

from __future__ import annotations

import statistics
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .config import TelemetryConfig


def _default_publish(payload: Dict[str, Any]) -> None:
    from ray_tpu_torch._private import core as core_mod

    core = core_mod._current_core
    if core is None or getattr(core, "_shutdown", False):
        return
    core.control.call("publish", {"topic": "train", "payload": payload},
                      timeout=5.0)


class StepAggregator:
    def __init__(self, config: Optional[TelemetryConfig] = None,
                 trial: str = "",
                 publish: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.config = config or TelemetryConfig()
        self.trial = trial
        self._publish = publish or _default_publish
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=256)  # per-step merged views
        self._over: Dict[int, int] = {}          # rank -> consecutive count
        self._advised: set = set()               # ranks in an open episode
        self.advisories: List[Dict[str, Any]] = []
        self._rounds = 0

    def ingest_round(self,
                     per_worker: List[Optional[Dict[str, Any]]]) -> None:
        """One lockstep round: element i is worker i's step record (the
        dict ``StepTimer.step_end`` returned) or None."""
        recs = [r for r in per_worker if isinstance(r, dict) and "dur" in r]
        if not recs:
            return
        busy = {}
        for rec in recs:
            phases = rec.get("phases") or {}
            # only the parent "collective" phase is subtracted — dotted
            # sub-phases (collective.quantize/transfer/dequantize) are
            # nested inside it, not additional wait time
            busy[rec.get("rank", 0)] = max(
                0.0, rec["dur"] - phases.get("collective", 0.0))
        view = {
            "step": recs[0].get("step"),
            "workers": {rec.get("rank", 0): rec for rec in recs},
            "busy": busy,
        }
        to_publish = []
        with self._lock:
            self._rounds += 1
            self._recent.append(view)
            if len(busy) >= 2:
                median = statistics.median(busy.values())
                threshold = self.config.straggler_multiple * median
                for rank, b in busy.items():
                    if median > 0 and b > threshold:
                        self._over[rank] = self._over.get(rank, 0) + 1
                        if (self._over[rank] >=
                                self.config.straggler_sustain and
                                rank not in self._advised):
                            self._advised.add(rank)
                            adv = {
                                "event": "straggler_detected",
                                "trial": self.trial,
                                "rank": rank,
                                "step": view["step"],
                                "step_s": round(b, 6),
                                "median_s": round(median, 6),
                                "ratio": round(b / median, 3),
                                "sustained": self._over[rank],
                            }
                            self.advisories.append(adv)
                            to_publish.append(adv)
                    else:
                        self._over[rank] = 0
                        self._advised.discard(rank)  # episode closed
        for adv in to_publish:
            try:
                self._publish(adv)
            except Exception:
                pass
            try:
                from . import recorder
                from ..util import metrics as metrics_mod

                recorder._get_metric(
                    "straggler_ctr", lambda: metrics_mod.Counter(
                        "ray_tpu_train_stragglers_total",
                        description="straggler_detected advisories",
                        tag_keys=("trial",))
                ).inc(1, tags={"trial": self.trial})
            except Exception:
                pass

    def last_view(self) -> Optional[Dict[str, Any]]:
        """The most recent merged per-step view (step/workers/busy), or
        None before the first round — the RemediationEngine's per-round
        input."""
        with self._lock:
            return self._recent[-1] if self._recent else None

    def open_episodes(self) -> Dict[int, int]:
        """Ranks currently inside an advised straggler episode, mapped to
        their consecutive over-threshold round count.  The count keeps
        growing past ``straggler_sustain`` while the episode stays open —
        remediation hysteresis is built on that."""
        with self._lock:
            return {r: self._over.get(r, 0) for r in self._advised}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            views = list(self._recent)
            out: Dict[str, Any] = {
                "rounds": self._rounds,
                "advisories": list(self.advisories),
            }
        if views:
            last = views[-1]
            durs = [r["dur"] for r in last["workers"].values()]
            out["last_step"] = last["step"]
            out["last_step_max_s"] = round(max(durs), 6)
            out["last_step_median_s"] = round(statistics.median(durs), 6)
            # mean per-phase seconds across the gang, sub-phases included
            # — the dashboard's "where does a step go" line
            totals: Dict[str, float] = {}
            for rec in last["workers"].values():
                for name, secs in (rec.get("phases") or {}).items():
                    totals[name] = totals.get(name, 0.0) + secs
            n = max(1, len(last["workers"]))
            out["last_step_phase_means_s"] = {
                k: round(v / n, 6) for k, v in sorted(totals.items())}
        return out
