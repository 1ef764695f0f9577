"""Remediation: close the detect→act loop on failure-detection advisories.

The elastic subsystem and the flight recorder are the *detection*
stack — drain notices, straggler advisories, goodput accounting — and
without this module nothing acts on any of it: a
sustained straggler was a pubsub message and a Prometheus counter while
the gang's lockstep collectives dragged every rank to the slowest
worker's pace (the pod-scale goodput killer in the MLPerf TPU scaling
report, arXiv:1909.09756).  ``RemediationEngine`` turns those advisories
into actions under a policy that can never thrash a healthy cluster:

  hysteresis    — an open straggler episode must persist
                  ``remediation_confirm_rounds`` rounds *beyond* the
                  aggregator's own sustain threshold before any action,
                  so a transient GC pause or one slow input shard never
                  triggers a rebalance;
  rate limits   — at most ``remediation_max_episodes`` actions per run,
                  with ``remediation_cooldown_s`` between them, and one
                  open remediation at a time;
  advisory mode — the default.  The engine logs/publishes exactly what
                  it *would* do (a cause→action record with
                  ``dry_run=True``) and changes nothing; operators flip
                  ``ElasticConfig.remediation_mode="enforce"`` once the
                  recommendations look sane.

Every remediation is a cause→action→effect record: the cause is the
straggler advisory that tripped the policy, the action is the quarantine
+ elastic rebalance (node id, grace, post-shrink width), and the effect
is measured — the engine keeps watching post-action rounds and stamps
whether the gang's median busy time returned to within
``remediation_recover_tolerance`` of the pre-episode baseline.  Records
flow to the "train" pubsub topic, the structured cluster event log, and
control-plane KV (ns ``remediation``) where the flight-recorder timeline
(``chrome_trace``), ``GET /api/train/timeline`` and the
``python -m ray_tpu_torch remediations <job>`` CLI pick them up — the timeline shows
*why* the cluster changed shape, not just that it did.

The port's copy of ``ray_tpu/elastic/remediation.py`` (imports renamed).
"""

from __future__ import annotations

import json
import logging
import statistics
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

#: control-plane KV namespace for cause→action→effect logs, keyed by
#: trial name.  Deliberately NOT ns "train": the dashboard's /api/train
#: json-loads every key there as a run state.
REMEDIATION_NS = "remediation"

#: valid ElasticConfig.remediation_mode values
MODES = ("off", "advisory", "enforce")


def _default_publish(payload: Dict[str, Any]) -> None:
    from ray_tpu_torch._private import core as core_mod

    core = core_mod._current_core
    if core is None or getattr(core, "_shutdown", False):
        return
    core.control.call("publish", {"topic": "train", "payload": payload},
                      timeout=5.0)


def _default_control_call(method: str, payload: Dict[str, Any]) -> Any:
    from ray_tpu_torch._private import core as core_mod

    core = core_mod._current_core
    if core is None or getattr(core, "_shutdown", False):
        return None
    return core.control.call(method, payload, timeout=5.0)


def fetch_records(control_client, trial: str) -> List[Dict[str, Any]]:
    """Read a trial's cause→action→effect log back from control KV
    (the CLI / dashboard read side)."""
    try:
        raw = control_client.call(
            "kv_get", {"ns": REMEDIATION_NS, "key": trial}, timeout=10.0)
    except Exception:
        return []
    if not raw:
        return []
    try:
        recs = json.loads(raw)
        return recs if isinstance(recs, list) else []
    except Exception:
        return []


class RemediationEngine:
    """Driver-side policy engine; one per training run.

    The trainer calls ``observe_round(aggregator)`` once per lockstep
    round (after ``StepAggregator.ingest_round``).  The return value is
    an enforcement decision dict when the policy wants an action *this*
    round — the trainer then quarantines the rank's node through the
    executor, reports back via ``note_enforced``/``note_recovered``, and
    raises so the existing elastic-recovery path rebalances the gang.
    In advisory mode ``observe_round`` never returns a decision; it only
    records what it would have done.
    """

    def __init__(self, config, trial: str = "",
                 publish: Optional[Callable[[Dict[str, Any]], None]] = None,
                 control_call: Optional[Callable[[str, Dict], Any]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.mode = getattr(config, "remediation_mode", "advisory")
        if self.mode not in MODES:
            raise ValueError(f"remediation_mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        self.trial = trial
        self.confirm_rounds = int(
            getattr(config, "remediation_confirm_rounds", 2))
        self.cooldown_s = float(
            getattr(config, "remediation_cooldown_s", 30.0))
        self.max_episodes = int(
            getattr(config, "remediation_max_episodes", 2))
        self.quarantine_grace_s = float(
            getattr(config, "quarantine_grace_s", 600.0))
        self.effect_window = int(
            getattr(config, "remediation_effect_window", 3))
        self.recover_tolerance = float(
            getattr(config, "remediation_recover_tolerance", 0.15))
        self._sustain = None  # learned from the aggregator's config
        self._publish = publish or _default_publish
        self._control_call = control_call or _default_control_call
        self._clock = clock
        self._wall = wall
        #: completed + in-flight cause→action→effect records
        self.records: List[Dict[str, Any]] = []
        self.episodes = 0          # actions taken (enforce) or recommended
        self.actions_enforced = 0  # actions actually executed
        self._last_action_at: Optional[float] = None
        #: ranks already handled (recommended or enforced) in their
        #: CURRENT open episode — cleared when the episode closes, so a
        #: rank that recovers and degrades again is a fresh episode
        self._handled: set = set()
        #: rolling gang-median busy time over healthy rounds (the
        #: pre-episode baseline the effect measurement compares against)
        self._baseline: deque = deque(maxlen=32)
        #: in-flight effect watch: record + post-action medians
        self._watch: Optional[Dict[str, Any]] = None

    # -- the per-round hook ------------------------------------------------

    def observe_round(self, aggregator) -> Optional[Dict[str, Any]]:
        """Feed one lockstep round; returns an enforcement decision or
        None.  Never raises — remediation must not take down training."""
        try:
            return self._observe(aggregator)
        except Exception:
            logger.exception("remediation observe_round failed")
            return None

    def _observe(self, aggregator) -> Optional[Dict[str, Any]]:
        view = aggregator.last_view()
        if view is None:
            return None
        busy = view.get("busy") or {}
        open_eps = aggregator.open_episodes()
        if self._sustain is None:
            self._sustain = int(getattr(aggregator.config,
                                        "straggler_sustain", 3))
        # episode bookkeeping: a closed episode re-arms its rank
        self._handled &= set(open_eps)
        median = statistics.median(busy.values()) if busy else None
        if median is not None and not open_eps:
            self._baseline.append(median)
        self._feed_effect_watch(median, view.get("step"))
        if not open_eps:
            return None

        # hysteresis: the aggregator advises at `sustain` consecutive
        # over-threshold rounds; the policy acts only once the episode
        # has outlived that by confirm_rounds more.
        need = self._sustain + self.confirm_rounds
        ripe = {r: c for r, c in open_eps.items()
                if c >= need and r not in self._handled}
        if not ripe:
            return None
        # worst offender first; one action per round
        rank = max(ripe, key=lambda r: busy.get(r, 0.0))

        # rate limits apply to enforcement AND recommendations — a
        # dry-run that would have thrashed is exactly what advisory mode
        # exists to expose, so it must follow the same policy.
        now = self._clock()
        if self.episodes >= self.max_episodes:
            self._handled.add(rank)
            logger.warning(
                "remediation suppressed (rank %s, trial %s): episode "
                "budget %d exhausted", rank, self.trial, self.max_episodes)
            return None
        if (self._last_action_at is not None
                and now - self._last_action_at < self.cooldown_s):
            # not handled: re-evaluated next round, acts once cooled down
            return None
        if self._watch is not None:
            return None  # one remediation in flight at a time

        cause = self._cause_for(aggregator, rank)
        record = {
            "id": f"rem-{len(self.records)}",
            "trial": self.trial,
            "mode": self.mode,
            "ts": self._wall(),
            "cause": cause,
            "action": {
                "kind": ("quarantine_rebalance" if self.mode == "enforce"
                         else "recommend_quarantine"),
                "rank": rank,
                "dry_run": self.mode != "enforce",
                "grace_s": self.quarantine_grace_s,
                "confirmed_rounds": open_eps[rank],
                "ts": self._wall(),
            },
            "effect": None,
        }
        self.records.append(record)
        self.episodes += 1
        self._last_action_at = now
        self._handled.add(rank)
        baseline = (statistics.median(self._baseline)
                    if self._baseline else None)

        if self.mode != "enforce":
            logger.warning(
                "remediation (advisory): WOULD quarantine rank %d of trial "
                "%s (busy %.4fs vs gang median %.4fs) — set "
                "ElasticConfig.remediation_mode='enforce' to act",
                rank, self.trial, busy.get(rank, 0.0), median or 0.0)
            self._emit("remediation_recommended", record)
            self._flush()
            return None

        logger.warning(
            "remediation (enforce): quarantining rank %d of trial %s "
            "(busy %.4fs vs gang median %.4fs, episode open %d rounds)",
            rank, self.trial, busy.get(rank, 0.0), median or 0.0,
            open_eps[rank])
        self._watch = {"record": record, "baseline": baseline,
                       "post": [], "armed_at_step": view.get("step")}
        return {"rank": rank, "record": record,
                "reason": (f"sustained straggler: busy "
                           f"{busy.get(rank, 0.0):.4f}s vs gang median "
                           f"{(median or 0.0):.4f}s"),
                "grace_s": self.quarantine_grace_s}

    def observe_advisory(self, advisory: Dict[str, Any]) -> None:
        """Record a device-runtime advisory (``recompile_storm`` /
        ``memory_watermark`` from telemetry/device.py) as a cause-only
        record in advisory mode.  No enforcement action exists for
        these yet — the record puts the storm in the trial's
        cause→action→effect log, so the timeline and ``python -m ray_tpu_torch
        remediations`` answer "why did goodput dip here" when the
        answer is the device runtime, not a straggler.  Never raises."""
        try:
            kind = advisory.get("kind", "device")
            record = {
                "id": f"rem-{len(self.records)}",
                "trial": self.trial,
                "mode": self.mode,
                "ts": advisory.get("ts", self._wall()),
                "cause": dict(advisory),
                "action": {"kind": f"observe_{kind}", "dry_run": True,
                           "ts": self._wall()},
                "effect": None,
            }
            self.records.append(record)
            logger.warning(
                "remediation (advisory): device %s on trial %s recorded "
                "(program=%s)", kind, self.trial,
                advisory.get("program", "n/a"))
            self._emit("remediation_recommended", record)
            self._flush()
        except Exception:
            logger.exception("remediation observe_advisory failed")

    # -- enforcement feedback from the trainer -----------------------------

    def note_enforced(self, decision: Dict[str, Any],
                      node_id: Optional[str]) -> None:
        """The trainer quarantined the node: finalize + publish the
        action half of the record."""
        record = decision["record"]
        record["action"]["node_id"] = node_id
        self.actions_enforced += 1
        self._emit("remediation", record, phase="action")
        self._record_cluster_event(
            "WARNING", "remediation_action",
            f"trial {self.trial}: quarantined rank "
            f"{record['action']['rank']} (node {str(node_id)[:12]}) for "
            f"sustained straggling; rebalancing gang", record)
        self._flush()

    def note_recovered(self, new_world: int, step: int) -> None:
        """Elastic recovery after the quarantine finished: stamp the
        post-rebalance shape on the open action."""
        if self._watch is None:
            return
        record = self._watch["record"]
        record["action"]["new_world"] = new_world
        record["action"]["resume_step"] = step
        self._flush()

    # -- effect measurement ------------------------------------------------

    def _feed_effect_watch(self, median: Optional[float],
                           step: Optional[int]) -> None:
        if self._watch is None or median is None:
            return
        # only post-rebalance rounds count (the action sets new_world
        # when recovery completes; rounds before that are the old gang)
        if "new_world" not in self._watch["record"]["action"]:
            return
        self._watch["post"].append(median)
        if len(self._watch["post"]) < self.effect_window:
            return
        record = self._watch["record"]
        post = statistics.median(self._watch["post"])
        baseline = self._watch["baseline"]
        recovered = (baseline is not None
                     and post <= (1.0 + self.recover_tolerance) * baseline)
        record["effect"] = {
            "baseline_busy_s": (round(baseline, 6)
                                if baseline is not None else None),
            "post_busy_s": round(post, 6),
            "tolerance": self.recover_tolerance,
            "measured_rounds": len(self._watch["post"]),
            "recovered": bool(recovered),
            "ts": self._wall(),
        }
        self._watch = None
        logger.warning(
            "remediation effect (trial %s): gang median busy %.4fs vs "
            "pre-episode baseline %s -> %s", self.trial, post,
            f"{baseline:.4f}s" if baseline is not None else "n/a",
            "recovered" if recovered else "NOT recovered")
        self._emit("remediation", record, phase="effect")
        self._record_cluster_event(
            "INFO" if recovered else "WARNING", "remediation_effect",
            f"trial {self.trial}: post-remediation gang median busy "
            f"{post:.4f}s ({'within' if recovered else 'OUTSIDE'} "
            f"{self.recover_tolerance:.0%} of baseline)", record)
        self._flush()

    # -- plumbing ----------------------------------------------------------

    def _cause_for(self, aggregator, rank: int) -> Dict[str, Any]:
        for adv in reversed(aggregator.advisories):
            if adv.get("rank") == rank:
                return dict(adv)
        return {"event": "straggler_detected", "trial": self.trial,
                "rank": rank}

    def _emit(self, event: str, record: Dict[str, Any],
              phase: Optional[str] = None) -> None:
        payload = {"event": event, "trial": self.trial, **record}
        if phase is not None:
            payload["phase"] = phase
        try:
            self._publish(payload)
        except Exception:
            pass

    def _record_cluster_event(self, severity: str, event_type: str,
                              message: str,
                              record: Dict[str, Any]) -> None:
        try:
            self._control_call("report_event", {
                "severity": severity, "source": "remediation",
                "event_type": event_type, "entity_id": self.trial,
                "message": message, "custom": {"record_id": record["id"]},
            })
        except Exception:
            pass

    def _flush(self) -> None:
        """Persist the full log to control KV so the CLI/timeline can
        read it after the run (advisory, never fails training)."""
        try:
            self._control_call("kv_put", {
                "ns": REMEDIATION_NS, "key": self.trial,
                "val": json.dumps(self.records).encode(),
            })
        except Exception:
            pass

    def summary(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "episodes": self.episodes,
            "enforced": self.actions_enforced,
            "records": list(self.records),
        }
