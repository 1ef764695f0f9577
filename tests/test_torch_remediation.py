"""Self-healing remediation on the port: the cases of
tests/test_remediation.py against ``ray_tpu_torch.elastic.remediation``
and the port's trainer, control plane and collectives.

Covers the policy engine (hysteresis past the detector's sustain
threshold, per-run episode budget + cooldown rate limits, advisory
dry-run vs enforce), goodput-predicted width selection
(IncarnationHistory / predict_rate / choose_width), preemption-notice
debouncing, the control plane's quarantine lifecycle, the
destroy_collective_group fin-marker timeout, the Chrome-trace
remediation markers + CLI, and the acceptance scenario end to
end: a sustained rank-1 straggler under ``remediation_mode="enforce"``
triggers exactly one quarantine+rebalance episode whose measured effect
shows the gang recovered — and the identical scenario under the default
advisory mode records the recommendation but changes nothing.

The reference's race between a self-posted drain and the quarantine
decision (``test_quarantine_on_draining_node_shrinks_once``) is not
copied: here the drain lands on the victim's node at the moment the
quarantine is decided, and the test waits (with a deadline) until the
trainer has seen it, so the quarantine always meets a draining node.
Every wait polls with a deadline.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.elastic import ElasticConfig
from ray_tpu_torch.elastic.preemption import FakePreemptionSource, PreemptionWatcher
from ray_tpu_torch.elastic.remediation import (REMEDIATION_NS, RemediationEngine,
                                         fetch_records)
from ray_tpu_torch.elastic.resume import (IncarnationHistory, choose_width,
                                    predict_rate)
from ray_tpu_torch.telemetry import StepAggregator, TelemetryConfig
from ray_tpu_torch.telemetry.timeline import (chrome_trace, collect_remediations,
                                        collect_snapshots,
                                        validate_chrome_trace)
from ray_tpu_torch.train import JaxConfig, RunConfig, ScalingConfig


@pytest.fixture(scope="module")
def ray_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def private_cluster_slot():
    """The test connects this process to a cluster of its own: a module
    cluster that is up is shut down for it and started again after."""
    was = ray_tpu_torch.is_initialized()
    ray_tpu_torch.shutdown()
    yield
    ray_tpu_torch.shutdown()
    if was:
        ray_tpu_torch.init(num_cpus=4)


@pytest.fixture
def multi_node_cluster():
    from ray_tpu_torch._private.bootstrap import Cluster

    clusters = []

    def make():
        c = Cluster()
        c.start_control()
        clusters.append(c)
        return c

    yield make
    for c in clusters:
        c.shutdown()


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_ledger():
    """Trainers here drain the process's program ledger into their
    remediation engines: start and leave it fresh."""
    from ray_tpu_torch.telemetry import device as devtel

    devtel.reset_for_tests()
    yield
    devtel.reset_for_tests()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _round(busy_by_rank, step=0):
    """Fabricate one lockstep round of step records (collective=0)."""
    return [{"step": step, "ts": 0.0, "dur": b, "phases": {"compute": b},
             "rank": r, "incarnation": 0}
            for r, b in sorted(busy_by_rank.items())]


def _mk(mode="advisory", confirm=1, cooldown=0.0, max_eps=2,
        effect_window=2, tol=0.15, sustain=2, clock=None):
    """A RemediationEngine over a real StepAggregator with captured
    publish/control channels."""
    cfg = ElasticConfig(remediation_mode=mode,
                        remediation_confirm_rounds=confirm,
                        remediation_cooldown_s=cooldown,
                        remediation_max_episodes=max_eps,
                        remediation_effect_window=effect_window,
                        remediation_recover_tolerance=tol)
    agg = StepAggregator(TelemetryConfig(straggler_multiple=2.0,
                                         straggler_sustain=sustain),
                         trial="t", publish=lambda p: None)
    pub, calls = [], []
    eng = RemediationEngine(
        cfg, trial="t", publish=pub.append,
        control_call=lambda m, p: calls.append((m, p)),
        clock=clock or time.monotonic)
    return eng, agg, pub, calls


# ---------------------------------------------------------------------------
# Policy engine units
# ---------------------------------------------------------------------------


def test_advisory_hysteresis_then_dry_run_record():
    # sustain=2 detector + confirm=2 policy => nothing until the episode
    # has been open 4 consecutive rounds
    eng, agg, pub, calls = _mk(mode="advisory", confirm=2)
    for i in range(3):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=i))
        assert eng.observe_round(agg) is None
        assert eng.records == []  # detector advised at round 2; policy waits
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=3))
    assert eng.observe_round(agg) is None  # advisory NEVER returns a decision
    assert len(eng.records) == 1
    rec = eng.records[0]
    assert rec["action"]["kind"] == "recommend_quarantine"
    assert rec["action"]["dry_run"] is True
    assert rec["action"]["rank"] == 2
    assert rec["cause"]["event"] == "straggler_detected"
    assert rec["effect"] is None
    assert [p["event"] for p in pub] == ["remediation_recommended"]
    # persisted to control KV under the remediation namespace
    puts = [p for m, p in calls if m == "kv_put"]
    assert puts and puts[-1]["ns"] == REMEDIATION_NS
    assert json.loads(puts[-1]["val"])[0]["id"] == rec["id"]
    # the same open episode is never re-recommended
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=4))
    assert eng.observe_round(agg) is None
    assert len(eng.records) == 1


def test_transient_straggler_never_triggers():
    # the detector advises (sustain reached) but the rank recovers before
    # the policy's confirm window closes: no record, no publish
    eng, agg, pub, _ = _mk(mode="enforce", confirm=2)
    for i in range(3):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=i))
        assert eng.observe_round(agg) is None
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.1}, step=3))  # recovered
    assert eng.observe_round(agg) is None
    assert eng.records == [] and pub == [] and len(agg.advisories) == 1


def test_enforce_decision_effect_recovered():
    eng, agg, pub, calls = _mk(mode="enforce", confirm=1, effect_window=2)
    # healthy rounds build the baseline the effect is judged against
    for i in range(3):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.1}, step=i))
        assert eng.observe_round(agg) is None
    decision = None
    for i in range(3, 6):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=i))
        decision = eng.observe_round(agg) or decision
    assert decision is not None and decision["rank"] == 2
    assert "straggler" in decision["reason"]
    eng.note_enforced(decision, node_id="node-abc123")
    rec = eng.records[0]
    assert rec["action"]["node_id"] == "node-abc123"
    assert rec["action"]["dry_run"] is False
    assert [p for p in pub if p.get("phase") == "action"]
    evs = [p for m, p in calls if m == "report_event"]
    assert evs and evs[0]["source"] == "remediation"
    # post-rebalance rounds before note_recovered must NOT count
    agg.ingest_round(_round({0: 0.1, 1: 0.1}, step=6))
    assert eng.observe_round(agg) is None
    assert eng.records[0]["effect"] is None
    eng.note_recovered(new_world=2, step=6)
    assert rec["action"]["new_world"] == 2
    for i in range(7, 9):
        agg.ingest_round(_round({0: 0.1, 1: 0.1}, step=i))
        eng.observe_round(agg)
    eff = eng.records[0]["effect"]
    assert eff is not None and eff["recovered"] is True
    assert eff["measured_rounds"] == 2
    assert eff["post_busy_s"] == pytest.approx(0.1)
    assert eff["baseline_busy_s"] == pytest.approx(0.1)
    assert [p for p in pub if p.get("phase") == "effect"]
    s = eng.summary()
    assert s["episodes"] == 1 and s["enforced"] == 1


def test_effect_not_recovered_when_still_slow():
    eng, agg, _, _ = _mk(mode="enforce", confirm=0, effect_window=2)
    for i in range(3):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.1}, step=i))
        eng.observe_round(agg)
    decision = None
    for i in range(3, 5):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=i))
        decision = eng.observe_round(agg) or decision
    eng.note_enforced(decision, node_id="n1")
    eng.note_recovered(new_world=2, step=5)
    for i in range(5, 7):  # the remaining gang is STILL degraded
        agg.ingest_round(_round({0: 0.3, 1: 0.3}, step=i))
        eng.observe_round(agg)
    eff = eng.records[0]["effect"]
    assert eff is not None and eff["recovered"] is False


def test_rate_limit_episode_budget():
    eng, agg, _, _ = _mk(mode="advisory", confirm=0, max_eps=1)
    for i in range(3):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=i))
        eng.observe_round(agg)
    assert len(eng.records) == 1
    # episode closes, a NEW sustained episode opens: budget exhausted
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.1}, step=3))
    eng.observe_round(agg)
    for i in range(4, 8):
        agg.ingest_round(_round({0: 0.1, 1: 0.5, 2: 0.1}, step=i))
        eng.observe_round(agg)
    assert len(eng.records) == 1 and eng.episodes == 1


def test_rate_limit_cooldown_defers_until_elapsed():
    clk = FakeClock()
    eng, agg, _, _ = _mk(mode="advisory", confirm=0, cooldown=30.0,
                         max_eps=5, clock=clk)
    for i in range(2):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=i))
        eng.observe_round(agg)
    assert len(eng.records) == 1
    # close episode 1, open a new one on another rank inside the cooldown
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.1}, step=2))
    eng.observe_round(agg)
    for i in range(3, 6):
        agg.ingest_round(_round({0: 0.1, 1: 0.5, 2: 0.1}, step=i))
        eng.observe_round(agg)
    assert len(eng.records) == 1  # suppressed by cooldown, NOT dropped
    clk.advance(31.0)
    agg.ingest_round(_round({0: 0.1, 1: 0.5, 2: 0.1}, step=6))
    eng.observe_round(agg)
    assert len(eng.records) == 2  # same still-open episode acts post-cooldown
    assert eng.records[1]["action"]["rank"] == 1


def test_one_remediation_in_flight_at_a_time():
    eng, agg, _, _ = _mk(mode="enforce", confirm=0, effect_window=4)
    for i in range(2):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}, step=i))
    decision = eng.observe_round(agg)
    assert decision is not None
    eng.note_enforced(decision, "n1")
    eng.note_recovered(2, step=2)
    # effect watch still open (needs 4 rounds): a fresh episode must wait
    for i in range(3, 6):
        agg.ingest_round(_round({0: 0.1, 1: 0.5}, step=i))
        assert eng.observe_round(agg) is None
    assert len(eng.records) == 1


def test_observe_round_never_raises():
    cfg = ElasticConfig()
    eng = RemediationEngine(cfg, trial="t", publish=lambda p: None,
                            control_call=lambda m, p: None)
    assert eng.observe_round(object()) is None  # not an aggregator at all


def test_engine_rejects_unknown_mode():
    with pytest.raises(ValueError):
        RemediationEngine(SimpleNamespace(remediation_mode="yolo"))
    with pytest.raises(ValueError):
        ElasticConfig(remediation_mode="yolo")
    with pytest.raises(ValueError):
        ElasticConfig(remediation_recover_tolerance=1.5)
    with pytest.raises(ValueError):
        ElasticConfig(remediation_effect_window=0)


def test_fetch_records_roundtrip_and_garbage():
    class FakeControl:
        def __init__(self, raw):
            self.raw = raw

        def call(self, method, payload, timeout=None):
            assert method == "kv_get" and payload["ns"] == REMEDIATION_NS
            return self.raw

    recs = [{"id": "rem-0", "cause": {}, "action": {}, "effect": None}]
    assert fetch_records(FakeControl(json.dumps(recs).encode()), "t") == recs
    assert fetch_records(FakeControl(None), "t") == []
    assert fetch_records(FakeControl(b"not json"), "t") == []
    assert fetch_records(FakeControl(b'{"a": 1}'), "t") == []  # not a list


# ---------------------------------------------------------------------------
# Goodput-predicted width selection
# ---------------------------------------------------------------------------


def test_incarnation_history_records_rates():
    h = IncarnationHistory()
    h.begin(0, width=3, rounds=0, now=0.0)
    h.begin(1, width=2, rounds=3, now=30.0)  # auto-closes incarnation 0
    h.end(rounds=9, now=60.0)
    recs = h.records()
    assert [r["width"] for r in recs] == [3, 2]
    assert recs[0]["rounds"] == 3 and recs[0]["rate"] == pytest.approx(0.1)
    assert recs[1]["rounds"] == 6 and recs[1]["rate"] == pytest.approx(0.2)
    h.end(rounds=99, now=99.0)  # nothing open: a no-op
    assert len(h.records()) == 2


def test_predict_rate_exact_mean_and_linear_extrapolation():
    recs = [{"width": 2, "rounds": 6, "rate": 0.2},
            {"width": 2, "rounds": 6, "rate": 0.4}]
    assert predict_rate(2, recs) == pytest.approx(0.3)
    assert predict_rate(4, recs) == pytest.approx(0.6)  # linear in width
    assert predict_rate(1, recs) == pytest.approx(0.15)
    assert predict_rate(3, []) is None
    assert predict_rate(3, [{"width": 2, "rounds": 0, "rate": 0.0}]) is None


def test_choose_width_prefers_predicted_goodput_over_largest():
    # the MLPerf trap: the widest gang kept collapsing, so its EFFECTIVE
    # rate (recovery churn included) is below the narrower stable gang's
    h = IncarnationHistory()
    h.begin(0, width=3, rounds=0, now=0.0)
    h.end(rounds=3, now=30.0)     # width 3: 0.1 rounds/s (kept dying)
    h.begin(1, width=2, rounds=3, now=30.0)
    h.end(rounds=9, now=60.0)     # width 2: 0.2 rounds/s (stable)
    assert choose_width(3, min_workers=1, history=h) == 2
    # no usable history degrades to largest feasible
    assert choose_width(3, min_workers=1) == 3
    assert choose_width(3, min_workers=1, history=IncarnationHistory()) == 3
    # a single candidate short-circuits
    assert choose_width(2, min_workers=2, history=h) == 2


def test_choose_width_tie_goes_wider_and_respects_replica_unit():
    h = IncarnationHistory()
    h.begin(0, width=1, rounds=0, now=0.0)
    h.end(rounds=2, now=10.0)   # width 1: 0.2
    h.begin(1, width=2, rounds=2, now=10.0)
    h.end(rounds=4, now=20.0)   # width 2: 0.2 -> tie, wider wins
    assert choose_width(2, min_workers=1, history=h) == 2
    # whole model replicas only: unit 2 => candidates 2 and 4
    h2 = IncarnationHistory()
    h2.begin(0, width=4, rounds=0, now=0.0)
    h2.end(rounds=1, now=100.0)  # width 4: 0.01
    h2.begin(1, width=2, rounds=1, now=100.0)
    h2.end(rounds=11, now=200.0)  # width 2: 0.1
    assert choose_width(5, min_workers=2, workers_per_replica=2,
                        history=h2) == 2


# ---------------------------------------------------------------------------
# Preemption-notice debouncing
# ---------------------------------------------------------------------------


def test_preemption_debounce_swallow_flap_inside_window():
    fired, clk = [], FakeClock()
    src = FakePreemptionSource()
    w = PreemptionWatcher(src, fired.append, debounce_s=5.0, clock=clk)
    src.trigger("drain-1")
    assert w.poll_once() is True and len(fired) == 1
    src.clear()
    assert w.poll_once() is False  # re-armed
    clk.advance(1.0)
    src.trigger("drain-2")  # the flap: re-trigger inside the window
    assert w.poll_once() is False
    assert w.notices_suppressed == 1
    src.clear()  # ...and it clears inside the window too
    assert w.poll_once() is False
    clk.advance(10.0)
    assert w.poll_once() is False  # nothing pending: the flap never re-fires
    assert len(fired) == 1 and w.notices_fired == 1


def test_preemption_debounce_pending_notice_fires_after_window():
    fired, clk = [], FakeClock()
    src = FakePreemptionSource()
    w = PreemptionWatcher(src, fired.append, debounce_s=5.0, clock=clk)
    src.trigger()
    assert w.poll_once() is True
    src.clear()
    w.poll_once()
    clk.advance(1.0)
    src.trigger()  # a REAL second notice, just early
    assert w.poll_once() is False and w.notices_suppressed == 1
    clk.advance(1.0)
    assert w.poll_once() is False  # still held, still inside the window
    clk.advance(4.0)  # past the window now
    assert w.poll_once() is True  # delayed, never lost
    assert len(fired) == 2


def test_preemption_debounce_zero_keeps_edge_semantics():
    fired = []
    src = FakePreemptionSource()
    w = PreemptionWatcher(src, fired.append)  # debounce_s defaults to 0
    src.trigger()
    assert w.poll_once() is True
    assert w.poll_once() is False  # level-held: one edge, one callback
    src.clear()
    w.poll_once()
    src.trigger()
    assert w.poll_once() is True  # immediate re-fire: no window
    assert len(fired) == 2


# ---------------------------------------------------------------------------
# Scheduler avoidance ordering (pure unit over the control plane helper)
# ---------------------------------------------------------------------------


def test_prefer_untainted_then_quarantined_then_draining():
    from ray_tpu_torch._private.control import ControlServer

    fresh = SimpleNamespace(draining_until=None, quarantined_until=None)
    quar = SimpleNamespace(draining_until=None, quarantined_until=1.0)
    drain = SimpleNamespace(draining_until=1.0, quarantined_until=None)
    pick = ControlServer._prefer_not_draining
    assert pick([drain, quar, fresh]) == [fresh]
    # no untainted node: a benched-but-staying node beats a disappearing one
    assert pick([drain, quar]) == [quar]
    assert pick([drain]) == [drain]  # last resort: still better than nowhere
    assert pick([]) == []


# ---------------------------------------------------------------------------
# Chrome-trace remediation markers (pure unit)
# ---------------------------------------------------------------------------


def test_chrome_trace_remediation_instant_events_validate():
    snaps = [{"trial": "t", "rank": 0, "incarnation": 0, "ring_size": 8,
              "steps": [{"step": 1, "ts": 100.0, "dur": 0.5,
                         "phases": {"compute": 0.5}, "rank": 0,
                         "incarnation": 0}]}]
    rems = [{"id": "rem-0", "ts": 100.2,
             "cause": {"rank": 1},
             "action": {"kind": "quarantine_rebalance", "ts": 100.3},
             "effect": {"recovered": True, "ts": 101.0}}]
    trace = chrome_trace(snaps, remediations=rems)
    assert validate_chrome_trace(trace)
    marks = [e for e in trace["traceEvents"] if e["ph"] == "i"]
    assert len(marks) == 3  # cause + action + effect
    assert {e["args"]["phase"] for e in marks} == {"cause", "action",
                                                  "effect"}
    assert all(e["name"].startswith("rem-0:quarantine_rebalance")
               for e in marks)
    assert marks[0]["ts"] == pytest.approx(100.2e6)
    # records missing timestamps degrade to fewer marks, never invalid
    trace2 = chrome_trace(snaps, remediations=[{"id": "x", "action": {}}])
    assert validate_chrome_trace(trace2)
    assert [e for e in trace2["traceEvents"] if e["ph"] == "i"] == []


# ---------------------------------------------------------------------------
# Control-plane quarantine lifecycle + collective teardown timeout
# ---------------------------------------------------------------------------


def test_quarantine_lifecycle_view_events_expiry(private_cluster_slot,
                                                 multi_node_cluster):
    from ray_tpu_torch._private.api import current_core

    c = multi_node_cluster()
    c.add_node(resources={"CPU": 1})
    c.add_node(resources={"CPU": 1})
    host, port = c.control_addr
    ray_tpu_torch.init(address=f"{host}:{port}")
    core = current_core()
    events = []
    core.add_push_handler("pub:node", events.append)
    core.control.call("subscribe", {"topics": ["node"]}, timeout=10.0)

    def node_view(nid):
        return next(n for n in core.control.call("get_nodes", {},
                                                 timeout=10.0)
                    if n["node_id"] == nid)

    nid = core.control.call("get_nodes", {}, timeout=10.0)[0]["node_id"]
    r = core.control.call("report_quarantine", {
        "node_id": nid, "grace_s": 1.0, "reason": "test-bench"},
        timeout=10.0)
    assert r["ok"]
    v = node_view(nid)
    assert v["quarantined"] and v["quarantine_reason"] == "test-bench"
    assert 0.0 < v["quarantine_remaining_s"] <= 1.0
    assert v["state"] == "ALIVE"  # benched, not dead

    # the health loop clears it at the deadline (no death-timeout margin)
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline and node_view(nid)["quarantined"]:
        time.sleep(0.1)
    assert not node_view(nid)["quarantined"]

    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        evs = [e.get("event") for e in events]
        if "quarantined" in evs and "quarantine_cleared" in evs:
            break
        time.sleep(0.05)
    evs = [e.get("event") for e in events]
    assert "quarantined" in evs and "quarantine_cleared" in evs

    # explicit cancel clears immediately; unknown nodes are refused
    core.control.call("report_quarantine", {
        "node_id": nid, "grace_s": 600.0}, timeout=10.0)
    assert node_view(nid)["quarantined"]
    core.control.call("report_quarantine", {
        "node_id": nid, "cancel": True}, timeout=10.0)
    assert not node_view(nid)["quarantined"]
    r = core.control.call("report_quarantine", {"node_id": "nope"},
                          timeout=10.0)
    assert not r["ok"]


def _kv_handle(name, world):
    from ray_tpu_torch.collective import collective as cmod

    return cmod.GroupHandle(name, world, 0, "kv", None, torch.device("cpu"),
                            False)


def test_destroy_collective_group_timeout_names_missing_ranks(ray_cluster):
    from ray_tpu_torch.collective import collective as cmod

    cmod._groups["remfin"] = _kv_handle("remfin", 3)
    with pytest.raises(cmod.CollectiveTeardownTimeout) as ei:
        cmod.destroy_collective_group("remfin", timeout=0.3)
    msg = str(ei.value)
    assert "remfin" in msg and "[1, 2]" in msg and "world 3" in msg
    assert "fin markers" in msg

    # default (no timeout) keeps the non-blocking early-leave contract
    cmod._groups["remfin2"] = _kv_handle("remfin2", 2)
    t0 = time.monotonic()
    cmod.destroy_collective_group("remfin2")
    assert time.monotonic() - t0 < 1.0

    # a late fin inside the timeout completes the sweep instead of raising
    cmod._groups["remfin3"] = _kv_handle("remfin3", 2)

    def late_fin():
        time.sleep(0.2)
        cmod._kv_put("remfin3/fin/1", b"1")

    threading.Thread(target=late_fin, daemon=True).start()
    cmod.destroy_collective_group("remfin3", timeout=10.0)
    assert not cmod._kv().call(
        "kv_exists", {"ns": "collective", "key": "remfin3/fin/0"})


# ---------------------------------------------------------------------------
# The acceptance scenario: detect -> act -> measure, end to end
# ---------------------------------------------------------------------------


def _selfheal_loop(config):
    """Elastic toy loop with a sustained rank-1 straggler gated on the
    full-width gang: quarantining rank 1's node and rebalancing to width
    2 removes the slow host, so post-remediation step time recovers."""
    from ray_tpu_torch import collective, elastic, telemetry
    from ray_tpu_torch import train as _train
    from ray_tpu_torch.elastic.emergency import EmergencyCheckpoint as _EC

    ctx = _train.get_context()
    G = ctx.extra["global_batch_size"]
    pb = ctx.extra["per_replica_batch"]
    off = ctx.extra["batch_offset"]
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]

    state = {"w": 1.0, "step": 0}
    ck = _train.get_checkpoint()
    if isinstance(ck, _EC):
        state = dict(max(ck.load(), key=lambda s: s["step"]))

    while state["step"] < config["steps"]:
        t = state["step"]
        with telemetry.phase("data"):
            idx = np.arange(off, off + pb, dtype=np.float64)
            time.sleep(0.05)  # uniform base work: a stable busy median
            if ctx.get_world_rank() == 1 and ctx.get_world_size() == 3:
                time.sleep(0.15)  # the sustained straggler
        gsum = float(np.sum(np.sin(idx + t) * state["w"] + idx * 0.01))
        total = collective.allreduce(torch.tensor([gsum],
                                                  dtype=torch.float64),
                                     group_name=group)
        state = {"w": state["w"] - 0.1 * float(total[0]) / G,
                 "step": t + 1}
        elastic.snapshot(state, state["step"])
        assert elastic.wait_replicated(20.0)
        _train.report({"step": state["step"], "w": state["w"],
                       "world_size": ctx.get_world_size()})


def _selfheal_cluster(multi_node_cluster):
    from ray_tpu_torch._private.api import current_core

    c = multi_node_cluster()
    for _ in range(3):
        c.add_node(resources={"CPU": 1})
    host, port = c.control_addr
    ray_tpu_torch.init(address=f"{host}:{port}")
    core = current_core()
    events = []
    core.add_push_handler("pub:train", events.append)
    core.control.call("subscribe", {"topics": ["train"]}, timeout=10.0)
    return core, events, f"{host}:{port}"


def test_remediation_enforce_end_to_end(private_cluster_slot,
                                        multi_node_cluster, tmp_path,
                                        capsys):
    STEPS, G = 18, 12
    core, events, address = _selfheal_cluster(multi_node_cluster)
    trainer = train.JaxTrainer(
        _selfheal_loop, train_loop_config={"steps": STEPS},
        backend_config=JaxConfig(
            mode="local",
            elastic=ElasticConfig(
                min_workers=2, replication_factor=1, global_batch_size=G,
                recover_timeout_s=5.0,
                remediation_mode="enforce",
                remediation_confirm_rounds=1,
                remediation_cooldown_s=5.0,
                remediation_max_episodes=2,
                remediation_effect_window=3),
            telemetry=TelemetryConfig(flush_interval_s=0.0,
                                      straggler_multiple=2.0,
                                      straggler_sustain=2)),
        scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(name="selfheal", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == STEPS
    trial = "selfheal_00000"

    # exactly ONE remediation episode — the rate limit forbids thrash
    records = fetch_records(core.control, trial)
    assert len(records) == 1, records
    rec = records[0]
    assert rec["mode"] == "enforce"
    assert rec["cause"]["event"] == "straggler_detected"
    assert rec["cause"]["rank"] == 1
    act = rec["action"]
    assert act["kind"] == "quarantine_rebalance" and not act["dry_run"]
    assert act["rank"] == 1 and act["node_id"]
    assert act["new_world"] == 2

    # the action really happened: gang shrank, the node is benched
    assert result.metrics["world_size"] == 2
    qnodes = [n for n in core.control.call("get_nodes", {}, timeout=10.0)
              if n.get("quarantined")]
    assert [n["node_id"] for n in qnodes] == [act["node_id"]]
    assert qnodes[0]["state"] == "ALIVE"

    # measured effect: post-remediation steady state recovered to within
    # tolerance of the pre-injection gang median
    eff = rec["effect"]
    assert eff is not None, rec
    assert eff["recovered"] is True, eff
    assert eff["post_busy_s"] <= (1.0 + eff["tolerance"]) \
        * eff["baseline_busy_s"]

    # cause->action->effect flowed over pubsub for live consumers
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        phases = {e.get("phase") for e in events
                  if e.get("event") == "remediation"}
        if {"action", "effect"} <= phases:
            break
        time.sleep(0.05)
    assert {"action", "effect"} <= {e.get("phase") for e in events
                                    if e.get("event") == "remediation"}

    # the run state the dashboard shows carries the remediation summary
    raw = core.control.call("kv_get", {"ns": "train", "key": trial},
                            timeout=10.0)
    tele = json.loads(raw)["telemetry"]
    assert tele["remediations"]["mode"] == "enforce"
    assert tele["remediations"]["episodes"] == 1
    assert tele["remediations"]["enforced"] == 1

    # the flight-recorder timeline shows WHY the cluster changed shape
    snaps = collect_snapshots(core.control, trial=trial)
    rems = collect_remediations(core.control, trial=trial)
    assert len(rems) == 1
    trace = chrome_trace(snaps, remediations=rems)
    assert validate_chrome_trace(trace)
    marks = [e for e in trace["traceEvents"] if e["ph"] == "i"]
    assert {e["args"]["phase"] for e in marks} == {"cause", "action",
                                                  "effect"}

    # the structured cluster event log has the remediation entries
    evlog = core.control.call("list_events", {"source": "remediation",
                                              "limit": 50}, timeout=10.0)
    types = {e["event_type"] for e in evlog}
    assert {"quarantined", "remediation_action",
            "remediation_effect"} <= types

    # and the CLI renders the cause->action->effect log
    from ray_tpu_torch.scripts.cli import main as cli_main

    cli_main(["remediations", trial, "--address", address])
    out = capsys.readouterr().out
    assert "quarantine_rebalance" in out and "recovered" in out
    cli_main(["remediations", trial, "--address", address,
              "--format", "json"])
    out = capsys.readouterr().out
    assert json.loads(out)[0]["id"] == rec["id"]


def test_remediation_advisory_records_but_changes_nothing(
        private_cluster_slot, multi_node_cluster, tmp_path):
    STEPS, G = 10, 12
    core, events, _ = _selfheal_cluster(multi_node_cluster)
    trainer = train.JaxTrainer(
        _selfheal_loop, train_loop_config={"steps": STEPS},
        backend_config=JaxConfig(
            mode="local",
            elastic=ElasticConfig(
                min_workers=2, replication_factor=1, global_batch_size=G,
                recover_timeout_s=5.0,
                # remediation_mode defaults to "advisory"
                remediation_confirm_rounds=1),
            telemetry=TelemetryConfig(flush_interval_s=0.0,
                                      straggler_multiple=2.0,
                                      straggler_sustain=2)),
        scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(name="dryheal", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == STEPS

    # same detection, same policy — but NOTHING changed
    assert result.metrics["world_size"] == 3  # never rebalanced
    assert [n for n in core.control.call("get_nodes", {}, timeout=10.0)
            if n.get("quarantined")] == []

    records = fetch_records(core.control, "dryheal_00000")
    assert len(records) == 1, records
    rec = records[0]
    assert rec["mode"] == "advisory"
    assert rec["action"]["kind"] == "recommend_quarantine"
    assert rec["action"]["dry_run"] is True
    assert rec["action"]["rank"] == 1
    assert rec["effect"] is None  # no action, nothing to measure

    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if any(e.get("event") == "remediation_recommended"
               for e in events):
            break
        time.sleep(0.05)
    recos = [e for e in events
             if e.get("event") == "remediation_recommended"]
    assert len(recos) == 1 and recos[0]["action"]["dry_run"] is True


# ---------------------------------------------------------------------------
# Remediation + drain racing on the SAME node: exactly one shrink
# ---------------------------------------------------------------------------


def _straggle_and_self_drain_loop(config):
    """Like _selfheal_loop; the drain against the straggler's own node is
    posted by the test at the moment the quarantine is decided (see
    test_quarantine_on_draining_node_shrinks_once), so the quarantine
    always lands on a node that is already draining."""
    from ray_tpu_torch import collective, elastic, telemetry
    from ray_tpu_torch import train as _train
    from ray_tpu_torch.elastic.emergency import EmergencyCheckpoint as _EC

    ctx = _train.get_context()
    G = ctx.extra["global_batch_size"]
    pb = ctx.extra["per_replica_batch"]
    off = ctx.extra["batch_offset"]
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]

    state = {"w": 1.0, "step": 0}
    ck = _train.get_checkpoint()
    if isinstance(ck, _EC):
        state = dict(max(ck.load(), key=lambda s: s["step"]))

    while state["step"] < config["steps"]:
        t = state["step"]
        straggler = ctx.get_world_rank() == 1 and ctx.get_world_size() == 3
        with telemetry.phase("data"):
            idx = np.arange(off, off + pb, dtype=np.float64)
            time.sleep(0.05)
            if straggler:
                time.sleep(0.15)
        gsum = float(np.sum(np.sin(idx + t) * state["w"] + idx * 0.01))
        total = collective.allreduce(torch.tensor([gsum],
                                                  dtype=torch.float64),
                                     group_name=group)
        state = {"w": state["w"] - 0.1 * float(total[0]) / G,
                 "step": t + 1}
        elastic.snapshot(state, state["step"])
        assert elastic.wait_replicated(20.0)
        _train.report({"step": state["step"], "w": state["w"],
                       "world_size": ctx.get_world_size()})


def test_quarantine_on_draining_node_shrinks_once(private_cluster_slot,
                                                  multi_node_cluster,
                                                  tmp_path):
    """A quarantine decision landing while the victim's node is already
    draining must shrink the gang exactly ONCE: elastic recovery taints
    the node through both sets (draining | quarantined) and sheds it in
    a single rebalance — never a second drain-triggered shrink for the
    same host.  min_workers=1 makes a double-shrink observable (the gang
    would reach width 1 instead of 2)."""
    STEPS, G = 12, 12
    core, events, _ = _selfheal_cluster(multi_node_cluster)
    from ray_tpu_torch.train import backend_executor as bex

    quarantine = bex.BackendExecutor.quarantine_worker

    def drain_then_quarantine(self, rank, reason, grace_s=600.0):
        # the victim's node posts its drain notice (a spot reclaim) as
        # the quarantine is decided; wait until the trainer's executor
        # has seen it, so the quarantine meets a draining node
        nid = self.worker_group.workers[rank].metadata["node_id"]
        core.control.call("report_draining", {
            "node_id": nid, "grace_s": 60.0, "reason": "spot-reclaim"},
            timeout=10.0)
        deadline = time.monotonic() + 30.0
        while nid not in self._draining_nodes:
            assert time.monotonic() < deadline, "drain notice never arrived"
            time.sleep(0.02)
        return quarantine(self, rank, reason, grace_s)

    bex.BackendExecutor.quarantine_worker = drain_then_quarantine
    trainer = train.JaxTrainer(
        _straggle_and_self_drain_loop, train_loop_config={"steps": STEPS},
        backend_config=JaxConfig(
            mode="local",
            elastic=ElasticConfig(
                min_workers=1, replication_factor=1, global_batch_size=G,
                recover_timeout_s=5.0,
                remediation_mode="enforce",
                remediation_confirm_rounds=1,
                remediation_cooldown_s=5.0,
                remediation_max_episodes=2,
                # window 3: the median discards the one-off replication
                # stall the first post-recovery round absorbs
                remediation_effect_window=3),
            telemetry=TelemetryConfig(flush_interval_s=0.0,
                                      straggler_multiple=2.0,
                                      straggler_sustain=2)),
        scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(name="drainrace", storage_path=str(tmp_path)))
    try:
        result = trainer.fit()
    finally:
        bex.BackendExecutor.quarantine_worker = quarantine
    assert result.error is None, result.error
    assert result.metrics["step"] == STEPS

    # shrunk exactly once: 3 -> 2, NOT 3 -> 2 -> 1
    assert result.metrics["world_size"] == 2

    # the quarantine path won (a drain-first recovery would record no
    # remediation episode) and it fired exactly once
    records = fetch_records(core.control, "drainrace_00000")
    assert len(records) == 1, records
    rec = records[0]
    assert rec["mode"] == "enforce"
    assert rec["cause"]["rank"] == 1
    act = rec["action"]
    assert act["kind"] == "quarantine_rebalance" and not act["dry_run"]
    assert act["new_world"] == 2
    assert rec["effect"] is not None and rec["effect"]["recovered"]

    # the victim node wears BOTH hats in the control plane's view —
    # the drain advisory was live when the quarantine landed
    nodes = core.control.call("get_nodes", {}, timeout=10.0)
    victim = [n for n in nodes if n["node_id"] == act["node_id"]]
    assert len(victim) == 1
    assert victim[0]["quarantined"], victim
    assert victim[0]["draining"], victim
    assert victim[0]["draining_reason"] == "spot-reclaim"
    # and no other node was touched by either mechanism
    assert [n["node_id"] for n in nodes
            if n.get("quarantined") or n.get("draining")] \
        == [act["node_id"]]
