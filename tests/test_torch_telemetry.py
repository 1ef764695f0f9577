"""The training flight recorder on the port: the cases of
tests/test_telemetry.py against ``ray_tpu_torch.telemetry``.

Covers the write side (StepTimer phase math + fenced ring buffer), the
accounting side (GoodputAccountant across drain->shrink->resume), the
driver side (StepAggregator straggler hysteresis), the export side
(Prometheus exposition, /api/train/timeline Chrome trace JSON), the
collective instrumentation + tracing spans, and the acceptance
scenario: a 20-step toy run with one injected straggler and one drain
event yields a per-step phase breakdown for every worker, exactly one
``straggler_detected`` advisory, goodput < 1.0 with the recovery window
attributed, and a timeline payload that validates as trace-event JSON.
The reference's mesh collective on a JAX CPU mesh becomes the port's
``nccl_group.mesh_allreduce`` over a one-member gloo group; the clusters
are the port's own (a module cluster, and private multi-raylet ones).
"""

import gc
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.elastic import ElasticConfig
from ray_tpu_torch.telemetry import (GoodputAccountant, StepAggregator, StepTimer,
                               TelemetryConfig, chrome_trace,
                               collect_snapshots, resolve_telemetry,
                               validate_chrome_trace)
from ray_tpu_torch.telemetry import goodput as goodput_mod
from ray_tpu_torch.telemetry import recorder
from ray_tpu_torch.train import JaxConfig, RunConfig, ScalingConfig


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# ---------------------------------------------------------------------------
# Pure units (no cluster)
# ---------------------------------------------------------------------------


def test_telemetry_config_resolution_and_validation():
    assert resolve_telemetry(None).enabled
    assert not resolve_telemetry(False).enabled
    assert resolve_telemetry(True).ring_size == 512
    tc = resolve_telemetry({"ring_size": 7, "bogus_key": 1})
    assert tc.ring_size == 7  # unknown keys dropped (forward compat)
    assert resolve_telemetry(tc) is tc
    rt = TelemetryConfig.from_dict(tc.to_dict())
    assert rt == tc
    with pytest.raises(TypeError):
        resolve_telemetry("yes")
    with pytest.raises(ValueError):
        TelemetryConfig(ring_size=0)
    with pytest.raises(ValueError):
        TelemetryConfig(flush_interval_s=-1)
    with pytest.raises(ValueError):
        TelemetryConfig(straggler_multiple=1.0)
    with pytest.raises(ValueError):
        TelemetryConfig(straggler_sustain=0)


def test_step_timer_phase_math():
    clk = FakeClock()
    t = StepTimer(ring_size=8, rank=1, incarnation=2, trial="t", clock=clk)
    t.step_start(0)
    with t.phase("data"):
        clk.advance(0.25)
    with t.phase("collective"):
        clk.advance(0.10)
    clk.advance(0.40)  # unattributed host/device time
    rec = t.step_end(0)
    assert rec["step"] == 0 and rec["rank"] == 1 and rec["incarnation"] == 2
    assert rec["dur"] == pytest.approx(0.75)
    # residual lands in "compute": phases sum exactly to the step duration
    assert rec["phases"]["data"] == pytest.approx(0.25)
    assert rec["phases"]["collective"] == pytest.approx(0.10)
    assert rec["phases"]["compute"] == pytest.approx(0.40)
    assert sum(rec["phases"].values()) == pytest.approx(rec["dur"])
    # phase time accrued between steps is dropped, not misattributed
    t.add_phase_time("collective", 9.9)
    assert t.step_end() is None  # no step in flight
    t.step_start(1)
    clk.advance(0.1)
    rec2 = t.step_end(1)
    assert "collective" not in rec2["phases"]


def test_step_timer_ring_bounded_and_aggregate():
    clk = FakeClock()
    t = StepTimer(ring_size=4, rank=0, clock=clk)
    for i in range(10):
        t.step_start(i)
        clk.advance(0.5)
        t.step_end(i)
    snap = t.snapshot()
    assert snap["ring_size"] == 4
    assert [r["step"] for r in snap["steps"]] == [6, 7, 8, 9]
    agg = t.aggregate()
    assert agg["steps"] == 4
    assert agg["step_mean_s"] == pytest.approx(0.5)
    assert agg["phase_means_s"]["compute"] == pytest.approx(0.5)


def test_step_timer_wall_mono_anchor():
    """One wall<->mono anchor per incarnation: the wall clock is read
    exactly once (at construction) and every "ts" the timer emits is
    derived from the monotonic clock via that anchor, so an NTP step
    mid-run moves nothing."""
    mono = FakeClock()
    wall = FakeClock()
    wall.t = 50_000.0
    reads = []

    def stepped_wall():
        reads.append(wall.t)
        return wall()

    t = StepTimer(ring_size=4, rank=0, clock=mono, wall=stepped_wall)
    assert len(reads) == 1
    mono.advance(2.0)
    wall.t += 3600.0                 # NTP step: wall jumps an hour ahead
    assert t.wall_now() == pytest.approx(50_002.0)
    t.step_start(0)
    mono.advance(0.5)
    rec = t.step_end(0)
    assert rec["ts"] == pytest.approx(50_002.0)
    assert rec["dur"] == pytest.approx(0.5)
    wall.t -= 7200.0                 # and back behind the anchor
    t.step_start(1)
    mono.advance(0.5)
    rec2 = t.step_end(1)
    # strictly monotonic "ts" progression despite both wall steps
    assert rec2["ts"] == pytest.approx(50_002.5)
    assert t.wall_now() == pytest.approx(50_003.0)
    assert len(reads) == 1           # never re-read after construction


def test_phase_is_noop_outside_session():
    # train loops use ray_tpu_torch.telemetry.phase unconditionally; with no
    # current timer (telemetry off / outside a session) it must be free
    recorder.set_current_timer(None)
    with recorder.phase("data") as ph:
        assert ph.fence(42) == 42  # passes the value through


def test_record_collective_feeds_current_timer():
    clk = FakeClock()
    t = StepTimer(ring_size=4, clock=clk)
    recorder.set_current_timer(t)
    try:
        t.step_start(0)
        recorder.record_collective("allreduce", 0.03,
                                   payload_bytes=4096, wire_bytes=1300)
        recorder.record_collective("allgather", 0.02)
        clk.advance(0.1)
        rec = t.step_end(0)
    finally:
        recorder.set_current_timer(None)
    assert rec["phases"]["collective"] == pytest.approx(0.05)
    # the wall clock only saw 0.1s: compute is the residual
    assert rec["phases"]["compute"] == pytest.approx(0.05)


def test_goodput_accountant_drain_shrink_resume():
    clk = FakeClock()
    g = GoodputAccountant(clock=clk)
    assert g.state == "idle"
    clk.advance(1.0)                    # startup
    g.transition("productive", incarnation=0)
    clk.advance(12.0)
    g.transition("draining", node="n2")
    clk.advance(2.0)
    g.transition("recovering")
    clk.advance(5.0)
    g.transition("productive", incarnation=1)
    # same-state no-op still absorbs incarnation metadata
    g.transition("productive", incarnation=1)
    clk.advance(10.0)
    rep = g.report()
    assert rep["state"] == "productive"
    assert rep["seconds"]["productive"] == pytest.approx(22.0)
    assert rep["seconds"]["draining"] == pytest.approx(2.0)
    assert rep["seconds"]["recovering"] == pytest.approx(5.0)
    assert rep["seconds"]["idle"] == pytest.approx(1.0)
    assert rep["wall_s"] == pytest.approx(30.0)
    assert rep["goodput"] == pytest.approx(22.0 / 30.0)
    assert rep["incarnations"] == [0, 1]
    assert [t["state"] for t in rep["transitions"]] == [
        "productive", "draining", "recovering", "productive"]
    with pytest.raises(ValueError):
        g.transition("confused")


def test_goodput_stamp_module_level():
    g = GoodputAccountant(clock=FakeClock())
    goodput_mod.set_current_accountant(g)
    try:
        goodput_mod.stamp("productive")
        goodput_mod.stamp("bogus-state")  # guarded: must not raise
        assert g.state == "productive"
    finally:
        goodput_mod.set_current_accountant(None)
    goodput_mod.stamp("draining")  # no accountant: no-op


def _round(busy_by_rank):
    """Fabricate one lockstep round of step records (collective=0)."""
    return [{"step": 0, "ts": 0.0, "dur": b, "phases": {"compute": b},
             "rank": r, "incarnation": 0}
            for r, b in sorted(busy_by_rank.items())]


def test_straggler_hysteresis_no_flap_on_single_slow_step():
    pub = []
    agg = StepAggregator(TelemetryConfig(straggler_multiple=2.0,
                                         straggler_sustain=3),
                         trial="t", publish=pub.append)
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}))   # one GC pause
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.1}))   # recovered
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}))
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}))
    assert agg.advisories == [] and pub == []  # never sustained 3


def test_straggler_sustained_emits_exactly_one_advisory():
    pub = []
    agg = StepAggregator(TelemetryConfig(straggler_multiple=2.0,
                                         straggler_sustain=3),
                         trial="t", publish=pub.append)
    for _ in range(6):  # sustained well past the threshold
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}))
    assert len(agg.advisories) == 1 and len(pub) == 1
    adv = pub[0]
    assert adv["event"] == "straggler_detected"
    assert adv["rank"] == 2 and adv["trial"] == "t"
    assert adv["ratio"] == pytest.approx(5.0)
    assert adv["sustained"] == 3
    # recovery closes the episode; a NEW sustained run re-advises
    agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.1}))
    for _ in range(3):
        agg.ingest_round(_round({0: 0.1, 1: 0.1, 2: 0.5}))
    assert len(agg.advisories) == 2
    s = agg.summary()
    assert s["rounds"] == 10 and len(s["advisories"]) == 2
    assert s["last_step_max_s"] == pytest.approx(0.5)


def test_straggler_needs_a_gang():
    # busy comparison is meaningless for a single worker — never flags
    pub = []
    agg = StepAggregator(TelemetryConfig(straggler_sustain=1),
                         publish=pub.append)
    for _ in range(5):
        agg.ingest_round(_round({0: 5.0}))
    assert pub == []
    agg.ingest_round([None, {"not": "a record"}])  # malformed rounds: ok
    assert agg.summary()["rounds"] == 5


def test_chrome_trace_from_snapshots():
    snaps = [{"trial": "t", "rank": 1, "incarnation": 0, "ring_size": 8,
              "steps": [{"step": 3, "ts": 100.0, "dur": 0.5,
                         "phases": {"compute": 0.3, "data": 0.1,
                                    "custom": 0.1},
                         "rank": 1, "incarnation": 0}]},
             {"trial": "t", "rank": 0, "incarnation": 0, "ring_size": 8,
              "steps": []}]
    trace = chrome_trace(snaps)
    assert validate_chrome_trace(trace)
    assert trace["displayTimeUnit"] == "ms"
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    step_ev = [e for e in xs if e["tid"] == 0][0]
    assert step_ev["name"] == "step 3"
    assert step_ev["ts"] == pytest.approx(100.0 * 1e6)
    assert step_ev["dur"] == pytest.approx(0.5 * 1e6)
    # phase lanes lay out sequentially in canonical order, extras last
    lanes = [e for e in xs if e["tid"] == 1]
    assert [e["name"] for e in lanes] == ["data", "compute", "custom"]
    assert lanes[1]["ts"] == pytest.approx(lanes[0]["ts"] + lanes[0]["dur"])
    # processes sorted by rank; metadata names workers
    metas = [e for e in trace["traceEvents"] if e["ph"] == "M"
             and e["name"] == "process_name"]
    assert [m["pid"] for m in metas] == [0, 1]
    assert not validate_chrome_trace({"traceEvents": [{"ph": "X"}]})
    assert not validate_chrome_trace([])


# ---------------------------------------------------------------------------
# util/metrics registry: the restart-epoch leak regression (satellite)
# ---------------------------------------------------------------------------


def test_registry_weakref_sweeps_dead_epoch_metrics():
    """Regression: _Registry used to hold strong refs forever, so every
    init/shutdown epoch's metrics kept flushing stale series. Now a
    dropped metric is swept on the next snapshot."""
    from ray_tpu_torch.util.metrics import Gauge, _registry

    g = Gauge("test_epoch_leak_gauge")
    g.set(1.0)
    assert any(m["name"] == "test_epoch_leak_gauge"
               for m in _registry.snapshot())
    del g
    gc.collect()
    assert not any(m["name"] == "test_epoch_leak_gauge"
                   for m in _registry.snapshot())

    # explicit deregister works even while strong refs remain
    g2 = Gauge("test_epoch_leak_gauge2")
    g2.set(2.0)
    g2.deregister()
    assert not any(m["name"] == "test_epoch_leak_gauge2"
                   for m in _registry.snapshot())


def test_registry_flusher_stop_restart():
    """shutdown() stops the flusher thread; the next epoch re-arms it
    (restart_if_needed / a fresh registration)."""
    from ray_tpu_torch.util.metrics import Gauge, _registry

    def flush_threads():
        return [t for t in threading.enumerate()
                if t.name == "ray_tpu_torch-metrics-flush"
                and t.is_alive()]

    g = Gauge("test_flusher_cycle_gauge")
    g.set(1.0)
    try:
        assert len(flush_threads()) == 1
        _registry.stop()
        deadline = time.monotonic() + 5
        while flush_threads() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not flush_threads()
        _registry.restart_if_needed()  # ray_tpu_torch.init() calls this
        assert len(flush_threads()) == 1
    finally:
        g.deregister()
        _registry.restart_if_needed()


# ---------------------------------------------------------------------------
# Cluster-backed: KV flush, Prometheus exposition, timeline endpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ray_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def cluster(ray_cluster):
    yield


@pytest.fixture
def private_cluster_slot():
    """The test connects this process to a cluster of its own: the
    module's cluster is shut down for it and started again after."""
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
    """Leave later modules in this process a fresh program ledger."""
    from ray_tpu_torch.telemetry import device as devtel

    devtel.reset_for_tests()
    yield
    devtel.reset_for_tests()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_flush_prometheus_and_timeline_endpoint(cluster):
    from ray_tpu_torch._private.api import current_core
    from ray_tpu_torch.dashboard import DashboardHead
    from ray_tpu_torch.util.metrics import _registry

    timer = StepTimer(ring_size=16, rank=0, trial="promtrial")
    recorder.set_current_timer(timer)
    try:
        timer.step_start(0)
        with timer.phase("data"):
            pass
        recorder.record_collective("allreduce", 0.01,
                                   payload_bytes=4000, wire_bytes=1300)
        timer.step_end(0)
    finally:
        recorder.set_current_timer(None)
    assert recorder.flush_snapshot(timer, force=True)
    # rate limit: an immediate re-flush inside the interval is skipped
    assert not recorder.flush_snapshot(timer, interval_s=60.0)
    _registry.flush()

    addr = ray_tpu_torch.connection_info()["control_address"]
    head = DashboardHead(addr, port=0)
    head.start()
    try:
        status, body = _get(head.url + "/metrics")
        assert status == 200
        assert "ray_tpu_train_step_phase_seconds" in body
        assert "ray_tpu_collective_op_seconds" in body
        assert "ray_tpu_collective_payload_bytes_total{" in body
        assert "ray_tpu_collective_wire_bytes_total{" in body
        assert 'op="allreduce"' in body

        status, body = _get(head.url + "/api/train/timeline")
        assert status == 200
        trace = json.loads(body)
        assert validate_chrome_trace(trace)
        steps = [e for e in trace["traceEvents"]
                 if e["ph"] == "X" and e.get("tid") == 0]
        assert any(e["name"] == "step 0" for e in steps)

        # ?trial= filters: a bogus trial yields an empty (valid) trace
        status, body = _get(head.url + "/api/train/timeline?trial=nope")
        empty = json.loads(body)
        assert validate_chrome_trace(empty)
        assert empty["traceEvents"] == []
    finally:
        head.stop()

    snaps = collect_snapshots(current_core().control, trial="promtrial")
    assert len(snaps) == 1 and snaps[0]["worker_id"]
    phases = snaps[0]["steps"][0]["phases"]
    assert "collective" in phases and "data" in phases


def test_collective_instrumentation_and_tracing_spans(cluster):
    """Collective ops time themselves into the current step's
    "collective" phase and open tracing spans (init/destroy + mesh ops)
    that parent into the ambient trace context."""
    from ray_tpu_torch import collective
    from ray_tpu_torch.collective.nccl_group import mesh_allreduce
    from ray_tpu_torch.util import tracing

    spans = []
    tracing.configure(spans.append)
    timer = StepTimer(ring_size=8, rank=0)
    recorder.set_current_timer(timer)
    try:
        collective.init_collective_group(1, 0, backend="kv",
                                         group_name="telspan")
        timer.step_start(0)
        out = collective.allreduce(torch.ones(8), group_name="telspan")
        assert float(out.sum()) == 8.0
        g = collective.init_collective_group(1, 0, backend="gloo",
                                             group_name="telmesh")
        m = mesh_allreduce(torch.ones(4), g.pg)
        assert m.tolist() == [1.0] * 4
        rec = timer.step_end(0)
        collective.destroy_collective_group("telmesh")
        collective.destroy_collective_group("telspan")
    finally:
        recorder.set_current_timer(None)
        tracing._enabled = False
        tracing._sink = None

    assert rec["phases"]["collective"] > 0
    names = [s["name"] for s in spans]
    assert "collective.init" in names
    assert "collective.destroy" in names
    assert "collective.mesh_allreduce" in names
    init = [s for s in spans if s["name"] == "collective.init"][0]
    assert init["attributes"]["world_size"] == 1
    assert init["attributes"]["backend"] == "kv"
    mesh_span = [s for s in spans
                 if s["name"] == "collective.mesh_allreduce"][0]
    assert mesh_span["attributes"]["world"] == 1
    assert not mesh_span["attributes"]["compressed"]
    # spans nest under an ambient parent via the contextvar
    with tracing._span("outer", "INTERNAL", None):
        pass  # (configure was reset above; just ensure no crash path)


def test_session_report_auto_attaches_telemetry(ray_cluster, tmp_path):
    """A plain 2-worker run: every report carries a telemetry record
    whose phases include the checkpoint write, and the trainer's state
    snapshot in KV exposes goodput + straggler summaries."""
    from ray_tpu_torch._private.api import current_core

    def loop(config):
        import tempfile

        from ray_tpu_torch import telemetry
        from ray_tpu_torch import train as _train

        for i in range(3):
            with telemetry.phase("data"):
                time.sleep(0.002)
            if i == 2:
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "s.txt"), "w") as f:
                        f.write(str(i))
                    _train.report({"step": i},
                                  checkpoint=train.Checkpoint(d))
            else:
                _train.report({"step": i})

    trainer = train.JaxTrainer(
        loop, backend_config=JaxConfig(
            mode="local", telemetry=TelemetryConfig(flush_interval_s=0.0)),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="telsess", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    tel = result.metrics["telemetry"]
    assert tel["step"] == 2 and tel["rank"] == 0
    assert "data" in tel["phases"] and "checkpoint" in tel["phases"]
    assert sum(tel["phases"].values()) == pytest.approx(tel["dur"])

    raw = current_core().control.call(
        "kv_get", {"ns": "train", "key": "telsess_00000"}, timeout=10.0)
    state = json.loads(raw)
    assert state["status"] == "FINISHED"
    assert state["telemetry"]["goodput"]["seconds"]["productive"] > 0
    assert state["telemetry"]["stragglers"]["rounds"] == 3

    snaps = collect_snapshots(current_core().control,
                              trial="telsess_00000")
    assert sorted(s["rank"] for s in snaps) == [0, 1]


def test_telemetry_disabled_is_silent(ray_cluster, tmp_path):
    def loop(config):
        from ray_tpu_torch import train as _train

        _train.report({"step": 0})

    trainer = train.JaxTrainer(
        loop, backend_config=JaxConfig(mode="local", telemetry=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="teloff", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert "telemetry" not in result.metrics


# ---------------------------------------------------------------------------
# The acceptance scenario (flight recorder end to end)
# ---------------------------------------------------------------------------


def _flight_loop(config):
    """The elastic toy loop plus telemetry phases and one injected
    straggler: rank 1 sleeps 120ms inside its "data" phase for steps
    5..12 — lockstep collectives equalize wall time, so only busy-time
    comparison can finger it."""
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
            # gate on the full-width gang: after the drain shrinks 3 -> 2
            # the loop may replay steps inside [5, 12] from the emergency
            # checkpoint, and re-injecting there would open a second
            # straggler episode (the test wants exactly one advisory)
            if (ctx.get_world_rank() == 1 and ctx.get_world_size() == 3
                    and 5 <= t <= 12):
                time.sleep(0.12)  # the injected straggler
        gsum = float(np.sum(np.sin(idx + t) * state["w"] + idx * 0.01))
        total = collective.allreduce(torch.tensor([gsum],
                                                  dtype=torch.float64),
                                     group_name=group)
        state = {"w": state["w"] - 0.1 * float(total[0]) / G,
                 "step": t + 1}
        elastic.snapshot(state, state["step"])
        assert elastic.wait_replicated(20.0)
        _train.report({"step": state["step"], "w": state["w"],
                       "world_size": ctx.get_world_size(),
                       "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID")})


class _FlightInjector:
    """Posts a drain notice against rank 0's node once step 14 lands."""

    def __init__(self):
        self.t_drain = None
        self.widths = []

    def on_trial_result(self, trial, metrics):
        self.widths.append(metrics["world_size"])
        if self.t_drain is None and metrics["step"] >= 14:
            from ray_tpu_torch._private.api import current_core

            current_core().control.call("report_draining", {
                "node_id": metrics["node_id"], "grace_s": 30.0,
                "reason": "test-preemption"}, timeout=10.0)
            self.t_drain = time.monotonic()

    def on_trial_complete(self, trial):
        pass

    def on_trial_error(self, trial):
        pass


def test_trainer_flight_recorder_end_to_end(private_cluster_slot,
                                            multi_node_cluster, tmp_path):
    STEPS, G = 20, 12
    c = multi_node_cluster()
    for _ in range(3):
        c.add_node(resources={"CPU": 1})
    host, port = c.control_addr
    ray_tpu_torch.init(address=f"{host}:{port}")
    from ray_tpu_torch._private.api import current_core

    # listen for the straggler advisory on the "train" pubsub topic
    core = current_core()
    events = []
    core.add_push_handler("pub:train", events.append)
    core.control.call("subscribe", {"topics": ["train"]}, timeout=10.0)

    injector = _FlightInjector()
    trainer = train.JaxTrainer(
        _flight_loop, train_loop_config={"steps": STEPS},
        backend_config=JaxConfig(
            mode="local",
            elastic=ElasticConfig(min_workers=2, replication_factor=1,
                                  global_batch_size=G,
                                  recover_timeout_s=5.0),
            telemetry=TelemetryConfig(flush_interval_s=0.0,
                                      straggler_multiple=2.0,
                                      straggler_sustain=3)),
        scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(name="flightrec", storage_path=str(tmp_path),
                             callbacks=[injector]),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == STEPS
    # the drain really shrank the gang 3 -> 2
    assert injector.widths[0] == 3
    assert result.metrics["world_size"] == 2
    assert injector.t_drain is not None

    # -- exactly one straggler advisory, for rank 1 --------------------
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if any(e.get("event") == "straggler_detected" for e in events):
            break
        time.sleep(0.05)
    advisories = [e for e in events
                  if e.get("event") == "straggler_detected"]
    assert len(advisories) == 1, advisories
    adv = advisories[0]
    assert adv["rank"] == 1 and adv["trial"] == "flightrec_00000"
    assert adv["ratio"] > 2.0 and adv["sustained"] == 3

    # -- published run state: goodput < 1 with the recovery attributed -
    raw = core.control.call(
        "kv_get", {"ns": "train", "key": "flightrec_00000"}, timeout=10.0)
    state = json.loads(raw)
    assert state["status"] == "FINISHED"
    gp = state["telemetry"]["goodput"]
    assert 0.0 < gp["goodput"] < 1.0
    lost = gp["seconds"]["draining"] + gp["seconds"]["recovering"]
    assert lost > 0.0, gp
    assert len(gp["incarnations"]) >= 2  # pre- and post-shrink gangs
    stragglers = state["telemetry"]["stragglers"]
    assert len(stragglers["advisories"]) == 1

    # -- per-step phase breakdown for every worker ---------------------
    snaps = collect_snapshots(core.control, trial="flightrec_00000")
    ranks = {s["rank"] for s in snaps}
    assert ranks >= {0, 1, 2}, ranks  # all pre-shrink ranks flushed
    for s in snaps:
        assert s["steps"], s["worker_id"]
        for rec in s["steps"]:
            assert rec["phases"] and "data" in rec["phases"]
            assert rec["dur"] >= 0
    # rank 1's straggler steps show the time in the data phase
    r1 = [s for s in snaps if s["rank"] == 1 and s["incarnation"] == 0]
    slow = [rec for s in r1 for rec in s["steps"]
            if 5 <= rec["step"] <= 12]
    assert slow and all(rec["phases"]["data"] > 0.1 for rec in slow)

    # -- the timeline payload validates as Chrome trace-event JSON -----
    trace = chrome_trace(snaps)
    assert validate_chrome_trace(trace)
    assert len([e for e in trace["traceEvents"] if e["ph"] == "X"]) > 0
