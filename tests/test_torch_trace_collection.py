"""Cluster-wide distributed tracing on the port: the cases of
tests/test_trace_collection.py and tests/test_tracing.py against
``ray_tpu_torch.util.tracing`` and ``ray_tpu_torch.telemetry.trace_assembly``
— sampling, central span collection, critical-path attribution, and task
spans stitched across processes (the last polls its trace file with a
deadline where the reference slept).

Covers the span pipeline end to end — head-based ratio sampling with the
decision riding the W3C traceparent flags byte, the per-process
SpanBuffer -> control-plane collector path, trace reassembly from the
``_tracing`` KV namespace, and the critical-path sweep that attributes a
trace's wall time to named phases.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from ray_tpu_torch.telemetry import trace_assembly as ta
from ray_tpu_torch.util import tracing

pytestmark = pytest.mark.tracing


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clean_tracing():
    """Enable tracing into a list sink; restore module state after."""
    spans = []
    tracing.configure(spans.append)
    yield spans
    tracing._enabled = False
    tracing._sink = None
    tracing.set_sample_ratio(None)
    tracing.detach_collector()


# -- unit: context + sampling ------------------------------------------------

def test_rpc_client_span_noop_without_context(clean_tracing):
    """Regression: with no active span context, rpc_client_span must be
    a true no-op — control-plane chatter (heartbeats, kv polls) must not
    mint orphan root traces."""
    spans = clean_tracing
    with tracing.rpc_client_span("heartbeat"):
        pass
    assert spans == []
    with tracing.span("parent"):
        with tracing.rpc_client_span("push_tasks"):
            pass
    names = [s["name"] for s in spans]
    assert "rpc push_tasks" in names and "parent" in names


def test_sampled_flag_rides_traceparent(clean_tracing):
    with tracing.span("root"):
        carrier = tracing.inject_context()
    assert carrier["traceparent"].endswith("-01")
    ctx = tracing._extract(carrier)
    assert ctx["sampled"] is True
    assert tracing.carrier_sampled(carrier)

    unsampled = {"traceparent": carrier["traceparent"][:-2] + "00"}
    assert tracing._extract(unsampled)["sampled"] is False
    assert not tracing.carrier_sampled(unsampled)
    assert not tracing.carrier_sampled(None)
    assert not tracing.carrier_sampled({"traceparent": "garbage"})


def test_sampling_deterministic_on_trace_id(clean_tracing):
    tracing.set_sample_ratio(0.5)
    ids = [i << 54 for i in range(1024)]
    picks = [tracing.sample_trace(t) for t in ids]
    assert picks == [tracing.sample_trace(t) for t in ids]
    assert sum(picks) == 512  # evenly spaced ids split exactly at 0.5
    # ratio 0 = sampler off (explicitly-enabled tracing records all)
    tracing.set_sample_ratio(0.0)
    assert all(tracing.sample_trace(t) for t in ids[:10])
    tracing.set_sample_ratio(1.0)
    assert all(tracing.sample_trace(t) for t in ids[:10])


def test_sampled_out_root_suppresses_subtree(clean_tracing):
    spans = clean_tracing
    tracing.set_sample_ratio(1e-12)  # everything sampled out
    with tracing.span("root"):
        carrier = tracing.inject_context()
        assert carrier["traceparent"].endswith("-00")
        with tracing.span("child"):
            pass
        tracing.record_span("retro", "INTERNAL", 0, 1, tracing._current())
    assert spans == []


def test_record_span_requires_sampled_parent(clean_tracing):
    spans = clean_tracing
    tracing.record_span("orphan", "INTERNAL", 0, 1, None)
    tracing.record_span("suppressed", "INTERNAL", 0, 1,
                        {"trace_id": 1, "span_id": 2, "sampled": False})
    assert spans == []
    tracing.record_span("ok", "INTERNAL", 100, 200,
                        {"trace_id": 1, "span_id": 2, "sampled": True},
                        batch=3)
    assert len(spans) == 1
    sp = spans[0]
    assert (sp["start_ns"], sp["end_ns"]) == (100, 200)
    assert sp["parent_id"] == f"{2:016x}"
    assert sp["attributes"]["batch"] == 3


# -- unit: file exporter + span buffer ---------------------------------------

def test_file_exporter_single_handle_and_close(tmp_path, clean_tracing):
    path = str(tmp_path / "spans.jsonl")
    exp = tracing._FileExporter(path)
    for i in range(3):
        exp({"name": f"s{i}"})
    exp.flush()
    assert [json.loads(l)["name"] for l in open(path)] == ["s0", "s1", "s2"]
    exp.close()
    exp({"name": "after-close"})  # no-op, must not raise
    assert len(open(path).readlines()) == 3


def test_span_buffer_drop_accounting_and_requeue():
    sent = []
    broken = [True]

    def transport(payload):
        if broken[0]:
            raise OSError("control down")
        sent.append(payload)

    buf = tracing.SpanBuffer(transport, cap=4, interval_s=3600,
                             common={"proc": "test"})
    try:
        for i in range(6):  # 2 over cap -> dropped-oldest accounting
            buf.add({"name": f"s{i}"})
        assert buf.stats()["dropped"] == 2
        buf.flush()  # transport fails: batch re-queues, drops carry over
        assert sent == []
        st = buf.stats()
        assert st["buffered"] == 4 and st["dropped"] == 2
        broken[0] = False
        buf.flush()
        assert len(sent) == 1
        assert [s["name"] for s in sent[0]["spans"]] == \
            ["s2", "s3", "s4", "s5"]
        assert sent[0]["dropped"] == 2
        assert sent[0]["common"]["proc"] == "test"
        assert buf.stats() == {"buffered": 0, "flushed_batches": 1,
                               "flushed_spans": 4, "dropped": 0}
    finally:
        buf.stop()


# -- unit: critical path -----------------------------------------------------

def _mk(name, span_id, parent_id, start_ms, end_ms, proc, kind="INTERNAL"):
    return {"name": name, "trace_id": f"{7:032x}",
            "span_id": f"{span_id:016x}",
            "parent_id": f"{parent_id:016x}" if parent_id else None,
            "kind": kind, "proc": proc,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "attributes": {}}


def test_critical_path_attribution():
    spans = [
        _mk("task f", 1, 0, 0, 100, "driver", "PRODUCER"),
        _mk("driver.flush_batch", 2, 1, 5, 10, "driver"),
        _mk("worker.queue_wait", 3, 1, 30, 40, "worker:ab"),
        _mk("task.execute f", 4, 1, 40, 90, "worker:ab", "CONSUMER"),
    ]
    cp = ta.critical_path(spans)
    wall = cp["wall_ns"]
    assert wall == int(100e6)
    # the phase breakdown tiles the wall exactly
    assert sum(cp["phases"].values()) == wall
    ms = {k: v / 1e6 for k, v in cp["phases"].items()}
    # deepest covering span wins each segment; the root only keeps what
    # no child covers
    assert ms["driver.flush_batch"] == 5
    assert ms["worker.queue_wait"] == 10
    assert ms["task.execute f"] == 50
    assert ms["task f"] == 35  # 0-5 + 10-30 + 90-100
    assert cp["coverage"] == 1.0
    # per-process attribution
    procs_ms = {k: v / 1e6 for k, v in cp["procs"].items()}
    assert procs_ms == {"driver": 40, "worker:ab": 60}


def test_critical_path_names_wire_gaps():
    spans = [
        _mk("driver.flush_batch", 2, 0, 0, 10, "driver"),
        _mk("task.execute f", 4, 0, 30, 90, "worker:ab", "CONSUMER"),
    ]
    cp = ta.critical_path(spans)
    assert sum(cp["phases"].values()) == cp["wall_ns"]
    gap = "wire:driver.flush_batch->task.execute f"
    assert cp["phases"][gap] == int(20e6)
    assert cp["procs"]["wire"] == int(20e6)
    assert cp["coverage"] == pytest.approx(70 / 90)
    assert ta.critical_path([]) == {
        "wall_ns": 0, "segments": [], "phases": {}, "procs": {},
        "covered_ns": 0, "coverage": 0.0}


def test_chrome_trace_export_is_valid():
    from ray_tpu_torch.telemetry.timeline import validate_chrome_trace

    spans = [
        _mk("task f", 1, 0, 0, 100, "driver", "PRODUCER"),
        _mk("task.execute f", 4, 1, 40, 90, "worker:ab", "CONSUMER"),
    ]
    trace = ta.chrome_trace(spans)
    assert validate_chrome_trace(trace)
    metas = [e for e in trace["traceEvents"] if e["ph"] == "M"]
    assert {m["args"]["name"] for m in metas} == {"driver", "worker:ab"}
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert all(isinstance(e["pid"], int) for e in xs)
    # the child renders on a deeper tid than its parent
    tid = {e["name"]: e["tid"] for e in xs}
    assert tid["task.execute f"] > tid["task f"]


def test_render_text_smoke():
    spans = [_mk("task f", 1, 0, 0, 100, "driver", "PRODUCER")]
    out = ta.render_text(ta.analyze(spans))
    assert "critical path" in out and "task f" in out
    summary = {"traces": 2, "mean_wall_ns": 5e6,
               "phases": {"task f": {"total_ns": 1e7, "mean_ns": 5e6,
                                     "share": 1.0}}}
    assert "task f" in ta.render_summary_text(summary)


# -- e2e: real cluster, central collection, >=3 processes --------------------

def test_trace_collected_centrally_with_critical_path(tmp_path):
    """A traced task through a real driver -> raylet -> worker cluster:
    every process reports its spans to the control collector, the trace
    reassembles from KV under one trace id with parented PRODUCER /
    CONSUMER / CLIENT / SERVER spans across >=3 processes, and the
    critical-path breakdown tiles the trace's wall time with named
    phases.  RAY_TPU_TORCH_TRACE_SAMPLE=1.0 enables tracing with no hook."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["RAY_TPU_TORCH_TRACE_SAMPLE"] = "1.0"
    body = """
        import json, time
        import ray_tpu_torch
        ray_tpu_torch.init(num_cpus=2)

        @ray_tpu_torch.remote
        def traced_task():
            return 42

        assert ray_tpu_torch.get(traced_task.remote(), timeout=90) == 42

        from ray_tpu_torch._private import core as core_mod
        from ray_tpu_torch.telemetry import trace_assembly as ta
        from ray_tpu_torch.telemetry.timeline import validate_chrome_trace
        from ray_tpu_torch.util import tracing

        control = core_mod._current_core.control
        result = None
        deadline = time.time() + 30
        while time.time() < deadline and result is None:
            for tid in ta.list_trace_ids(control):
                spans = ta.fetch_trace(control, tid)
                names = {s["name"] for s in spans}
                procs = {s.get("proc", "?") for s in spans}
                kinds = {s.get("kind") for s in spans}
                if "task.execute traced_task" in names \\
                        and len(procs) >= 3 \\
                        and {"PRODUCER", "CONSUMER", "CLIENT",
                             "SERVER"} <= kinds:
                    analysis = ta.analyze(spans)
                    result = {
                        "trace_id": tid,
                        "names": sorted(names),
                        "procs": sorted(procs),
                        "kinds": sorted(k for k in kinds if k),
                        "n_spans": len(spans),
                        "one_trace": len({s["trace_id"]
                                          for s in spans}) == 1,
                        "parented": next(
                            s["parent_id"] for s in spans
                            if s["name"] == "task.execute traced_task")
                            == next(s["span_id"] for s in spans
                                    if s["name"] == "task traced_task"),
                        "critical_path": {
                            "wall_ns": analysis["critical_path"][
                                "wall_ns"],
                            "phase_sum_ns": sum(
                                analysis["critical_path"][
                                    "phases"].values()),
                            "phases": list(analysis["critical_path"][
                                "phases"])[:20],
                        },
                        "chrome_valid": validate_chrome_trace(
                            ta.chrome_trace(spans)),
                        "buffer": tracing.buffer_stats(),
                    }
                    break
            time.sleep(0.4)
        print("RESULT " + json.dumps(result))
        ray_tpu_torch.shutdown()
    """
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                         capture_output=True, text=True, timeout=180,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines()
                if l.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res is not None, \
        f"no complete trace reached the collector: {out.stdout[-2000:]}"
    assert res["one_trace"], "spans leaked across trace ids"
    assert res["parented"], "execute span not parented under submit span"
    assert len(res["procs"]) >= 3, res["procs"]
    assert {"PRODUCER", "CONSUMER", "CLIENT", "SERVER"} <= set(
        res["kinds"])
    # hot-path phase coverage made it into the trace
    assert "driver.flush_batch" in res["names"], res["names"]
    assert any(n.startswith("driver.lease") for n in res["names"])
    assert "worker.queue_wait" in res["names"], res["names"]
    cp = res["critical_path"]
    # attribution tiles the wall time (wire gaps included, so exact)
    assert cp["phase_sum_ns"] == cp["wall_ns"] > 0
    assert res["chrome_valid"]


@pytest.fixture(scope="module")
def ray_cluster():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_report_spans_collector_merges_and_serves_kv(ray_cluster):
    """Direct collector contract: a report_spans notify lands in the
    per-trace store and is served back through plain kv_get, with
    collector counters visible in control_stats."""
    import time as _time

    import ray_tpu_torch

    control = ray_tpu_torch._core.control
    tid = f"{0xabc123:032x}"
    spans = [{"name": "synthetic", "trace_id": tid,
              "span_id": f"{1:016x}", "parent_id": None,
              "kind": "INTERNAL", "start_ns": 10, "end_ns": 20,
              "attributes": {}}]
    control.notify("report_spans", {
        "spans": spans, "dropped": 3, "common": {"proc": "synthetic"}})
    deadline = _time.time() + 10
    got = []
    while _time.time() < deadline:
        got = ta.fetch_trace(control, tid)
        if got:
            break
        _time.sleep(0.1)
    assert got and got[0]["name"] == "synthetic"
    assert got[0]["proc"] == "synthetic"  # stamped from batch common
    stats = control.call("control_stats", {}, timeout=10.0)
    tr = stats["tracing"]
    assert tr["spans"] >= 1
    assert tr["dropped"] >= 3
    assert tr["traces"] >= 1


# -- task spans stitch across processes (tests/test_tracing.py) -------------

def test_task_spans_stitch_across_processes(tmp_path):
    trace_file = str(tmp_path / "spans.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    body = f"""
        import time
        import ray_tpu_torch
        ray_tpu_torch.init(
            num_cpus=2,
            _tracing_startup_hook="ray_tpu_torch.util.tracing:setup_file_exporter",
            _tracing_config={{"trace_file": {trace_file!r}}})

        @ray_tpu_torch.remote
        def traced_task():
            return 42

        assert ray_tpu_torch.get(traced_task.remote(), timeout=90) == 42
        # the worker's span reaches the file after the result: poll
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                with open({trace_file!r}) as f:
                    if "task.execute traced_task" in f.read():
                        break
            except FileNotFoundError:
                pass
            time.sleep(0.05)
        ray_tpu_torch.shutdown()
    """
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                         capture_output=True, text=True, timeout=180,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]

    spans = [json.loads(l) for l in open(trace_file) if l.strip()]
    submits = [s for s in spans if s["name"] == "task traced_task"]
    execs = [s for s in spans
             if s["name"] == "task.execute traced_task"]
    assert submits, f"no submit span in {[s['name'] for s in spans]}"
    assert execs, f"no execute span in {[s['name'] for s in spans]}"
    # cross-process stitching: same trace, executor parented under submit
    assert execs[0]["trace_id"] == submits[0]["trace_id"]
    assert execs[0]["parent_id"] == submits[0]["span_id"]
    assert execs[0]["attributes"].get("task_id", "").startswith("tsk-")
