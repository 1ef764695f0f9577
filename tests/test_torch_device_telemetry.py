"""Device runtime observability on the port (``telemetry/device.py``): the
cases of tests/test_device_telemetry.py against ``ray_tpu_torch``.

The reference's ledger watches ``jax.jit`` compiles; the port's counterpart
records a program's first call with each new input signature (shapes,
dtypes, devices, static values), so every case that fed a jitted program
new shapes feeds an instrumented one here and expects the same snapshot,
cause diffs and storm episodes.  The census walks the tensors Python can
reach; on this CPU host the walk is pointed at CPU tensors
(``CENSUS_DEVICE_TYPES``), the CUDA walk runs in tests/test_torch_kernels.py
and chip_smoke.  The cluster case reads only this driver's own snapshot
(the reference's read every snapshot in a shared cluster's KV and raced
with other workers' flushes).
"""

import json
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.telemetry import device as devtel


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


@pytest.fixture(autouse=True)
def _fresh_singletons(monkeypatch):
    devtel.reset_for_tests()
    monkeypatch.setattr(devtel, "CENSUS_DEVICE_TYPES", ("cpu",))
    yield
    devtel.reset_for_tests()


def _ledger(**kw):
    pubs = []
    kw.setdefault("storm_threshold", 3)
    kw.setdefault("storm_window_s", 30.0)
    led = devtel.CompilationLedger(publish=pubs.append, **kw)
    return led, pubs


# ---------------------------------------------------------------------------
# program ledger: detection, cause diffs, storms
# ---------------------------------------------------------------------------


def test_shape_unstable_workload_records_cause_diffs():
    """A shape-unstable stream through an instrumented program records
    every new signature with a cause diff naming the changed argument and
    its old -> new shape; a same-shape call records nothing."""
    led, pubs = _ledger()

    def step(x):
        return x * 2.0

    prog = led.instrument(step, name="e2e.step")
    prog(torch.ones((2, 3)))
    mark = led.counts()
    prog(torch.ones((2, 3)))                     # seen signature
    assert led.compiles_since(mark) == {}
    prog(torch.ones((2, 4)))                     # new signature 1
    prog(torch.zeros((2, 5)))                    # new signature 2

    snap = led.snapshot()
    st = snap["programs"]["e2e.step"]
    assert st["compiles"] == 3 and st["recompiles"] == 2
    assert snap["total_compiles"] == 3 and snap["total_recompiles"] == 2

    cause = st["last_cause"]
    assert cause["arg"] == "x" and cause["kind"] == "shape"
    assert cause["old"] == "float32[2,4]"
    assert cause["new"] == "float32[2,5]"

    recs = snap["records"]
    assert [r["nth_compile"] for r in recs] == [1, 2, 3]
    assert recs[0]["cause"] is None              # first call: no diff
    assert recs[1]["cause"]["old"] == "float32[2,3]"
    assert recs[1]["cause"]["new"] == "float32[2,4]"
    assert all(r["program"] == "e2e.step" for r in recs)
    # the event's seconds are that first call's wall time
    assert recs[0]["compile_s"] > 0
    assert recs[0]["compile_s"] == recs[0]["call_s"]


def test_cause_diff_dtype_static_and_pytree():
    led, _ = _ledger()

    def g(x, flag=True):
        return x * 2.0 if flag else -x

    prog = led.instrument(g, name="e2e.static")
    x = torch.ones((2, 2))
    prog(x, flag=True)
    prog(x, flag=False)                          # static value change
    cause = led.snapshot()["programs"]["e2e.static"]["last_cause"]
    assert cause["arg"] == "flag" and cause["kind"] == "static"
    assert cause["old"] == "True" and cause["new"] == "False"

    def h(d):
        return d["a"] + 1

    tprog = led.instrument(h, name="e2e.tree")
    tprog({"a": torch.ones((2, 2))})
    tprog({"a": torch.ones((2, 3))})             # leaf shape change
    cause = led.snapshot()["programs"]["e2e.tree"]["last_cause"]
    assert cause["kind"] == "shape"
    assert cause["arg"].startswith("d") and "a" in cause["arg"]

    dprog = led.instrument(lambda x: x + 1, name="e2e.dtype")
    dprog(torch.ones((4,)))
    dprog(torch.ones((4,), dtype=torch.int32))   # dtype change
    cause = led.snapshot()["programs"]["e2e.dtype"]["last_cause"]
    assert cause["kind"] == "dtype"
    assert "float32" in cause["old"] and "int32" in cause["new"]

    # a dynamic argument (a seed, traced by the reference's jit) counts by
    # type alone: new values are no new signature
    sprog = led.instrument(lambda x, seed: x + seed, name="e2e.seed",
                           dynamic_argnames=("seed",))
    for seed in range(5):
        sprog(torch.ones(2), seed)
    assert led.snapshot()["programs"]["e2e.seed"]["compiles"] == 1


def test_storm_advisory_fires_exactly_once_per_episode():
    """threshold new signatures inside the window open ONE advisory;
    further ones while the episode is open stay silent; once the window
    drains the detector re-arms and a second storm raises a second
    advisory."""
    clk = FakeClock()
    led, pubs = _ledger(storm_threshold=3, storm_window_s=30.0,
                        clock=clk)
    prog = led.instrument(lambda x: x * 1.5, name="storm.prog")
    for n in (1, 2, 3, 4, 5):                    # 5 shapes, one episode
        prog(torch.ones((2, n)))
        clk.advance(1.0)
    storms = led.storm_advisories()
    assert len(storms) == 1 and len(pubs) == 1
    adv = storms[0]
    assert adv["kind"] == "recompile_storm"
    assert adv["program"] == "storm.prog"
    assert adv["compiles_in_window"] == 3
    assert adv["cause"]["kind"] == "shape"
    st = led.snapshot()["programs"]["storm.prog"]
    assert st["storm_episodes"] == 1 and st["storm_open"]

    clk.advance(120.0)                           # window drains
    assert not led.snapshot()["programs"]["storm.prog"]["storm_open"]
    for n in (6, 7, 8):                          # second episode
        prog(torch.ones((2, n)))
        clk.advance(1.0)
    assert len(led.storm_advisories()) == 2 and len(pubs) == 2
    assert led.snapshot()["programs"]["storm.prog"]["storm_episodes"] == 2

    # kernel builds are one-off events: no recompile, no storm
    for i in range(5):
        led.record_build(f"k{i}.cu", 0.5)
    kb = led.snapshot()["programs"]["kernels.build"]
    assert kb["compiles"] == 5 and kb["recompiles"] == 0
    assert kb["storm_episodes"] == 0
    assert kb["durations_total_s"]["backend_s"] == pytest.approx(2.5)
    assert len(pubs) == 2


def test_drain_advisories_cursor():
    led, _ = _ledger()
    led.push_advisory({"kind": "memory_watermark", "ts": 1.0},
                      publish=False)
    first = led.drain_advisories()
    assert [a["kind"] for a in first] == ["memory_watermark"]
    assert led.drain_advisories() == []          # cursor advanced
    led.push_advisory({"kind": "recompile_storm", "ts": 2.0},
                      publish=False)
    assert [a["kind"] for a in led.drain_advisories()] \
        == ["recompile_storm"]


def test_instrumented_program_is_transparent():
    led, _ = _ledger()

    def step(x):
        """docstring survives"""
        return x + 1

    step.tag = "proxied"
    prog = led.instrument(step, name="wrap.step")
    out = prog(torch.ones((3,)))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert prog.__doc__ == "docstring survives"
    # attribute proxying reaches the wrapped callable
    assert prog.tag == "proxied"
    # idempotent double-instrumentation
    assert led.instrument(prog) is prog


def test_executable_analysis_opt_in():
    """Eager PyTorch builds no executable to analyze: opt-in analysis
    records why, with no cost or memory fields, and never raises."""
    led, _ = _ledger(analysis=True)
    prog = led.instrument(lambda x: x @ x, name="an.prog")
    prog(torch.ones((8, 8)))
    rec = led.snapshot()["records"][-1]
    assert "analysis" in rec
    assert rec["analysis"] == {"note": devtel.ANALYSIS_NOTE}
    assert "cost" not in rec["analysis"] and "memory" not in rec["analysis"]


# ---------------------------------------------------------------------------
# memory census: live tensors, PageAllocator pages, gauges, watermark
# ---------------------------------------------------------------------------


def _gauge_value(name, tags=None):
    from ray_tpu_torch.util.metrics import _registry

    for m in _registry.snapshot():
        if m["name"] != name:
            continue
        for key, val in m.get("series", {}).items():
            if json.loads(key) == (tags or {}):
                return val
    return None


def test_census_counts_live_buffers_and_sets_hbm_gauge():
    keep = torch.ones((64, 64)) + 0              # a live tensor
    views = [keep[1:], keep.view(-1), keep.t()]  # views add no bytes
    census = devtel.get_census()
    snap = census.census()
    assert snap["live"]["count"] >= 1
    assert snap["live"]["total_bytes"] >= keep.nbytes
    assert snap["live"]["by_dtype"].get("float32", 0) >= keep.nbytes
    (slot,) = [s for s in snap["live"]["top_shapes"]
               if s["shape"] == [64, 64]]
    assert slot["count"] >= 1
    assert not any(s["shape"] in ([63, 64], [4096]) and s["bytes"]
                   for s in snap["live"]["top_shapes"])
    base = census.census()["live"]["total_bytes"]
    del views
    assert census.census()["live"]["total_bytes"] == base
    assert _gauge_value("ray_tpu_hbm_live_bytes") \
        == pytest.approx(census.census()["live"]["total_bytes"])
    assert snap["live"]["walk_s"] >= 0
    assert snap["live"]["allocator"] == {}       # no card in this process


def test_page_allocator_occupancy_flows_to_census_and_gauges():
    """Shared-prefix decode -> engine_stats shared/cow -> census owner
    report pages -> ray_tpu_kv_pages{state=...} gauges."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve._engine import ContinuousEngine

    cfg = gpt.GPTConfig.nano(max_seq=64, dtype=torch.float32)
    params = gpt.init(cfg, seed=0, device="cpu")
    eng = ContinuousEngine(gpt, cfg, params, cache="paged", max_slots=4,
                           page_size=8, device="cpu")
    # page-aligned prefix (2 full pages of 8): sharing needs fully
    # registered prompt pages, and the shared_len clamp to plen-1 forces
    # a COW copy of the last page for the joiner
    prompt = list(range(40, 56))
    try:
        a = eng.submit(prompt, max_new_tokens=24)
        deadline = time.time() + 60
        while eng.engine_stats()["prefills"] < 1:
            assert time.time() < deadline
            time.sleep(0.005)
        b = eng.submit(prompt, max_new_tokens=5)  # joins a's live prefix
        eng.collect(b, timeout=120)
        eng.collect(a, timeout=120)
        st = eng.engine_stats()
        assert st["shared_pages"] >= 1 and st["cow_copies"] >= 1

        snap = devtel.get_census().census()
        (tag, rep), = [(t, r) for t, r in snap["owners"].items()
                       if t.startswith("serve.engine.")]
        assert rep["pages"]["shared"] == st["shared_pages"]
        assert rep["pages"]["cow"] == st["cow_copies"]
        assert rep["pages"]["free"] + rep["pages"]["used"] \
            == st["num_pages"] - 1               # page 0 reserved
        for state in ("free", "used", "shared", "cow"):
            assert _gauge_value("ray_tpu_kv_pages",
                                {"state": state}) is not None
        assert _gauge_value("ray_tpu_kv_pages", {"state": "shared"}) >= 1
        assert _gauge_value("ray_tpu_kv_pages", {"state": "cow"}) >= 1
        # the engine's programs ran through the process ledger
        progs = devtel.get_ledger().snapshot()["programs"]
        assert progs["serve.prefill"]["compiles"] >= 1
        assert progs["serve.step"]["compiles"] >= 1
    finally:
        eng.stop()
    # stop() unregisters the owner
    assert not any(t.startswith("serve.engine.")
                   for t in devtel.get_census().census()["owners"])


def test_emergency_vault_footprint_in_census():
    from ray_tpu_torch.elastic import emergency

    with emergency._LOCK:                        # as the replicator does
        emergency._VAULT[(7, 0)] = b"x" * 4096
        emergency._VAULT_WORLDS[7] = 1
    try:
        vf = emergency.vault_footprint()
        assert vf == {"entries": 1, "bytes": 4096, "steps": 1}
        snap = devtel.get_census().census()
        assert snap["owners"]["emergency_vault"]["bytes"] == 4096
    finally:
        emergency._clear_vault()
    # empty vault: the built-in owner stays silent
    assert "emergency_vault" not in devtel.get_census().census()["owners"]


def test_memory_watermark_advisory_once_per_episode():
    led, pubs = _ledger()
    census = devtel.DeviceMemoryCensus(watermark_bytes=1, ledger=led)
    keep = torch.ones((16,)) + 0
    census.census()
    census.census()                              # still above: no repeat
    kinds = [a["kind"] for a in led.drain_advisories()]
    assert kinds == ["memory_watermark"]
    assert [p["kind"] for p in pubs] == ["memory_watermark"]
    del keep


# ---------------------------------------------------------------------------
# advisory -> remediation (advisory mode records, never acts)
# ---------------------------------------------------------------------------


def test_remediation_records_device_advisory():
    from ray_tpu_torch.elastic import ElasticConfig
    from ray_tpu_torch.elastic.remediation import RemediationEngine

    pub = []
    eng = RemediationEngine(ElasticConfig(), trial="t",
                            publish=pub.append,
                            control_call=lambda m, p: None)
    adv = {"event": "device_advisory", "kind": "recompile_storm",
           "program": "serve.step", "compiles_in_window": 4,
           "ts": 123.0, "cause": {"arg": "x", "kind": "shape",
                                  "old": "f32[2,3]", "new": "f32[2,4]"}}
    eng.observe_advisory(adv)
    assert len(eng.records) == 1
    rec = eng.records[0]
    assert rec["mode"] == "advisory"
    assert rec["action"]["kind"] == "observe_recompile_storm"
    assert rec["action"]["dry_run"] is True
    assert rec["cause"]["program"] == "serve.step"
    assert rec["ts"] == 123.0
    assert any(p.get("event") == "remediation_recommended" for p in pub)
    # malformed advisories never raise
    eng.observe_advisory(None)
    eng.observe_advisory({"no": "kind"})


# ---------------------------------------------------------------------------
# chrome-trace compile slices
# ---------------------------------------------------------------------------


def test_compile_trace_events():
    led, _ = _ledger()
    prog = led.instrument(lambda x: x * 3, name="tr.prog")
    prog(torch.ones((2, 2)))
    prog(torch.ones((2, 3)))
    workers = {"w1": {"ledger": led.snapshot(), "memory": {}}}
    events = devtel.compile_trace_events(workers)
    slices = [e for e in events if e.get("ph") == "X"]
    assert len(slices) == 2
    assert all(e["name"].startswith("compile tr.prog") for e in slices)
    assert any("recompile" in e.get("args", {}).get("cause", "")
               or "shape" in e.get("args", {}).get("cause", "")
               for e in slices[1:])
    from ray_tpu_torch.telemetry import validate_chrome_trace

    assert validate_chrome_trace({"traceEvents": events})


# ---------------------------------------------------------------------------
# cluster roundtrip: KV flush -> collect -> CLI / HTTP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_device_flush_collect_cli_and_http(cluster, capsys):
    from ray_tpu_torch._private.api import current_core
    from ray_tpu_torch.dashboard import DashboardHead
    from ray_tpu_torch.util.state import api as state

    keep = torch.ones((32, 32)) + 0              # a live tensor to census
    prog = devtel.instrument(lambda x: x + 1, name="clu.step")
    prog(torch.ones((2, 2)))
    prog(torch.ones((2, 3)))                     # one new signature
    devtel.get_ledger().record_build("clu.cu", 0.5)
    assert devtel.flush_device_snapshot(force=True)
    # rate limit: an immediate re-flush inside the interval is skipped
    assert not devtel.flush_device_snapshot(interval_s=60.0)
    wid = current_core().worker_id

    merged = devtel.collect_device_stats(current_core().control)
    wsnap = merged["workers"][wid]               # this driver's own
    st = wsnap["ledger"]["programs"]["clu.step"]
    assert st["compiles"] == 2 and st["recompiles"] == 1
    cause = st["last_cause"]
    assert cause["arg"] == "x"
    assert cause["old"] == "float32[2,2]"
    assert cause["new"] == "float32[2,3]"
    assert merged["total_compiles"] >= 3
    assert merged["total_recompiles"] >= 1
    assert merged["programs"]["clu.step"]["recompiles"] >= 1
    assert merged["live_bytes"] >= keep.nbytes
    assert wsnap["memory"]["live"]["count"] >= 1
    assert any(r["program"] == "kernels.build"
               for r in wsnap["ledger"]["records"])

    # state API mirrors the merge
    via_api = state.device_stats()
    assert via_api["workers"][wid]["ledger"]["programs"]["clu.step"][
        "recompiles"] == 1

    # HTTP route + timeline compile slices
    addr = rt.connection_info()["control_address"]
    head = DashboardHead(addr, port=0)
    head.start()
    try:
        status, body = _get(head.url + "/api/device/stats")
        assert status == 200
        got = json.loads(body)
        assert got["workers"][wid]["ledger"]["programs"]["clu.step"][
            "compiles"] == 2

        status, body = _get(head.url + "/api/train/timeline")
        assert status == 200
        trace = json.loads(body)
        names = {e.get("name") for e in trace["traceEvents"]}
        assert any(n and n.startswith("compile clu.step")
                   for n in names)
    finally:
        head.stop()

    # CLI rendering (text mode)
    from ray_tpu_torch.scripts import cli as cli_mod

    parser = cli_mod.build_parser()
    args = parser.parse_args(["device-stats", "--address", addr])
    args.fn(args)
    out = capsys.readouterr().out
    assert "clu.step" in out and "kernels.build" in out
    assert "shape" in out and "float32[2,2] -> float32[2,3]" in out
    assert f"worker {wid[:16]}" in out

    args = parser.parse_args(
        ["device-stats", "--address", addr, "--format", "json"])
    args.fn(args)
    out = capsys.readouterr().out
    assert json.loads(out)["workers"][wid]["ledger"][
        "total_recompiles"] == 1


def test_census_does_not_scale_with_the_heap(monkeypatch):
    """After the registry's seeding walk, a census scans only the young
    generations: half a million objects promoted to the old generation
    add nothing to what it scans, and a tensor promoted with them is
    still counted (the gc callback registered it on its way)."""
    import gc

    census = devtel.DeviceMemoryCensus()
    census.census()                                # seeds the registry
    junk = [{"k": [i]} for i in range(500_000)]    # non-tensor objects
    keep = torch.ones((128, 128)) + 0
    gc.collect()                       # promotes junk and keep to gen 2
    heap = len(gc.get_objects())
    live = census.census()["live"]
    assert heap > 1_000_000
    assert live["scanned"] < 50_000, live["scanned"]
    assert any(s["shape"] == [128, 128] and s["count"] >= 1
               for s in live["top_shapes"])
    stats = devtel.census_registry_stats()
    assert stats["registered"] >= 1 and stats["gc_scans"] >= 1
    del junk, keep


def test_census_counts_a_dtensor_as_its_local_shard():
    """A DTensor's wrapper holds no storage; its local shard is counted,
    once."""
    from ray_tpu_torch.parallel import (NamedSharding, PartitionSpec,
                                        distribute, make_mesh)

    census = devtel.DeviceMemoryCensus()
    base = census.census()["live"]["total_bytes"]
    d = distribute(torch.ones((96, 64)),
                   NamedSharding(make_mesh(device_type="cpu"),
                                 PartitionSpec("dp")))
    live = census.census()["live"]
    # the shard, and the mesh's own small tensor of ranks
    assert 96 * 64 * 4 <= live["total_bytes"] - base < 96 * 64 * 4 + 64
    (slot,) = [s for s in live["top_shapes"] if s["shape"] == [96, 64]]
    assert slot["count"] == 1 and slot["bytes"] == 96 * 64 * 4
    del d
