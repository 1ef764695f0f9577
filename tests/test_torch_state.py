"""State API + task events + timeline on the port's runtime: the cases of
tests/test_state.py against ``ray_tpu_torch.util.state`` and
``ray_tpu_torch.timeline`` (reference: python/ray/util/state), on one
cluster of the port's own per module.  The timeline case waits for its
events with a deadline where the reference's sleeps a fixed 1.5 s
against the workers' 1 s flush cadence; ``device_stats`` raises naming
the slice that ports the device telemetry."""

import json
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import state


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _flush():
    from ray_tpu_torch._private.api import current_core

    current_core().task_events.flush()


def _wait_for(pred, timeout=5.0):
    """Worker-side event buffers flush on a 1 s cadence; poll until
    visible instead of a fixed sleep."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = pred()
        if out:
            return out
        time.sleep(0.1)
    raise AssertionError(
        f"condition not met within timeout; "
        f"tasks={state.list_tasks(limit=50)}")


def test_list_nodes_and_workers(cluster):
    nodes = state.list_nodes()
    assert len(nodes) == 1
    assert nodes[0]["state"] == "ALIVE"
    assert "CPU" in nodes[0]["total"]
    # workers may still be prestarting; just check shape
    workers = state.list_workers()
    for w in workers:
        assert "worker_id" in w and "state" in w


def test_task_events_and_summary(cluster):
    @rt.remote
    def marked_task(x):
        return x + 1

    rt.get([marked_task.remote(i) for i in range(5)])
    _flush()

    def all_finished():
        # task names are qualnames (locals-scoped under pytest)
        ts = [t for t in state.list_tasks()
              if t.get("name", "").endswith("marked_task")]
        done = [t for t in ts if t["state"] == "FINISHED"]
        return done if len(done) == 5 else None

    finished = _wait_for(all_finished)
    # lifecycle timestamps present and ordered
    ts = finished[0]["state_ts"]
    assert ts["PENDING_ARGS_AVAIL"] <= ts["FINISHED"]

    s = state.summarize_tasks()
    by_name = {k: v for k, v in s["summary"].items()
               if k.endswith("marked_task")}
    assert sum(v.get("FINISHED", 0) for v in by_name.values()) == 5


def test_failed_task_recorded(cluster):
    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("nope")

    with pytest.raises(rt.TaskError):
        rt.get(boom.remote())
    _flush()
    # match this test's qualname exactly: other tests also name a task
    # "boom" and the shared session cluster retains their records
    tasks = _wait_for(lambda: [
        t for t in state.list_tasks()
        if t.get("name", "").endswith(
            "test_failed_task_recorded.<locals>.boom")
        and t["state"] == "FAILED"] or None)
    assert "nope" in tasks[0].get("error", "")


def test_list_actors_and_summary(cluster):
    @rt.remote
    class Counter:
        def bump(self):
            return 1

    c = Counter.remote()
    rt.get(c.bump.remote())
    # robust to leftover actors from other tests on a shared cluster
    mine = [a for a in state.list_actors(filters={"state": "ALIVE"})
            if "Counter" in (a.get("class_name") or "")]
    assert len(mine) == 1
    s = state.summarize_actors()
    assert s["total"] >= 1


def test_timeline_export(cluster, tmp_path):
    @rt.remote
    def traced():
        with rt.profile("inner_span"):
            time.sleep(0.01)
        return 1

    rt.get([traced.remote() for _ in range(3)], timeout=60)
    _flush()

    def exported():
        # worker-side buffers flush on a 1 s cadence: poll the export
        # until the tasks' and the spans' events are in it
        names = {e["name"] for e in json.loads(rt.timeline())}
        return (any(n.endswith("traced") for n in names)
                and "inner_span" in names)

    _wait_for(exported, timeout=30.0)
    out = tmp_path / "trace.json"
    rt.timeline(str(out))
    events = json.loads(out.read_text())
    names = {e["name"] for e in events}
    assert any(n.endswith("traced") for n in names)
    assert "inner_span" in names
    for e in events:
        assert e["ph"] == "X" and e["dur"] > 0


def test_state_api_with_explicit_address(cluster):
    addr = rt.connection_info()["control_address"]
    nodes = state.list_nodes(address=addr)
    assert len(nodes) == 1


def test_summarize_objects(cluster):
    import numpy as np

    ref = rt.put(np.zeros(1 << 20, np.uint8))
    s = state.summarize_objects()
    assert s["total_bytes"] >= (1 << 20)
    del ref


def test_list_and_get_logs(cluster):
    """Log listing + tail through the state API (reference: `ray logs`)."""
    @rt.remote
    def noisy():
        print("hello-from-noisy-task")
        return 1

    assert rt.get(noisy.remote(), timeout=60) == 1
    deadline = time.time() + 30
    found = None
    while time.time() < deadline and not found:
        logs = state.list_logs()
        for nid, entries in logs.items():
            workers = [e for e in entries
                       if e["name"].startswith("worker-")]
            if workers:
                found = (nid, workers)
                break
        time.sleep(0.5)
    assert found, f"no worker logs listed: {logs}"
    nid, workers = found
    # the print landed in some worker's log
    deadline = time.time() + 30
    while time.time() < deadline:
        texts = [t for e in workers
                 for t in [state.get_log(e["name"]).get(nid)] if t]
        if any("hello-from-noisy-task" in t for t in texts):
            break
        time.sleep(0.5)
        logs = state.list_logs()
        workers = [e for e in logs.get(nid, [])
                   if e["name"].startswith("worker-")]
    assert any("hello-from-noisy-task" in t for t in texts)


def test_device_stats_names_its_slice(cluster):
    """``device_stats`` merges every worker's flushed device snapshot,
    in the driver and from an unconnected process alike."""
    from ray_tpu_torch._private.core import current_core
    from ray_tpu_torch.telemetry import device as devtel
    from ray_tpu_torch.util.state import api

    devtel.get_ledger().record_build("state_probe.cu", 0.25)
    assert devtel.flush_device_snapshot(force=True)
    wid = current_core().worker_id
    for snap in (api.device_stats(),
                 api.device_stats(
                     address=rt.connection_info()["control_address"])):
        assert wid in snap["workers"], sorted(snap["workers"])
        led = snap["workers"][wid]["ledger"]
        assert any(r["program"] == "kernels.build"
                   and r["signature"][0]["value"] == "state_probe.cu"
                   for r in led["records"])
        assert "kernels.build" in snap["programs"]
