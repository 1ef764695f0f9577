"""Metrics API + dashboard HTTP backend on the port: the cases of
tests/test_metrics_dashboard.py against ``ray_tpu_torch.util.metrics``
and ``ray_tpu_torch.dashboard`` (reference: ray.util.metrics,
python/ray/dashboard), one cluster of the port's own per module."""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram,
                                  collect_cluster_metrics, prometheus_text)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_metric_types_and_snapshot(cluster):
    c = Counter("test_requests_total", description="reqs",
                tag_keys=("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2.0, tags={"route": "/a"})
    c.inc(tags={"route": "/b"})
    snap = c._snapshot()
    assert snap["type"] == "counter"
    vals = {json.loads(k)["route"]: v for k, v in snap["series"].items()}
    assert vals == {"/a": 3.0, "/b": 1.0}

    g = Gauge("test_temperature", tag_keys=("zone",))
    g.set(21.5, tags={"zone": "x"})
    g.set(22.5, tags={"zone": "x"})
    assert list(g._snapshot()["series"].values()) == [22.5]

    h = Histogram("test_latency", boundaries=[0.1, 1.0, 10.0])
    h.observe(0.05)
    h.observe(0.5)
    h.observe(100.0)  # above top boundary -> only +Inf/count
    counts, total, num = list(h._snapshot()["series"].values())[0]
    assert counts == [1, 1, 0]
    assert num == 3
    assert total == pytest.approx(100.55)


def test_counter_validation(cluster):
    c = Counter("test_valid", tag_keys=("a",))
    with pytest.raises(ValueError):
        c.inc(0)
    with pytest.raises(ValueError):
        c.inc(1, tags={"bogus": "t"})


def test_metrics_flush_and_prometheus(cluster):
    from ray_tpu_torch._private.api import current_core
    from ray_tpu_torch.util.metrics import _registry

    c = Counter("test_flush_total", tag_keys=())
    c.inc(5)
    _registry.flush()
    merged = collect_cluster_metrics(current_core().control)
    mine = [m for m in merged if m["name"] == "test_flush_total"]
    assert mine
    text = prometheus_text(merged)
    assert "# TYPE test_flush_total counter" in text
    assert "test_flush_total{" in text


def test_metrics_from_remote_task(cluster):
    @ray_tpu_torch.remote
    def emits():
        from ray_tpu_torch.util.metrics import Counter as C
        from ray_tpu_torch.util.metrics import _registry

        c = C("test_remote_metric_total", tag_keys=())
        c.inc(7)
        _registry.flush()
        return True

    assert ray_tpu_torch.get(emits.remote())
    from ray_tpu_torch._private.api import current_core

    merged = collect_cluster_metrics(current_core().control)
    assert any(m["name"] == "test_remote_metric_total" for m in merged)
    # the task's worker computed nothing on a card: no torch loaded there

    @ray_tpu_torch.remote
    def loaded():
        import sys

        return "torch" in sys.modules

    assert ray_tpu_torch.get(loaded.remote()) is False


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_dashboard_endpoints(cluster):
    from ray_tpu_torch.dashboard import DashboardHead

    addr = ray_tpu_torch.connection_info()["control_address"]
    head = DashboardHead(addr, port=0)
    head.start()
    try:
        status, body = _get(head.url + "/healthz")
        assert status == 200 and body == "success"

        status, body = _get(head.url + "/api/cluster_status")
        data = json.loads(body)
        assert data["alive_nodes"] == 1
        assert "CPU" in data["total_resources"]
        status, body = _get(head.url + "/")
        assert status == 200 and "GPU free/total" in body

        @ray_tpu_torch.remote
        class DashActor:
            def hi(self):
                return 1

        a = DashActor.remote()
        ray_tpu_torch.get(a.hi.remote())
        status, body = _get(head.url + "/api/actors")
        actors = json.loads(body)
        assert any("DashActor" in (x.get("class_name") or "")
                   for x in actors)

        status, body = _get(head.url + "/api/tasks?limit=10")
        assert status == 200
        assert "records" in json.loads(body)

        # metrics scrape endpoint
        from ray_tpu_torch.util.metrics import _registry

        # hold the ref: the registry is weak (dropped metrics are swept,
        # not flushed forever)
        dash_total = Counter("test_dash_total", tag_keys=())
        dash_total.inc(1)
        _registry.flush()
        status, body = _get(head.url + "/metrics")
        assert status == 200
        assert "test_dash_total" in body

        status, body = _get(head.url + "/api/version")
        assert json.loads(body)["ray_tpu_version"]

        status, _ = _get(head.url + "/api/jobs")
        assert status == 200
    finally:
        head.stop()
