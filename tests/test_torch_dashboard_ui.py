"""The port's dashboard serves a live HTML UI at / (the stand-in for the
reference's React client, dashboard/client/): the cases of
tests/test_dashboard_ui.py against ``ray_tpu_torch.dashboard``; the
trainer's run (telemetry on by default) also carries its goodput."""

import urllib.error
import urllib.parse
import urllib.request

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def dashboard(ray_cluster):
    from ray_tpu_torch.dashboard.head import DashboardHead

    info = ray_tpu_torch.connection_info()
    head = DashboardHead(info["control_address"], port=0)
    head.start()
    yield head
    head.stop()


def test_serve_status_panel(dashboard):
    """The serve controller publishes reconcile-time status into the
    control KV; /api/serve surfaces it and the page renders it."""
    import json
    import time

    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=1)
    class Hello:
        async def __call__(self, request):
            return {"ok": True}

    serve.run(Hello.bind(), name="dash_app", route_prefix="/dash")
    try:
        deadline = time.time() + 60
        apps = []
        while time.time() < deadline:
            with urllib.request.urlopen(dashboard.url + "/api/serve",
                                        timeout=30) as r:
                snap = json.loads(r.read().decode())
            apps = snap.get("apps") or []
            if any(a["app"] == "dash_app" and a["deployments"]
                   for a in apps):
                break
            time.sleep(0.5)
        app = next(a for a in apps if a["app"] == "dash_app")
        assert app["route_prefix"] == "/dash"
        dep = app["deployments"][0]
        assert dep["replicas"].endswith("/1")
        # the page itself carries the panel
        with urllib.request.urlopen(dashboard.url + "/", timeout=30) as r:
            body = r.read().decode()
        assert "/api/serve" in body and 'id="serve"' in body
    finally:
        serve.shutdown()


def test_train_runs_panel(dashboard, tmp_path):
    """Trainer runs publish their state into the control KV; /api/train
    lists them newest-first."""
    import json

    from ray_tpu_torch import train
    from ray_tpu_torch.train import JaxTrainer, RunConfig, ScalingConfig

    def loop(config):
        train.report({"loss": 1.5})

    JaxTrainer(loop, train_loop_config={},
               scaling_config=ScalingConfig(num_workers=1),
               run_config=RunConfig(name="dash_run",
                                    storage_path=str(tmp_path))).fit()
    with urllib.request.urlopen(dashboard.url + "/api/train",
                                timeout=30) as r:
        runs = json.loads(r.read().decode())
    run = next(x for x in runs if x["name"] == "dash_run")
    assert run["status"] == "FINISHED"
    assert run["workers"] == 1 and run["rounds"] == 1
    assert run["last_metrics"]["loss"] == 1.5
    # the flight recorder is on by default: the run state carries the
    # goodput the autoscaler's LoadMetrics reads
    assert run["telemetry"]["goodput"]["seconds"]["productive"] > 0
    with urllib.request.urlopen(dashboard.url + "/", timeout=30) as r:
        assert 'id="train"' in r.read().decode()


def test_root_serves_html_ui(dashboard):
    with urllib.request.urlopen(dashboard.url + "/", timeout=30) as r:
        assert r.status == 200
        assert r.headers.get_content_type() == "text/html"
        body = r.read().decode()
    # the page drives the JSON API the head actually serves
    for endpoint in ("/api/cluster_status", "/api/nodes", "/api/actors",
                     "/api/jobs", "/api/placement_groups"):
        assert endpoint in body
    assert "ray_tpu_torch" in body


def test_ui_has_timeline_and_utilization_views(dashboard):
    """The canvas views (task timeline + utilization charts) ship in the
    page and reference real API fields (state_ts from /api/tasks)."""
    with urllib.request.urlopen(dashboard.url + "/", timeout=30) as r:
        body = r.read().decode()
    assert 'id="timeline"' in body
    assert 'id="util"' in body
    assert "state_ts" in body        # timeline derives spans from it
    assert "sparkline" in body       # per-node utilization cells


def _get_json(url):
    import json

    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_node_drilldown_endpoint(dashboard):
    """Per-node detail: node view + live worker/lease tables + log list
    (reference: the dashboard's node detail page)."""
    # ensure at least one worker exists
    @ray_tpu_torch.remote
    def warm():
        print("drill-down-marker")
        return 1

    assert ray_tpu_torch.get(warm.remote(), timeout=60) == 1
    nodes = _get_json(dashboard.url + "/api/nodes")
    nid = nodes[0]["node_id"]
    d = _get_json(dashboard.url + "/api/node?node_id=" + nid)
    assert d["node_id"] == nid and d["state"] == "ALIVE"
    assert isinstance(d["workers"], list) and d["workers"]
    assert isinstance(d["leases"], list)
    assert any(lg.get("name") for lg in d["logs"])
    # log tail round-trips through the raylet's read_log
    name = d["logs"][0]["name"]
    t = _get_json(dashboard.url + "/api/log_tail?node_id=" + nid
                  + "&name=" + urllib.parse.quote(name))
    assert t["name"] == name and isinstance(t["text"], str)
    with pytest.raises(urllib.error.HTTPError):
        _get_json(dashboard.url + "/api/node?node_id=nope")


def test_actor_drilldown_endpoint(dashboard):
    @ray_tpu_torch.remote
    class Probe:
        def hit(self):
            return 1

    a = Probe.remote()
    assert ray_tpu_torch.get(a.hit.remote(), timeout=60) == 1
    actors = _get_json(dashboard.url + "/api/actors")
    rec = next(r for r in actors if r["class_name"] == "Probe"
               and r["state"] == "ALIVE")
    d = _get_json(dashboard.url + "/api/actor?actor_id="
                  + rec["actor_id"])
    assert d["actor_id"] == rec["actor_id"]
    assert isinstance(d["task_events"], list)
    ray_tpu_torch.kill(a)


def test_ui_ships_drilldown_panel(dashboard):
    with urllib.request.urlopen(dashboard.url + "/", timeout=30) as r:
        body = r.read().decode()
    assert 'id="panel"' in body
    assert "openNode" in body and "openActor" in body
    assert "/api/log_tail" in body
