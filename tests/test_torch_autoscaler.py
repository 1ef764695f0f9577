"""Autoscaler on the port's runtime: the cases of tests/test_autoscaler.py
against ``ray_tpu_torch.autoscaler`` (reference: autoscaler tested against
FakeMultiNodeProvider launching local processes).  The GCP and Kubernetes
cases are their GPU-group versions: a gang of four ``{"GPU": 8}`` bundles
gives one group of four a3-highgpu-8g hosts (four pods on GKE's H100 node
pool), released as one.  What the port adds: a ``num_gpus=1`` demand on a
head without cards launches a GPU node (the task is cancelled there: no
card here to run it), and the node scales down once idle."""

import time

import pytest

from ray_tpu_torch.autoscaler import (GCPGpuNodeProvider, LocalNodeProvider,
                                      ResourceDemandScheduler,
                                      StandardAutoscaler)
from ray_tpu_torch.autoscaler.node_provider import (TAG_NODE_KIND,
                                                    TAG_NODE_TYPE)


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


def _driver(cluster, node):
    from ray_tpu_torch._private.core import CoreWorker

    return CoreWorker(cluster.control_addr, node.addr, mode="driver")


def test_demand_scheduler_bin_packing():
    sched = ResourceDemandScheduler(
        {"cpu4": {"resources": {"CPU": 4.0}, "max_workers": 10},
         "big": {"resources": {"CPU": 16.0}, "max_workers": 2}},
        max_workers=10)
    snapshot = {
        "nodes": [{"node_id": "head", "available": {"CPU": 1.0},
                   "total": {"CPU": 4.0}}],
        "demands": [{"CPU": 2.0}] * 5,  # 10 CPUs wanted, 1 free
        "idle_s": {},
    }
    launch = sched.get_nodes_to_launch(snapshot, {})
    # 4.5 demands unmet -> ffd packs 2 per cpu4 node
    assert launch == {"cpu4": 3}


def test_demand_scheduler_respects_max():
    sched = ResourceDemandScheduler(
        {"cpu4": {"resources": {"CPU": 4.0}, "max_workers": 1}},
        max_workers=1)
    snapshot = {"nodes": [], "demands": [{"CPU": 4.0}] * 5, "idle_s": {}}
    launch = sched.get_nodes_to_launch(snapshot, {})
    assert launch == {"cpu4": 1}


def test_gcp_gpu_provider_group_model():
    class FakeTransport:
        def __init__(self):
            self.created = []
            self.deleted = []

        def create_gpu_group(self, name, machine_type, hosts, zone):
            self.created.append((name, machine_type, hosts, zone))

        def delete_gpu_group(self, name):
            self.deleted.append(name)

    t = FakeTransport()
    p = GCPGpuNodeProvider({"transport": t, "zone": "us-east5-a"},
                           "testcluster")
    nodes = p.create_node({"machine_type": "a3-highgpu-8g", "hosts": 4},
                          {TAG_NODE_KIND: "worker",
                           TAG_NODE_TYPE: "h100x32"}, 1)
    # one group of 4 a3-highgpu-8g hosts = 4 host nodes, one API call
    assert len(nodes) == 4
    assert len(t.created) == 1
    assert t.created[0][1:] == ("a3-highgpu-8g", 4, "us-east5-a")
    tags = p.node_tags(nodes[0])
    assert tags["machine-type"] == "a3-highgpu-8g"
    assert tags["node-group"] == p.node_tags(nodes[3])["node-group"]
    assert sorted(p.node_tags(n)["group-worker-id"] for n in nodes) == \
        ["0", "1", "2", "3"]
    assert p._nodes[nodes[0]]["resources"] == {"CPU": 208.0, "GPU": 8.0}
    assert GCPGpuNodeProvider.host_resources("a3-highgpu-1g") == \
        {"CPU": 26.0, "GPU": 1.0}
    # terminating one host releases the whole group
    p.terminate_node(nodes[1])
    assert t.deleted == [t.created[0][0]]
    assert p.non_terminated_nodes({}) == []
    # without a transport, creation raises (no egress)
    with pytest.raises(RuntimeError, match="transport"):
        GCPGpuNodeProvider({}, "x").create_node(
            {"machine_type": "a3-highgpu-1g"}, {}, 1)


def test_autoscaler_scales_up_and_down(multi_node_cluster):
    """End-to-end: local provider launches real raylets; pending actors
    drive scale-up; idleness drives scale-down.

    Uses its own 1-CPU-head cluster — the scale-up assertion depends on
    the head NOT having room for the 2-CPU actors."""
    c = multi_node_cluster()
    head = c.add_node(resources={"CPU": 1})
    core = _driver(c, head)
    try:
        control = core.control
        addr = f"{c.control_addr[0]}:{c.control_addr[1]}"
        provider = LocalNodeProvider({"control_address": addr}, "t")
        autoscaler = StandardAutoscaler(
            {"max_workers": 3, "idle_timeout_minutes": 0.02,  # 1.2 s
             "available_node_types": {
                 "cpu2": {"resources": {"CPU": 2.0}, "min_workers": 0,
                          "max_workers": 3},
             }},
            provider, control)

        # nothing pending: no nodes
        autoscaler.update()
        assert autoscaler.num_launches == 0

        # demand more than the 1-CPU head can hold
        class Big:
            def ping(self):
                return 1

        aids = [core.create_actor(Big, (), {}, resources={"CPU": 2})
                for _ in range(2)]
        deadline = time.time() + 30
        while time.time() < deadline and autoscaler.num_launches == 0:
            autoscaler.update()
            time.sleep(0.2)
        assert autoscaler.num_launches >= 1
        # the actors eventually schedule on the new nodes (another tick
        # launches the second node once the first took one actor)
        refs = [core.submit_actor_task(a, "ping", (), {})[0] for a in aids]
        deadline = time.time() + 120
        while time.time() < deadline:
            ready, _ = core.wait(refs, num_returns=2, timeout=0.5)
            if len(ready) == 2:
                break
            autoscaler.update()
        assert core.get(refs, timeout=60) == [1, 1]

        # release demand -> idle timeout -> scale down to min (0)
        for a in aids:
            core.kill_actor(a)
        deadline = time.time() + 30
        while time.time() < deadline:
            autoscaler.update()
            if autoscaler.num_terminations >= autoscaler.num_launches:
                break
            time.sleep(0.5)
        assert autoscaler.num_terminations >= 1
        provider.shutdown()
    finally:
        core.shutdown()


def test_gpu_demand_launches_a_gpu_node(multi_node_cluster):
    """A ``num_gpus=1`` task pends on a head without cards; the autoscaler
    launches the one GPU node type, whose raylet offers the card through
    ``--resources``.  The head raylet hands the queued lease back once the
    GPU node can grant it, so the task reaches that node at once (where
    its worker refuses to run: this host has no card), the node goes
    idle, and it is terminated."""
    c = multi_node_cluster()
    head = c.add_node(resources={"CPU": 2})
    core = _driver(c, head)
    try:
        addr = f"{c.control_addr[0]}:{c.control_addr[1]}"
        provider = LocalNodeProvider({"control_address": addr}, "g")
        autoscaler = StandardAutoscaler(
            {"max_workers": 1, "idle_timeout_minutes": 0.02,
             "available_node_types": {
                 "gpu1": {"resources": {"CPU": 2.0, "GPU": 1.0},
                          "min_workers": 0, "max_workers": 1},
             }},
            provider, core.control)
        autoscaler.update()
        assert autoscaler.num_launches == 0

        def on_card():
            return "ran"

        (ref,) = core.submit_task(on_card, (), {}, max_retries=0,
                                  resources={"CPU": 1, "GPU": 1})
        deadline = time.time() + 30
        while time.time() < deadline and autoscaler.num_launches == 0:
            autoscaler.update()
            time.sleep(0.2)
        assert autoscaler.num_launches == 1
        (pid,) = provider.non_terminated_nodes({})
        assert provider.node_tags(pid)[TAG_NODE_TYPE] == "gpu1"
        nodes = {n["node_id"]: n for n in core.control.call(
            "get_nodes", {}, timeout=10.0)}
        assert nodes[pid]["total"].get("GPU") == 1.0
        assert "GPU" not in nodes[head.node_id]["total"]
        # a second tick sees the GPU capacity: no further launch
        autoscaler.update()
        assert autoscaler.num_launches == 1
        # well inside the owner's 120 s lease deadline
        t0 = time.time()
        with pytest.raises(Exception, match="CUDA finds no card"):
            core.get([ref], timeout=30)
        assert time.time() - t0 < 30
        deadline = time.time() + 60
        while time.time() < deadline and autoscaler.num_terminations == 0:
            autoscaler.update()
            time.sleep(0.3)
        assert autoscaler.num_terminations == 1
        assert provider.non_terminated_nodes({}) == []
        provider.shutdown()
    finally:
        core.shutdown()


def test_load_metrics_counts_only_unplaced_pending_actors():
    """An actor stays PENDING while its worker starts on the node it was
    placed on; only an actor no node holds yet is demand."""
    from ray_tpu_torch.autoscaler import LoadMetrics

    class Control:
        def call(self, method, payload=None, timeout=None):
            if method == "get_nodes":
                return []
            if method == "state_dump":
                return {"actors": [
                    {"state": "PENDING", "node_id": None,
                     "resources": {"CPU": 1.0, "GPU": 0.5}},
                    {"state": "PENDING", "node_id": "node-a",
                     "resources": {"CPU": 1.0, "GPU": 0.5}},
                    {"state": "ALIVE", "node_id": "node-a",
                     "resources": {"GPU": 1.0}}],
                    "pgs": [{"state": "PENDING",
                             "bundles": [{"GPU": 8.0}]}]}
            return None

    snap = LoadMetrics(Control()).snapshot()
    assert snap["demands"] == [{"CPU": 1.0, "GPU": 0.5}, {"GPU": 8.0}]
    # the trainer publishes no goodput until the port's telemetry lands
    assert snap["train_goodput"] == {} and snap["serve_load"] == {}


class _FakeKubeApi:
    """In-memory API server: create assigns names, pods go Running
    immediately (the fake kubelet), list filters by label selector."""

    def __init__(self):
        self.pods = {}          # name -> manifest
        self.deleted = []
        self._n = 0

    def create_pod(self, namespace, manifest):
        meta = manifest["metadata"]
        name = meta.get("name")
        if not name:
            self._n += 1
            name = meta["generateName"] + f"{self._n:04d}"
        manifest = {**manifest,
                    "metadata": {**meta, "name": name},
                    "status": {"phase": "Running"}}
        self.pods[name] = manifest
        return manifest

    def list_pods(self, namespace, label_selector):
        want = dict(kv.split("=", 1)
                    for kv in label_selector.split(",") if kv)
        return [p for p in self.pods.values()
                if all(p["metadata"]["labels"].get(k) == v
                       for k, v in want.items())]

    def delete_pod(self, namespace, name):
        self.pods.pop(name, None)
        self.deleted.append(name)


class _FakeControl:
    """Control-plane stub for LoadMetrics: scripted get_nodes /
    state_dump responses."""

    def __init__(self):
        self.nodes = []
        self.pending_pg_bundles = []

    def call(self, method, payload=None, timeout=None):
        if method == "get_nodes":
            return self.nodes
        if method == "state_dump":
            return {"actors": [],
                    "pgs": ([{"state": "PENDING",
                              "bundles": self.pending_pg_bundles}]
                            if self.pending_pg_bundles else [])}
        raise AssertionError(method)


def test_kubernetes_provider_gpu_group_e2e():
    """KubeRay/GKE-shaped provider, fake API server end to end: a pending
    GPU gang drives `up` -> one group of four a3-highgpu-8g hosts = 4
    pods with GKE's GPU selector, nvidia.com/gpu limits and the group
    labels; the demand then fits (no further launches); idleness drives
    scale-down, which releases the WHOLE group atomically."""
    from ray_tpu_torch.autoscaler.node_provider import (
        KubernetesNodeProvider, make_node_provider)

    api = _FakeKubeApi()
    provider = make_node_provider(
        {"type": "kubernetes", "api_client": api, "namespace": "ray"},
        "kube-gpu")
    assert isinstance(provider, KubernetesNodeProvider)
    control = _FakeControl()
    # the pods' raylets: one stub answering LoadMetrics' probe with no
    # queued demand (an unreachable address would hold each probe for
    # its 30 s connect timeout)
    from ray_tpu_torch._private.protocol import Server

    raylet = Server(name="fake-raylet")
    raylet.handle("pending_demands", lambda conn, p: [])
    raylet.start()
    autoscaler = StandardAutoscaler(
        {"max_workers": 8, "idle_timeout_minutes": 0.005,   # 0.3 s
         "available_node_types": {
             # a node type is one GROUP (the schedulable gang unit)
             "h100x32": {
                 "resources": {"CPU": 832.0, "GPU": 32.0},
                 "node_config": {"accelerator": "nvidia-h100-80gb",
                                 "machine_type": "a3-highgpu-8g",
                                 "hosts": 4},
                 "min_workers": 0, "max_workers": 2},
         }},
        provider, control)

    # `up` with a pending 4-host GPU gang (a placement group of GPU:8
    # bundles, one per host)
    control.pending_pg_bundles = [{"GPU": 8.0} for _ in range(4)]
    autoscaler.update()
    assert autoscaler.num_launches == 4          # 4 pods = ONE group
    pods = list(api.pods.values())
    assert len(pods) == 4
    groups = {p["metadata"]["labels"]["node-group"] for p in pods}
    assert len(groups) == 1
    workers = sorted(p["metadata"]["labels"]["group-worker-id"]
                     for p in pods)
    assert workers == ["0", "1", "2", "3"]
    for p in pods:
        sel = p["spec"]["nodeSelector"]
        assert sel == {"cloud.google.com/gke-accelerator":
                       "nvidia-h100-80gb"}
        c0 = p["spec"]["containers"][0]
        assert c0["resources"]["limits"]["nvidia.com/gpu"] == 8
        assert {"name": "RAY_TPU_TORCH_NODE_ID", "valueFrom": {
            "fieldRef": {"fieldPath": "metadata.name"}}} in c0["env"]
        assert p["metadata"]["labels"]["ray.io/node-type"] == "h100x32"

    # the gang PLACED on its group: pg no longer pending, cards busy —
    # a second reconcile neither launches nor scales down
    control.pending_pg_bundles = []
    control.nodes = [
        {"node_id": p["metadata"]["name"], "state": "ALIVE",
         "addr": list(raylet.addr),
         "available": {"CPU": 208.0, "GPU": 0.0},   # gang holds cards
         "total": {"CPU": 208.0, "GPU": 8.0}}
        for p in api.pods.values()]
    autoscaler.update()
    assert autoscaler.num_launches == 4
    assert len(api.pods) == 4

    # gang done: no demand, cards free -> idle timeout -> the WHOLE
    # group scales down together
    for n in control.nodes:
        n["available"] = dict(n["total"])
    deadline = time.time() + 10
    while time.time() < deadline and api.pods:
        autoscaler.update()
        time.sleep(0.1)
    raylet.stop()
    assert api.pods == {}
    assert sorted(api.deleted) == sorted(
        p["metadata"]["name"] for p in pods)
