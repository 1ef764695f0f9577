"""Node providers: pluggable machine lifecycle backends.

Analog of the reference's NodeProvider interface (reference:
python/ray/autoscaler/node_provider.py) with three implementations:

  * LocalNodeProvider — "launches" nodes as local raylet processes
    against the running control plane (the reference's
    FakeMultiNodeProvider pattern, autoscaler/_private/fake_multi_node/
    node_provider.py) — the workhorse for autoscaler tests.
  * GCPGpuNodeProvider — models GCE GPU VM provisioning: one *group* of
    ``hosts`` VMs of one A3 machine type is the atomic unit.  API calls
    are delegated to an injectable transport so it is testable offline
    (zero egress here).
  * KubernetesNodeProvider — one ray worker = one pod on GKE, a GPU
    group being one pod per host on the accelerator's node pool.

The port's copy of ``ray_tpu/autoscaler/node_provider.py``: the two
cloud providers model GPU groups where the reference's model TPU pod
slices (``node-group`` / ``group-worker-id`` for ``tpu-slice`` /
``tpu-worker-id``); ROADMAP §C says what else differs.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

TAG_NODE_KIND = "node-kind"        # head | worker
TAG_NODE_TYPE = "node-type"        # user node type name
TAG_NODE_STATUS = "node-status"    # pending | up-to-date | terminated
#: the schedulable unit: every host of one GPU group carries its name
TAG_NODE_GROUP = "node-group"
TAG_GROUP_WORKER = "group-worker-id"


class NodeProvider:
    """Machine lifecycle interface (reference: node_provider.py)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str):
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Launch raylets as local processes joined to a live control plane.

    provider_config: {"control_address": "host:port"}.
    node_config: {"resources": {...}, "labels": {...}}.  A node type with
    ``{"GPU": n}`` in its resources starts a raylet that offers n cards
    (workers holding a GPU lease see every card of the host).
    """

    def __init__(self, provider_config, cluster_name):
        super().__init__(provider_config, cluster_name)
        from .._private.bootstrap import Cluster

        addr = provider_config["control_address"].rsplit(":", 1)
        self._cluster = Cluster(
            session_name=f"autoscaler-{cluster_name}-{uuid.uuid4().hex[:6]}")
        self._cluster.control_addr = (addr[0], int(addr[1]))
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[str, Any]] = {}  # id -> {handle, tags}

    def non_terminated_nodes(self, tag_filters):
        with self._lock:
            out = []
            for nid, rec in self._nodes.items():
                if rec["tags"].get(TAG_NODE_STATUS) == "terminated":
                    continue
                if all(rec["tags"].get(k) == v
                       for k, v in tag_filters.items()):
                    out.append(nid)
            return out

    def node_tags(self, node_id):
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def create_node(self, node_config, tags, count):
        created = []
        for _ in range(count):
            handle = self._cluster.add_node(
                resources=node_config.get("resources"),
                labels=node_config.get("labels"), wait=True)
            nid = handle.node_id
            with self._lock:
                self._nodes[nid] = {
                    "handle": handle,
                    "tags": {**tags, TAG_NODE_STATUS: "up-to-date"},
                }
            created.append(nid)
        return created

    def terminate_node(self, node_id):
        with self._lock:
            rec = self._nodes.get(node_id)
        if rec is None:
            return
        rec["handle"].terminate()
        with self._lock:
            rec["tags"][TAG_NODE_STATUS] = "terminated"

    def is_running(self, node_id):
        with self._lock:
            rec = self._nodes.get(node_id)
        return rec is not None and rec["handle"].proc.poll() is None

    def shutdown(self):
        with self._lock:
            recs = list(self._nodes.values())
        for rec in recs:
            try:
                rec["handle"].terminate()
            except Exception:
                pass


class GCPGpuNodeProvider(NodeProvider):
    """GCE GPU VM group provisioning model (offline, transport-injected).

    A node type names a GCE ``machine_type`` and ``hosts`` (default 1);
    one create_node provisions a *group* of that many VMs, each host a
    node tagged with the group, its index in it and its machine type, so
    that ``min_workers``/``max_workers`` count groups and a group is
    released as one (as the reference releases a TPU slice).

    The machine table is GCE's published A3 machine series (Google Cloud
    documentation, "Accelerator-optimized machine family", A3 High and
    A3 Mega machine types: a3-highgpu-1g/2g/4g/8g with 1/2/4/8 H100 80GB
    GPUs and 26/52/104/208 vCPUs; a3-megagpu-8g with 8 and 208).

    provider_config["transport"]: object with
    create_gpu_group(name, machine_type, hosts, zone) /
    delete_gpu_group(name) — a real GCE client in production, a fake in
    tests.  Without one, creation raises (zero egress).
    """

    #: machine type -> (H100 GPUs, vCPUs) per host
    MACHINE_TYPES = {
        "a3-highgpu-1g": (1, 26),
        "a3-highgpu-2g": (2, 52),
        "a3-highgpu-4g": (4, 104),
        "a3-highgpu-8g": (8, 208),
        "a3-megagpu-8g": (8, 208),
    }

    def __init__(self, provider_config, cluster_name):
        super().__init__(provider_config, cluster_name)
        self.transport = provider_config.get("transport")
        self.zone = provider_config.get("zone", "us-central1-a")
        self._lock = threading.Lock()
        self._nodes: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def host_resources(cls, machine_type: str) -> Dict[str, float]:
        """"a3-highgpu-8g" -> {"CPU": 208.0, "GPU": 8.0}."""
        if machine_type not in cls.MACHINE_TYPES:
            raise ValueError(f"unknown GPU machine type {machine_type!r} "
                             f"(known: {sorted(cls.MACHINE_TYPES)})")
        gpus, vcpus = cls.MACHINE_TYPES[machine_type]
        return {"CPU": float(vcpus), "GPU": float(gpus)}

    def create_node(self, node_config, tags, count):
        if self.transport is None:
            raise RuntimeError(
                "GCPGpuNodeProvider needs provider_config['transport'] "
                "(a GCE compute API client); none configured")
        machine = node_config["machine_type"]
        hosts = int(node_config.get("hosts", 1))
        resources = self.host_resources(machine)
        created = []
        for _ in range(count):
            group = f"{self.cluster_name}-{uuid.uuid4().hex[:8]}"
            self.transport.create_gpu_group(group, machine, hosts,
                                            self.zone)
            for w in range(hosts):
                nid = f"{group}-w{w}"
                with self._lock:
                    self._nodes[nid] = {
                        "group": group,
                        "tags": {
                            **tags,
                            TAG_NODE_STATUS: "up-to-date",
                            TAG_NODE_GROUP: group,
                            TAG_GROUP_WORKER: str(w),
                            "machine-type": machine,
                        },
                        "resources": dict(resources),
                        "created_at": time.time(),
                    }
                created.append(nid)
        return created

    def non_terminated_nodes(self, tag_filters):
        with self._lock:
            return [nid for nid, rec in self._nodes.items()
                    if rec["tags"].get(TAG_NODE_STATUS) != "terminated"
                    and all(rec["tags"].get(k) == v
                            for k, v in tag_filters.items())]

    def node_tags(self, node_id):
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def terminate_node(self, node_id):
        """Terminating any host of a group releases the whole group (the
        unit provisions and releases as one)."""
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None:
                return
            group = rec["group"]
            peers = [n for n, r in self._nodes.items()
                     if r.get("group") == group]
        if self.transport is not None:
            self.transport.delete_gpu_group(group)
        with self._lock:
            for n in peers:
                self._nodes[n]["tags"][TAG_NODE_STATUS] = "terminated"

    def is_running(self, node_id):
        with self._lock:
            rec = self._nodes.get(node_id)
        return rec is not None and \
            rec["tags"].get(TAG_NODE_STATUS) == "up-to-date"


class KubernetesNodeProvider(NodeProvider):
    """KubeRay/GKE-shaped provider: one ray worker = one pod, managed
    through the Kubernetes API (reference:
    autoscaler/_private/kuberay/node_provider.py — pods carry ray.io/*
    labels; the autoscaler reconciles by creating/deleting pods, and
    the kubelet/scheduler does the rest).

    A GPU group follows GKE's GPU recipe: a node type with
    ``accelerator`` (GKE's accelerator label value, e.g.
    "nvidia-h100-80gb") and ``hosts`` creates ONE POD PER HOST, each
    pinned to the accelerator's node pool by the
    ``cloud.google.com/gke-accelerator`` node selector and requesting
    ``nvidia.com/gpu`` cards (GKE documentation, "Run GPUs in GKE Standard
    node pools": the node label and the device plugin's resource name).
    The group labels are what the autoscaler counts and releases as one
    unit.  Cards per host come from ``gpus_per_host``, else from
    ``machine_type`` (GCPGpuNodeProvider's table), else 1.

    provider_config:
      namespace: k8s namespace (default "default")
      api_client: duck-typed API server client —
          create_pod(namespace, manifest) -> manifest (server fills
              metadata.name if generateName was used)
          list_pods(namespace, label_selector) -> [pod dicts]
          delete_pod(namespace, name)
        a real kubernetes.client.CoreV1Api adapter in production, a
        fake in tests (zero egress here).
      pod_template: optional baseline pod manifest merged under ours.
    """

    RAY_CLUSTER_LABEL = "ray.io/cluster"
    RAY_TYPE_LABEL = "ray.io/node-type"
    RAY_KIND_LABEL = "ray.io/node-kind"
    #: GKE's GPU node-pool selector
    GKE_ACCEL_SELECTOR = "cloud.google.com/gke-accelerator"
    #: the NVIDIA device plugin's extended resource
    GPU_RESOURCE = "nvidia.com/gpu"

    #: pod-list cache TTL: a reconcile tick calls node_tags once per
    #: node, and each would otherwise LIST every cluster pod — O(P^2)
    #: API-server requests per tick at scale
    LIST_CACHE_TTL_S = 2.0

    def __init__(self, provider_config, cluster_name):
        super().__init__(provider_config, cluster_name)
        self.api = provider_config.get("api_client")
        if self.api is None:
            self.api = _default_kubernetes_client()
        self.namespace = provider_config.get("namespace", "default")
        self.pod_template = provider_config.get("pod_template") or {}
        self._pods_cache: Optional[Dict[str, Dict]] = None
        self._pods_cache_at = 0.0

    # -- pod <-> node mapping ---------------------------------------------
    # (one TTL-cached LIST per tick; tag filters apply client-side on
    # the cached manifests rather than as server-side label selectors)

    def _cluster_pods(self) -> Dict[str, Dict]:
        now = time.monotonic()
        if self._pods_cache is None \
                or now - self._pods_cache_at > self.LIST_CACHE_TTL_S:
            pods = self.api.list_pods(
                self.namespace,
                f"{self.RAY_CLUSTER_LABEL}={self.cluster_name}")
            self._pods_cache = {p["metadata"]["name"]: p for p in pods}
            self._pods_cache_at = now
        return self._pods_cache

    def _invalidate(self):
        self._pods_cache = None

    def non_terminated_nodes(self, tag_filters):
        want = {_tag_to_label(k): v for k, v in tag_filters.items()}
        return [name for name, p in self._cluster_pods().items()
                if p.get("status", {}).get("phase")
                not in ("Succeeded", "Failed")
                and all(p["metadata"]["labels"].get(k) == v
                        for k, v in want.items())]

    def node_tags(self, node_id):
        p = self._cluster_pods().get(node_id)
        if p is None:
            # a pod deleted mid-reconcile (e.g. its group peer was
            # terminated this tick) is just gone, not an error
            return {}
        return {_label_to_tag(k): v
                for k, v in p["metadata"]["labels"].items()}

    def is_running(self, node_id):
        p = self._cluster_pods().get(node_id)
        return p is not None and \
            p.get("status", {}).get("phase") == "Running"

    # -- create / delete ---------------------------------------------------

    def create_node(self, node_config, tags, count):
        acc = node_config.get("accelerator")
        created = []
        for _ in range(count):
            if acc:
                created += self._create_gpu_group_pods(node_config, tags)
            else:
                created.append(self._create_pod(node_config, tags, {}))
        return created

    @staticmethod
    def gpus_per_host(node_config) -> int:
        if node_config.get("gpus_per_host") is not None:
            return int(node_config["gpus_per_host"])
        machine = node_config.get("machine_type")
        if machine:
            return int(GCPGpuNodeProvider.host_resources(machine)["GPU"])
        return 1

    def _create_gpu_group_pods(self, node_config, tags) -> List[str]:
        acc = node_config["accelerator"]
        hosts = int(node_config.get("hosts", 1))
        per_host = self.gpus_per_host(node_config)
        group = f"{self.cluster_name}-{uuid.uuid4().hex[:8]}"
        names = []
        for w in range(hosts):
            extra = {
                "labels": {TAG_NODE_GROUP: group,
                           TAG_GROUP_WORKER: str(w),
                           "accelerator": acc},
                "nodeSelector": {self.GKE_ACCEL_SELECTOR: acc},
                "resources": {self.GPU_RESOURCE: per_host},
            }
            names.append(self._create_pod(node_config, tags, extra,
                                          name=f"{group}-w{w}"))
        return names

    def _create_pod(self, node_config, tags, extra,
                    name: Optional[str] = None) -> str:
        labels = {self.RAY_CLUSTER_LABEL: self.cluster_name}
        for k, v in tags.items():
            labels[_tag_to_label(k)] = v
        labels.update(extra.get("labels", {}))
        spec = dict(self.pod_template.get("spec", {}))
        if extra.get("nodeSelector"):
            spec["nodeSelector"] = {**spec.get("nodeSelector", {}),
                                    **extra["nodeSelector"]}
        containers = spec.get("containers") or [{"name": "ray-worker"}]
        c0 = dict(containers[0])
        limits = dict(node_config.get("custom_resources", {}))
        limits.update(extra.get("resources", {}))
        if limits:
            # merge INTO the template's resources: clobbering the dict
            # would drop its requests and the kube scheduler would place
            # the pod as if it needed no cpu/memory
            res = dict(c0.get("resources", {}))
            res["limits"] = {**res.get("limits", {}), **limits}
            c0["resources"] = res
        # downward API: the raylet inside the pod registers with the
        # POD NAME as its control-plane node id (node.py honors
        # RAY_TPU_TORCH_NODE_ID), which is what lets the autoscaler match
        # control-plane idleness back to a pod for scale-down
        env = [e for e in c0.get("env", [])
               if e.get("name") != "RAY_TPU_TORCH_NODE_ID"]
        env.append({"name": "RAY_TPU_TORCH_NODE_ID", "valueFrom": {
            "fieldRef": {"fieldPath": "metadata.name"}}})
        c0["env"] = env
        containers = [c0, *containers[1:]]
        spec["containers"] = containers
        tmeta = self.pod_template.get("metadata", {})
        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                **({"name": name} if name
                   else {"generateName": f"{self.cluster_name}-worker-"}),
                "labels": {**tmeta.get("labels", {}), **labels},
                **({"annotations": tmeta["annotations"]}
                   if tmeta.get("annotations") else {}),
            },
            "spec": spec,
        }
        out = self.api.create_pod(self.namespace, manifest)
        self._invalidate()
        return out["metadata"]["name"]

    def terminate_node(self, node_id):
        """A GPU group's pods release as a unit, matching
        GCPGpuNodeProvider semantics."""
        tags = self.node_tags(node_id)
        group = tags.get(TAG_NODE_GROUP)
        if not tags:
            # the pod itself is gone (drained/evicted out-of-band) but
            # its group peers may survive as a partial group: group pod
            # names are <group>-w<N>, so recover the group label and
            # release the peers too
            base, sep, tail = node_id.rpartition("-w")
            if sep and tail.isdigit():
                group = base
            else:
                return
        if group:
            sel = (f"{self.RAY_CLUSTER_LABEL}={self.cluster_name},"
                   f"{TAG_NODE_GROUP}={group}")
            for p in self.api.list_pods(self.namespace, sel):
                self.api.delete_pod(self.namespace,
                                    p["metadata"]["name"])
        else:
            self.api.delete_pod(self.namespace, node_id)
        self._invalidate()


def _tag_to_label(tag: str) -> str:
    # node-kind/node-type/node-status ride as ray.io/* labels (kuberay
    # convention); anything else passes through as-is
    if tag in (TAG_NODE_KIND, TAG_NODE_TYPE, TAG_NODE_STATUS):
        return f"ray.io/{tag}"
    return tag


def _label_to_tag(label: str) -> str:
    return label[len("ray.io/"):] if label.startswith("ray.io/") else label


def _default_kubernetes_client():
    """Adapt kubernetes.client.CoreV1Api to the duck surface (in-cluster
    config first, kubeconfig fallback) — only importable where the k8s
    client library exists."""
    try:
        from kubernetes import client, config  # type: ignore
    except ImportError as e:
        raise ImportError(
            "KubernetesNodeProvider needs the kubernetes client library "
            "(not available in this environment) — or pass "
            "provider_config['api_client'] with a compatible client") from e
    try:
        config.load_incluster_config()
    except Exception:
        config.load_kube_config()
    v1 = client.CoreV1Api()

    class _Adapter:
        def create_pod(self, namespace, manifest):
            out = v1.create_namespaced_pod(namespace, manifest)
            return client.ApiClient().sanitize_for_serialization(out)

        def list_pods(self, namespace, label_selector):
            out = v1.list_namespaced_pod(namespace,
                                         label_selector=label_selector)
            return client.ApiClient().sanitize_for_serialization(
                out)["items"]

        def delete_pod(self, namespace, name):
            v1.delete_namespaced_pod(name, namespace)

    return _Adapter()


def make_node_provider(provider_config: Dict[str, Any],
                       cluster_name: str) -> NodeProvider:
    """Provider factory keyed by provider.type (reference:
    autoscaler/_private/providers.py _get_node_provider)."""
    kind = (provider_config or {}).get("type", "local")
    if kind == "local":
        return LocalNodeProvider(provider_config, cluster_name)
    if kind in ("gcp_gpu", "gcp"):
        return GCPGpuNodeProvider(provider_config, cluster_name)
    if kind in ("kubernetes", "kuberay", "gke"):
        return KubernetesNodeProvider(provider_config, cluster_name)
    raise ValueError(f"unknown node provider type {kind!r}")
