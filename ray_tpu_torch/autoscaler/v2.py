"""Autoscaler v2: declarative instance-manager + reconciler.

Reference parity: python/ray/autoscaler/v2 — `InstanceStorage` (versioned
instance table, instance_manager/instance_storage.py), `InstanceManager`
(update-based mutations, instance_manager/instance_manager.py), and the
`Reconciler` (instance_manager/reconciler.py) that drives each instance
through its lifecycle:

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
           -> RAY_STOPPING -> TERMINATING -> TERMINATED

Unlike v1's imperative loop (autoscaler.py StandardAutoscaler), v2 first
declares a *target* instance set from resource demand, records it, and
then reconciles observed cloud/node state against the declared state —
so a crashed autoscaler resumes from its instance table instead of
re-deriving intent from scratch.

The cloud layer is the same NodeProvider interface as v1; the demand
scheduler is reused from v1 (ResourceDemandScheduler).

The port's copy of ``ray_tpu/autoscaler/v2.py``; the goodput policy
reads ``train_goodput``, which the port's trainer fills (its run state in
KV namespace ``train`` carries ``telemetry.goodput``).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .autoscaler import LoadMetrics, ResourceDemandScheduler
from .node_provider import (NodeProvider, TAG_NODE_KIND, TAG_NODE_STATUS,
                            TAG_NODE_TYPE)

logger = logging.getLogger(__name__)

# instance lifecycle states (reference: instance_manager.proto Instance)
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
RAY_STOPPING = "RAY_STOPPING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"


@dataclass
class GoodputPolicy:
    """Goodput-driven scaling knobs (the self-healing loop's capacity
    arm): when a training run's goodput sags while demand queues, spare
    capacity is launched ahead of strict bin-packing need; while it
    sags, idle termination pauses so recovery headroom isn't shaved.

    scale_up_below: launch spares when any RUNNING trial's goodput drops
        below this fraction AND queue pressure warrants it.
    scale_down_above: idle termination only proceeds while every
        RUNNING trial's goodput is at/above this fraction.
    min_queue: queued demands required before goodput alone triggers a
        spare launch (goodput sag with an empty queue means the gang is
        recovering, not starved).
    max_extra: cap on goodput-motivated spare instances on the way up at
        any moment (counted against QUEUED/REQUESTED/ALLOCATED).
    """

    scale_up_below: float = 0.7
    scale_down_above: float = 0.95
    min_queue: int = 1
    max_extra: int = 2


@dataclass
class ServeSLOPolicy:
    """Serve-SLO scaling knobs (the inference-side analog of
    GoodputPolicy): when a deployment's decode engines queue past the
    per-replica watermark, breach the p99-TTFT SLO, or shed everything,
    spare capacity is launched ahead of strict bin-packing need; while
    any deployment is under pressure, idle termination pauses.

    max_queue_per_replica: average engine waiting-queue depth per
        RUNNING replica that counts as pressure (0 disables).
    ttft_slo_s: p99 time-to-first-token above this counts as pressure
        (0 disables).
    max_extra: cap on SLO-motivated spare instances on the way up at
        any moment (counted against QUEUED/REQUESTED/ALLOCATED).
    """

    max_queue_per_replica: float = 4.0
    ttft_slo_s: float = 0.0
    max_extra: int = 2


def _serve_pressure(snapshot: Dict[str, Any],
                    pol: "ServeSLOPolicy") -> Optional[str]:
    """First deployment violating the serve SLO, as a human-readable
    reason — None when every deployment is inside its envelope."""
    for name, load in (snapshot.get("serve_load") or {}).items():
        replicas = max(1, int(load.get("replicas", 1) or 1))
        queued = float(load.get("queue_depth", 0) or 0)
        if pol.max_queue_per_replica > 0 \
                and queued / replicas > pol.max_queue_per_replica:
            return (f"{name}: {queued:g} queued across {replicas} "
                    f"replica(s) > {pol.max_queue_per_replica:g}/replica")
        ttft = float(load.get("ttft_p99_s", 0.0) or 0.0)
        if pol.ttft_slo_s > 0 and ttft > pol.ttft_slo_s:
            return (f"{name}: p99 TTFT {ttft:.3f}s > "
                    f"{pol.ttft_slo_s:g}s SLO")
        if int(load.get("accepting", 1) or 0) == 0:
            return f"{name}: every replica shedding"
    return None


def _min_goodput(snapshot: Dict[str, Any]) -> Optional[float]:
    vals = list((snapshot.get("train_goodput") or {}).values())
    return min(vals) if vals else None


def _untainted(nodes: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Drop draining/quarantined nodes from a capacity view: demand that
    only 'fits' on a node the control plane is steering work away from
    is unmet demand, and must drive a launch."""
    return [n for n in nodes
            if not n.get("draining") and not n.get("quarantined")]


@dataclass
class Instance:
    instance_id: str
    instance_type: str
    status: str = QUEUED
    cloud_instance_id: Optional[str] = None
    node_id: Optional[str] = None  # control-plane node id once running
    launch_request_id: str = ""
    status_since: float = field(default_factory=time.monotonic)
    version: int = 0

    def transition(self, status: str):
        self.status = status
        self.status_since = time.monotonic()


class InstanceStorage:
    """Versioned instance table (reference: instance_storage.py).

    Every batch upsert carries the expected table version; a stale writer
    gets a conflict instead of silently clobbering a concurrent update.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}
        self._version = 0

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def batch_upsert(self, instances: List[Instance],
                     expected_version: Optional[int] = None
                     ) -> Tuple[bool, int]:
        with self._lock:
            if expected_version is not None \
                    and expected_version != self._version:
                return False, self._version
            self._version += 1
            for inst in instances:
                inst.version = self._version
                self._instances[inst.instance_id] = inst
            return True, self._version

    def delete(self, instance_ids: List[str]) -> None:
        with self._lock:
            for iid in instance_ids:
                self._instances.pop(iid, None)
            self._version += 1

    def get_instances(self, statuses: Optional[List[str]] = None
                      ) -> Dict[str, Instance]:
        with self._lock:
            return {iid: inst for iid, inst in self._instances.items()
                    if statuses is None or inst.status in statuses}


class InstanceManager:
    """Update-based mutations over the instance table (reference:
    instance_manager.py — callers submit status transitions; direct table
    writes are not exposed)."""

    def __init__(self, storage: Optional[InstanceStorage] = None):
        self.storage = storage or InstanceStorage()

    def add_instances(self, instance_type: str, count: int,
                      launch_request_id: Optional[str] = None
                      ) -> List[Instance]:
        rid = launch_request_id or uuid.uuid4().hex[:12]
        instances = [
            Instance(instance_id=f"inst-{uuid.uuid4().hex[:12]}",
                     instance_type=instance_type,
                     launch_request_id=rid)
            for _ in range(count)
        ]
        self.storage.batch_upsert(instances)
        return instances

    def update_status(self, instance_id: str, status: str, **fields) -> bool:
        insts = self.storage.get_instances()
        inst = insts.get(instance_id)
        if inst is None:
            return False
        inst.transition(status)
        for k, v in fields.items():
            setattr(inst, k, v)
        self.storage.batch_upsert([inst])
        return True


class Reconciler:
    """One reconciliation pass (reference: reconciler.py Reconcile):
    observe cloud + cluster state, declare the target from demand, and
    step every instance toward its goal state."""

    def __init__(self, manager: InstanceManager, provider: NodeProvider,
                 scheduler: ResourceDemandScheduler,
                 load_metrics: LoadMetrics,
                 idle_timeout_s: float = 60.0,
                 request_timeout_s: float = 300.0,
                 goodput_policy: Optional[GoodputPolicy] = None,
                 serve_policy: Optional[ServeSLOPolicy] = None):
        self.im = manager
        self.provider = provider
        self.scheduler = scheduler
        self.load = load_metrics
        self.idle_timeout_s = idle_timeout_s
        self.request_timeout_s = request_timeout_s
        self.goodput_policy = goodput_policy
        self.serve_policy = serve_policy
        self.num_launched = 0
        self.num_terminated = 0
        self.num_goodput_launches = 0
        self.num_goodput_holds = 0
        self.num_serve_launches = 0
        self.num_serve_holds = 0

    # -- observation --------------------------------------------------------

    def _sync_cloud_state(self):
        """Cloud says a requested instance now exists (or a tracked one
        vanished) — move statuses accordingly."""
        alive = set(self.provider.non_terminated_nodes({}))
        for inst in self.im.storage.get_instances().values():
            if inst.status in (REQUESTED,) and inst.cloud_instance_id \
                    and inst.cloud_instance_id in alive:
                self.im.update_status(inst.instance_id, ALLOCATED)
            elif inst.status in (ALLOCATED, RAY_RUNNING) \
                    and inst.cloud_instance_id not in alive:
                # died under us (preemption, manual delete)
                self.im.update_status(inst.instance_id, TERMINATED)
            elif inst.status == TERMINATING \
                    and inst.cloud_instance_id not in alive:
                self.im.update_status(inst.instance_id, TERMINATED)
                self.num_terminated += 1

    def _sync_ray_state(self, snapshot: Dict[str, Any]):
        """A control-plane node appeared on an allocated instance →
        RAY_RUNNING (reference: Reconciler matching ray nodes to
        instances by cloud id)."""
        running_nodes = {n["node_id"] for n in snapshot.get("nodes", [])}
        by_cloud = {}
        for n in snapshot.get("nodes", []):
            cid = (n.get("labels") or {}).get("cloud_instance_id")
            if cid:
                by_cloud[cid] = n["node_id"]
        for inst in self.im.storage.get_instances([ALLOCATED]).values():
            nid = by_cloud.get(inst.cloud_instance_id)
            if nid is None and len(running_nodes) > 0 \
                    and inst.cloud_instance_id in running_nodes:
                nid = inst.cloud_instance_id
            if nid is not None:
                self.im.update_status(inst.instance_id, RAY_RUNNING,
                                      node_id=nid)

    # -- declaration --------------------------------------------------------

    def _declare_target(self, snapshot: Dict[str, Any]):
        """Compute instances to add from unmet demand (the declarative
        step: we only *enqueue* here; launching happens in stepping).

        Draining/quarantined nodes are dropped from the capacity view:
        the control plane is steering work away from them, so demand
        that only "fits" there must still drive a launch.  When a
        goodput policy is set and a RUNNING trial's goodput sags below
        its threshold while demand queues, spare instances are enqueued
        beyond strict bin-packing need (capped by max_extra)."""
        pending_like = self.im.storage.get_instances(
            [QUEUED, REQUESTED, ALLOCATED])
        # feed the scheduler a view that includes instances on the way up
        # so demand isn't double-counted into duplicate launches
        snap = dict(snapshot)
        extra_nodes = []
        for inst in pending_like.values():
            res = self.scheduler.node_types.get(
                inst.instance_type, {}).get("resources", {})
            extra_nodes.append({"node_id": inst.instance_id,
                                "available": dict(res),
                                "total": dict(res)})
        snap["nodes"] = _untainted(
            list(snapshot.get("nodes", []))) + extra_nodes
        to_launch = self.scheduler.get_nodes_to_launch(
            snap, self._counts_by_type())
        for type_name, count in to_launch.items():
            if count > 0:
                self.im.add_instances(type_name, count)
        self._declare_goodput_spares(snapshot, to_launch)
        self._declare_serve_spares(snapshot, to_launch)

    def _declare_serve_spares(self, snapshot: Dict[str, Any],
                              demand_launch: Dict[str, int]):
        pol = self.serve_policy
        if pol is None:
            return
        reason = _serve_pressure(snapshot, pol)
        if reason is None:
            return
        on_the_way = len(self.im.storage.get_instances(
            [QUEUED, REQUESTED, ALLOCATED])) + sum(demand_launch.values())
        budget = pol.max_extra - on_the_way
        if budget <= 0:
            return
        counts = self._counts_by_type()
        total = sum(counts.values())
        for tname, tcfg in self.scheduler.node_types.items():
            cap = tcfg.get("max_workers", self.scheduler.max_workers)
            room = min(cap - counts.get(tname, 0),
                       self.scheduler.max_workers - total, budget)
            if room <= 0:
                continue
            logger.info("serve SLO pressure (%s): launching %d spare %s",
                        reason, room, tname)
            self.im.add_instances(tname, room)
            self.num_serve_launches += room
            return

    def _declare_goodput_spares(self, snapshot: Dict[str, Any],
                                demand_launch: Dict[str, int]):
        pol = self.goodput_policy
        if pol is None:
            return
        gp = _min_goodput(snapshot)
        if gp is None or gp >= pol.scale_up_below:
            return
        if len(snapshot.get("demands", [])) < pol.min_queue:
            return
        on_the_way = len(self.im.storage.get_instances(
            [QUEUED, REQUESTED, ALLOCATED])) + sum(demand_launch.values())
        budget = pol.max_extra - on_the_way
        if budget <= 0:
            return
        # spares take the first type with headroom under its max_workers
        counts = self._counts_by_type()
        total = sum(counts.values())
        for tname, tcfg in self.scheduler.node_types.items():
            cap = tcfg.get("max_workers", self.scheduler.max_workers)
            room = min(cap - counts.get(tname, 0),
                       self.scheduler.max_workers - total, budget)
            if room <= 0:
                continue
            logger.info(
                "goodput %.2f < %.2f with %d queued demands: launching "
                "%d spare %s", gp, pol.scale_up_below,
                len(snapshot.get("demands", [])), room, tname)
            self.im.add_instances(tname, room)
            self.num_goodput_launches += room
            return

    def _counts_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for inst in self.im.storage.get_instances().values():
            if inst.status not in (TERMINATED,):
                counts[inst.instance_type] = \
                    counts.get(inst.instance_type, 0) + 1
        return counts

    # -- stepping -----------------------------------------------------------

    def _step_queued(self):
        for inst in self.im.storage.get_instances([QUEUED]).values():
            node_cfg = dict(self.scheduler.node_types.get(
                inst.instance_type, {}))
            try:
                cloud_ids = self.provider.create_node(
                    node_cfg, {TAG_NODE_KIND: "worker",
                               TAG_NODE_TYPE: inst.instance_type,
                               TAG_NODE_STATUS: "pending"}, 1)
            except Exception as e:
                logger.warning("launch of %s failed: %s",
                               inst.instance_type, e)
                continue
            self.num_launched += 1
            self.im.update_status(
                inst.instance_id, REQUESTED,
                cloud_instance_id=cloud_ids[0] if cloud_ids else None)

    def _step_idle_termination(self, snapshot: Dict[str, Any]):
        pol = self.goodput_policy
        if pol is not None:
            gp = _min_goodput(snapshot)
            if gp is not None and gp < pol.scale_down_above:
                # a run is below healthy goodput: keep every node — the
                # recovery may need exactly the capacity we'd shave
                self.num_goodput_holds += 1
                logger.debug(
                    "idle termination held: goodput %.2f < %.2f",
                    gp, pol.scale_down_above)
                return
        if self.serve_policy is not None:
            reason = _serve_pressure(snapshot, self.serve_policy)
            if reason is not None:
                # a deployment is under SLO pressure: shaving nodes now
                # would fight the replicas the controller wants to add
                self.num_serve_holds += 1
                logger.debug("idle termination held: %s", reason)
                return
        idle_s = snapshot.get("idle_s", {})
        min_workers = {
            t: cfg.get("min_workers", 0)
            for t, cfg in self.scheduler.node_types.items()}
        counts = self._counts_by_type()
        for inst in self.im.storage.get_instances([RAY_RUNNING]).values():
            node_idle = idle_s.get(inst.node_id, 0.0)
            if node_idle < self.idle_timeout_s:
                continue
            if counts.get(inst.instance_type, 0) \
                    <= min_workers.get(inst.instance_type, 0):
                continue
            counts[inst.instance_type] -= 1
            self.im.update_status(inst.instance_id, RAY_STOPPING)

    def _step_stopping(self):
        for inst in self.im.storage.get_instances(
                [RAY_STOPPING]).values():
            try:
                if inst.cloud_instance_id:
                    self.provider.terminate_node(inst.cloud_instance_id)
            except Exception as e:
                logger.warning("terminate of %s failed: %s",
                               inst.cloud_instance_id, e)
                continue
            self.im.update_status(inst.instance_id, TERMINATING)

    def _step_stuck_requests(self):
        """Requests that never allocated within the timeout are retried
        (requeued) — reference: reconciler's stuck-instance handling."""
        now = time.monotonic()
        for inst in self.im.storage.get_instances([REQUESTED]).values():
            if now - inst.status_since > self.request_timeout_s:
                logger.warning("instance %s stuck in REQUESTED; requeueing",
                               inst.instance_id)
                self.im.update_status(inst.instance_id, QUEUED,
                                      cloud_instance_id=None)

    def _gc_terminated(self):
        dead = list(self.im.storage.get_instances([TERMINATED]))
        if dead:
            self.im.storage.delete(dead)

    def reconcile(self) -> None:
        snapshot = self.load.snapshot()
        self._sync_cloud_state()
        self._sync_ray_state(snapshot)
        self._declare_target(snapshot)
        self._step_queued()
        self._step_idle_termination(snapshot)
        self._step_stopping()
        self._step_stuck_requests()
        self._gc_terminated()


class AutoscalerV2:
    """Facade wiring storage + manager + reconciler, mirroring
    autoscaler/v2/autoscaler.py's composition."""

    def __init__(self, config: Dict[str, Any], provider: NodeProvider,
                 control_client):
        node_types = config.get("available_node_types", {})
        self.scheduler = ResourceDemandScheduler(
            node_types, max_workers=config.get("max_workers", 8))
        self.manager = InstanceManager()
        gp_cfg = config.get("goodput")
        policy = None
        if gp_cfg is not None:
            policy = GoodputPolicy(**gp_cfg) if isinstance(gp_cfg, dict) \
                else GoodputPolicy()
        slo_cfg = config.get("serve_slo")
        serve_policy = None
        if slo_cfg is not None:
            serve_policy = ServeSLOPolicy(**slo_cfg) \
                if isinstance(slo_cfg, dict) else ServeSLOPolicy()
        self.reconciler = Reconciler(
            self.manager, provider, self.scheduler,
            LoadMetrics(control_client),
            idle_timeout_s=config.get("idle_timeout_minutes", 1.0) * 60.0,
            goodput_policy=policy, serve_policy=serve_policy)

    def update(self):
        self.reconciler.reconcile()

    @property
    def instances(self) -> Dict[str, Instance]:
        return self.manager.storage.get_instances()
