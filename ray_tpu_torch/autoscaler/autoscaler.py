"""StandardAutoscaler: demand-driven scale-up, idle-timeout scale-down.

Analog of the reference's autoscaler v1 loop (reference:
autoscaler/_private/autoscaler.py:172 StandardAutoscaler.update, driven by
monitor.py; demand from load_metrics.py; node picking in
resource_demand_scheduler.py):

  update():
    1. LoadMetrics pulls cluster state: per-node utilization/idleness from
       the control plane, queued lease demands from each raylet, PENDING
       actors/placement groups.
    2. ResourceDemandScheduler bin-packs unmet demands onto node types to
       get "nodes to launch" (respecting min/max per type).
    3. Launch via the provider; terminate nodes idle past the timeout
       (never below min_workers; never the head).

The port's copy of ``ray_tpu/autoscaler/autoscaler.py``: the schedulable
unit is a provider's GPU group (tag ``node-group``) where the reference's
is a TPU slice (``tpu-slice``); ``train_goodput`` reads the goodput the
port's trainer publishes with its run state (KV namespace ``train``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from .node_provider import (TAG_NODE_GROUP, TAG_NODE_KIND, TAG_NODE_STATUS,
                            TAG_NODE_TYPE, NodeProvider)

logger = logging.getLogger(__name__)


class LoadMetrics:
    """Cluster demand/usage snapshot (reference: load_metrics.py).

    Besides resource demand, the snapshot carries the train-side health
    signals the v2 goodput policy scales on: per-RUNNING-trial goodput
    fractions (from the run states the Trainer publishes into KV ns
    'train') under ``train_goodput``."""

    def __init__(self, control_client):
        self.control = control_client
        #: node_id -> monotonic ts when last seen busy
        self.last_busy: Dict[str, float] = {}

    def _train_goodput(self) -> Dict[str, float]:
        """trial -> goodput fraction for every RUNNING/RESTARTING run
        that publishes telemetry.  Advisory: any failure yields {}."""
        import json

        out: Dict[str, float] = {}
        try:
            keys = self.control.call(
                "kv_keys", {"ns": "train", "prefix": ""}, timeout=5.0) or []
            for key in keys:
                raw = self.control.call(
                    "kv_get", {"ns": "train", "key": key}, timeout=5.0)
                if not raw:
                    continue
                state = json.loads(
                    raw.decode() if isinstance(raw, bytes) else raw)
                if state.get("status") not in ("RUNNING", "RESTARTING"):
                    continue
                gp = ((state.get("telemetry") or {}).get("goodput")
                      or {}).get("goodput")
                if gp is not None:
                    out[key] = float(gp)
        except Exception:
            return {}
        return out

    def _serve_load(self) -> Dict[str, Any]:
        """'app:deployment' -> decode-engine load aggregates (queue_depth,
        ttft_p99_s, accepting, ...) from the Serve controller's status
        snapshot in KV ns 'serve'.  Advisory: any failure yields {}."""
        import json

        try:
            raw = self.control.call(
                "kv_get", {"ns": "serve", "key": "status"}, timeout=5.0)
            if not raw:
                return {}
            snap = json.loads(
                raw.decode() if isinstance(raw, bytes) else raw)
            load = snap.get("serve_load") or {}
            return load if isinstance(load, dict) else {}
        except Exception:
            return {}

    def snapshot(self) -> Dict[str, Any]:
        from .._private.protocol import Client

        nodes = self.control.call("get_nodes", {}, timeout=10.0)
        demands: List[Dict[str, float]] = []
        now = time.monotonic()
        alive = []
        for n in nodes:
            if n["state"] != "ALIVE":
                continue
            alive.append(n)
            busy = n["available"] != n["total"]
            try:
                c = Client(tuple(n["addr"]), name="autoscaler-probe")
                try:
                    pending = c.call("pending_demands", {}, timeout=5.0)
                    demands.extend(pending)
                    busy = busy or bool(pending)
                finally:
                    c.close()
            except Exception:
                pass
            if busy or n["node_id"] not in self.last_busy:
                self.last_busy[n["node_id"]] = now
        # PENDING actors not yet placed carry their resource demand (a
        # placed one stays PENDING while its worker starts, its resources
        # already held on its node: counting it again would ask for a
        # node it does not need; ROADMAP §C)
        dump = self.control.call("state_dump", {}, timeout=10.0)
        for a in dump["actors"]:
            if a["state"] == "PENDING" and a.get("resources") \
                    and not a.get("node_id"):
                demands.append(dict(a["resources"]))
        for pg in dump["pgs"]:
            if pg["state"] == "PENDING":
                demands.extend(dict(b) for b in pg["bundles"])
        return {"nodes": alive, "demands": demands,
                "idle_s": {nid: now - ts
                           for nid, ts in self.last_busy.items()},
                "train_goodput": self._train_goodput(),
                "serve_load": self._serve_load()}


class ResourceDemandScheduler:
    """First-fit-decreasing bin packing of unmet demands onto node types
    (reference: resource_demand_scheduler.py get_nodes_to_launch)."""

    def __init__(self, node_types: Dict[str, Dict[str, Any]],
                 max_workers: int):
        self.node_types = node_types
        self.max_workers = max_workers

    @staticmethod
    def _fits(demand: Dict[str, float], free: Dict[str, float]) -> bool:
        return all(free.get(k, 0.0) >= v for k, v in demand.items())

    @staticmethod
    def _consume(demand: Dict[str, float], free: Dict[str, float]):
        for k, v in demand.items():
            free[k] = free.get(k, 0.0) - v

    def get_nodes_to_launch(self, snapshot: Dict[str, Any],
                            current_by_type: Dict[str, int]
                            ) -> Dict[str, int]:
        # start from current free capacity
        free_pools = [dict(n["available"]) for n in snapshot["nodes"]]
        unmet: List[Dict[str, float]] = []
        for demand in sorted(snapshot["demands"],
                             key=lambda d: -sum(d.values())):
            for pool in free_pools:
                if self._fits(demand, pool):
                    self._consume(demand, pool)
                    break
            else:
                unmet.append(demand)
        if not unmet:
            return {}

        to_launch: Dict[str, int] = {}
        total_workers = sum(current_by_type.values())
        for demand in unmet:
            placed = False
            # try capacity of nodes we already decided to launch
            for pool in free_pools:
                if self._fits(demand, pool):
                    self._consume(demand, pool)
                    placed = True
                    break
            if placed:
                continue
            for tname, tcfg in self.node_types.items():
                res = tcfg.get("resources", {})
                launched = current_by_type.get(tname, 0) \
                    + to_launch.get(tname, 0)
                if launched >= tcfg.get("max_workers", self.max_workers):
                    continue
                if total_workers + sum(to_launch.values()) \
                        >= self.max_workers:
                    break
                if self._fits(demand, dict(res)):
                    to_launch[tname] = to_launch.get(tname, 0) + 1
                    pool = dict(res)
                    self._consume(demand, pool)
                    free_pools.append(pool)
                    placed = True
                    break
            if not placed:
                logger.warning("demand %s does not fit any node type",
                               demand)
        return to_launch


class StandardAutoscaler:
    def __init__(self, config: Dict[str, Any], provider: NodeProvider,
                 control_client):
        """config (reference: cluster YAML schema subset):
        {"max_workers": int, "idle_timeout_minutes": float,
         "available_node_types": {name: {"resources": {...},
                                         "node_config": {...},
                                         "min_workers": int,
                                         "max_workers": int}}}
        """
        self.config = config
        self.provider = provider
        self.load_metrics = LoadMetrics(control_client)
        self.scheduler = ResourceDemandScheduler(
            config["available_node_types"],
            config.get("max_workers", 8))
        self.idle_timeout_s = config.get("idle_timeout_minutes", 5) * 60
        #: provider node id -> control-plane node id (filled as they join)
        self.num_launches = 0
        self.num_terminations = 0

    def _workers_by_type(self) -> Dict[str, List[str]]:
        """One entry per SCHEDULABLE UNIT: a GPU group's host nodes
        collapse to one representative (the type's resources describe
        the whole group, terminate_node releases the whole group) — so
        max_workers/min_workers count groups, not hosts, and idle
        scale-down can't shave a group below usability.  A node without
        the group tag is its own unit."""
        out: Dict[str, List[str]] = {}
        seen_units = set()
        for nid in self.provider.non_terminated_nodes(
                {TAG_NODE_KIND: "worker"}):
            tags = self.provider.node_tags(nid)
            unit = tags.get(TAG_NODE_GROUP, nid)
            if unit in seen_units:
                continue
            seen_units.add(unit)
            out.setdefault(tags.get(TAG_NODE_TYPE, "?"), []).append(nid)
        return out

    def update(self):
        """One reconcile tick (reference: StandardAutoscaler.update)."""
        snapshot = self.load_metrics.snapshot()
        by_type = self._workers_by_type()
        current_counts = {t: len(v) for t, v in by_type.items()}

        # 1. enforce min_workers
        for tname, tcfg in self.config["available_node_types"].items():
            deficit = tcfg.get("min_workers", 0) \
                - current_counts.get(tname, 0)
            if deficit > 0:
                self._launch(tname, deficit)
                current_counts[tname] = current_counts.get(tname, 0) \
                    + deficit

        # 2. demand-driven scale up
        to_launch = self.scheduler.get_nodes_to_launch(
            snapshot, current_counts)
        for tname, count in to_launch.items():
            self._launch(tname, count)

        # 3. idle scale down (never below min_workers)
        if not snapshot["demands"]:
            idle_s = snapshot["idle_s"]
            # provider ids whose control node ids are idle: match by the
            # provider-visible control node id tag when available
            for tname, nodes in self._workers_by_type().items():
                tcfg = self.config["available_node_types"][tname]
                removable = len(nodes) - tcfg.get("min_workers", 0)
                if removable <= 0:
                    continue
                for pid in nodes:
                    if removable <= 0:
                        break
                    if self._unit_idle_s(pid, idle_s) > self.idle_timeout_s:
                        logger.info("terminating idle node %s", pid)
                        self.provider.terminate_node(pid)
                        self.num_terminations += 1
                        removable -= 1

    def _unit_idle_s(self, pid: str, idle_s: Dict[str, float]) -> float:
        """Idle seconds of the SCHEDULABLE UNIT pid represents.  For a
        GPU group that is the LEAST idle of all its host nodes —
        terminate_node releases the whole group, so judging it by one
        representative would kill work running on a peer host."""
        tags = self.provider.node_tags(pid)
        group = tags.get(TAG_NODE_GROUP)
        if not group:
            ctrl = tags.get("control-node-id", pid)
            return idle_s.get(ctrl, 0.0)
        vals = []
        for peer in self.provider.non_terminated_nodes(
                {TAG_NODE_GROUP: group}):
            ctrl = self.provider.node_tags(peer).get(
                "control-node-id", peer)
            vals.append(idle_s.get(ctrl, 0.0))
        return min(vals) if vals else 0.0

    def _launch(self, type_name: str, count: int):
        tcfg = self.config["available_node_types"][type_name]
        logger.info("launching %d x %s", count, type_name)
        node_config = dict(tcfg.get("node_config", {}))
        node_config.setdefault("resources", tcfg.get("resources", {}))
        created = self.provider.create_node(
            node_config,
            {TAG_NODE_KIND: "worker", TAG_NODE_TYPE: type_name,
             TAG_NODE_STATUS: "pending"},
            count)
        self.num_launches += len(created)


class Monitor:
    """The autoscaler driver loop (reference: monitor.py)."""

    def __init__(self, autoscaler: StandardAutoscaler,
                 interval_s: float = 5.0):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = False

    def run(self, max_ticks: Optional[int] = None):
        ticks = 0
        while not self._stop:
            try:
                self.autoscaler.update()
            except Exception:
                logger.exception("autoscaler tick failed")
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                return
            time.sleep(self.interval_s)

    def stop(self):
        self._stop = True
