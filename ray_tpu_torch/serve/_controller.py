"""ServeController: the serve control-plane actor.

Reference: python/ray/serve/_private/controller.py:84 ServeController and
deployment_state.py:1245 DeploymentState — a singleton actor holding target
state (apps -> deployments -> target replica counts) and a reconcile loop
that starts/stops replica actors, health-checks them, autoscales from
replica queue metrics, and serves the routing table to proxies/handles.

Config fan-out is pull-based: proxies and handles poll
``get_routing_table(version)`` / ``get_replica_table(...)`` cheaply and
re-pull on version bumps (the role LongPollHost plays in the reference,
long_poll.py:177).

The port's copy of ``ray_tpu/serve/_controller.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import logging
import math
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import ray_tpu_torch

from ._common import (APP_RUNNING, DEPLOY_FAILED, DEPLOYING, RUNNING,
                      STARTING, ApplicationStatus, AutoscalingConfig,
                      DeploymentStatus, ReplicaStatus)
from ._replica import Replica

logger = logging.getLogger(__name__)

RECONCILE_PERIOD_S = 0.25


class _ReplicaState:
    def __init__(self, replica_id: str, handle):
        self.replica_id = replica_id
        self.handle = handle
        self.state = STARTING
        self.ready_ref = None
        self.ongoing = 0
        self.model_ids: List[str] = []
        self.engine: Optional[Dict[str, Any]] = None  # decode-engine stats
        self.last_health_ts = time.time()
        self.health_ref = None       # in-flight check_health probe
        self.health_fired_ts = 0.0   # when that probe was submitted
        self.metrics_ref = None
        self.node_id: Optional[str] = None   # placement, for drain marks
        self.draining = False        # node preemption/quarantine advisory
        self.drain_deadline = 0.0    # wall time the node goes away


class _DeploymentState:
    def __init__(self, app_name: str, spec: Dict[str, Any]):
        self.app_name = app_name
        self.spec = spec  # serialized deployment info
        self.target_num_replicas = spec["num_replicas"]
        self.replicas: Dict[str, _ReplicaState] = {}
        self.next_replica_no = 0
        self.autoscaling = (AutoscalingConfig.from_dict(
            spec["autoscaling_config"]) if spec.get("autoscaling_config")
            else None)
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0
        self.message = ""

    @property
    def name(self) -> str:
        return self.spec["name"]


class ServeController:
    def __init__(self, http_host: str = "127.0.0.1", http_port: int = 8000):
        from ray_tpu_torch._private.config import cfg

        c = cfg()
        self._apps: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._routing_version = 0
        self._replica_version = 0
        self._http_host = http_host
        self._http_port = http_port
        self._proxy = None
        self._rpc_proxy = None
        self._grpc_proxy = None
        self._shutdown = False
        self._health_period = c.serve_health_check_period_s
        self._health_timeout = c.serve_health_check_timeout_s
        self._drain_grace = c.serve_drain_grace_s
        # preemption advisories: node_id -> wall-clock deadline the node
        # goes away.  Fed by the pubsub edge (h_report_draining /
        # h_report_quarantine events) and re-derived level-triggered from
        # get_nodes so a missed push cannot strand a mark forever.
        self._unsafe_nodes: Dict[str, float] = {}  # guarded-by: _lock
        self._safe_node_exists = True  # guarded-by: _lock
        self._last_node_sync = 0.0
        try:
            from ray_tpu_torch._private.api import current_core

            current_core().add_push_handler("pub:node", self._on_node_event)
        except Exception:
            # single-process / test harness without a control plane: the
            # level-triggered sync (or nothing) covers it
            logger.debug("node-event subscription unavailable",
                         exc_info=True)
        self._reconciler = threading.Thread(target=self._reconcile_loop,
                                            name="serve-reconcile",
                                            daemon=True)
        self._reconciler.start()

    # -- preemption advisories ----------------------------------------------

    def _on_node_event(self, payload: Dict[str, Any]):
        """Pubsub edge: drain/quarantine advisories land here the moment
        the control plane publishes them (reference: the drain listener in
        train/backend_executor.py) — the reconcile tick then pre-starts
        replacements before the node's deadline instead of after its
        death."""
        try:
            event = payload.get("event")
            view = payload.get("node") or {}
            nid = view.get("node_id")
            if not nid:
                return
            if event in ("draining", "quarantined"):
                grace = payload.get("grace_s")
                deadline = time.time() + (float(grace)
                                          if grace else self._drain_grace)
                with self._lock:
                    self._unsafe_nodes[nid] = deadline
            elif event in ("drain_canceled", "quarantine_cleared",
                           "removed"):
                with self._lock:
                    self._unsafe_nodes.pop(nid, None)
        except Exception:
            logger.debug("node event ignored", exc_info=True)

    def _sync_node_state(self):
        """Level-triggered reconciliation of the unsafe-node map against
        get_nodes (≤1/s): catches advisories published before this
        controller subscribed, prunes marks for nodes that drained away or
        had the advisory cleared, and resolves replica -> node placement
        for drain marking.  All control calls run OUTSIDE the lock."""
        now = time.time()
        if now - self._last_node_sync < 1.0:
            return
        self._last_node_sync = now
        try:
            from ray_tpu_torch._private.api import current_core

            core = current_core()
            views = core.control.call("get_nodes", {}, timeout=5.0)
        except Exception:
            return
        fresh: Dict[str, float] = {}
        safe = False
        live_ids = set()
        for v in views or []:
            nid = v.get("node_id")
            if not nid:
                continue
            live_ids.add(nid)
            if v.get("state") != "ALIVE" or v.get("disconnected"):
                continue
            unsafe = False
            if v.get("draining"):
                rem = v.get("draining_remaining_s")
                fresh[nid] = now + (float(rem) if rem is not None
                                    else self._drain_grace)
                unsafe = True
            if v.get("quarantined"):
                rem = v.get("quarantine_remaining_s")
                dl = now + (float(rem) if rem is not None
                            else self._drain_grace)
                fresh[nid] = max(fresh.get(nid, 0.0), dl)
                unsafe = True
            if not unsafe:
                safe = True
        with self._lock:
            for nid in list(self._unsafe_nodes):
                # prune: node gone, or the view says the advisory cleared
                if nid in live_ids and nid not in fresh:
                    self._unsafe_nodes.pop(nid)
                elif nid not in live_ids:
                    self._unsafe_nodes.pop(nid)
            self._unsafe_nodes.update(fresh)
            self._safe_node_exists = safe or not views
        # resolve node placement for replicas that don't know theirs yet
        pending = []
        with self._lock:
            for app in self._apps.values():
                for ds in app["deployments"].values():
                    for r in ds.replicas.values():
                        if r.node_id is None and r.state == RUNNING:
                            pending.append(r)
        for r in pending:
            try:
                view = core.control.call(
                    "get_actor", {"actor_id": r.handle._actor_id},
                    timeout=5.0)
                nid = (view or {}).get("node_id")
            except Exception:
                nid = None
            if nid:
                with self._lock:
                    r.node_id = nid

    @staticmethod
    def _actor_dead(handle) -> bool:
        """Best-effort liveness read from the control plane; False on any
        doubt — a dead-looking replica still gets the kill, it just also
        gets a useless prepare_shutdown first."""
        try:
            from ray_tpu_torch._private.api import current_core

            view = current_core().control.call(
                "get_actor", {"actor_id": handle._actor_id}, timeout=2.0)
            return (view or {}).get("state") == "DEAD"
        except Exception:
            return False

    # -- app deploy/delete --------------------------------------------------

    def deploy_app(self, name: str, route_prefix: Optional[str],
                   deployment_specs: List[Dict[str, Any]],
                   ingress_name: str) -> bool:
        with self._lock:
            old = self._apps.get(name)
            deployments: Dict[str, _DeploymentState] = {}
            for spec in deployment_specs:
                ds = _DeploymentState(name, spec)
                if old and spec["name"] in old["deployments"]:
                    prev = old["deployments"][spec["name"]]
                    if (prev.spec["callable_blob"] == spec["callable_blob"]
                            and prev.spec["init_args_blob"]
                            == spec["init_args_blob"]):
                        # same code: keep live replicas, adopt new target
                        ds.replicas = prev.replicas
                        ds.next_replica_no = prev.next_replica_no
                        if spec.get("user_config") is not None and \
                                spec.get("user_config") != prev.spec.get(
                                    "user_config"):
                            for r in ds.replicas.values():
                                try:
                                    r.handle.reconfigure.remote(
                                        spec["user_config"])
                                except Exception:
                                    pass
                    else:
                        self._stop_replicas(prev)
                deployments[spec["name"]] = ds
            if old:
                for dname, prev in old["deployments"].items():
                    if dname not in deployments:
                        self._stop_replicas(prev)
            self._apps[name] = {
                "deployments": deployments,
                "route_prefix": route_prefix,
                "ingress": ingress_name,
                "status": DEPLOYING,
                "message": "",
            }
            self._routing_version += 1
            self._replica_version += 1
        return True

    def delete_app(self, name: str, drain_s: float = 2.0) -> bool:
        with self._lock:
            app = self._apps.pop(name, None)
            if app is None:
                return False
            states = list(app["deployments"].values())
            self._routing_version += 1
            self._replica_version += 1
        # drain + kill SYNCHRONOUSLY: delete/shutdown must not return while
        # replica actors are still alive (a killed controller would leak
        # them — its drain threads die with it)
        victims = []
        for ds in states:
            with self._lock:
                vs = list(ds.replicas.values())
                ds.replicas.clear()
            victims.extend(vs)
        # skip the drain wait for replicas the control plane already knows
        # are dead — otherwise deleting an app whose replicas were killed
        # burns the full drain timeout per call for actors that can never
        # answer prepare_shutdown
        refs = []
        for r in victims:
            if self._actor_dead(r.handle):
                continue
            try:
                refs.append(r.handle.prepare_shutdown.remote(drain_s))
            except Exception:
                pass
        if refs:
            try:
                ray_tpu_torch.wait(refs, num_returns=len(refs),
                                   timeout=drain_s + 2.0)
            except Exception:
                pass
        for r in victims:
            try:
                ray_tpu_torch.kill(r.handle)
            except Exception:
                pass
        return True

    def shutdown(self) -> bool:
        with self._lock:
            self._shutdown = True  # stop reconcile from respawning
            names = list(self._apps)
        for name in names:
            self.delete_app(name, drain_s=0.5)
        try:
            # final publish with the (now empty) app set — otherwise the
            # dashboard renders the last pre-shutdown snapshot's apps as
            # HEALTHY forever
            self._publish_status()
        except Exception:
            pass
        return True

    # -- read API (proxies / handles / status) ------------------------------

    def get_routing_table(self) -> Dict[str, Any]:
        with self._lock:
            routes = {}
            for app_name, app in self._apps.items():
                if app["route_prefix"]:
                    ingress = app["deployments"].get(app["ingress"])
                    spec = ingress.spec if ingress else {}
                    routes[app["route_prefix"]] = {
                        "app": app_name, "deployment": app["ingress"],
                        # the proxy streams chunked responses for
                        # generator/ASGI ingress callables
                        "streaming": bool(spec.get("streaming")),
                        "asgi": bool(spec.get("asgi"))}
            return {"version": self._routing_version, "routes": routes}

    def get_app_table(self) -> Dict[str, Any]:
        """All apps keyed by name — the RPC ingress serves apps without an
        HTTP route_prefix too (the reference's gRPC proxy does likewise)."""
        with self._lock:
            apps = {name: {"app": name, "deployment": app["ingress"]}
                    for name, app in self._apps.items()}
            return {"version": self._routing_version, "apps": apps}

    def get_replica_table(self, app_name: str,
                          deployment_name: str) -> Dict[str, Any]:
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return {"version": self._replica_version, "replicas": [],
                        "max_ongoing_requests": 100}
            ds = app["deployments"].get(deployment_name)
            if ds is None:
                return {"version": self._replica_version, "replicas": [],
                        "max_ongoing_requests": 100}
            return {
                "version": self._replica_version,
                "replicas": [
                    {"replica_id": r.replica_id, "handle": r.handle,
                     "model_ids": list(r.model_ids),
                     "draining": r.draining,
                     "engine": dict(r.engine) if r.engine else None}
                    for r in ds.replicas.values() if r.state == RUNNING],
                "max_ongoing_requests": ds.spec.get(
                    "max_ongoing_requests", 100),
            }

    def get_replica_version(self) -> int:
        return self._replica_version

    def status(self) -> Dict[str, Any]:
        with self._lock:
            out = {}
            for app_name, app in self._apps.items():
                deps = {}
                for dname, ds in app["deployments"].items():
                    deps[dname] = DeploymentStatus(
                        name=dname,
                        status="HEALTHY" if all(
                            r.state == RUNNING
                            for r in ds.replicas.values())
                        and len(ds.replicas) >= ds.target_num_replicas
                        else "UPDATING",
                        target_num_replicas=ds.target_num_replicas,
                        replicas=[ReplicaStatus(r.replica_id, r.state,
                                                r.ongoing)
                                  for r in ds.replicas.values()],
                        message=ds.message)
                out[app_name] = ApplicationStatus(
                    name=app_name, status=app["status"],
                    route_prefix=app["route_prefix"], deployments=deps,
                    message=app["message"], ingress=app["ingress"])
            return out

    def get_http_config(self):
        return {"host": self._http_host, "port": self._http_port}

    def ensure_proxy(self) -> Any:
        """Start the HTTP proxy actor on demand; returns (host, port)."""
        with self._lock:
            if self._proxy is None:
                from ._proxy import HTTPProxy

                self._proxy = ray_tpu_torch.remote(HTTPProxy).options(
                    name="SERVE_PROXY", max_concurrency=8,
                    num_cpus=0).remote(self._http_host, self._http_port)
            proxy = self._proxy
        return ray_tpu_torch.get(proxy.ready.remote(), timeout=30.0)

    def ensure_rpc_proxy(self) -> Any:
        """Start the RPC ingress actor on demand (the reference's gRPC
        proxy analog); returns (host, port)."""
        with self._lock:
            if self._rpc_proxy is None:
                from ._proxy import RpcProxy

                self._rpc_proxy = ray_tpu_torch.remote(RpcProxy).options(
                    name="SERVE_RPC_PROXY", max_concurrency=8,
                    num_cpus=0).remote(self._http_host, 0)
            proxy = self._rpc_proxy
        return ray_tpu_torch.get(proxy.ready.remote(), timeout=30.0)

    def ensure_grpc_proxy(self, servicer_blob: bytes,
                          host: Optional[str] = None) -> Any:
        """Start the REAL gRPC ingress actor on demand (reference:
        proxy.py:558 gRPCProxy); returns (host, port).  The user's
        add_*Servicer_to_server functions arrive pickled (they are
        driver-side code) and pass through to the proxy unopened."""
        import hashlib

        digest = hashlib.sha256(servicer_blob).hexdigest()
        with self._lock:
            if self._grpc_proxy is None:
                from ._grpc import GrpcProxy

                self._grpc_blob_digest = digest
                self._grpc_proxy = ray_tpu_torch.remote(GrpcProxy).options(
                    name="SERVE_GRPC_PROXY", max_concurrency=8,
                    num_cpus=0).remote(host or self._http_host, 0,
                                       servicer_blob=servicer_blob)
            elif digest != self._grpc_blob_digest:
                # a second start_grpc with DIFFERENT services would
                # silently serve only the first set — refuse loudly
                raise ValueError(
                    "the gRPC proxy is already running with a different "
                    "set of servicer functions; serve.shutdown() first "
                    "to change the registered services")
            proxy = self._grpc_proxy
        try:
            return ray_tpu_torch.get(proxy.ready.remote(), timeout=30.0)
        except Exception:
            # failed/dead proxy must not brick every future start_grpc
            # behind the digest guard — forget it so a retry re-creates
            with self._lock:
                if self._grpc_proxy is proxy:
                    self._grpc_proxy = None
                    self._grpc_blob_digest = None
            try:
                ray_tpu_torch.kill(proxy, no_restart=True)
            except Exception:
                pass
            raise

    # -- reconcile loop -----------------------------------------------------

    def _reconcile_loop(self):
        while not self._shutdown:
            try:
                self._sync_node_state()
            except Exception:
                logger.debug("node sync failed", exc_info=True)
            try:
                self._reconcile_once()
            except Exception:
                logger.error("serve reconcile error:\n%s",
                             traceback.format_exc())
            try:
                self._publish_status()
            except Exception:
                logger.debug("serve status publish failed", exc_info=True)
            time.sleep(RECONCILE_PERIOD_S)

    def _publish_status(self):
        """Push a plain-dict snapshot to the control-plane KV (ns
        'serve') so the dashboard — which holds only a control client,
        not a driver — can render serve state without calling into this
        actor (reference shape: the controller checkpoints state the
        serve dashboard module reads)."""
        import json as _json

        from ray_tpu_torch._private.api import current_core

        snap = {"ts": time.time(), "apps": [], "serve_load": {}}
        with self._lock:
            for app_name, app in self._apps.items():
                deps = []
                for dname, ds in app["deployments"].items():
                    running = sum(1 for r in ds.replicas.values()
                                  if r.state == RUNNING)
                    deps.append({
                        "deployment": dname,
                        "status": "HEALTHY"
                        if running >= ds.target_num_replicas
                        else "UPDATING",
                        "replicas": f"{running}/{ds.target_num_replicas}",
                        "ongoing": sum(r.ongoing
                                       for r in ds.replicas.values()),
                        "message": ds.message or "",
                    })
                    engines = [r.engine for r in ds.replicas.values()
                               if r.state == RUNNING and r.engine]
                    if engines:
                        # per-deployment decode-engine load: the
                        # queue-depth / p99-TTFT signals autoscaler v2's
                        # ServeSLOPolicy consumes from LoadMetrics
                        snap["serve_load"][f"{app_name}:{dname}"] = {
                            "replicas": running,
                            "queue_depth": sum(e.get("queue_depth", 0)
                                               for e in engines),
                            "active": sum(e.get("active", 0)
                                          for e in engines),
                            "free_pages": sum(e.get("free_pages", 0)
                                              for e in engines),
                            "accepting": sum(
                                1 for e in engines
                                if e.get("accepting", True)),
                            "ttft_p99_s": max(e.get("ttft_p99_s", 0.0)
                                              for e in engines),
                            "tokens_per_s": sum(
                                e.get("tokens_per_s", 0.0)
                                for e in engines),
                        }
                snap["apps"].append({
                    "app": app_name, "status": app["status"],
                    "route_prefix": app["route_prefix"],
                    "message": app["message"] or "",
                    "deployments": deps,
                })
        # single kv_put (the internal_kv wrapper's overwrite path pays an
        # extra kv_exists round-trip per publish for a return value
        # nobody reads)
        current_core().control.call("kv_put", {
            "ns": "serve", "key": "status",
            "val": _json.dumps(snap).encode()})

    def _reconcile_once(self):
        with self._lock:
            apps = list(self._apps.items())
        for app_name, app in apps:
            all_ready = True
            failed_msg = None
            for ds in list(app["deployments"].values()):
                with self._lock:
                    # a concurrent redeploy may have replaced this
                    # _DeploymentState — reconciling the orphan would leak
                    # replicas running stale code
                    live = self._apps.get(app_name, {}).get(
                        "deployments", {}).get(ds.name)
                    if live is not ds:
                        all_ready = False
                        continue
                    try:
                        self._reconcile_deployment(ds)
                    except _DeployFailed as e:
                        failed_msg = str(e)
                        all_ready = False
                        continue
                    running = sum(1 for r in ds.replicas.values()
                                  if r.state == RUNNING)
                    if running < ds.target_num_replicas:
                        all_ready = False
            with self._lock:
                if app_name in self._apps:
                    if failed_msg:
                        self._apps[app_name]["status"] = DEPLOY_FAILED
                        self._apps[app_name]["message"] = failed_msg
                    elif all_ready:
                        self._apps[app_name]["status"] = APP_RUNNING

    def _reconcile_deployment(self, ds: _DeploymentState):  # holds: _lock
        # caller holds self._lock (RLock): replica-map mutations are never
        # concurrent with get_replica_table/status readers
        self._poll_replica_futures(ds)
        self._autoscale(ds)
        self._mark_draining(ds)
        running_or_starting = [r for r in ds.replicas.values()
                               if r.state in (STARTING, RUNNING)]
        # a draining replica stops counting toward target — its
        # replacement pre-starts NOW, before the node's deadline — but
        # only when somewhere safe exists to put it (otherwise a
        # single-node drain would spawn-loop replicas that are instantly
        # re-marked draining)
        if self._safe_node_exists:
            effective = [r for r in running_or_starting if not r.draining]
        else:
            effective = running_or_starting
        # scale up
        while len(effective) < ds.target_num_replicas:
            r = self._start_replica(ds)
            effective.append(r)
        # scale down (prefer draining STARTING last-in first; node-drain
        # replicas retire through _retire_draining, never as generic
        # excess — killing them early would drop their in-flight work)
        excess = len(effective) - ds.target_num_replicas
        if excess > 0:
            victims = sorted(effective,
                             key=lambda r: (r.state == RUNNING, -r.ongoing))
            self._stop_replica_set(ds, victims[:excess])
        self._retire_draining(ds)

    def _mark_draining(self, ds: _DeploymentState):  # holds: _lock
        """Flag replicas whose node has a preemption/quarantine advisory.
        Marked replicas keep serving (the router deprioritizes but does
        not refuse them — zero-drop when no safe node exists) while their
        replacements start."""
        if not self._unsafe_nodes:
            return
        changed = False
        for r in ds.replicas.values():
            if r.draining or r.node_id is None:
                continue
            deadline = self._unsafe_nodes.get(r.node_id)
            if deadline is not None:
                r.draining = True
                r.drain_deadline = deadline
                changed = True
                logger.warning(
                    "replica %s marked draining (node %s preempted, "
                    "%.1fs left)", r.replica_id, r.node_id,
                    max(0.0, deadline - time.time()))
        if changed:
            self._replica_version += 1

    def _retire_draining(self, ds: _DeploymentState):  # holds: _lock
        """Retire draining replicas once their replacements are RUNNING
        (or the node deadline passed — at that point the node takes the
        replica with it either way, so a last drain attempt is free)."""
        draining = [r for r in ds.replicas.values()
                    if r.draining and r.state in (STARTING, RUNNING)]
        if not draining:
            return
        if not self._safe_node_exists:
            return  # nowhere to retire TO: keep serving on the doomed node
        ready = sum(1 for r in ds.replicas.values()
                    if r.state == RUNNING and not r.draining)
        now = time.time()
        for r in draining:
            if ready >= ds.target_num_replicas or now >= r.drain_deadline:
                drain_s = max(0.5, min(5.0, r.drain_deadline - now))
                logger.info("retiring draining replica %s (%.1fs drain)",
                            r.replica_id, drain_s)
                self._stop_replica_set(ds, [r], drain_s=drain_s)

    def _poll_replica_futures(self, ds: _DeploymentState):
        changed = False
        for r in list(ds.replicas.values()):
            if r.state == STARTING and r.ready_ref is not None:
                done, _ = ray_tpu_torch.wait([r.ready_ref], num_returns=1,
                                             timeout=0)
                if done:
                    try:
                        ray_tpu_torch.get(done[0])
                        r.state = RUNNING
                        r.ready_ref = None
                        changed = True
                    except Exception as e:
                        ds.message = f"replica failed to start: {e}"
                        del ds.replicas[r.replica_id]
                        changed = True
                        raise _DeployFailed(ds.message)
            elif r.state == RUNNING:
                # harvest metrics probe
                if r.metrics_ref is not None:
                    done, _ = ray_tpu_torch.wait([r.metrics_ref],
                                                 num_returns=1, timeout=0)
                    if done:
                        try:
                            m = ray_tpu_torch.get(done[0])
                            r.ongoing = m.get("ongoing", 0)
                            r.engine = m.get("engine")
                            new_models = m.get("model_ids", [])
                            if new_models != r.model_ids:
                                r.model_ids = new_models
                                changed = True
                            # NOTE: metrics success does NOT refresh
                            # last_health_ts — a wedged engine answers
                            # metrics fine; only check_health (which
                            # probes the engine's scheduler thread and
                            # step counter) counts as proof of life
                        except Exception:
                            # replica died: drop + let scale-up replace it
                            logger.warning("replica %s died; replacing",
                                           r.replica_id)
                            del ds.replicas[r.replica_id]
                            changed = True
                            continue
                        r.metrics_ref = None
                if r.metrics_ref is None:
                    r.metrics_ref = r.handle.get_metrics.remote()
                # liveness probe: engine-level check_health on a period;
                # a failed OR timed-out probe restarts the replica
                now = time.time()
                if r.health_ref is not None:
                    done, _ = ray_tpu_torch.wait([r.health_ref], num_returns=1,
                                                 timeout=0)
                    if done:
                        try:
                            ray_tpu_torch.get(done[0])
                            r.last_health_ts = now
                        except Exception as e:
                            self._restart_replica(
                                ds, r, f"health check failed: {e}")
                            changed = True
                            continue
                        r.health_ref = None
                    elif now - r.health_fired_ts > self._health_timeout:
                        # probe never answered: replica event loop (or the
                        # whole worker) is wedged even though the actor
                        # is nominally alive
                        self._restart_replica(
                            ds, r, "health check timed out "
                            f"({self._health_timeout:.0f}s): wedged")
                        changed = True
                        continue
                if (r.health_ref is None
                        and now - r.last_health_ts >= self._health_period):
                    try:
                        r.health_ref = r.handle.check_health.remote()
                        r.health_fired_ts = now
                    except Exception:
                        pass  # submit fails only mid-shutdown
        if changed:
            with self._lock:
                self._replica_version += 1

    def _restart_replica(self, ds: _DeploymentState, r: _ReplicaState,
                         reason: str):  # holds: _lock
        """Drop a wedged/unhealthy replica; the scale-up pass replaces it
        on the next tick.  The kill runs on a daemon thread — killing a
        wedged worker can block, and this runs under the reconcile lock."""
        logger.warning("restarting replica %s: %s", r.replica_id, reason)
        ds.replicas.pop(r.replica_id, None)
        ds.message = f"replica {r.replica_id} restarted: {reason}"
        handle = r.handle

        def _kill():
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass

        threading.Thread(target=_kill, daemon=True).start()

    def _start_replica(self, ds: _DeploymentState) -> _ReplicaState:
        rid = f"{ds.app_name}#{ds.name}#{ds.next_replica_no}"
        ds.next_replica_no += 1
        opts = dict(ds.spec.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 0)
        opts["max_concurrency"] = max(
            2, min(8, ds.spec.get("max_ongoing_requests", 100)))
        actor = ray_tpu_torch.remote(Replica).options(**opts).remote(
            ds.app_name, ds.name, rid,
            ds.spec["callable_blob"], ds.spec["init_args_blob"],
            ds.spec.get("user_config"), ds.spec.get("is_function", False))
        r = _ReplicaState(rid, actor)
        r.ready_ref = actor.check_health.remote()
        ds.replicas[rid] = r
        return r

    def _stop_replica_set(self, ds: _DeploymentState,
                          victims: List[_ReplicaState],
                          drain_s: float = 5.0):
        if not victims:
            return
        handles = []
        for r in victims:
            ds.replicas.pop(r.replica_id, None)
            handles.append(r.handle)
        with self._lock:
            self._replica_version += 1

        def _drain_then_kill():
            # drain off-thread so neither reconcile nor deploy_app blocks;
            # prepare_shutdown submission happens here too — submitting to
            # a dead replica can block on connection setup, and the caller
            # may hold the reconcile lock
            refs = []
            for h in handles:
                if self._actor_dead(h):
                    continue  # no drain to wait for: straight to the kill
                try:
                    refs.append(h.prepare_shutdown.remote(drain_s))
                except Exception:
                    pass
            if refs:
                try:
                    ray_tpu_torch.wait(refs, num_returns=len(refs),
                                       timeout=drain_s + 2.0)
                except Exception:
                    pass
            for h in handles:
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass

        threading.Thread(target=_drain_then_kill, daemon=True).start()

    def _stop_replicas(self, ds: _DeploymentState):
        self._stop_replica_set(ds, list(ds.replicas.values()))

    # -- autoscaling --------------------------------------------------------

    def _autoscale(self, ds: _DeploymentState):
        cfg = ds.autoscaling
        if cfg is None:
            return
        running = [r for r in ds.replicas.values() if r.state == RUNNING]
        if not running:
            return
        total_ongoing = sum(r.ongoing for r in running)
        desired = math.ceil(total_ongoing
                            / max(cfg.target_ongoing_requests, 1e-9))
        # serve-SLO signals from the decode engines: sustained waiting
        # queues or p99 TTFT past the SLO mean the replicas are saturated
        # even if ongoing-request counts look tame (one engine request is
        # "one ongoing" no matter how many are queued behind its slots)
        engines = [r.engine for r in running if r.engine]
        if engines:
            if cfg.target_queue_depth > 0:
                queued = sum(e.get("queue_depth", 0) for e in engines)
                if queued:
                    desired = max(desired, math.ceil(
                        queued / cfg.target_queue_depth))
                if queued / len(running) > cfg.target_queue_depth:
                    desired = max(desired, len(running) + 1)
            if cfg.ttft_slo_s > 0:
                worst = max(e.get("ttft_p99_s", 0.0) for e in engines)
                if worst > cfg.ttft_slo_s:
                    desired = max(desired, len(running) + 1)
        desired = max(cfg.min_replicas, min(cfg.max_replicas, desired))
        now = time.time()
        if desired > ds.target_num_replicas:
            if now - ds.last_scale_up >= cfg.upscale_delay_s:
                logger.info("autoscale %s: %d -> %d (ongoing=%d)", ds.name,
                            ds.target_num_replicas, desired, total_ongoing)
                ds.target_num_replicas = desired
                ds.last_scale_up = now
        elif desired < ds.target_num_replicas:
            if now - ds.last_scale_down >= cfg.downscale_delay_s:
                logger.info("autoscale %s: %d -> %d (ongoing=%d)", ds.name,
                            ds.target_num_replicas, desired, total_ongoing)
                ds.target_num_replicas = desired
                ds.last_scale_down = now
        else:
            ds.last_scale_up = now
            ds.last_scale_down = now


class _DeployFailed(RuntimeError):
    pass
