"""Control plane server — the cluster-singleton GCS equivalent.

The reference's GcsServer composes per-concern managers (node, resource,
job, actor, placement group, worker, KV, pubsub, health
— reference: src/ray/gcs/gcs_server/gcs_server.h:128-179).  This module is the
TPU-native analog: one process owning

  * node table + resource view (fed by raylet heartbeats, the ray_syncer
    equivalent),
  * internal KV store (function table, collective rendezvous, named objects),
  * pubsub (long-push channels over server->client push frames),
  * actor manager with restart-on-failure (GcsActorManager::RestartActor,
    reference: gcs_actor_manager.cc:1361),
  * placement group manager with 2-phase PREPARE/COMMIT bundle reservation
    (reference: gcs_placement_group_manager.h:230,
    placement_group_resource_manager.h:54-61),
  * health checks via heartbeat timeout
    (reference: gcs_health_check_manager.h).

Scheduling policy: hybrid pack-then-spread over the resource view (reference:
hybrid_scheduling_policy.h:61) extended with TPU topology labels — nodes carry
`tpu_slice`/`tpu_worker_id` labels so gang placement can keep bundles on one
ICI-connected slice.

The port's copy of ``ray_tpu/_private/control.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Set, Tuple

from . import common
from . import protocol
from .common import add, fits, normalize_resources, subtract
from .protocol import Client, DaemonPool, Deferred, Server, ServerConn

logger = logging.getLogger(__name__)

# typed flag table (reference: ray_config_def.h); RAY_TPU_TORCH_* env or
# _system_config overrides.  The generous death timeout absorbs raylet
# heartbeat stalls during worker-spawn (interpreter import) storms.
from .config import cfg as _cfg

HEARTBEAT_INTERVAL_S = _cfg().heartbeat_interval_s
NODE_DEATH_TIMEOUT_S = _cfg().node_death_timeout_s
DRAIN_GRACE_S = _cfg().drain_grace_s

ALIVE, RESTARTING, DEAD, PENDING = "ALIVE", "RESTARTING", "DEAD", "PENDING"


class NodeRecord:
    def __init__(self, nid: str, addr, resources, labels):
        self.node_id = nid
        self.addr = tuple(addr)
        self.total = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels or {})
        self.last_heartbeat = time.monotonic()
        self.state = ALIVE
        #: bumped on every (re-)registration; h_disconnect ignores drops
        #: of connections from superseded registrations
        self.reg_epoch = 0
        #: monotonic time of the last TCP drop observed while ALIVE.
        #: A transient disconnect is NOT death — only the heartbeat
        #: timeout (or an explicit unregister_node) declares that.
        self.disconnected_at: Optional[float] = None
        #: last applied availability version (delta resource sync)
        self.avail_version = 0
        #: an optimistic reservation diverged this view from the
        #: raylet's truth; ask the raylet to resend it (delta sync
        #: would otherwise never correct a control-side guess)
        self.needs_resync = False
        #: advisory drain deadline (monotonic): a preemption/maintenance
        #: notice says this host is going away around then.  Draining is
        #: NOT death — the node keeps serving until it actually dies —
        #: but the scheduler avoids it and Train shrinks off it.
        self.draining_until: Optional[float] = None
        self.draining_reason: str = ""
        #: remediation quarantine deadline (monotonic): a sustained-
        #: straggler advisory got this node benched.  Quarantine is NOT
        #: death either — the node stays alive and its vaults readable —
        #: but the scheduler avoids it and Train rebalances off it until
        #: the deadline passes.
        self.quarantined_until: Optional[float] = None
        self.quarantine_reason: str = ""

    def view(self):
        return {
            "node_id": self.node_id,
            "addr": self.addr,
            "total": common.denormalize_resources(self.total),
            "available": common.denormalize_resources(self.available),
            "labels": self.labels,
            "state": self.state,
            # observability for partition tolerance: how many times this
            # node has (re-)registered, and whether its control link is
            # currently down (disconnected but NOT dead)
            "reg_epoch": self.reg_epoch,
            "disconnected": self.disconnected_at is not None,
            "draining": self.draining_until is not None,
            "draining_reason": self.draining_reason,
            "draining_remaining_s": (
                max(0.0, self.draining_until - time.monotonic())
                if self.draining_until is not None else None),
            "quarantined": self.quarantined_until is not None,
            "quarantine_reason": self.quarantine_reason,
            "quarantine_remaining_s": (
                max(0.0, self.quarantined_until - time.monotonic())
                if self.quarantined_until is not None else None),
        }


class ActorRecord:
    def __init__(self, aid: str, spec_blob: bytes, name, resources, max_restarts,
                 owner_id, pg_id=None, bundle_index=-1, detached=False,
                 namespace: str = "default", job_id: str = ""):
        # job_id: the owning *driver* job, when known ("" for actors
        # created from inside workers) — used to reap restored owned
        # actors whose driver never came back after a control restart
        self.job_id = job_id
        # non-PG scheduling strategy dict (node_affinity / node_label /
        # spread) honored at placement
        self.strategy: Optional[Dict] = None
        self.actor_id = aid
        self.spec_blob = spec_blob
        self.name = name
        self.namespace = namespace
        self.resources = resources
        self.max_restarts = max_restarts
        self.restarts = 0
        self.owner_id = owner_id
        self.pg_id = pg_id
        self.bundle_index = bundle_index
        self.detached = detached
        self.state = PENDING
        self.node_id: Optional[str] = None
        self.worker_addr: Optional[Tuple[str, int]] = None
        self.incarnation = 0
        self.error: Optional[str] = None
        self.class_name = ""
        #: validated container spec ({'image': ...}) — the raylet wraps
        #: this actor's dedicated worker in the container runtime
        self.container: Optional[Dict] = None
        self.last_pending_warn = -1e9  # monotonic ts of last pending warning

    def view(self):
        return {
            "actor_id": self.actor_id,
            "name": self.name,
            "namespace": self.namespace,
            "state": self.state,
            "node_id": self.node_id,
            "worker_addr": self.worker_addr,
            "incarnation": self.incarnation,
            "restarts": self.restarts,
            "max_restarts": self.max_restarts,
            "error": self.error,
            "class_name": self.class_name,
            "pg_id": self.pg_id,
            "resources": common.denormalize_resources(self.resources),
        }


class PlacementGroupRecord:
    def __init__(self, pgid: str, bundles: List[Dict[str, int]], strategy: str, name: str):
        self.pg_id = pgid
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = PENDING
        # bundle index -> node_id
        self.assignments: Dict[int, str] = {}

    def view(self):
        return {
            "pg_id": self.pg_id,
            "strategy": self.strategy,
            "name": self.name,
            "state": self.state,
            "bundles": [common.denormalize_resources(b) for b in self.bundles],
            "assignments": dict(self.assignments),
        }


def _named_key(namespace: str, name: str) -> str:
    return f"{namespace or 'default'}:{name}"


class _NullDeferred:
    """Stands in for a client Deferred when the control plane reschedules
    restored work at boot — nobody is waiting on the reply."""

    def resolve(self, *_):
        pass

    def reject(self, *_):
        pass


class ControlServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None,
                 addr_file: Optional[str] = None):
        self.server = Server(host, port, name="control")
        self._addr_file = addr_file
        if addr_file:
            # the cluster's control-plane rendezvous: raylets and drivers
            # re-read this on reconnect, which is how they re-home to a
            # promoted standby at a different address (reference analog:
            # the Redis bootstrap address raylets resolve the GCS from)
            common.write_addr_file(addr_file, self.server.addr)
        self.lock = threading.RLock()
        self.kv: Dict[str, Dict[str, bytes]] = {}  # namespace -> key -> value
        self.nodes: Dict[str, NodeRecord] = {}
        self.actors: Dict[str, ActorRecord] = {}
        self.named_actors: Dict[str, str] = {}
        self.pgs: Dict[str, PlacementGroupRecord] = {}
        self.functions: Dict[str, bytes] = {}
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.subs: Dict[str, Set[ServerConn]] = {}  # topic -> conns
        self.node_clients: Dict[str, Client] = {}  # node_id -> raylet client
        self.pool = DaemonPool(max_workers=16, name="control")
        self._stop = threading.Event()
        self.start_time = time.time()
        # task-event manager (reference: GcsTaskManager,
        # src/ray/gcs/gcs_server/gcs_task_manager.h): bounded per-task
        # merged lifecycle records + profile spans for the timeline
        self.task_records: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.profile_events: List[Dict[str, Any]] = []
        self.task_events_dropped = 0
        self.max_task_records = _cfg().max_task_events
        # ingestion is queue + dedicated merge thread (own lock — event
        # merging must never contend with the scheduler's global lock)
        self._event_queue: deque = deque()
        self._event_queue_cap = 4096  # batches; overflow drops oldest
        self._event_signal = threading.Event()
        self._events_lock = threading.Lock()
        self._drain_lock = threading.Lock()  # one drainer at a time
        self._event_thread = threading.Thread(
            target=self._event_merge_loop, name="control-task-events",
            daemon=True)
        # destroyed-actor cache bound (reference:
        # maximum_gcs_destroyed_actor_cached_count)
        self._dead_actor_order: deque = deque()
        self._max_dead_actors = _cfg().max_dead_actors
        # structured cluster events (reference: src/ray/util/event.h):
        # bounded, seq-ordered; fed by publish() + h_report_event
        self.events: deque = deque(maxlen=_cfg().max_cluster_events)
        self._event_seq = 0
        # pending-actor scheduler queue (reference: GcsActorScheduler)
        self.pending_actors: List[ActorRecord] = []
        self._sched_event = threading.Event()
        # flight-recorder counters (control_stats).  _obs_lock is a LEAF
        # lock: publish() runs with self.lock held on some paths, so
        # nothing may be called while holding it.  KV counters are
        # loop-thread-only plain dicts.
        self._obs_lock = threading.Lock()  # lock-ok: leaf, no calls inside
        # ns -> [ops, bytes_in, bytes_out]
        self._kv_stats: Dict[str, list] = {}
        # topic -> [publishes, deliveries, drops, bytes_out,
        #           fanout_s_sum, fanout_s_max]
        self._pubsub_stats: Dict[str, list] = {}
        # coalesced task-event relay accounting (see h_report_task_events)
        self._relay_batches = 0
        self._relay_dropped = 0
        # distributed-trace span collector (see h_report_spans): batched
        # report_spans notifies land in a bounded queue; a dedicated
        # merge thread folds them per-trace and mirrors each trace as a
        # JSON blob into the _tracing KV namespace (so kv_get serves
        # trace reads), with LRU-cap + idle-TTL eviction
        self._span_queue: deque = deque()  # batches; overflow drops oldest
        self._span_queue_cap = 1024
        self._span_signal = threading.Event()
        self._traces_lock = threading.Lock()
        # trace_id -> list of span dicts
        self.trace_spans: Dict[str, List[Dict[str, Any]]] = {}  # guarded-by: _traces_lock
        # trace_id -> last-merge monotonic ts, LRU-ordered for eviction
        self._trace_index: "OrderedDict[str, float]" = OrderedDict()  # guarded-by: _traces_lock
        self._spans_received = 0       # guarded-by: _traces_lock
        self._span_batches = 0         # guarded-by: _traces_lock
        self._spans_dropped = 0        # guarded-by: _traces_lock
        self._trace_span_overflow = 0  # guarded-by: _traces_lock
        self._traces_evicted = 0       # guarded-by: _traces_lock
        self._trace_store_cap = _cfg().trace_store_cap
        self._trace_store_ttl_s = _cfg().trace_store_ttl_s
        self._trace_spans_per_trace = _cfg().trace_spans_per_trace
        self._span_thread = threading.Thread(
            target=self._span_merge_loop, name="control-trace-spans",
            daemon=True)
        # native C++ selection/planning engine (reference's scheduling core
        # is C++: cluster_resource_scheduler.h, hybrid_scheduling_policy.h);
        # Python keeps authoritative optimistic accounting and mirrors
        # availability into the native engine at every mutation
        self.nsched = None
        if _cfg().native_sched:
            try:
                from ray_tpu_torch.native.sched import try_create
                self.nsched = try_create(spread_threshold=0.5, topk=1)
            except Exception:
                self.nsched = None

        s = self.server
        s.handle("ping", lambda c, p: "pong")
        s.handle("kv_put", self.h_kv_put)
        s.handle("kv_get", self.h_kv_get)
        s.handle("kv_del", self.h_kv_del)
        s.handle("kv_keys", self.h_kv_keys)
        s.handle("kv_exists", self.h_kv_exists)
        s.handle("register_node", self.h_register_node)
        s.handle("unregister_node", self.h_unregister_node)
        s.handle("heartbeat", self.h_heartbeat)
        s.handle("report_draining", self.h_report_draining)
        s.handle("report_quarantine", self.h_report_quarantine)
        s.handle("get_nodes", self.h_get_nodes)
        s.handle("pick_node", self.h_pick_node)
        s.handle("pick_nodes", self.h_pick_nodes)
        s.handle("register_function", self.h_register_function)
        s.handle("get_function", self.h_get_function)
        s.handle("register_job", self.h_register_job)
        s.handle("create_actor", self.h_create_actor, deferred=True)
        s.handle("get_actor", self.h_get_actor)
        s.handle("get_actor_spec", lambda c, p: (
            self.actors[p["actor_id"]].spec_blob
            if p["actor_id"] in self.actors else None))
        s.handle("wait_actor_alive", self.h_wait_actor_alive, deferred=True)
        s.handle("list_actors", self.h_list_actors)
        s.handle("actor_ready", self.h_actor_ready)
        s.handle("actor_failed", self.h_actor_failed)
        s.handle("kill_actor", self.h_kill_actor, deferred=True)
        s.handle("subscribe", self.h_subscribe)
        s.handle("publish", self.h_publish)
        s.handle("create_pg", self.h_create_pg, deferred=True)
        s.handle("remove_pg", self.h_remove_pg, deferred=True)
        s.handle("get_pg", self.h_get_pg)
        s.handle("list_pgs", lambda c, p: [pg.view() for pg in self.pgs.values()])
        s.handle("cluster_resources", self.h_cluster_resources)
        s.handle("state_dump", self.h_state_dump)
        s.handle("report_task_events", self.h_report_task_events)
        s.handle("report_spans", self.h_report_spans)
        s.handle("list_events", self.h_list_events)
        s.handle("report_event", self.h_report_event)
        s.handle("list_task_events", self.h_list_task_events, deferred=True)
        s.handle("list_profile_events", self.h_list_profile_events,
                 deferred=True)
        s.handle("control_stats", self.h_control_stats)
        s.on_disconnect(self.h_disconnect)

        self.health_thread = threading.Thread(
            target=self._health_loop, name="control-health", daemon=True
        )

        # restored owned actors awaiting their driver's re-registration:
        # actor_id -> reap deadline (monotonic)
        self._restored_unclaimed: Dict[str, float] = {}

        # restored ALIVE actors awaiting re-adoption by the raylet that
        # still hosts their live worker (warm-standby failover / in-place
        # restart): actor_id -> reschedule deadline.  A re-registering
        # raylet reports its live actor workers; matches are adopted in
        # place (same incarnation, state preserved); the rest are
        # rescheduled when the deadline passes.
        self._adoptable: Dict[str, float] = {}

        # durable metadata store (reference: redis_store_client.h role —
        # GCS fault tolerance).  Off unless a path is configured.
        from . import persist

        self.pstore = persist.open_store(
            persist_path or os.environ.get("RAY_TPU_TORCH_CONTROL_PERSIST"))
        if self.pstore is not None:
            self._load_persisted()

    # -- persistence -------------------------------------------------------

    def _persist_actor(self, rec: ActorRecord):
        if rec.state == DEAD:
            # bound the destroyed-actor cache (reference: the GCS keeps
            # maximum_gcs_destroyed_actor_cached_count records): an
            # actor-churning workload (one Tune trial = one actor) would
            # otherwise grow self.actors — and every state_dump reply —
            # forever
            self._note_dead_actor(rec)
        if self.pstore is None:
            return
        # snapshot + write under the table lock so disk ordering can't
        # invert a pair of racing state transitions; DEAD records are
        # pruned (the reference GCS garbage-collects destroyed actors)
        with self.lock:
            if rec.state == DEAD:
                self.pstore.rec_del("actor", rec.actor_id)
                return
            self.pstore.rec_put("actor", rec.actor_id, {
                "spec_blob": rec.spec_blob, "name": rec.name,
                "resources": rec.resources,
                "max_restarts": rec.max_restarts,
                "owner_id": rec.owner_id, "pg_id": rec.pg_id,
                "bundle_index": rec.bundle_index, "detached": rec.detached,
                "job_id": rec.job_id, "strategy": rec.strategy,
                "state": rec.state, "restarts": rec.restarts,
                "incarnation": rec.incarnation, "error": rec.error,
                "class_name": rec.class_name,
                "namespace": rec.namespace,
                "container": rec.container,
            })

    def _persist_pg(self, rec: PlacementGroupRecord):
        if self.pstore is None:
            return
        with self.lock:
            if rec.state == DEAD:
                self.pstore.rec_del("pg", rec.pg_id)
                return
            self.pstore.rec_put("pg", rec.pg_id, {
                "bundles": rec.bundles, "strategy": rec.strategy,
                "name": rec.name, "state": rec.state,
            })

    def _load_persisted(self):
        """Reload durable tables after a control-plane restart
        (reference: GcsInitData reload, gcs_init_data.h).

        Non-PG actors whose workers may still be alive get an ADOPTION
        window first: reconnecting raylets report live actor workers
        (register_node live_actors) and matches resume in place — same
        incarnation, state preserved (the warm-standby promise).  Only
        unclaimed records are rescheduled fresh after the window
        (incarnation bumped; restart budget NOT charged — the failure
        was ours, not the actor's).  PG-placed actors skip adoption and
        reschedule with their group: live placement groups re-run
        2-phase reservation once nodes return."""
        self.kv = self.pstore.load_kv()
        self.functions = self.pstore.load_table("function")
        self.jobs = self.pstore.load_table("job")
        n_actors = n_pgs = 0
        grace = _cfg().restore_owner_grace_s
        for aid, d in self.pstore.load_table("actor").items():
            rec = ActorRecord(aid, d["spec_blob"], d["name"], d["resources"],
                              d["max_restarts"], d["owner_id"], d["pg_id"],
                              d["bundle_index"], d["detached"],
                              namespace=d.get("namespace", "default"),
                              job_id=d.get("job_id", ""))
            rec.class_name = d.get("class_name", "")
            rec.strategy = d.get("strategy")
            rec.container = d.get("container")
            rec.restarts = d.get("restarts", 0)
            rec.incarnation = d.get("incarnation", 0)
            self.actors[aid] = rec
            if d["state"] == DEAD:
                rec.state = DEAD
                rec.error = d.get("error")
                continue
            rec.state = RESTARTING
            rec.incarnation += 1
            if rec.name:
                self.named_actors[_named_key(rec.namespace, rec.name)] = aid
            if rec.pg_id is None:
                self._adoptable[aid] = \
                    time.monotonic() + _cfg().actor_adopt_grace_s
            else:
                self.pending_actors.append(rec)
            # non-detached actors die with their owner in the reference;
            # reschedule optimistically but reap unless the owning driver
            # job re-registers within the grace window (h_register_job
            # claims them; _health_loop reaps the rest)
            if not rec.detached and rec.job_id:
                self._restored_unclaimed[aid] = time.monotonic() + grace
            n_actors += 1
        for pgid, d in self.pstore.load_table("pg").items():
            rec = PlacementGroupRecord(pgid, d["bundles"], d["strategy"],
                                       d["name"])
            self.pgs[pgid] = rec
            if d["state"] == DEAD:
                rec.state = DEAD
                continue
            rec.state = PENDING
            self.pool.submit(self._schedule_pg, rec, _NullDeferred(),
                             600.0, False)
            n_pgs += 1
        if n_actors or n_pgs or self.kv or self.functions:
            logger.info(
                "restored persisted state: %d kv namespaces, %d functions, "
                "%d jobs, %d actors to reschedule, %d PGs to re-reserve",
                len(self.kv), len(self.functions), len(self.jobs),
                n_actors, n_pgs)
        self._sched_event.set()

    # -- lifecycle ---------------------------------------------------------

    def start(self, block: bool = False):
        self.health_thread.start()
        self._event_thread.start()
        self._span_thread.start()
        self._actor_sched_thread = threading.Thread(
            target=self._actor_sched_loop, name="control-actor-sched",
            daemon=True)
        self._actor_sched_thread.start()
        self.server.start(thread=not block)

    def stop(self):
        self._stop.set()
        self._event_signal.set()
        self._span_signal.set()
        if self._event_thread.is_alive():
            self._event_thread.join(timeout=2.0)
        if self._span_thread.is_alive():
            self._span_thread.join(timeout=2.0)
        self.server.stop()
        self.pool.shutdown(wait=False)
        if self.pstore is not None:
            self.pstore.close()

    @property
    def addr(self):
        return self.server.addr

    # -- kv ----------------------------------------------------------------

    def _kv_account(self, ns: str, bytes_in: int = 0, bytes_out: int = 0):
        """Per-namespace op/byte counters: the `_metrics` / `serve` /
        `remediation` namespaces are the control plane's chattiest
        tenants and these numbers name them (all KV handlers run on the
        RPC loop thread, as does the stats reader, so a plain dict
        suffices)."""
        st = self._kv_stats.get(ns)
        if st is None:
            st = self._kv_stats[ns] = [0, 0, 0]
        st[0] += 1
        st[1] += bytes_in
        st[2] += bytes_out

    def h_kv_put(self, conn, p):
        ns, k, v, overwrite = p["ns"], p["key"], p["val"], p.get("overwrite", True)
        self._kv_account(ns, bytes_in=len(v) if isinstance(v, (bytes, bytearray)) else 0)
        with self.lock:
            space = self.kv.setdefault(ns, {})
            if not overwrite and k in space:
                return False
            space[k] = v
            # persisted inside the lock: disk order must match memory order
            if self.pstore is not None:
                self.pstore.kv_put(ns, k, v)
        return True

    def h_kv_get(self, conn, p):
        with self.lock:
            v = self.kv.get(p["ns"], {}).get(p["key"])
        self._kv_account(p["ns"], bytes_out=len(v)
                         if isinstance(v, (bytes, bytearray)) else 0)
        return v

    def h_kv_del(self, conn, p):
        self._kv_account(p["ns"])
        with self.lock:
            found = self.kv.get(p["ns"], {}).pop(p["key"], None) is not None
            if found and self.pstore is not None:
                self.pstore.kv_del(p["ns"], p["key"])
        return found

    def h_kv_keys(self, conn, p):
        prefix = p.get("prefix", "")
        self._kv_account(p["ns"])
        with self.lock:
            return [k for k in self.kv.get(p["ns"], {}) if k.startswith(prefix)]

    def h_kv_exists(self, conn, p):
        self._kv_account(p["ns"])
        with self.lock:
            return p["key"] in self.kv.get(p["ns"], {})

    # -- nodes -------------------------------------------------------------

    def h_register_node(self, conn, p):
        """Cold registration OR re-registration of a live node.

        Re-registration — the control still holds a non-DEAD record for
        this node_id (the raylet reconnected after a transient partition)
        — is *resumed*: the record is refreshed in place, ALIVE actors
        whose node_id matches are re-adopted idempotently (same worker,
        same incarnation — nothing gets killed), and the reply carries
        ``resumed=True`` plus ``assigned_bundles`` (the PG bundles this
        control still places here) so the raylet preserves its PG state
        and reconciles instead of tearing down.  Cold registration gets a
        fresh record; only actors parked in the post-restart adoption
        window can be claimed.
        """
        nid = p["node_id"]
        adopted, rejected, lost = [], [], []
        with self.lock:
            prev = self.nodes.get(nid)
            resumed = prev is not None and prev.state != DEAD
            if resumed:
                rec = prev
                rec.addr = tuple(p["addr"])
                rec.total = normalize_resources(p["resources"])
                rec.labels = dict(p.get("labels") or {})
                rec.last_heartbeat = time.monotonic()
                rec.disconnected_at = None
                # keep the availability view — the raylet's books
                # survived with it; the next heartbeat resyncs truth
                rec.needs_resync = True
            else:
                rec = NodeRecord(nid, p["addr"],
                                 normalize_resources(p["resources"]),
                                 p.get("labels"))
                self.nodes[nid] = rec
            rec.reg_epoch += 1
            if self.nsched is not None:
                self.nsched.upsert_node(rec.node_id, rec.total)
                if resumed:
                    self.nsched.set_available(rec.node_id, rec.available)
            # a re-homing raylet reports actor workers that are still
            # alive on it.  Adoptable: (a) records waiting in the
            # post-restart adoption window, (b) on a resumed node, ALIVE
            # records this control already places here — re-adopted
            # idempotently.  Anything else (already rescheduled
            # elsewhere, reaped, unknown) is rejected and the raylet
            # kills that worker.
            reported = set()
            for la in p.get("live_actors") or []:
                reported.add(la["actor_id"])
                a = self.actors.get(la["actor_id"])
                if (a is not None and a.state == RESTARTING
                        and la["actor_id"] in self._adoptable):
                    a.state = ALIVE
                    a.node_id = rec.node_id
                    a.worker_addr = tuple(la["worker_addr"]) \
                        if la.get("worker_addr") else None
                    a.incarnation = la.get("incarnation", a.incarnation)
                    self._adoptable.pop(la["actor_id"], None)
                    adopted.append(a)
                elif (a is not None and a.state == ALIVE
                        and a.node_id == nid
                        and la.get("incarnation", a.incarnation)
                            == a.incarnation):
                    if la.get("worker_addr"):
                        a.worker_addr = tuple(la["worker_addr"])
                    adopted.append(a)
                else:
                    rejected.append(la["actor_id"])
            if resumed:
                # the inverse direction: actors this control believes
                # are ALIVE here but the raylet no longer hosts died
                # while we were partitioned — fail them now
                lost = [a.actor_id for a in self.actors.values()
                        if a.node_id == nid and a.state == ALIVE
                        and a.actor_id not in reported]
            # PG bundles this control still assigns to the node; the
            # raylet releases anything beyond this set (a remove_pg
            # whose release RPC was lost to the partition)
            assigned = [[pgid, idx]
                        for pgid, pg in self.pgs.items()
                        if pg.state != DEAD
                        for idx, bnid in pg.assignments.items()
                        if bnid == nid]
            conn.meta["node_id"] = rec.node_id
            conn.meta["reg_epoch"] = rec.reg_epoch
        logger.info("node %s %s at %s: %s", rec.node_id[:12],
                    "re-registered (resumed)" if resumed else "registered",
                    rec.addr, p["resources"])
        self.publish("node", {"event": "added", "node": rec.view()})
        for a in adopted:
            self._persist_actor(a)
            self.publish("actor", {"event": "update", "actor": a.view()})
            logger.info("adopted live actor %s on %s (incarnation %d)",
                        a.actor_id[:12], rec.node_id[:12], a.incarnation)
        for aid in lost:
            logger.warning("actor %s lost across re-registration of %s",
                           aid[:12], nid[:12])
            self._on_actor_failure(
                aid, "actor worker lost across raylet re-registration")
        return {"ok": True, "cluster_start_time": self.start_time,
                "resumed": resumed, "assigned_bundles": assigned,
                "rejected_actors": rejected}

    def h_heartbeat(self, conn, p):
        with self.lock:
            rec = self.nodes.get(p["node_id"])
            if rec is None or rec.state == DEAD:
                # a falsely-declared-dead raylet is still running: tell it
                # to wipe its actor workers and re-register (the reference
                # raylet exits and is restarted by its process manager)
                return {"ok": False, "reregister": True}
            rec.last_heartbeat = time.monotonic()
            rec.disconnected_at = None
            if "available" in p:
                # versioned delta sync (reference: ray_syncer.h:44-70):
                # only snapshots newer than the last applied version
                # land — a reordered/raced update can never roll the
                # view backwards
                v = p.get("avail_version", 0)
                if v == 0 or v > rec.avail_version:
                    if v:   # unversioned updates keep the high-water mark
                        rec.avail_version = v
                    rec.available = normalize_resources(p["available"])
                    rec.needs_resync = False
                    if self.nsched is not None:
                        self.nsched.set_available(rec.node_id,
                                                  rec.available)
            # resync: an optimistic pick_node reservation diverged this
            # view from the raylet's truth — delta sync skips unchanged
            # views, so explicitly request the ground truth back
            return {"ok": True, "resync": rec.needs_resync}

    def h_report_draining(self, conn, p):
        """A preemption/maintenance notice for a node: mark the record
        draining and broadcast a ``node_draining`` advisory with its
        deadline over pubsub, so consumers (Train's elastic supervisor,
        schedulers) act BEFORE the heartbeat timeout declares death.
        ``cancel=True`` clears a notice that didn't materialize."""
        nid = p["node_id"]
        cancel = bool(p.get("cancel"))
        with self.lock:
            rec = self.nodes.get(nid)
            if rec is None or rec.state == DEAD:
                return {"ok": False, "error": f"unknown or dead node {nid}"}
            if cancel:
                rec.draining_until = None
                rec.draining_reason = ""
                grace = None
            else:
                grace = float(p.get("grace_s") or DRAIN_GRACE_S)
                rec.draining_until = time.monotonic() + grace
                rec.draining_reason = str(p.get("reason") or "preemption")
            view = rec.view()
            reason = rec.draining_reason
        event = "drain_canceled" if cancel else "draining"
        if cancel:
            logger.info("node %s drain canceled", nid[:12])
        else:
            logger.warning("node %s draining in %.1fs (%s)", nid[:12],
                           grace, reason)
        self.record_event(
            severity="INFO" if cancel else "WARNING", source="node",
            event_type=event, entity_id=nid,
            message=(f"node {nid[:12]} drain canceled" if cancel else
                     f"node {nid[:12]} draining in {grace:.1f}s ({reason})"))
        self.publish("node", {"event": event, "node": view,
                              "grace_s": grace, "reason": reason})
        return {"ok": True}

    def h_report_quarantine(self, conn, p):
        """Remediation benched a node (sustained-straggler quarantine):
        mark the record so the scheduler avoids it, and broadcast a
        ``node_quarantined`` advisory over pubsub so Train executors
        rebalance off it.  ``cancel=True`` clears the bench early; the
        health loop clears it automatically once the grace passes."""
        nid = p["node_id"]
        cancel = bool(p.get("cancel"))
        with self.lock:
            rec = self.nodes.get(nid)
            if rec is None or rec.state == DEAD:
                return {"ok": False, "error": f"unknown or dead node {nid}"}
            if cancel:
                rec.quarantined_until = None
                rec.quarantine_reason = ""
                grace = None
            else:
                grace = float(p.get("grace_s") or 600.0)
                rec.quarantined_until = time.monotonic() + grace
                rec.quarantine_reason = str(
                    p.get("reason") or "sustained straggler")
            view = rec.view()
            reason = rec.quarantine_reason
        event = "quarantine_cleared" if cancel else "quarantined"
        if cancel:
            logger.info("node %s quarantine cleared", nid[:12])
        else:
            logger.warning("node %s quarantined for %.1fs (%s)", nid[:12],
                           grace, reason)
        self.record_event(
            severity="INFO" if cancel else "WARNING", source="remediation",
            event_type=event, entity_id=nid,
            message=(f"node {nid[:12]} quarantine cleared" if cancel else
                     f"node {nid[:12]} quarantined for {grace:.1f}s "
                     f"({reason})"))
        self.publish("node", {"event": event, "node": view,
                              "grace_s": grace, "reason": reason})
        return {"ok": True}

    def h_get_nodes(self, conn, p):
        with self.lock:
            return [n.view() for n in self.nodes.values()]

    def _alive_nodes(self) -> List[NodeRecord]:
        return [n for n in self.nodes.values() if n.state == ALIVE]

    @staticmethod
    def _match_one(labels: Dict[str, str], key: str, op: str,
                   values) -> bool:
        present = key in labels
        if op == "exists":
            return present
        if op == "does_not_exist":
            return not present
        if op == "in":
            return present and str(labels[key]) in values
        if op == "not_in":
            return present and str(labels[key]) not in values
        return False

    def _pick_node_locked(self, demand: Dict[str, int], strategy=None) -> Optional[NodeRecord]:
        """Hybrid policy: pack onto the busiest node that fits (reference
        defaults to pack-then-spread, hybrid_scheduling_policy.h:61); honors
        node-affinity / pg strategies."""
        nodes = self._alive_nodes()
        if strategy is not None:
            kind = strategy.get("kind")
            if kind == "node_affinity":
                n = self.nodes.get(strategy["node_id"])
                if n is not None and n.state == ALIVE and (strategy.get("soft") or fits(n.available, demand)):
                    return n
                if not strategy.get("soft"):
                    return None
            elif kind == "placement_group":
                pg = self.pgs.get(strategy["pg_id"])
                if pg is None or pg.state != ALIVE:
                    return None
                idx = strategy.get("bundle_index", -1)
                if idx >= 0:
                    indices = [idx]
                else:
                    # any-bundle (-1): rotate across assignment nodes so
                    # repeated leases don't pin to one node's bundle while
                    # the group's other bundles idle (per-bundle occupancy
                    # lives node-side; round-robin is the control's lever)
                    indices = list(pg.assignments)
                    pg.rr_cursor = getattr(pg, "rr_cursor", 0) + 1
                    k = pg.rr_cursor % max(1, len(indices))
                    indices = indices[k:] + indices[:k]
                for i in indices:
                    nid = pg.assignments.get(i)
                    n = self.nodes.get(nid)
                    if n is not None and n.state == ALIVE:
                        return n
                return None
            elif kind == "node_label":
                # label matching (reference: NodeLabelSchedulingStrategy,
                # scheduling_strategies.py:135 + label scheduling policy)
                hard = strategy.get("hard") or []
                soft = strategy.get("soft") or []
                def match_all(n, exprs):
                    return all(self._match_one(n.labels or {}, k, op, vals)
                               for (k, op, vals) in exprs)

                cands = [n for n in nodes
                         if fits(n.available, demand)
                         and match_all(n, hard)]
                if not cands:
                    return None
                preferred = [n for n in cands if match_all(n, soft)]
                pool = preferred or cands

                def util(n: NodeRecord) -> float:
                    tot = sum(n.total.values()) or 1
                    return 1.0 - sum(n.available.values()) / tot
                return max(pool, key=util)  # pack among matching nodes
            elif kind == "spread":
                n = self._native_pick(demand, spread=True)
                if n is not None:
                    return n
                cands = [n for n in nodes if fits(n.available, demand)]
                cands = self._prefer_not_draining(cands)
                if not cands:
                    return None
                # least-loaded first
                return min(cands, key=lambda n: sum(v / max(t, 1) for v, t in
                                                    ((n.total.get(k, 0) - n.available.get(k, 0), n.total.get(k, 1))
                                                     for k in n.total)))
        n = self._native_pick(demand, spread=False)
        if n is not None:
            return n
        cands = [n for n in nodes if fits(n.available, demand)]
        cands = self._prefer_not_draining(cands)
        if not cands:
            return None
        # pack: most-utilized node that still fits
        def util(n: NodeRecord) -> float:
            tot = sum(n.total.values()) or 1
            return 1.0 - sum(n.available.values()) / tot
        return max(cands, key=util)

    @staticmethod
    def _prefer_not_draining(cands: List[NodeRecord]) -> List[NodeRecord]:
        """New work avoids draining AND quarantined nodes while any
        untainted node fits — but a tainted node remains a last resort
        (its work is still better placed than not placed; a quarantined
        host is slow, not dead)."""
        fresh = [n for n in cands if n.draining_until is None
                 and n.quarantined_until is None]
        if fresh:
            return fresh
        # among tainted, a merely-quarantined node beats one that is
        # about to disappear
        not_draining = [n for n in cands if n.draining_until is None]
        return not_draining or cands

    def _native_pick(self, demand: Dict[str, int],
                     spread: bool) -> Optional[NodeRecord]:
        """Delegate selection to the native engine; validated against the
        Python books so mirror drift can never hand out a bad node."""
        if self.nsched is None:
            return None
        try:
            from ray_tpu_torch.native.sched import PACK, SPREAD
            nid = self.nsched.pick(demand, SPREAD if spread else PACK)
        except Exception:
            return None
        if nid is None:
            return None
        n = self.nodes.get(nid)
        if n is not None and (n.draining_until is not None
                              or n.quarantined_until is not None):
            # the native mirror doesn't track drains/quarantines; fall
            # back to the Python path, which prefers untainted nodes
            return None
        if n is not None and n.state == ALIVE and fits(n.available, demand):
            return n
        return None

    def h_pick_node(self, conn, p):
        demand = normalize_resources(p.get("resources"))
        with self.lock:
            n = self._pick_node_locked(demand, p.get("strategy"))
            if n is None:
                return None
            # optimistic reservation so concurrent picks spread; the
            # raylet's ground truth comes back via the resync flag on
            # its next heartbeat (delta sync skips unchanged views)
            subtract(n.available, demand)
            n.needs_resync = True
            if self.nsched is not None:
                self.nsched.set_available(n.node_id, n.available)
            return {"node_id": n.node_id, "addr": n.addr}

    def _native_pick_n_locked(self, demand: Dict[str, int],
                              count: int) -> List[Dict[str, str]]:
        """Vectorized native selection: one ctypes call picks AND reserves
        up to `count` placements.  Each returned name is validated against
        the Python books (mirror drift can never hand out a bad node);
        accepted picks copy the native reservation into the Python books
        directly (the native side already subtracted, so set_available
        would double-count); rejected picks are released back and the
        remainder falls through to the Python loop."""
        try:
            from ray_tpu_torch.native.sched import PACK
            out = self.nsched.pick_n(demand, count, PACK)
        except Exception:
            return []
        picks: List[Dict[str, str]] = []
        stop = False
        for nid in out:
            n = self.nodes.get(nid)
            ok = (not stop and n is not None and n.state == ALIVE
                  and n.draining_until is None
                  and n.quarantined_until is None
                  and fits(n.available, demand))
            if ok:
                subtract(n.available, demand)
                n.needs_resync = True
                picks.append({"node_id": n.node_id, "addr": n.addr})
            else:
                try:
                    self.nsched.release(nid, demand)
                except Exception:
                    pass
                stop = True
        return picks

    def h_pick_nodes(self, conn, p):
        """Batched pick_node: reserve up to `count` placements of one
        demand in a single RPC (the owner's vectorized lease ramp-up).
        Returns a possibly-short (or empty) list of {node_id, addr};
        names may repeat when one node fits several leases."""
        demand = normalize_resources(p.get("resources"))
        count = max(1, int(p.get("count", 1)))
        strategy = p.get("strategy")
        picks: List[Dict[str, str]] = []
        with self.lock:
            if strategy is None and self.nsched is not None:
                picks.extend(self._native_pick_n_locked(demand, count))
            while len(picks) < count:
                n = self._pick_node_locked(demand, strategy)
                if n is None:
                    break
                subtract(n.available, demand)
                n.needs_resync = True
                if self.nsched is not None:
                    self.nsched.set_available(n.node_id, n.available)
                picks.append({"node_id": n.node_id, "addr": n.addr})
        return picks

    def h_cluster_resources(self, conn, p):
        with self.lock:
            total: Dict[str, int] = {}
            avail: Dict[str, int] = {}
            for n in self._alive_nodes():
                add(total, n.total)
                add(avail, n.available)
            return {
                "total": common.denormalize_resources(total),
                "available": common.denormalize_resources(avail),
            }

    # -- functions / jobs --------------------------------------------------

    def h_register_function(self, conn, p):
        with self.lock:
            self.functions[p["function_id"]] = p["blob"]
        if self.pstore is not None:
            self.pstore.rec_put("function", p["function_id"], p["blob"])
        return True

    def h_get_function(self, conn, p):
        with self.lock:
            return self.functions.get(p["function_id"])

    def h_register_job(self, conn, p):
        with self.lock:
            self.jobs[p["job_id"]] = {"start_time": time.time(), **p}
            # the owning driver came back after a control restart: its
            # restored actors are claimed and escape the orphan reaper
            for aid in [a for a, _ in self._restored_unclaimed.items()
                        if self.actors.get(a) is not None
                        and self.actors[a].job_id == p["job_id"]]:
                self._restored_unclaimed.pop(aid, None)
        conn.meta["job_id"] = p["job_id"]
        if self.pstore is not None:
            self.pstore.rec_put("job", p["job_id"], self.jobs[p["job_id"]])
        self.record_event(severity="INFO", source="job",
                          event_type="started",
                          message=f"job {p['job_id'][:20]} registered",
                          entity_id=p["job_id"])
        return True

    # -- pubsub ------------------------------------------------------------

    def h_subscribe(self, conn, p):
        with self.lock:
            for t in p["topics"]:
                self.subs.setdefault(t, set()).add(conn)
        return True

    def h_publish(self, conn, p):
        self.publish(p["topic"], p["payload"])
        return True

    def publish(self, topic: str, payload: Any):
        try:
            # event recording must never break pubsub delivery: user
            # payloads on these topics may have any shape
            self._maybe_record_event(topic, payload)
        except Exception:
            logger.debug("event recording failed for topic %s", topic,
                         exc_info=True)
        with self.lock:
            conns = list(self.subs.get(topic, ()))
        # one pickle for the whole fan-out (500 subscribers = 1 dumps, not
        # 500); the meta wall-clock stamp lets every subscriber measure
        # publish->deliver latency (rpc_stats.record_pubsub_delivery)
        t0 = time.perf_counter()
        data = protocol._pack_frame(0, protocol.PUSH, f"pub:{topic}",
                                    payload, {"ts": time.time()})
        dead = [c for c in conns if not c.send_raw(data)]
        fanout_s = time.perf_counter() - t0
        with self._obs_lock:
            st = self._pubsub_stats.get(topic)
            if st is None:
                st = self._pubsub_stats[topic] = [0, 0, 0, 0, 0.0, 0.0]
            st[0] += 1
            st[1] += len(conns) - len(dead)
            st[2] += len(dead)
            st[3] += len(data) * (len(conns) - len(dead))
            st[4] += fanout_s
            if fanout_s > st[5]:
                st[5] = fanout_s
        if dead:
            with self.lock:
                for c in dead:
                    for s in self.subs.values():
                        s.discard(c)

    # -- structured cluster events -----------------------------------------
    # reference: src/ray/util/event.h + dashboard/modules/event — durable,
    # queryable records of lifecycle transitions (node died, actor failed,
    # job finished), distinct from free-text logs.  publish() is the
    # chokepoint every such transition already flows through.

    _EVENT_SEVERITY = {  # (topic, event) -> severity; default INFO
        ("node", "removed"): "WARNING",
        ("actor", "dead"): "WARNING",
        ("actor", "restarting"): "WARNING",
        ("pg", "removed"): "INFO",
        ("error", None): "ERROR",
    }

    def _maybe_record_event(self, topic: str, payload: Any):
        if topic not in ("node", "actor", "pg", "job", "error"):
            return
        p = payload if isinstance(payload, dict) else {"data": payload}
        ev = p.get("event", topic)
        entity = (p.get("node", {}).get("node_id", "")
                  if "node" in p else
                  p.get("actor", {}).get("actor_id", "")
                  if "actor" in p else
                  p.get("pg", {}).get("pg_id", p.get("pg_id", ""))
                  if topic == "pg" else
                  p.get("job_id", p.get("submission_id", "")))
        sev = self._EVENT_SEVERITY.get((topic, ev)) \
            or self._EVENT_SEVERITY.get((topic, None)) or "INFO"
        # actor death with an error message is an ERROR, not a shutdown
        if topic == "actor" and ev == "dead" \
                and p.get("actor", {}).get("error"):
            sev = "ERROR"
        msg = f"{topic} {entity[:20]} {ev}"
        err = (p.get("actor", {}) or {}).get("error") or p.get("error")
        if err:
            msg += f": {str(err)[:300]}"
        self.record_event(severity=sev, source=topic, event_type=ev,
                          message=msg, entity_id=entity)

    def _note_dead_actor(self, rec: ActorRecord):
        with self.lock:
            self._dead_actor_order.append(rec.actor_id)
            while len(self._dead_actor_order) > self._max_dead_actors:
                aid = self._dead_actor_order.popleft()
                old = self.actors.get(aid)
                if old is not None and old.state == DEAD:
                    del self.actors[aid]
                    if old.name:
                        key = _named_key(old.namespace, old.name)
                        if self.named_actors.get(key) == aid:
                            del self.named_actors[key]

    def record_event(self, *, severity: str, source: str, event_type: str,
                     message: str, entity_id: str = "",
                     custom: Optional[Dict[str, Any]] = None):
        """Append one structured event (bounded buffer, monotonic seq)."""
        with self.lock:
            self._event_seq += 1
            self.events.append({
                "seq": self._event_seq,
                "ts": time.time(),
                "severity": severity,
                "source": source,
                "event_type": event_type,
                "entity_id": entity_id,
                "message": message,
                **({"custom": custom} if custom else {}),
            })

    def h_report_event(self, conn, p):
        """External emitters (raylets, libraries) push structured events
        (reference: the event agent's ReportEvents RPC)."""
        self.record_event(
            severity=str(p.get("severity", "INFO")).upper(),
            source=str(p.get("source", "user")),
            event_type=str(p.get("event_type", "custom")),
            message=str(p.get("message", ""))[:2000],
            entity_id=str(p.get("entity_id", "")),
            custom=p.get("custom"))
        return True

    def h_list_events(self, conn, p):
        """Filterable, seq-ordered slice of the event buffer.

        With a cursor (after_seq > 0) the OLDEST `limit` matches after
        the cursor return, so pollers that fall behind page forward
        without silently skipping the middle; cursorless calls (the
        dashboard) get the newest `limit`."""
        sev = p.get("severity")
        sev = sev.upper() if sev else None   # stored normalized upper
        src = p.get("source")
        ent = p.get("entity_id")
        after = int(p.get("after_seq") or 0)
        limit = max(0, int(p.get("limit", 1000)))
        if limit == 0:
            return []
        with self.lock:
            out = [e for e in self.events
                   if e["seq"] > after
                   and (sev is None or e["severity"] == sev)
                   and (src is None or e["source"] == src)
                   and (ent is None or e["entity_id"] == ent)]
        return out[:limit] if after else out[-limit:]

    # -- raylet client cache ----------------------------------------------

    def _node_client(self, nid: str) -> Optional[Client]:
        with self.lock:
            rec = self.nodes.get(nid)
            if rec is None or rec.state != ALIVE:
                return None
            cli = self.node_clients.get(nid)
            if cli is not None and not cli.closed:
                return cli
            addr = rec.addr
        try:
            cli = Client(addr, name=f"control->raylet-{nid[:8]}")
        except Exception:
            return None
        with self.lock:
            self.node_clients[nid] = cli
        return cli

    # -- actors ------------------------------------------------------------

    def h_create_actor(self, conn, p, d: Deferred):
        rec = ActorRecord(
            p["actor_id"], p["spec_blob"], p.get("name"),
            normalize_resources(p.get("resources")), p.get("max_restarts", 0),
            p.get("owner_id", ""), p.get("pg_id"), p.get("bundle_index", -1),
            p.get("detached", False),
            namespace=p.get("namespace") or "default",
            job_id=p.get("job_id", ""),
        )
        rec.class_name = p.get("class_name", "")
        rec.strategy = p.get("strategy")
        rec.container = p.get("container")
        with self.lock:
            # idempotent on actor_id: clients retry blindly after a
            # control-plane reconnect, and the first attempt may have
            # registered (and persisted) the record before the reply
            # was lost
            existing = self.actors.get(rec.actor_id)
            if existing is not None:
                d.resolve(existing.view())
                return
            if rec.name:
                key = _named_key(rec.namespace, rec.name)
                if self.named_actors.get(key, rec.actor_id) \
                        != rec.actor_id:
                    d.reject(f"actor name {rec.name!r} already taken "
                             f"in namespace {rec.namespace!r}")
                    return
                self.named_actors[key] = rec.actor_id
            self.actors[rec.actor_id] = rec
        # creation is async (reference: RegisterActor replies before the
        # actor is scheduled; the caller learns placement via
        # wait_actor_alive / pubsub) — an unschedulable actor stays
        # PENDING as autoscaler demand instead of failing fast
        self._persist_actor(rec)
        d.resolve(rec.view())
        self._schedule_actor(rec, None)

    def _schedule_actor(self, rec: ActorRecord, d=None):
        """Queue for the scheduler loop (reference:
        GcsActorScheduler::Schedule, gcs_actor_scheduler.h:146)."""
        with self.lock:
            if rec not in self.pending_actors:
                self.pending_actors.append(rec)
        self._sched_event.set()

    def _actor_sched_loop(self):
        """Single placement loop over pending actors: retries forever as
        resources free up (the reference keeps unschedulable actors
        pending and reports them as resource demand)."""
        while not self._stop.is_set():
            self._sched_event.wait(0.2)
            self._sched_event.clear()
            with self.lock:
                pending = list(self.pending_actors)
            for rec in pending:
                placed_or_dropped = self._try_place_actor(rec)
                if placed_or_dropped:
                    with self.lock:
                        if rec in self.pending_actors:
                            self.pending_actors.remove(rec)

    def _try_place_actor(self, rec: ActorRecord) -> bool:
        """One placement attempt; True if the actor left the queue
        (started on a node, or died)."""
        strategy = rec.strategy
        if rec.pg_id:
            strategy = {"kind": "placement_group", "pg_id": rec.pg_id,
                        "bundle_index": rec.bundle_index}
        with self.lock:
            if rec.state == DEAD:
                return True
            if rec.state == ALIVE:
                # an orphaned worker's actor_ready adopted the placement
                # while this record sat in the queue — nothing to place
                return True
            node = self._pick_node_locked(rec.resources, strategy)
            if node is None:
                now = time.monotonic()
                if now - rec.last_pending_warn > 30.0:
                    rec.last_pending_warn = now
                    logger.warning(
                        "actor %s (%s) pending: no node with free %s",
                        rec.actor_id[:12], rec.class_name,
                        common.denormalize_resources(rec.resources))
                return False
        cli = self._node_client(node.node_id)
        if cli is None:
            return False
        try:
            r = cli.call("start_actor_worker", {
                "actor_id": rec.actor_id,
                "resources": common.denormalize_resources(rec.resources),
                "pg_id": rec.pg_id,
                "bundle_index": rec.bundle_index,
                "incarnation": rec.incarnation,
                "container": rec.container,
            }, timeout=60.0)
            if r and r.get("ok"):
                with self.lock:
                    killed = rec.state == DEAD
                    adopted_elsewhere = (
                        rec.state == ALIVE
                        and (rec.worker_addr or ()) != tuple(r["worker_addr"]))
                    if not killed and not adopted_elsewhere:
                        rec.node_id = node.node_id
                        rec.worker_addr = tuple(r["worker_addr"])
                        # stays PENDING until worker reports ready
                if killed or adopted_elsewhere:
                    # kill_actor raced with placement, or an orphaned
                    # worker already adopted this actor: reap the spare we
                    # just started (addressed by worker_addr so a same-node
                    # adopted worker is never the one killed)
                    logger.info(
                        "reaping spare worker of actor %s (%s)",
                        rec.actor_id[:12],
                        "killed during placement" if killed
                        else "adopted elsewhere")
                    self._kill_actor_worker(
                        node.node_id, rec.actor_id,
                        worker_addr=tuple(r["worker_addr"]))
                return True
            if r and r.get("permanent"):
                # the raylet says retrying can't help (e.g. container
                # runtime missing) — fail the actor loudly now instead
                # of re-queueing it forever
                self._on_actor_failure(
                    rec.actor_id, r.get("error", "worker spawn failed"))
                return True
        except Exception as e:
            logger.warning("actor %s placement on %s failed: %s",
                           rec.actor_id[:12], node.node_id[:12], e)
        return False

    def _kill_actor_worker(self, node_id: str, actor_id: str,
                           worker_addr=None):
        cli = self._node_client(node_id)
        if cli is not None:
            try:
                cli.call("kill_actor_worker",
                         {"actor_id": actor_id, "worker_addr": worker_addr},
                         timeout=10.0)
            except Exception:
                pass

    def h_actor_ready(self, conn, p):
        """Worker finished running the creation task.

        Placement is reconciled here, not assumed from the RPC reply: if
        the start_actor_worker call failed mid-flight but the raylet did
        start the worker, the orphan's report *adopts* the placement; a
        stale incarnation or a duplicate placement gets its worker reaped
        (reference: GcsActorManager reconciles via the actor table for the
        same reason — replies can be lost while the work happened)."""
        aid = p["actor_id"]
        rep_node = p.get("node_id")
        rep_inc = p.get("incarnation", 0)
        kill_on = None  # node to reap a stale/duplicate/killed worker from
        with self.lock:
            rec = self.actors.get(aid)
            if rec is None:
                return False
            if rec.state == DEAD:
                # killed while the creation task ran — never resurrect;
                # make sure the node reaps the worker and frees resources
                kill_on = rep_node or rec.node_id
                view = None
            elif rep_inc < rec.incarnation:
                # report from a previous incarnation's worker: stale
                kill_on = rep_node
                view = None
            elif (rec.state == ALIVE
                  and tuple(p.get("worker_addr") or ()) != (rec.worker_addr or ())):
                # double placement (lost-reply retry): keep the first
                # worker, reap the spare
                kill_on = rep_node
                view = None
            elif p.get("error"):
                rec.state = DEAD
                rec.error = p["error"]
                view = rec.view()
            else:
                rec.state = ALIVE
                rec.worker_addr = tuple(p["worker_addr"])
                rec.incarnation = rep_inc
                if rep_node:
                    rec.node_id = rep_node
                # adopted placements leave the pending queue
                if rec in self.pending_actors:
                    self.pending_actors.remove(rec)
                view = rec.view()
        if view is None:
            if kill_on:
                self._kill_actor_worker(kill_on, aid,
                                        worker_addr=p.get("worker_addr"))
            return True
        self._persist_actor(rec)
        self.publish("actor", {"event": "alive" if not p.get("error") else "dead",
                               "actor": view})
        return True

    def h_actor_failed(self, conn, p):
        """Worker/raylet reports actor process death -> maybe restart
        (reference: GcsActorManager::RestartActor gcs_actor_manager.cc:1361)."""
        self._on_actor_failure(p["actor_id"], p.get("error", "actor process died"))
        return True

    def _on_actor_failure(self, aid: str, error: str):
        with self.lock:
            rec = self.actors.get(aid)
            if rec is None or rec.state == DEAD:
                return
            if rec.max_restarts != 0 and (
                rec.max_restarts < 0 or rec.restarts < rec.max_restarts
            ):
                rec.restarts += 1
                rec.incarnation += 1
                rec.state = RESTARTING
                rec.worker_addr = None
                view = rec.view()
                restart = True
            else:
                rec.state = DEAD
                rec.error = error
                view = rec.view()
                restart = False
        self._persist_actor(self.actors[aid])
        self.publish("actor", {"event": "restarting" if restart else "dead", "actor": view})
        if restart:
            self.pool.submit(self._schedule_actor, self.actors[aid], None)

    def h_get_actor(self, conn, p):
        with self.lock:
            aid = p.get("actor_id")
            if aid is None and p.get("name"):
                aid = self.named_actors.get(
                    _named_key(p.get("namespace") or "default", p["name"]))
            rec = self.actors.get(aid) if aid else None
            return None if rec is None else rec.view()

    def h_wait_actor_alive(self, conn, p, d: Deferred):
        aid, timeout = p["actor_id"], p.get("timeout", 60.0)
        # callers that saw an incarnation die pass min_incarnation so a
        # stale ALIVE view (death notification still in flight) is not
        # returned as if it were the restarted actor
        min_inc = p.get("min_incarnation", 0)

        def waiter():
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline and not self._stop.is_set():
                with self.lock:
                    rec = self.actors.get(aid)
                    if rec is None:
                        d.resolve(None)
                        return
                    if rec.state == DEAD or (
                            rec.state == ALIVE and rec.incarnation >= min_inc):
                        d.resolve(rec.view())
                        return
                time.sleep(0.05)
            with self.lock:
                rec = self.actors.get(aid)
                d.resolve(rec.view() if rec else None)

        self.pool.submit(waiter)

    def h_list_actors(self, conn, p):
        with self.lock:
            return [a.view() for a in self.actors.values()]

    def h_kill_actor(self, conn, p, d: Deferred):
        aid, no_restart = p["actor_id"], p.get("no_restart", True)

        def do():
            with self.lock:
                rec = self.actors.get(aid)
                nid = rec.node_id if rec is not None else None
            if rec is None:
                d.resolve(False)
                return
            if no_restart:
                self._destroy_actor(aid, "killed via kill_actor")
            elif nid:
                # restartable kill: just reap the worker; the failure
                # path reschedules per max_restarts
                self._kill_actor_worker(nid, aid)
            d.resolve(True)

        self.pool.submit(do)

    # -- placement groups --------------------------------------------------

    def h_create_pg(self, conn, p, d: Deferred):
        bundles = [normalize_resources(b) for b in p["bundles"]]
        rec = PlacementGroupRecord(p["pg_id"], bundles, p.get("strategy", "PACK"),
                                   p.get("name", ""))
        with self.lock:
            existing = self.pgs.get(rec.pg_id)
            if existing is not None:
                # blind client retry after reconnect: never double-reserve
                d.resolve(existing.view())
                return
            self.pgs[rec.pg_id] = rec
        self._persist_pg(rec)
        self.pool.submit(self._schedule_pg, rec, d)

    def _schedule_pg(self, rec: PlacementGroupRecord, d: Deferred,
                     deadline_s: float = 60.0,
                     fail_on_timeout: bool = True):
        """2-phase bundle reservation: PREPARE on every chosen node, then
        COMMIT; release everything on any failure (reference:
        placement_group_resource_manager.h:54-61)."""
        deadline = time.monotonic() + deadline_s
        while not self._stop.is_set():
            plan_result = self._plan_pg(rec)
            if plan_result is not None:
                prepared: List[Tuple[str, int]] = []
                ok = True
                for idx, nid in plan_result.items():
                    cli = self._node_client(nid)
                    try:
                        r = cli.call("prepare_bundle", {
                            "pg_id": rec.pg_id, "bundle_index": idx,
                            "resources": common.denormalize_resources(rec.bundles[idx]),
                        }, timeout=15.0) if cli else None
                        if not (r and r.get("ok")):
                            ok = False
                            break
                        prepared.append((nid, idx))
                    except Exception:
                        ok = False
                        break
                if ok:
                    for nid, idx in prepared:
                        cli = self._node_client(nid)
                        if cli:
                            try:
                                cli.call("commit_bundle",
                                         {"pg_id": rec.pg_id, "bundle_index": idx},
                                         timeout=15.0)
                            except Exception:
                                pass
                    with self.lock:
                        rec.assignments = dict(plan_result)
                        rec.state = ALIVE
                    self._persist_pg(rec)
                    self.publish("pg", {"event": "alive", "pg": rec.view()})
                    d.resolve(rec.view())
                    return
                for nid, idx in prepared:
                    cli = self._node_client(nid)
                    if cli:
                        try:
                            cli.call("release_bundle",
                                     {"pg_id": rec.pg_id, "bundle_index": idx},
                                     timeout=15.0)
                        except Exception:
                            pass
            if time.monotonic() > deadline:
                if not fail_on_timeout:
                    # boot-restored PG: stay PENDING — nodes may still be
                    # rejoining after the control restart, and killing a
                    # previously-healthy group would strand its actors
                    d.resolve(rec.view())
                    return
                with self.lock:
                    rec.state = DEAD
                self._persist_pg(rec)
                d.resolve(rec.view())
                return
            time.sleep(0.2)

    def _plan_pg(self, rec: PlacementGroupRecord) -> Optional[Dict[int, str]]:
        with self.lock:
            nodes = self._alive_nodes()
            # native bundle planner (reference: bundle_scheduling_policy.h)
            # handles the pure-resource case; the Python path below keeps
            # TPU-slice-affinity ordering which the native engine lacks
            if (self.nsched is not None
                    and not any(n.labels.get("tpu_slice") for n in nodes)):
                plan = self._native_plan_pg(rec)
                if plan is not None:
                    return plan
            # simulate availability
            sim = {n.node_id: dict(n.available) for n in nodes}
            # TPU slice affinity: prefer nodes sharing a tpu_slice label
            order = sorted(nodes, key=lambda n: n.labels.get("tpu_slice", ""))
            out: Dict[int, str] = {}
            if rec.strategy == "STRICT_PACK":
                for n in order:
                    s = dict(sim[n.node_id])
                    if all(fits(s, b) and (subtract(s, b) or True)
                           for b in rec.bundles):
                        return {i: n.node_id for i in range(len(rec.bundles))}
                return None
            if rec.strategy == "STRICT_SPREAD":
                used: Set[str] = set()
                for i, b in enumerate(rec.bundles):
                    got = next((n.node_id for n in order
                                if n.node_id not in used
                                and fits(sim[n.node_id], b)), None)
                    if got is None:
                        return None
                    subtract(sim[got], b)
                    used.add(got)
                    out[i] = got
                return out
            # PACK / SPREAD: soft preferences
            prefer_spread = rec.strategy == "SPREAD"
            last = None
            for i, b in enumerate(rec.bundles):
                cands = [n for n in order if fits(sim[n.node_id], b)]
                if not cands:
                    return None
                if prefer_spread:
                    fresh = [n for n in cands if n.node_id != last]
                    n = (fresh or cands)[0]
                else:
                    n = cands[0] if last is None else next(
                        (c for c in cands if c.node_id == last), cands[0])
                subtract(sim[n.node_id], b)
                out[i] = n.node_id
                last = n.node_id
            return out

    def _native_plan_pg(self, rec) -> Optional[Dict[int, str]]:
        """Plan via the C++ engine; None falls back to the Python planner
        (including the infeasible case, which Python re-confirms)."""
        try:
            from ray_tpu_torch.native.sched import (PACK, SPREAD, STRICT_PACK,
                                              STRICT_SPREAD)
            strat = {"PACK": PACK, "SPREAD": SPREAD,
                     "STRICT_PACK": STRICT_PACK,
                     "STRICT_SPREAD": STRICT_SPREAD}.get(rec.strategy)
            if strat is None:
                return None
            names = self.nsched.plan_bundles(rec.bundles, strat)
        except Exception:
            return None
        if names is None:
            return None
        # validate against the authoritative books before trusting
        sim = {n.node_id: dict(n.available) for n in self._alive_nodes()}
        for b, nid in zip(rec.bundles, names):
            if nid not in sim or not fits(sim[nid], b):
                return None
            subtract(sim[nid], b)
        return {i: nid for i, nid in enumerate(names)}

    def h_remove_pg(self, conn, p, d: Deferred):
        pgid = p["pg_id"]

        def do():
            with self.lock:
                rec = self.pgs.get(pgid)
                if rec is None:
                    d.resolve(False)
                    return
                rec.state = DEAD
                assignments = dict(rec.assignments)
            self._persist_pg(rec)
            for idx, nid in assignments.items():
                cli = self._node_client(nid)
                if cli:
                    try:
                        cli.call("release_bundle", {"pg_id": pgid, "bundle_index": idx},
                                 timeout=15.0)
                    except Exception:
                        pass
            self.publish("pg", {"event": "removed", "pg_id": pgid})
            d.resolve(True)

        self.pool.submit(do)

    def h_get_pg(self, conn, p):
        with self.lock:
            rec = self.pgs.get(p["pg_id"]) or (
                self.pgs.get(self._pg_by_name(p["name"])) if p.get("name") else None)
            return None if rec is None else rec.view()

    def _pg_by_name(self, name):
        for pg in self.pgs.values():
            if pg.name == name:
                return pg.pg_id
        return None

    # -- health / failure detection ---------------------------------------

    def _health_loop(self):
        while not self._stop.is_set():
            time.sleep(HEARTBEAT_INTERVAL_S)
            now = time.monotonic()
            dead_nodes: List[NodeRecord] = []
            drain_expired: List[NodeRecord] = []
            quarantine_expired: List[NodeRecord] = []
            with self.lock:
                for rec in self.nodes.values():
                    if rec.state == ALIVE and now - rec.last_heartbeat > NODE_DEATH_TIMEOUT_S:
                        rec.state = DEAD
                        dead_nodes.append(rec)
                    elif (rec.state == ALIVE and rec.draining_until is not None
                            and now > rec.draining_until + NODE_DEATH_TIMEOUT_S):
                        # the predicted preemption never happened: the node
                        # outlived its deadline by a full death interval —
                        # clear the advisory so it takes work again
                        rec.draining_until = None
                        rec.draining_reason = ""
                        drain_expired.append(rec)
                    if (rec.state == ALIVE
                            and rec.quarantined_until is not None
                            and now > rec.quarantined_until):
                        # quarantine served: the bench duration IS the
                        # penalty — the node rejoins the schedulable pool
                        rec.quarantined_until = None
                        rec.quarantine_reason = ""
                        quarantine_expired.append(rec)
            for rec in quarantine_expired:
                logger.info("node %s quarantine expired; schedulable again",
                            rec.node_id[:12])
                self.publish("node", {"event": "quarantine_cleared",
                                      "node": rec.view(), "grace_s": None,
                                      "reason": "expired"})
            for rec in drain_expired:
                logger.info("node %s drain notice expired without death; "
                            "cleared", rec.node_id[:12])
                self.publish("node", {"event": "drain_canceled",
                                      "node": rec.view(), "grace_s": None,
                                      "reason": "expired"})
            for rec in dead_nodes:
                logger.warning("node %s declared dead (heartbeat timeout)", rec.node_id[:12])
                self.publish("node", {"event": "removed", "node": rec.view()})
                self._on_node_death(rec.node_id)
            self._reap_unclaimed_restored(now)
            self._reschedule_unadopted(now)
            self._check_fenced()

    def _check_fenced(self):
        """Split-brain fencing: the addr-file is the single source of
        truth for who the controller is.  If a standby promoted while
        this (slow-but-alive) process was stalled, the file no longer
        names our address — step down immediately rather than serve a
        second, diverging control plane against the same persisted
        store."""
        if not self._addr_file:
            return
        cur = common.read_addr_file(self._addr_file)
        if cur is not None and tuple(cur) != tuple(self.server.addr):
            logger.critical(
                "fenced: addr-file %s now names %s (a standby promoted "
                "over us); stepping down", self._addr_file, cur)
            # immediate exit, no graceful stop: a fenced primary must
            # not serve one more request, and a graceful stop races the
            # blocking serve loop in main() returning 0 first (the WAL
            # is crash-safe; the successor already owns the store)
            os._exit(3)

    def _reschedule_unadopted(self, now: float):
        """Adoption window expired with no raylet claiming the live
        worker: fall back to a fresh reschedule (the round-4 restart
        semantics)."""
        fell_through = []
        with self.lock:
            expired = [aid for aid, dl in self._adoptable.items()
                       if now > dl]
            for aid in expired:
                self._adoptable.pop(aid, None)
                rec = self.actors.get(aid)
                if rec is not None and rec.state == RESTARTING \
                        and rec not in self.pending_actors:
                    self.pending_actors.append(rec)
                    fell_through.append(aid)
        if fell_through:
            logger.warning("adoption window expired for %d restored "
                           "actor(s); rescheduling fresh", len(fell_through))
            self._sched_event.set()

    def _reap_unclaimed_restored(self, now: float):
        """Destroy restored non-detached actors whose owning driver job
        never re-registered after a control restart (the reference only
        recreates detached actors — owned actors die with their owner;
        gcs_actor_manager.cc ownership rules)."""
        with self.lock:
            expired = [aid for aid, dl in self._restored_unclaimed.items()
                       if now > dl]
            for aid in expired:
                self._restored_unclaimed.pop(aid, None)
        for aid in expired:
            logger.warning(
                "reaping restored actor %s: owner job never re-registered",
                aid[:12])
            self._destroy_actor(
                aid, "owner driver did not return after control restart")

    def _destroy_actor(self, aid: str, error: str):
        """Force-kill an actor: mark DEAD, drop its name, reap its
        worker, publish (shared by kill_actor and the orphan reaper)."""
        with self.lock:
            rec = self.actors.get(aid)
            if rec is None or rec.state == DEAD:
                return
            rec.max_restarts = 0
            rec.state = DEAD
            rec.error = error
            if rec.name:
                self.named_actors.pop(
                    _named_key(rec.namespace, rec.name), None)
            if rec in self.pending_actors:
                self.pending_actors.remove(rec)
            self._adoptable.pop(aid, None)
            nid = rec.node_id
            view = rec.view()
        self._persist_actor(rec)
        if nid:
            self._kill_actor_worker(nid, aid)
        self.publish("actor", {"event": "dead", "actor": view})

    def _on_node_death(self, nid: str):
        with self.lock:
            if self.nsched is not None:
                self.nsched.set_alive(nid, False)
            cli = self.node_clients.pop(nid, None)
            affected = [a for a in self.actors.values()
                        if a.node_id == nid and a.state in (ALIVE, PENDING, RESTARTING)]
        if cli:
            cli.close()
        for rec in affected:
            self._on_actor_failure(rec.actor_id, f"node {nid} died")

    def h_disconnect(self, conn: ServerConn):
        with self.lock:
            for s in self.subs.values():
                s.discard(conn)
        nid = conn.meta.get("node_id")
        if not nid:
            return
        with self.lock:
            rec = self.nodes.get(nid)
            # Partition tolerance: a dropped TCP connection is NOT node
            # death.  The record stays ALIVE and its actors/bundles are
            # untouched; only the heartbeat timeout (_health_loop,
            # NODE_DEATH_TIMEOUT_S) or an explicit unregister_node
            # declares death.  Drops of superseded connections (the
            # raylet already re-registered over a fresh one) are ignored
            # so a slow FIN can't mark a healthy node disconnected.
            if rec is None or rec.state != ALIVE:
                return
            if conn.meta.get("reg_epoch") != rec.reg_epoch:
                return
            rec.disconnected_at = time.monotonic()
            view = rec.view()
        logger.warning(
            "node %s connection dropped; keeping it ALIVE pending "
            "heartbeat timeout (%.0fs)", nid[:12], NODE_DEATH_TIMEOUT_S)
        self.publish("node", {"event": "disconnected", "node": view})

    def h_unregister_node(self, conn, p):
        """Graceful node departure (raylet shutdown / scale-down): death
        is declared immediately.  The heartbeat-timeout grace exists for
        *transient* faults — a deliberate exit must not strand its actors
        for NODE_DEATH_TIMEOUT_S."""
        nid = p["node_id"]
        with self.lock:
            rec = self.nodes.get(nid)
            if rec is None or rec.state == DEAD:
                return {"ok": True}
            rec.state = DEAD
            view = rec.view()
        logger.info("node %s unregistered (graceful shutdown)", nid[:12])
        self.publish("node", {"event": "removed", "node": view})
        self._on_node_death(nid)
        return {"ok": True}

    # -- control-plane flight recorder ------------------------------------

    def h_control_stats(self, conn, p):
        """One-stop control-plane health view: per-handler RPC stats,
        event-loop lag, per-KV-namespace traffic, per-topic pubsub
        fan-out and task-event ingest accounting.  Served by `ray-tpu
        control-stats`, `GET /api/control/stats` and the dashboard's
        ray_tpu_control_* Prometheus series."""
        with self.lock:
            nodes_total = len(self.nodes)
            nodes_alive = sum(1 for n in self.nodes.values()
                              if n.state == "ALIVE")
            subs = {t: len(cs) for t, cs in self.subs.items() if cs}
        with self._obs_lock:
            pubsub = {
                t: {"publishes": st[0], "deliveries": st[1],
                    "dropped_subscribers": st[2], "bytes_out": st[3],
                    "fanout_ms_total": round(st[4] * 1e3, 3),
                    "fanout_ms_max": round(st[5] * 1e3, 3)}
                for t, st in self._pubsub_stats.items()}
            relay_batches = self._relay_batches
            relay_dropped = self._relay_dropped
        with self._events_lock:
            events = {
                "queue_depth": len(self._event_queue),
                "dropped": self.task_events_dropped,
                "task_records": len(self.task_records),
                "profile_events": len(self.profile_events),
                "relay_batches": relay_batches,
                "relay_dropped": relay_dropped,
            }
        with self._traces_lock:
            tracing = {
                "queue_depth": len(self._span_queue),
                "traces": len(self.trace_spans),
                "spans": self._spans_received,
                "span_batches": self._span_batches,
                "dropped": self._spans_dropped,
                "span_overflow": self._trace_span_overflow,
                "traces_evicted": self._traces_evicted,
            }
        return {
            "uptime_s": round(time.time() - self.start_time, 1),
            "handlers": self.server.stats(),
            "loop": self.server.loop_stats(),
            "kv": {ns: {"ops": st[0], "bytes_in": st[1],
                        "bytes_out": st[2]}
                   for ns, st in self._kv_stats.items()},
            "pubsub": pubsub,
            "subscriptions": subs,
            "events": events,
            "tracing": tracing,
            "nodes": {"alive": nodes_alive, "total": nodes_total},
        }

    # -- state dump (state API source of truth) ---------------------------

    def h_state_dump(self, conn, p):
        with self.lock:
            return {
                "nodes": [n.view() for n in self.nodes.values()],
                "actors": [a.view() for a in self.actors.values()],
                "pgs": [g.view() for g in self.pgs.values()],
                "jobs": dict(self.jobs),
                "start_time": self.start_time,
            }

    # -- task events (reference: GcsTaskManager) --------------------------

    def _defer(self, d: Deferred, fn):
        def run():
            try:
                d.resolve(fn())
            except Exception as e:
                logger.exception("deferred control handler failed")
                try:
                    d.reject(f"{type(e).__name__}: {e}")
                except Exception:
                    pass

        self.pool.submit(run)

    def h_report_task_events(self, conn, p):
        """Ingest is decoupled from the RPC loop: batches land in a
        queue and a dedicated thread merges them.  At high task rates
        the merge is the control plane's biggest CPU item — doing it on
        the event loop under the global lock stalled lease scheduling
        (measured ~40% of headline tasks/s).  The queue is bounded: if
        the merge thread falls behind the oldest batch is dropped with
        accounting (the reference's TaskEventBuffer does the same).

        Accepts either one worker batch ({"events", "dropped", "common"})
        or a raylet relay envelope ({"batches": [...], "dropped": n}) —
        one framed pipe write carrying every worker batch a node
        coalesced in its flush window."""
        q = self._event_queue
        batches = p.get("batches")
        if batches is not None:
            with self._obs_lock:
                self._relay_batches += 1
                self._relay_dropped += p.get("dropped", 0)
            if p.get("dropped"):
                with self._events_lock:
                    self.task_events_dropped += p["dropped"]
            q.extend(batches)
        else:
            q.append(p)
        while len(q) > self._event_queue_cap:
            try:
                old = q.popleft()
                with self._events_lock:
                    self.task_events_dropped += \
                        len(old.get("events", ())) + old.get("dropped", 0)
            except IndexError:
                break
        self._event_signal.set()
        return True

    def _event_merge_loop(self):
        while not self._stop.is_set():
            self._event_signal.wait(0.5)
            self._event_signal.clear()
            self._drain_event_queue()
        self._drain_event_queue()  # final drain: don't lose pre-stop batches

    def _drain_event_queue(self):
        # single drainer: the merge thread and deferred readers race here;
        # batches must merge in report order and a reader that got True
        # from report_task_events must then see those events
        with self._drain_lock:
            while self._event_queue:
                try:
                    self._merge_task_events(self._event_queue.popleft())
                except IndexError:
                    break
                except Exception:
                    logger.exception("task-event merge failed")

    def _merge_task_events(self, p):
        with self._events_lock:
            self.task_events_dropped += p.get("dropped", 0)
            common_fields = p.get("common") or {}
            for ev in p.get("events", []):
                if common_fields:
                    ev = {**common_fields, **ev}
                if ev.get("kind") == "profile":
                    self.profile_events.append(ev)
                    if len(self.profile_events) > self.max_task_records:
                        self.profile_events.pop(0)
                    continue
                tid = ev["task_id"]
                rec = self.task_records.get(tid)
                if rec is None:
                    rec = {"task_id": tid, "state_ts": {}}
                    self.task_records[tid] = rec
                    while len(self.task_records) > self.max_task_records:
                        self.task_records.popitem(last=False)
                        self.task_events_dropped += 1
                for k in ("name", "job_id", "actor_id", "node_id",
                          "worker_id", "error", "type"):
                    if ev.get(k):
                        rec[k] = ev[k]
                state = ev.get("state")
                if state:
                    # merge out-of-order batches: a terminal state must not
                    # be overwritten by a late RUNNING report
                    terminal = rec.get("state") in ("FINISHED", "FAILED")
                    if not terminal or state in ("FINISHED", "FAILED"):
                        rec["state"] = state
                    rec["state_ts"][state] = ev["ts"]

    def h_list_task_events(self, conn, p, d):
        # deferred: the drain + snapshot is O(backlog + records) and must
        # not run on the RPC event loop (protocol handlers must not block)
        def run():
            filters = p.get("filters") or {}
            limit = p.get("limit", 1000)
            out = []
            self._drain_event_queue()  # readers see everything reported
            with self._events_lock:
                for rec in reversed(self.task_records.values()):
                    if all(rec.get(k) == v for k, v in filters.items()):
                        out.append(dict(rec, state_ts=dict(rec["state_ts"])))
                        if len(out) >= limit:
                            break
                return {"records": out, "dropped": self.task_events_dropped,
                        "total": len(self.task_records),
                        # server clock anchor: event ts are cluster-host
                        # time; viewers (dashboard timeline) must render
                        # relative to THIS, not their own skewed clock
                        "now": time.time()}

        self._defer(d, run)

    def h_list_profile_events(self, conn, p, d):
        def run():
            limit = p.get("limit", 10000)
            self._drain_event_queue()
            with self._events_lock:
                return list(self.profile_events[-limit:])

        self._defer(d, run)

    # -- distributed-trace span collector ---------------------------------

    def h_report_spans(self, conn, p):
        """Span ingest mirrors task-event ingest: batches queue here and
        a dedicated thread merges them per-trace off the RPC loop, so a
        burst of sampled traces never stalls lease scheduling.  Accepts
        one process batch ({"spans", "dropped", "common"}) or a relay
        envelope ({"batches": [...], "dropped": n}); the queue is
        bounded with drop-oldest accounting."""
        q = self._span_queue
        batches = p.get("batches")
        if batches is not None:
            if p.get("dropped"):
                with self._traces_lock:
                    self._spans_dropped += p["dropped"]
            q.extend(batches)
        else:
            q.append(p)
        while len(q) > self._span_queue_cap:
            try:
                old = q.popleft()
                with self._traces_lock:
                    self._spans_dropped += \
                        len(old.get("spans", ())) + old.get("dropped", 0)
            except IndexError:
                break
        self._span_signal.set()
        return True

    def _span_merge_loop(self):
        while not self._stop.is_set():
            self._span_signal.wait(0.5)
            self._span_signal.clear()
            self._drain_span_queue()
        self._drain_span_queue()  # final drain: keep pre-stop batches

    def _drain_span_queue(self):
        while self._span_queue:
            try:
                self._merge_spans(self._span_queue.popleft())
            except IndexError:
                break
            except Exception:
                logger.exception("span merge failed")

    def _merge_spans(self, p):
        """Fold one batch into the per-trace store, evict (LRU cap +
        idle TTL), then mirror touched traces into the _tracing KV
        namespace as pre-encoded JSON blobs — the encode happens outside
        self.lock, so the global lock is held only for dict updates."""
        common_fields = p.get("common") or {}
        proc = common_fields.get("proc")
        now = time.monotonic()
        with self._traces_lock:
            self._span_batches += 1
            self._spans_dropped += p.get("dropped", 0)
            touched = set()
            for sp in p.get("spans", []):
                tid = sp.get("trace_id")
                if not tid:
                    continue
                if proc and "proc" not in sp:
                    sp["proc"] = proc
                lst = self.trace_spans.get(tid)
                if lst is None:
                    lst = self.trace_spans[tid] = []
                if len(lst) >= self._trace_spans_per_trace:
                    self._trace_span_overflow += 1
                    continue
                lst.append(sp)
                self._spans_received += 1
                self._trace_index[tid] = now
                self._trace_index.move_to_end(tid)
                touched.add(tid)
            evicted = []
            while len(self._trace_index) > self._trace_store_cap:
                old, _ = self._trace_index.popitem(last=False)
                self.trace_spans.pop(old, None)
                evicted.append(old)
                self._traces_evicted += 1
            while self._trace_index:
                old, ts = next(iter(self._trace_index.items()))
                if now - ts <= self._trace_store_ttl_s:
                    break
                self._trace_index.popitem(last=False)
                self.trace_spans.pop(old, None)
                evicted.append(old)
                self._traces_evicted += 1
            blobs = {tid: json.dumps(self.trace_spans[tid]).encode()
                     for tid in touched if tid in self.trace_spans}
        if not blobs and not evicted:
            return
        with self.lock:
            ns = self.kv.setdefault("_tracing", {})
            for tid, blob in blobs.items():
                ns[f"trace:{tid}"] = blob
            for tid in evicted:
                ns.pop(f"trace:{tid}", None)


def _standby_watch(peer: str, interval: float, misses_to_promote: int):
    """Block until the primary at `peer` is unreachable for
    `misses_to_promote` consecutive probes, then return (the caller
    promotes).  The warm-standby analog of the reference's GCS
    fault-tolerance supervisor: state is already on shared disk, so
    promotion is just 'load the store and start serving'."""
    from .protocol import Client

    host, port = peer.rsplit(":", 1)
    addr = (host, int(port))
    misses = 0
    logger.info("standby: watching primary at %s", peer)
    while True:
        try:
            cli = Client(addr, name="standby->primary", connect_timeout=2.0)
            try:
                cli.call("ping", timeout=2.0)
            finally:
                cli.close()
            misses = 0
        except Exception:
            misses += 1
            logger.warning("standby: primary probe failed (%d/%d)",
                           misses, misses_to_promote)
            if misses >= misses_to_promote:
                logger.warning("standby: promoting — primary declared dead")
                return
        time.sleep(interval)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--persist", default=None,
                    help="sqlite path for durable control-plane state "
                         "(GCS fault-tolerance equivalent)")
    ap.add_argument("--addr-file", default=None,
                    help="file to publish this control plane's address "
                         "in (the re-homing rendezvous for failover)")
    ap.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                    help="run as a warm standby: watch the primary at "
                         "this address and take over (load the persisted "
                         "state, serve, rewrite --addr-file) when it "
                         "stops answering")
    ap.add_argument("--standby-interval", type=float, default=0.5)
    ap.add_argument("--standby-misses", type=int, default=3)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s control %(levelname)s %(message)s")
    if args.standby_of:
        if not args.persist:
            ap.error("--standby-of requires --persist (takeover state)")
        if not args.addr_file:
            ap.error("--standby-of requires --addr-file (re-homing)")
        _standby_watch(args.standby_of, args.standby_interval,
                       args.standby_misses)
    srv = ControlServer(args.host, args.port, persist_path=args.persist,
                        addr_file=args.addr_file)
    srv.start(block=True)


if __name__ == "__main__":
    main()
