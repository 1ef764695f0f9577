"""Raylet: the per-node daemon.

The runtime's analog of the reference's NodeManager
(reference: src/ray/raylet/node_manager.cc:101): owns the worker pool
(worker_pool.h:366 PopWorker + startup-token protocol), lease-based local
scheduling (local_task_manager.h:58), placement-group bundle 2-phase commit
(placement_group_resource_manager.h:54-61), the node object store (shm_store),
and node-to-node object transfer (object_manager.proto:61 Push/Pull).

Deadlock avoidance for nested tasks: a worker blocked in `get` notifies the
raylet (task_blocked), which releases its CPUs so queued leases can be granted
— possibly by spawning extra workers (the reference does the same when
workers block in ray.get).

The port's copy of ``ray_tpu/_private/node.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from . import accelerators, common
from .common import add, fits, normalize_resources, subtract
from .protocol import (Backoff, Client, ConnectionLost, Deferred, Server,
                       ServerConn)
from .shm_store import ShmObjectStore

logger = logging.getLogger(__name__)

LEASE_GRANT_TICK_S = 0.01
# how often a lease this node can never grant looks for a node that can
INFEASIBLE_RECHECK_S = 1.0
WORKER_SPAWN_HARD_CAP_FACTOR = 10
# submit multiplexer: how recently a client must have submitted to count
# as a concurrent submitter, and how long a relay worker may sit idle
# before it returns to the shared pool
MUX_WINDOW_S = 10.0
MUX_IDLE_RELEASE_S = 1.0
MUX_CLIENT_ID = "__mux__"


class WorkerRecord:
    def __init__(self, worker_id: str, proc: Optional[subprocess.Popen], token: int):
        self.worker_id = worker_id
        self.proc = proc
        self.token = token
        self.addr: Optional[Tuple[str, int]] = None
        self.conn: Optional[ServerConn] = None
        self.state = "starting"  # starting | idle | leased | actor | dead
        self.leased_at = 0.0
        self.actor_id: Optional[str] = None
        self.lease_id: Optional[str] = None
        self.blocked = False
        self.lease_resources: Dict[str, int] = {}
        self.lease_retriable = True  # OOM-victim hint from the owner
        self.lease_client_id: Optional[str] = None  # whose core holds us
        self.bundle_key: Optional[Tuple[str, int]] = None
        self.bundle_demand: Dict[str, int] = {}  # PG actors: placed demand
        self.lent: Dict[str, int] = {}  # CPUs lent to the pool while blocked
        self.gpu = False  # spawned with GPU device visibility
        self.incarnation = 0  # actor incarnation this worker hosts


class PendingLease:
    def __init__(self, demand: Dict[str, int], deferred: Deferred, client_id: str,
                 bundle: Optional[Tuple[str, int]] = None,
                 retriable: bool = True, count: int = 1,
                 vector: bool = False):
        self.demand = demand
        self.deferred = deferred
        self.client_id = client_id
        self.bundle = bundle
        self.retriable = retriable
        self.count = count    # copies of `demand` wanted in one grant
        self.vector = vector  # reply shape: {"grants": [...]} vs single
        self.ts = time.monotonic()


class Raylet:
    def __init__(self, control_addr: Tuple[str, int], host: str = "127.0.0.1",
                 port: int = 0, resources: Optional[Dict[str, float]] = None,
                 session_dir: Optional[str] = None, labels: Optional[Dict[str, str]] = None,
                 node_id: Optional[str] = None,
                 control_addr_file: Optional[str] = None):
        self.node_id = node_id or common.node_id()
        self.control_addr = tuple(control_addr)
        self.control_addr_file = control_addr_file \
            or os.environ.get("RAY_TPU_TORCH_CONTROL_ADDR_FILE")
        self.server = Server(host, port, name="raylet")
        self.session_dir = session_dir or f"/dev/shm/ray_tpu_torch/{self.node_id}"
        self.store = ShmObjectStore(os.path.join(self.session_dir, "objects"))
        res = resources if resources is not None else accelerators.default_resources()
        self.total = normalize_resources(res)
        self.available = dict(self.total)
        self.labels = dict(labels or {})
        self.lock = threading.RLock()
        self.workers: Dict[str, WorkerRecord] = {}
        self.workers_by_token: Dict[int, WorkerRecord] = {}
        self.idle: Deque[WorkerRecord] = deque()
        self.pending_leases: Deque[PendingLease] = deque()
        # lessee core conns, for on-demand idle-lease reclaim pushes
        self.client_conns: Dict[str, Any] = {}
        self._last_reclaim_push = 0.0
        self._last_infeasible_check = 0.0
        # multi-client submit multiplexer (relay): once >=2 distinct
        # external clients submit within MUX_WINDOW_S, eligible plain
        # tasks arrive as framed mux_push_tasks notifies and are
        # scheduled HERE against the shared worker pool — N drivers stop
        # holding N separate pick_nodes/request_leases conversations.
        from .config import cfg as _mcfg

        self.mux_enabled = bool(_mcfg().submit_mux)
        self.mux_on = False                        # guarded-by: lock
        # FIFO of (client_id, spec) awaiting a worker slot
        self.mux_queue: Deque[Tuple[str, Any]] = deque()  # guarded-by: lock
        # wid -> {"rec", "inflight": {tid: (cid, spec)}, "idle_since"}
        self.mux_workers: Dict[str, Dict[str, Any]] = {}  # guarded-by: lock
        self.mux_seen: Dict[str, float] = {}       # guarded-by: lock
        self.mux_avg_ms: Optional[float] = None    # guarded-by: lock
        self.mux_stats = {"submitted": 0, "completed": 0,  # guarded-by: lock
                          "failed": 0, "released": 0}
        self.bundles: Dict[Tuple[str, int], Dict[str, Any]] = {}  # (pg,idx)->{resources,state}
        self._next_token = 0
        self._stop = threading.Event()
        self._reconnecting = threading.Semaphore(1)
        self._resurrect_lock = threading.Lock()
        self._registered_at = 0.0
        self.control: Optional[Client] = None
        self.peer_clients: Dict[Tuple[str, int], Client] = {}
        self.max_workers = max(
            1, int(sum(v for k, v in self.total.items() if k == common.CPU) / common._GRAN)
        ) * WORKER_SPAWN_HARD_CAP_FACTOR

        s = self.server
        s.handle("ping", lambda c, p: "pong")
        s.handle("register_worker", self.h_register_worker)
        s.handle("request_lease", self.h_request_lease, deferred=True)
        s.handle("request_leases", self.h_request_leases, deferred=True)
        s.handle("return_lease", self.h_return_lease)
        s.handle("cancel_lease_requests", self.h_cancel_lease_requests)
        s.handle("task_blocked", self.h_task_blocked)
        s.handle("task_unblocked", self.h_task_unblocked)
        s.handle("start_actor_worker", self.h_start_actor_worker, deferred=True)
        s.handle("kill_actor_worker", self.h_kill_actor_worker)
        s.handle("prepare_bundle", self.h_prepare_bundle)
        s.handle("commit_bundle", self.h_commit_bundle)
        s.handle("release_bundle", self.h_release_bundle)
        s.handle("fetch_object", self.h_fetch_object)
        s.handle("pull_object", self.h_pull_object, deferred=True)
        s.handle("delete_objects", self.h_delete_objects)
        s.handle("store_stats", self.h_store_stats)
        s.handle("node_info", self.h_node_info)
        s.handle("list_leases", self.h_list_leases)
        s.handle("list_workers", self.h_list_workers)
        s.handle("list_logs", self.h_list_logs)
        s.handle("read_log", self.h_read_log)
        s.handle("pending_demands", self.h_pending_demands)
        s.handle("report_task_events", self.h_report_task_events)
        s.handle("mux_push_tasks", self.h_mux_push_tasks)
        s.handle("mux_tasks_done", self.h_mux_tasks_done)
        s.handle("mux_cancel", self.h_mux_cancel)
        s.on_disconnect(self.h_disconnect)

        # node-local task-event relay (ROADMAP item 5 "per-node batching
        # of task events"): workers flush their task-event batches to
        # THIS raylet over their existing socket; a relay loop coalesces
        # every batch from the flush window into ONE framed pipe write
        # to the control.  N workers/node no longer means N control
        # writes per flush interval.  Bounded with drop-oldest
        # accounting — never silent loss.
        self._ev_relay: Deque[Dict[str, Any]] = deque()
        self._ev_relay_lock = threading.Lock()
        self._ev_relay_buffered = 0  # events currently buffered
        self._ev_relay_cap = 20_000  # events; overflow drops oldest batch
        self._ev_relay_pending_dropped = 0  # dropped, not yet reported
        self._ev_relay_stats = {"batches_in": 0, "events_in": 0,
                                "sends": 0, "coalesced": 0, "dropped": 0}
        self._ev_relay_thread = threading.Thread(
            target=self._task_event_relay_loop, name="raylet-task-events",
            daemon=True)

        # prestarted warm workers (reference: worker_pool.h prestart):
        # interpreter + framework import is paid once off the critical path;
        # leases and actor creations pop a warm worker
        cpu_slots = max(1, int(sum(
            v for k, v in self.total.items() if k == common.CPU)
            / common._GRAN))
        from .config import cfg as _pcfg

        self.prestart_target = min(cpu_slots, _pcfg().worker_prestart)
        self._prestart_thread = threading.Thread(
            target=self._prestart_loop, name="raylet-prestart", daemon=True)
        self._grant_thread = threading.Thread(target=self._grant_loop,
                                              name="raylet-grant", daemon=True)
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           name="raylet-heartbeat", daemon=True)
        self._reap_thread = threading.Thread(target=self._reap_loop,
                                             name="raylet-reap", daemon=True)
        self._pull_pool: Dict[str, threading.Event] = {}
        #: a preemption notice was observed for THIS host: stop warming
        #: new workers; the control plane broadcasts the drain advisory
        self._draining = False
        self.preemption_watcher = None

        # object spilling + memory watchdog (reference:
        # local_object_manager.h:110, memory_monitor.h:52)
        from . import spilling

        from .config import cfg as _ncfg

        self.spill: Optional[spilling.SpillManager] = None
        if _ncfg().object_spilling:
            # spill to real disk — the session dir lives on /dev/shm, and
            # spilling tmpfs→tmpfs would free no memory.  Always suffix
            # with the node id: co-hosted raylets must not share (and on
            # shutdown rmtree) one directory.
            spill_base = os.environ.get("RAY_TPU_TORCH_SPILL_DIR",
                                        "/tmp/ray_tpu_torch_spill")
            self.spill = spilling.SpillManager(
                self.store, os.path.join(spill_base, self.node_id))
        self.oom_killer: Optional[spilling.OomKiller] = None
        if _ncfg().is_set("memory_monitor_refresh_ms"):
            refresh_ms = _ncfg().memory_monitor_refresh_ms
        else:
            # default on only inside a memory-limited cgroup, where the
            # limit is real and ours; on a shared host a high ambient
            # usage would make kills spurious
            refresh_ms = 250 if spilling._cgroup_usage() else 0
        self._mem_refresh_s = max(int(refresh_ms), 0) / 1000.0
        if self._mem_refresh_s > 0:
            self.oom_killer = spilling.OomKiller(
                self, spilling.MemoryMonitor())
        self._mem_thread = None
        if self.spill is not None or self.oom_killer is not None:
            self._mem_thread = threading.Thread(
                target=self._memory_loop, name="raylet-memory", daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self, block: bool = False):
        self.server.start()
        # the rendezvous file outranks the bootstrap --control address: a
        # node added AFTER a failover must join the promoted controller,
        # not the dead primary it was configured with
        file_addr = self._read_addr_file()
        if file_addr and file_addr != self.control_addr:
            logger.info("control addr-file overrides bootstrap address: "
                        "%s -> %s", self.control_addr, file_addr)
            self.control_addr = file_addr
        self.control = Client(self.control_addr, name="raylet->control",
                              on_disconnect=self._on_control_lost)
        self.control.call("register_node", {
            "node_id": self.node_id,
            "addr": self.server.addr,
            "resources": common.denormalize_resources(self.total),
            "labels": self.labels,
        }, timeout=30.0)
        self._registered_at = time.monotonic()
        # span collector: the raylet reports its relay/mux phase spans to
        # the control plane like every other traced process
        from ray_tpu_torch.util import tracing as _tracing

        _tracing.ensure_collector(self.control,
                                  proc=f"raylet:{self.node_id[:8]}",
                                  node_id=self.node_id)
        self._grant_thread.start()
        self._hb_thread.start()
        self._reap_thread.start()
        self._prestart_thread.start()
        self._ev_relay_thread.start()
        if self._mem_thread is not None:
            self._mem_thread.start()
        # worker-log tailer -> control pubsub -> driver stderr
        # (reference: python/ray/_private/log_monitor.py)
        from .log_monitor import LogMonitor

        def _publish_logs(payload):
            cli = self.control
            if cli is not None and not cli.closed:
                try:
                    cli.notify("publish", {"topic": "worker_logs",
                                           "payload": payload})
                except Exception:
                    pass

        self.log_monitor = LogMonitor(
            os.path.join(self.session_dir, "logs"), self.node_id,
            _publish_logs)
        self.log_monitor.start()
        # preemption watcher: poll the maintenance-event source (env-
        # selected; None on hosts without one) and report a drain notice
        # to the control plane before the heartbeat timeout would fire
        from ray_tpu_torch.elastic.preemption import (PreemptionWatcher,
                                                source_from_env)

        src = source_from_env()
        if src is not None:
            from .config import cfg as _wcfg

            self.preemption_watcher = PreemptionWatcher(
                src, self._on_preemption_notice,
                poll_interval_s=_wcfg().preemption_poll_s,
                debounce_s=_wcfg().preemption_debounce_s)
            self.preemption_watcher.start()
            logger.info("preemption watcher active (%s)",
                        type(src).__name__)
        logger.info("raylet %s up at %s resources=%s", self.node_id[:12],
                    self.server.addr, common.denormalize_resources(self.total))
        if block:
            try:
                while not self._stop.is_set():
                    time.sleep(0.5)
            except KeyboardInterrupt:
                pass
            self.shutdown()

    def _on_preemption_notice(self, notice):
        """The preemption source says this host is going away: report a
        drain notice to the control (which broadcasts the advisory) and
        stop warming new workers locally.  Best-effort — a raylet that
        can't reach the control still dies on schedule; the heartbeat
        timeout remains the backstop."""
        from .config import cfg as _wcfg

        grace = notice.grace_s if notice.grace_s is not None \
            else _wcfg().drain_grace_s
        logger.warning("preemption notice (%s): draining, grace %.1fs",
                       notice.reason, grace)
        self._draining = True
        cli = self.control
        if cli is None or cli.closed:
            return
        try:
            cli.call("report_draining", {
                "node_id": self.node_id, "grace_s": grace,
                "reason": notice.reason}, timeout=5.0)
        except Exception:
            logger.warning("could not report drain notice to control",
                           exc_info=True)

    def _on_control_lost(self):
        """Control connection dropped.  With a persistent control plane the
        daemon comes back at the same address (reference: GCS fault
        tolerance — raylets reconnect and re-sync rather than exiting);
        retry for a grace window before giving up."""
        if self._stop.is_set():
            return
        # closing a superseded client re-fires this callback: only react
        # when the *current* control client is actually down, one
        # reconnector at a time
        if self.control is not None and not self.control.closed:
            return
        if not self._reconnecting.acquire(blocking=False):
            return
        from .config import cfg

        grace = cfg().control_reconnect_s
        threading.Thread(target=self._reconnect_control, args=(grace,),
                         name="raylet-reconnect", daemon=True).start()

    def _read_addr_file(self):
        """Current control-plane address from the rendezvous file, or
        None.  A promoted standby rewrites the file (atomically) with
        its own address — re-reading it per retry is what re-homes this
        raylet across a failover."""
        return common.read_addr_file(self.control_addr_file)

    def _reconnect_control(self, grace: float):
        try:
            from .config import cfg

            deadline = time.monotonic() + grace
            # jittered exponential backoff: a cluster of raylets re-homing
            # after a control restart must not stampede it in lockstep
            bo = Backoff(cfg().rpc_backoff_base_s, cfg().rpc_backoff_cap_s)
            logger.warning("control connection lost; retrying for %.0fs",
                           grace)
            while not self._stop.is_set() and time.monotonic() < deadline:
                new_addr = self._read_addr_file()
                if new_addr and new_addr != self.control_addr:
                    logger.warning("control plane moved: %s -> %s",
                                   self.control_addr, new_addr)
                    self.control_addr = new_addr
                try:
                    cli = Client(self.control_addr, name="raylet->control",
                                 on_disconnect=self._on_control_lost,
                                 connect_timeout=2.0)
                    cli.call("ping", timeout=5.0)
                except Exception:
                    bo.sleep(max_s=max(0.0, deadline - time.monotonic()))
                    continue
                connected_at = time.monotonic()
                old, self.control = self.control, cli
                if old is not None:
                    old.close()
                # the restarted/promoted control has no node entry for
                # us: re-register, REPORTING live actor workers so the
                # control adopts them in place (state preserved) instead
                # of rescheduling; it replies with any it refuses
                self._rehome(if_stale_since=connected_at)
                logger.info("reconnected to control plane at %s",
                            self.control_addr)
                return
            if not self._stop.is_set():
                logger.warning("control did not come back within %.0fs; "
                               "shutting down raylet", grace)
                self.shutdown()
        finally:
            self._reconnecting.release()

    def _rehome(self, if_stale_since: Optional[float] = None):
        """Re-register after a control disconnect / restart / failover.

        Registration happens FIRST, reporting EVERY live actor worker —
        PG-placed ones included, tagged with their bundle.  The control's
        reply says whether it still held our node record (``resumed``):

        * resumed — transient disconnect (or failover to a standby that
          restored us): NOTHING is torn down.  PG workers, self.bundles
          and the availability books all survive; the only reconciliation
          is releasing bundles the control no longer assigns here (a
          remove_pg whose release RPC the partition ate) and reaping
          workers of rejected actors.
        * cold — the control lost our record (restart without
          persistence) or declared us dead: the clean-slate semantics.
          Live non-PG actors were offered for adoption (same incarnation,
          state preserved — the warm-standby promise) and the control
          rejected any it already rescheduled; PG-placed actors take the
          reschedule path with their group (bundle reservations re-run
          2-phase commit), so their workers are reaped and the bundle
          books wiped.  Only bundle keys snapshotted BEFORE registration
          are wiped — a bundle the control prepares concurrently with
          the cleanup must survive it.

        if_stale_since: skip if a registration already landed at/after
        this time — a second rehome racing the first would find its
        just-adopted actors ALIVE (not adoptable), get them rejected,
        and kill the workers the first rehome saved.  Checked UNDER the
        serializing lock (the check-outside variant was exactly that
        race)."""
        with self._resurrect_lock:
            if if_stale_since is not None \
                    and self._registered_at >= if_stale_since:
                return
            with self.lock:
                live = [{"actor_id": r.actor_id,
                         "incarnation": r.incarnation,
                         "worker_addr": r.addr,
                         "worker_id": r.worker_id,
                         "bundle": r.bundle_key}
                        for r in self.workers.values()
                        if r.actor_id is not None and r.state != "dead"
                        and r.addr is not None]
                bundles_before = list(self.bundles.keys())
            try:
                resp = self.control.call("register_node", {
                    "node_id": self.node_id,
                    "addr": self.server.addr,
                    "resources": common.denormalize_resources(self.total),
                    "labels": self.labels,
                    "live_actors": live,
                    "bundles": bundles_before,
                }, timeout=30.0) or {}
                self._registered_at = time.monotonic()
            except Exception:
                logger.warning("re-registration failed; will retry on "
                               "next heartbeat")
                return
            resumed = bool(resp.get("resumed"))
            rejected = set(resp.get("rejected_actors") or ())
            if resumed:
                assigned = {tuple(k) for k in
                            (resp.get("assigned_bundles") or ())}
                stale = [k for k in bundles_before if k not in assigned]
                if stale:
                    logger.warning("releasing %d bundle(s) the control "
                                   "dropped while we were disconnected: "
                                   "%s", len(stale), stale)
                for key in stale:
                    self._release_bundle_local(key)
                logger.info("re-registered with control (resumed): "
                            "%d live actor(s) kept, %d rejected",
                            len(live) - len(rejected), len(rejected))
            else:
                # clean slate: PG-placed workers reschedule with their
                # group; their bundles re-run the 2-phase reservation
                with self.lock:
                    pg_actor_workers = [
                        r for r in self.workers.values()
                        if r.actor_id is not None and r.state != "dead"
                        and r.bundle_key is not None]
                for rec in pg_actor_workers:
                    try:
                        if rec.conn is not None:
                            rec.conn.push("shutdown", {})
                        self._kill_worker(rec)
                    except Exception:
                        pass
                with self.lock:
                    for key in bundles_before:
                        self.bundles.pop(key, None)
                    self.available = dict(self.total)
                    for rec in self.workers.values():
                        if rec.state != "dead" and rec.lease_resources:
                            subtract(self.available, rec.lease_resources)
                            if rec.blocked and rec.lent:
                                add(self.available, rec.lent)
                    # reservations prepared after the snapshot survive
                    for b in self.bundles.values():
                        subtract(self.available, b["resources"])
            if rejected:
                with self.lock:
                    victims = [r for r in self.workers.values()
                               if r.actor_id in rejected
                               and r.state != "dead"]
                for rec in victims:
                    logger.warning("control rejected adoption of actor "
                                   "%s; reaping its worker",
                                   rec.actor_id[:12])
                    try:
                        if rec.conn is not None:
                            rec.conn.push("shutdown", {})
                        self._kill_worker(rec)
                    except Exception:
                        pass

    def _release_bundle_local(self, key: Tuple[str, int]):
        """Release one PG bundle and reap workers placed on it — rehome
        reconciliation for groups the control removed mid-partition."""
        with self.lock:
            victims = [r for r in self.workers.values()
                       if r.bundle_key == key and r.state != "dead"]
        for rec in victims:
            try:
                if rec.conn is not None:
                    rec.conn.push("shutdown", {})
                self._kill_worker(rec)
            except Exception:
                pass
        with self.lock:
            b = self.bundles.pop(key, None)
            if b is not None:
                add(self.available, b["resources"])

    def shutdown(self):
        if self._stop.is_set():
            return
        self._stop.set()
        # graceful exit: tell the control immediately.  Death is otherwise
        # only declared after the heartbeat timeout now that transient
        # disconnects are tolerated — a deliberate exit must not leave its
        # actors in limbo for that window.
        cli = self.control
        if cli is not None and not cli.closed:
            try:
                cli.call("unregister_node", {"node_id": self.node_id},
                         timeout=2.0)
            except Exception:
                pass
        if getattr(self, "log_monitor", None) is not None:
            self.log_monitor.stop()
        if self.preemption_watcher is not None:
            self.preemption_watcher.stop()
        with self.lock:
            workers = list(self.workers.values())
        for w in workers:
            self._kill_worker(w)
        self.server.stop()
        if self.spill is not None:
            self.spill.destroy()
        self.store.destroy()
        try:
            shutil.rmtree(self.session_dir, ignore_errors=True)
        except OSError:
            pass

    # -- worker pool -------------------------------------------------------

    def _spawn_worker(self, actor_id: Optional[str] = None,
                      env_extra: Optional[Dict[str, str]] = None,
                      gpu: bool = False,
                      container: Optional[Dict] = None) -> WorkerRecord:
        with self.lock:
            self._next_token += 1
            token = self._next_token
        wid = common.worker_id()
        rec = WorkerRecord(wid, None, token)
        rec.actor_id = actor_id
        rec.gpu = gpu
        with self.lock:
            self.workers[wid] = rec
            self.workers_by_token[token] = rec
        env = dict(os.environ)
        from .bootstrap import _package_pythonpath

        # ONE dict of worker-specific vars: the same set is applied to
        # the host env AND forwarded into containers as -e flags (a
        # second hand-written list would silently drift)
        worker_vars = {
            "PYTHONPATH": _package_pythonpath(),
            "RAY_TPU_TORCH_STARTUP_TOKEN": str(token),
            "RAY_TPU_TORCH_WORKER_ID": wid,
            # line-buffered stdout so task prints reach the log tailer
            # (and the driver) promptly, not on buffer flushes
            "PYTHONUNBUFFERED": "1",
            "RAY_TPU_TORCH_NODE_ID": self.node_id,
            "RAY_TPU_TORCH_SESSION_DIR": self.session_dir,
        }
        if self.control_addr_file:
            # workers re-home to a promoted standby controller through
            # the same rendezvous file the raylet uses
            worker_vars["RAY_TPU_TORCH_CONTROL_ADDR_FILE"] = self.control_addr_file
        if not gpu:
            # Device visibility is binary, as in the reference (which pins
            # a worker without the TPU resource to JAX_PLATFORMS=cpu): a
            # worker not granted GPU sees no card at all, so it can neither
            # take a CUDA context on a card another worker holds nor fall
            # back to one by accident (Ray's CUDA_VISIBLE_DEVICES scoping,
            # accelerators/nvidia_gpu.py).  A GPU worker inherits the
            # raylet's view of the cards.
            worker_vars["CUDA_VISIBLE_DEVICES"] = ""
        else:
            # the worker must raise, never compute on the CPU, if it finds
            # no card while holding the GPU lease (worker_proc checks)
            worker_vars["RAY_TPU_TORCH_WORKER_GPU"] = "1"
        if actor_id:
            worker_vars["RAY_TPU_TORCH_ACTOR_ID"] = actor_id
        if env_extra:
            worker_vars.update(env_extra)
        env.update(worker_vars)
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.worker_proc",
               "--raylet", f"{self.server.addr[0]}:{self.server.addr[1]}",
               "--control", f"{self.control_addr[0]}:{self.control_addr[1]}"]
        try:
            if container:
                # containerized actor worker (reference: image_uri.py:106
                # ImageURIPlugin wrapping the worker command): the runtime
                # does not forward its client's env, so worker_vars ride
                # as -e flags; host network + /dev/shm + session dir
                # mounts keep the data/control planes reachable
                from . import runtime_env as _rtenv

                devices: list = []
                if gpu:
                    # GPU actors get the host's device nodes granted into
                    # the container and the card-visibility env forwarded
                    # (reference: image_uri.py device propagation).  A host
                    # with no card node is refused: the container would
                    # otherwise run on the CPU while holding the GPU lease.
                    devices = accelerators.gpu_device_paths()
                    if not accelerators.card_nodes(devices):
                        raise RuntimeError(
                            "containerized GPU actor on a host with no GPU "
                            "device nodes (/dev/nvidia<N>) — the container "
                            "would silently run on CPU while holding the "
                            "GPU lease")
                    worker_vars = {**worker_vars,
                                   **accelerators.gpu_container_env()}
                cmd = _rtenv.wrap_container_cmd(
                    cmd, worker_vars, container, self.session_dir,
                    env["PYTHONPATH"], devices=devices)
            log_dir = os.path.join(self.session_dir, "logs")
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"worker-{wid[:12]}.log"), "ab")
            rec.proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=out,
                                        start_new_session=True)
            out.close()
        except Exception:
            # never leak the pre-registered record of a worker that was
            # never born (the reap loop skips proc=None records)
            with self.lock:
                self.workers.pop(wid, None)
                self.workers_by_token.pop(token, None)
            rec.state = "dead"
            raise
        return rec

    def h_register_worker(self, conn: ServerConn, p):
        token = p["token"]
        with self.lock:
            rec = self.workers_by_token.get(token)
            if rec is None:
                return {"ok": False, "error": "unknown startup token"}
            rec.addr = tuple(p["addr"])
            rec.conn = conn
            conn.meta["worker_id"] = rec.worker_id
            if rec.actor_id is None:
                rec.state = "idle"
                self.idle.append(rec)
            else:
                rec.state = "actor"
        return {"ok": True, "worker_id": rec.worker_id, "node_id": self.node_id,
                "actor_id": rec.actor_id}

    def _kill_worker(self, rec: WorkerRecord):
        rec.state = "dead"
        if rec.proc is not None and rec.proc.poll() is None:
            try:
                rec.proc.terminate()
            except OSError:
                pass

    def kill_worker_for_oom(self, rec: WorkerRecord) -> bool:
        """OOM-policy kill: release the lease's resources and retire the
        record up front — marking it dead suppresses the disconnect
        handler, which must not see this as an implicit lease return."""
        with self.lock:
            if rec.state != "leased":
                return False
            self._free_lease_resources(rec)
            rec.blocked = False
            rec.lease_id = None
            self.workers.pop(rec.worker_id, None)
            self.workers_by_token.pop(rec.token, None)
        self._kill_worker(rec)
        # its core may have held leases on other workers for nested tasks
        self._reclaim_leases_of_dead_client(rec.worker_id)
        self._mux_on_worker_gone(rec.worker_id)
        self._try_grant()
        return True

    def h_disconnect(self, conn: ServerConn):
        # drop reclaim-push registrations bound to this conn (drivers
        # and worker cores alike), or dead ServerConns accumulate —
        # and reclaim the departed client's leases: a DRIVER exiting
        # mid-lease never registers as a worker, so without this its
        # task leases leak until the whole node starves (each departed
        # driver once pinned its leased CPUs forever)
        gone_clients = []
        with self.lock:
            for cid, c in list(self.client_conns.items()):
                if c is conn:
                    self.client_conns.pop(cid, None)
                    # a worker core's own id is handled by the worker
                    # tail below (which also kills the proc) — don't
                    # run the reclaim scan twice for it
                    if cid != conn.meta.get("worker_id"):
                        gone_clients.append(cid)
        for cid in gone_clients:
            # purge the departed client's QUEUED lease requests too:
            # granting one to a ghost books resources nobody will ever
            # use or return (the leak that starved a node after a burst
            # of short-lived drivers)
            self._purge_pending_of_client(cid)
            self._mux_purge_client(cid)
            self._reclaim_leases_of_dead_client(cid)
        if gone_clients:
            self._try_grant()
        wid = conn.meta.get("worker_id")
        if not wid:
            return
        with self.lock:
            rec = self.workers.get(wid)
            if rec is None:
                return
            # single critical section (the lock is re-entrant, so the
            # reclaim below may re-acquire it): no TOCTOU window between
            # classifying the record and retiring it
            if rec.state == "dead":
                # killed via a kill path that already handled resources —
                # the record must still leave the table, or it counts
                # against max_workers forever and eventually starves all
                # worker spawning.  Leases ITS core held on other workers
                # still need reclaiming (below).
                self.workers.pop(wid, None)
                self.workers_by_token.pop(rec.token, None)
                was = actor_id = None
                killed_path = True
            else:
                killed_path = False
                was = rec.state
                actor_id = rec.actor_id
                if rec.lease_resources or rec.bundle_demand or rec.lent:
                    self._free_lease_resources(rec)
                if rec in self.idle:
                    try:
                        self.idle.remove(rec)
                    except ValueError:
                        pass
                rec.state = "dead"
                self.workers.pop(wid, None)
                self.workers_by_token.pop(rec.token, None)
        self._mux_on_worker_gone(wid)
        if killed_path:
            self._reclaim_leases_of_dead_client(wid)
            return
        if actor_id and self.control is not None and not self._stop.is_set():
            try:
                self.control.notify("actor_failed", {
                    "actor_id": actor_id,
                    "error": f"actor worker process exited (state={was})",
                })
            except OSError:
                pass
        self._reclaim_leases_of_dead_client(wid)

    def _reclaim_leases_of_dead_client(self, dead_worker_id: str):
        """A local worker (whose core may have leased OTHER workers for
        nested tasks — e.g. an actor running data tasks) died: free the
        leases it held, or they stay 'leased' forever and the node starves
        (reference: raylet lease cleanup on client disconnect).  The
        leased workers are KILLED, not recycled — they may still be
        executing the dead client's task, and a stale task queued ahead
        would stall the next lessee's work indefinitely."""
        reclaimed = []
        with self.lock:
            for rec in list(self.workers.values()):
                if rec.state == "leased" \
                        and rec.lease_client_id == dead_worker_id:
                    self._free_lease_resources(rec)
                    rec.blocked = False
                    rec.lease_id = None
                    rec.lease_client_id = None
                    self.workers.pop(rec.worker_id, None)
                    self.workers_by_token.pop(rec.token, None)
                    reclaimed.append(rec)
        for rec in reclaimed:
            self._kill_worker(rec)
        if reclaimed:
            logger.info("reclaimed %d lease(s) of dead client %s",
                        len(reclaimed), dead_worker_id[:12])
            # a reclaimed worker's own core may have leased further
            # workers (depth-2 nesting); its disconnect handler will
            # no-op (record already popped), so recurse here
            for rec in reclaimed:
                self._reclaim_leases_of_dead_client(rec.worker_id)
            self._try_grant()

    def _reap_loop(self):
        while not self._stop.is_set():
            time.sleep(1.0)
            with self.lock:
                for rec in list(self.workers.values()):
                    if rec.proc is None or rec.proc.poll() is None:
                        continue
                    if rec.state == "starting":
                        # died before registering
                        logger.warning("worker %s died during startup",
                                       rec.worker_id[:12])
                        self.workers.pop(rec.worker_id, None)
                        self.workers_by_token.pop(rec.token, None)
                    elif rec.state == "dead":
                        # kill paths own the resource bookkeeping; the
                        # reaper only retires the record (backstop for
                        # workers whose conn never fires h_disconnect)
                        self.workers.pop(rec.worker_id, None)
                        self.workers_by_token.pop(rec.token, None)

    # -- leases ------------------------------------------------------------

    def h_request_lease(self, conn, p, d: Deferred):
        self._enqueue_lease(conn, p, d, count=1, vector=False)

    def h_request_leases(self, conn, p, d: Deferred):
        """Vectorized lease request: up to p['count'] copies of one demand
        granted in a single reply ({"ok": True, "grants": [...]}).  Grants
        may be fewer than requested — whatever one grant pass can serve —
        and never zero with ok=True (zero keeps the request pending)."""
        self._enqueue_lease(conn, p, d,
                            count=max(1, int(p.get("count", 1))),
                            vector=True)

    def _enqueue_lease(self, conn, p, d: Deferred, count: int, vector: bool):
        res = p.get("resources")
        demand = normalize_resources({common.CPU: 1} if res is None else res)
        bundle = p.get("bundle")  # (pg_id, index) -> draw from bundle reservation
        if bundle is not None:
            bundle = (bundle[0], bundle[1])
            with self.lock:
                if bundle[1] == -1:
                    # "any bundle of this group" (reference:
                    # placement_group_bundle_index=-1): accept if the pg
                    # has any committed bundle here; resolved at grant
                    if not self._pg_bundles_locked(bundle[0]):
                        d.reject(f"no committed bundle of {bundle[0]} "
                                 f"on this node")
                        return
                else:
                    b = self.bundles.get(bundle)
                    if b is None or b["state"] != "committed":
                        d.reject(f"bundle {bundle} not committed on this node")
                        return
        cid = p.get("client_id", "")
        with self.lock:
            if cid:
                self.client_conns[cid] = conn
                activated = self._mux_note_client(cid)
            else:
                activated = False
            self.pending_leases.append(
                PendingLease(demand, d, cid, bundle,
                             retriable=p.get("retriable", True),
                             count=count, vector=vector))
        if activated:
            self._mux_announce()
        self._try_grant()

    def _pg_bundles_locked(self, pg_id: str):
        return [k for k, b in self.bundles.items()
                if k[0] == pg_id and b["state"] == "committed"]

    def _bundle_free_fits_locked(self, key, demand) -> bool:
        b = self.bundles.get(key)
        if b is None or b["state"] != "committed":
            return False
        free = dict(b["resources"])
        subtract(free, b.setdefault("used", {}))
        return fits(free, demand)

    def _resolve_bundle_locked(self, bundle, demand):
        """Concrete committed bundle key for a lease (index -1 = any bundle
        of the pg with room)."""
        if bundle[1] != -1:
            return bundle if self._bundle_free_fits_locked(bundle, demand) \
                else None
        for key in self._pg_bundles_locked(bundle[0]):
            if self._bundle_free_fits_locked(key, demand):
                return key
        return None

    def _lease_fits(self, pl: PendingLease) -> bool:
        """Bundle leases draw from the bundle's reservation, not general
        availability (the reservation was subtracted at PREPARE)."""
        if pl.bundle is not None:
            if pl.bundle[1] == -1:
                if not self._pg_bundles_locked(pl.bundle[0]):
                    return True  # grant path rejects; don't wedge the queue
                return self._resolve_bundle_locked(pl.bundle,
                                                   pl.demand) is not None
            b = self.bundles.get(pl.bundle)
            if b is None or b["state"] != "committed":
                return True  # grant path will reject; don't wedge the queue
            free = dict(b["resources"])
            subtract(free, b.setdefault("used", {}))
            return fits(free, pl.demand)
        return fits(self.available, pl.demand)

    def _grant_loop(self):
        while not self._stop.is_set():
            time.sleep(LEASE_GRANT_TICK_S)
            self._try_grant()
            self._spill_infeasible()
            try:
                self._mux_tick()
            except Exception:
                logger.exception("mux tick failed")

    def _prestart_loop(self):
        while not self._stop.is_set():
            try:
                with self.lock:
                    warm = sum(1 for r in self.workers.values()
                               if r.actor_id is None
                               and r.state in ("starting", "idle"))
                    deficit = self.prestart_target - warm
                    room = self.max_workers - len(self.workers)
                # spawn at most one per tick: on small hosts concurrent
                # interpreter (+torch) imports thrash the CPU.  A draining
                # host stops warming — its pool only shrinks from here.
                if deficit > 0 and room > 0 and not self._draining:
                    self._spawn_worker()
            except Exception:
                logger.exception("prestart failed")
            time.sleep(0.25)

    def _try_grant(self):
        grants: List[Tuple[PendingLease, List[WorkerRecord]]] = []
        rejects: List[Tuple[PendingLease, str]] = []
        spawn = 0
        spawn_gpu = False
        starved = False
        with self.lock:
            mux_flag = self.mux_on
            while self.pending_leases:
                pl = self.pending_leases[0]
                wants_gpu = any(k.startswith(common.GPU)
                                for k in pl.demand)
                # grant up to pl.count copies in this one pass; the fits
                # check re-runs per copy because each charge shrinks the
                # pool (vector requests stop at whatever actually fits)
                granted: List[WorkerRecord] = []
                reject_msg = None
                while len(granted) < pl.count:
                    if not self._lease_fits(pl):
                        break
                    w = None
                    skipped: List[WorkerRecord] = []
                    while self.idle:
                        cand = self.idle.popleft()
                        if cand.state != "idle":
                            continue
                        if wants_gpu and not cand.gpu:
                            skipped.append(cand)  # CPU-only worker: no device
                            continue
                        w = cand
                        break
                    self.idle.extend(skipped)
                    if w is None:
                        break
                    if pl.bundle is not None:
                        key = self._resolve_bundle_locked(pl.bundle, pl.demand)
                        b = self.bundles.get(key) if key else None
                        if b is None:
                            reject_msg = f"bundle {pl.bundle} no longer committed"
                            self.idle.append(w)
                            break
                        add(b.setdefault("used", {}), pl.demand)
                        w.bundle_key = key
                    else:
                        subtract(self.available, pl.demand)
                    w.state = "leased"
                    w.leased_at = time.monotonic()
                    w.lease_id = common.new_id("lease-")
                    w.lease_resources = pl.demand
                    w.lease_retriable = pl.retriable
                    w.lease_client_id = pl.client_id
                    granted.append(w)
                if granted:
                    # partial vector grants resolve immediately with what
                    # this pass could serve — never park granted workers
                    # behind the remainder (the owner re-requests)
                    self.pending_leases.popleft()
                    grants.append((pl, granted))
                    continue
                if reject_msg is not None:
                    self.pending_leases.popleft()
                    rejects.append((pl, reject_msg))
                    continue
                if not self._lease_fits(pl):
                    starved = True
                    break
                # fits but no idle worker: spawn toward the remaining
                # demand (a vector request warms several at once instead
                # of the old one-per-grant-tick trickle)
                n_starting = sum(
                    1 for r in self.workers.values()
                    if r.state == "starting" and r.actor_id is None
                    and r.gpu == wants_gpu)
                room = self.max_workers - len(self.workers)
                spawn = max(0, min(pl.count - n_starting, room))
                spawn_gpu = wants_gpu
                break
        for _ in range(spawn):
            self._spawn_worker(gpu=spawn_gpu)
        for pl, msg in rejects:
            pl.deferred.reject(msg)
        for pl, ws in grants:
            logger.debug("grant %s lease=%s client=%s avail=%s",
                         [w.worker_id for w in ws], pl.demand,
                         pl.client_id, self.available)
            if pl.vector:
                pl.deferred.resolve({
                    "ok": True, "node_id": self.node_id,
                    # relay advisory: late-joining drivers learn the mux
                    # is open without waiting for a submit_mux push
                    "mux": mux_flag,
                    "grants": [{"lease_id": w.lease_id,
                                "worker_id": w.worker_id,
                                "worker_addr": w.addr} for w in ws],
                })
            else:
                w = ws[0]
                pl.deferred.resolve({
                    "ok": True, "lease_id": w.lease_id,
                    "worker_id": w.worker_id,
                    "worker_addr": w.addr, "node_id": self.node_id,
                })
        if starved:
            self._request_idle_reclaim()

    def _spill_infeasible(self):
        """A lease whose demand exceeds this node's total waits here only
        as autoscaler demand (``pending_demands``).  Once another node
        could grant it now (one the autoscaler launched, say), hand it
        back to its owner with ``spillback``, and the owner picks again.
        Without this the request waits out the owner's 120 s lease
        deadline, as it does in the reference's raylet (ROADMAP §C)."""
        now = time.monotonic()
        if now - self._last_infeasible_check < INFEASIBLE_RECHECK_S:
            return
        self._last_infeasible_check = now
        with self.lock:
            stuck = [pl for pl in self.pending_leases
                     if pl.bundle is None and not fits(self.total, pl.demand)]
        if not stuck or self.control is None:
            return
        try:
            nodes = self.control.call("get_nodes", {}, timeout=5.0)
        except Exception:
            return
        avail = [normalize_resources(n["available"]) for n in nodes
                 if n["state"] == "ALIVE" and n["node_id"] != self.node_id]
        spill = [pl for pl in stuck
                 if any(fits(a, pl.demand) for a in avail)]
        if not spill:
            return
        gone = {id(pl) for pl in spill}
        with self.lock:
            # a lease canceled since the scan is resolved already
            taken = [pl for pl in self.pending_leases if id(pl) in gone]
            self.pending_leases = deque(pl for pl in self.pending_leases
                                        if id(pl) not in gone)
        for pl in taken:
            try:
                pl.deferred.resolve({"ok": False, "spillback": True})
            except Exception:
                pass

    def _request_idle_reclaim(self):
        """A queued lease can't be served: ask every known lessee core to
        return its IDLE leases now instead of at the TTL reaper
        (reference: raylet ReleaseUnusedWorkers).  Without this, each
        new scheduling key's pool hoards leases and serialized one-shot
        workloads degrade to one reap-quantum per step."""
        now = time.monotonic()
        with self.lock:
            if now - self._last_reclaim_push < 0.5:
                return
            self._last_reclaim_push = now
            conns = list(self.client_conns.items())
        dead = []
        for cid, conn in conns:
            try:
                if not conn.push("reclaim_idle_leases", {}):
                    raise OSError("push failed")
            except Exception:
                with self.lock:
                    # identity guard: a failed push to a STALE conn must
                    # not reclaim a client that reconnected since
                    if self.client_conns.get(cid) is conn:
                        self.client_conns.pop(cid, None)
                        dead.append(cid)
        for cid in dead:
            # a push to a dead conn may race ahead of its h_disconnect;
            # having popped the registration (the disconnect handler's
            # only cue), run the same reclaim here or the dead client's
            # leases/queued requests leak
            self._purge_pending_of_client(cid)
            self._reclaim_leases_of_dead_client(cid)

    def _free_lease_resources(self, rec: WorkerRecord):
        """Return a worker's held resources to the right pool (general
        availability or its PG bundle's reservation).  Caller holds lock."""
        logger.info("free_lease %s lease=%s blocked=%s bundle=%s avail=%s",
                    rec.worker_id[:12], rec.lease_resources, rec.blocked,
                    rec.bundle_key, self.available)
        if rec.bundle_key is not None or rec.bundle_demand:
            # bundle 'used' is charged only for TASK leases; a blocked
            # task already released its CPU slot at block time, so only
            # the non-lent remainder comes back here
            if rec.lease_resources:
                b = self.bundles.get(rec.bundle_key) \
                    if rec.bundle_key is not None else None
                if b is not None:
                    rest = ({k: v for k, v in rec.lease_resources.items()
                             if k not in rec.lent}
                            if rec.blocked else rec.lease_resources)
                    subtract(b.setdefault("used", {}), rest)
            if rec.blocked and rec.lent:
                # bundle-backed: the general-pool loan was an EXTRA credit
                # on top of the PG's reservation; dying without unblocking
                # means it must be revoked (non-bundle loans simply stay —
                # the dead worker's CPU is genuinely free)
                subtract(self.available, rec.lent)
            rec.bundle_key = None
            rec.bundle_demand = {}
        elif not rec.blocked:
            add(self.available, rec.lease_resources)
        else:
            # blocked non-bundle lease: the CPU portion (rec.lent) already
            # went back at block time, but non-CPU resources (devices)
            # stayed booked — return them now or they leak forever
            rest = {k: v for k, v in rec.lease_resources.items()
                    if k not in rec.lent}
            add(self.available, rest)
        rec.lent = {}
        rec.lease_resources = {}

    def h_return_lease(self, conn, p):
        wid = p.get("worker_id")
        with self.lock:
            rec = self.workers.get(wid)
            if rec is None or rec.state != "leased":
                return False
            self._free_lease_resources(rec)
            rec.blocked = False
            rec.state = "idle"
            rec.lease_id = None
            self.idle.append(rec)
        self._try_grant()
        return True

    # -- submit multiplexer (relay) ---------------------------------------
    # Reference shape: the reference raylet's lease-less actor submission
    # path — here generalized so N concurrent drivers' plain tasks share
    # ONE framed stream per driver into this raylet, which schedules them
    # against the pool and fans coalesced acks back out.  rpc_stats
    # before/after shows request_leases/return_lease traffic collapsing.

    def _mux_note_client(self, cid: str) -> bool:  # holds: lock
        """Track distinct concurrent external submitters; True when this
        observation just flipped the mux on (caller announces, outside
        the lock).  Caller holds lock.  Worker cores doing nested
        submits don't count — they ride their host driver's workload."""
        if not self.mux_enabled or not cid or cid in self.workers:
            return False
        now = time.monotonic()
        self.mux_seen[cid] = now
        if self.mux_on:
            return False
        live = sum(1 for ts in self.mux_seen.values()
                   if now - ts < MUX_WINDOW_S)
        if live >= 2:
            self.mux_on = True   # sticky for the session
            return True
        return False

    def _mux_announce(self):
        """Tell every known lessee core the relay is open (late joiners
        learn via the mux flag on request_leases replies)."""
        with self.lock:
            conns = list(self.client_conns.values())
        for conn in conns:
            try:
                conn.push("submit_mux", {"on": True})
            except Exception:
                pass

    def _mux_depth_locked(self) -> int:  # holds: lock
        """Pushes in flight per relay worker before it stops getting
        more (same EWMA-driven pipelining rule as SchedPool.depth)."""
        if self.mux_avg_ms is None:
            return 1
        if self.mux_avg_ms < 2.0:
            return 16
        if self.mux_avg_ms < 20.0:
            return 4
        return 1

    def h_mux_push_tasks(self, conn: ServerConn, p):
        """A driver's flusher ships a framed batch of relay tasks."""
        cid = p.get("client_id", "")
        specs = p.get("specs") or []
        self._trace_stamp_relay(specs)
        activated = False
        with self.lock:
            if cid:
                self.client_conns[cid] = conn
                activated = self._mux_note_client(cid)
            for spec in specs:
                self.mux_queue.append((cid, spec))
            self.mux_stats["submitted"] += len(specs)
        if activated:
            self._mux_announce()
        self._mux_pump()
        return True

    def _mux_pump(self):
        """Dispatch queued relay tasks to workers with pipeline room,
        claiming idle workers (or spawning) toward the backlog.  All
        socket sends happen outside the lock."""
        to_push: List[Tuple[Any, List[Any]]] = []
        spawn = 0
        starved = False
        with self.lock:
            if not self.mux_queue:
                return
            demand = normalize_resources({common.CPU: 1})
            per_worker: Dict[str, Tuple[Any, List[Any]]] = {}
            while self.mux_queue:
                depth = self._mux_depth_locked()
                best = None
                for mw in self.mux_workers.values():
                    rec = mw["rec"]
                    if rec.state != "leased" or rec.conn is None \
                            or rec.blocked:
                        continue
                    if len(mw["inflight"]) >= depth:
                        continue
                    if best is None \
                            or len(mw["inflight"]) < len(best["inflight"]):
                        best = mw
                if best is None:
                    if self._mux_claim_worker_locked(demand):
                        continue
                    if fits(self.available, demand):
                        # fits but no idle worker: spawn toward the
                        # backlog (mirrors _try_grant's vector warmup)
                        n_starting = sum(
                            1 for r in self.workers.values()
                            if r.state == "starting"
                            and r.actor_id is None and not r.gpu)
                        room = self.max_workers - len(self.workers)
                        spawn = max(0, min(
                            len(self.mux_queue) - n_starting, room))
                    else:
                        starved = True
                    break
                cid, spec = self.mux_queue.popleft()
                best["inflight"][spec.task_id] = (cid, spec)
                rec = best["rec"]
                ent = per_worker.get(rec.worker_id)
                if ent is None:
                    ent = per_worker[rec.worker_id] = (rec.conn, [])
                ent[1].append(spec)
            to_push = list(per_worker.values())
        for _ in range(spawn):
            try:
                self._spawn_worker()
            except Exception:
                logger.exception("mux worker spawn failed")
        for wconn, specs in to_push:
            try:
                with self._trace_relay_cm(specs):
                    if not wconn.push("mux_push_tasks", specs):
                        raise OSError("push failed")
            except Exception:
                # dead worker conn: its h_disconnect sweep fails these
                # back to their owners via _mux_on_worker_gone
                pass
        if starved:
            self._request_idle_reclaim()

    @staticmethod
    def _trace_stamp_relay(specs) -> None:
        """Stamp relay-queue entry clocks on sampled specs (local-only
        attr — TaskSpec.__reduce__ keeps it off the wire)."""
        from ray_tpu_torch.util import tracing

        if not tracing.is_enabled():
            return
        now = time.time_ns()
        for spec in specs:
            if tracing.carrier_sampled(getattr(spec, "trace_ctx", None)):
                spec._relay_ns = now

    @staticmethod
    def _trace_relay_cm(specs):
        """Retro ``raylet.relay`` spans (relay-queue dwell) for each
        sampled spec in the outgoing batch, plus a ``raylet.mux_push``
        phase span around the worker push itself."""
        from ray_tpu_torch.util import tracing

        if not tracing.is_enabled():
            return contextlib.nullcontext()
        now_ns = time.time_ns()
        carrier = None
        for spec in specs:
            relay_ns = getattr(spec, "_relay_ns", None)
            if relay_ns is None:
                continue
            spec._relay_ns = None
            tracing.record_span("raylet.relay", "INTERNAL", relay_ns,
                                now_ns, tracing._extract(spec.trace_ctx),
                                batch=len(specs))
            if carrier is None:
                carrier = spec.trace_ctx
        if carrier is None:
            return contextlib.nullcontext()
        payload_bytes = sum(len(s.args_blob or b"") for s in specs)
        return tracing.phase_span("raylet.mux_push", carrier,
                                  batch=len(specs),
                                  payload_bytes=payload_bytes)

    def _mux_claim_worker_locked(self, demand) -> bool:  # holds: lock
        """Claim one idle CPU worker for the relay (caller holds lock).
        The claim books a full lease record — blocked-task lending, OOM
        policy and disconnect reclaim all see a normal leased worker."""
        if not fits(self.available, demand):
            return False
        w = None
        skipped: List[WorkerRecord] = []
        while self.idle:
            cand = self.idle.popleft()
            if cand.state != "idle":
                continue
            if cand.gpu:
                skipped.append(cand)  # keep device workers for leases
                continue
            w = cand
            break
        self.idle.extend(skipped)
        if w is None:
            return False
        subtract(self.available, demand)
        w.state = "leased"
        w.leased_at = time.monotonic()
        w.lease_id = common.new_id("lease-")
        w.lease_resources = demand
        w.lease_retriable = True
        w.lease_client_id = MUX_CLIENT_ID
        self.mux_workers[w.worker_id] = {
            "rec": w, "inflight": {}, "idle_since": time.monotonic()}
        return True

    def h_mux_tasks_done(self, conn: ServerConn, batch):
        """A relay worker's coalesced completions: fan them back out to
        the owning drivers, one framed push per driver."""
        wid = conn.meta.get("worker_id")
        per_client: Dict[str, List] = {}
        with self.lock:
            mw = self.mux_workers.get(wid)
            if mw is None:
                return True
            for task_id, reply in batch:
                ent = mw["inflight"].pop(task_id, None)
                if ent is None:
                    continue
                cid, _spec = ent
                ms = reply.get("exec_ms")
                if ms is not None:
                    self.mux_avg_ms = ms if self.mux_avg_ms is None \
                        else 0.8 * self.mux_avg_ms + 0.2 * ms
                per_client.setdefault(cid, []).append((task_id, reply))
                self.mux_stats["completed"] += 1
            if not mw["inflight"]:
                mw["idle_since"] = time.monotonic()
            conns = {cid: self.client_conns.get(cid) for cid in per_client}
        for cid, items in per_client.items():
            c = conns.get(cid)
            if c is None:
                continue   # owner gone; disconnect reclaim handles it
            try:
                c.push("mux_tasks_done", items)
            except Exception:
                pass
        self._mux_pump()
        return True

    def h_mux_cancel(self, conn: ServerConn, p):
        """Owner-requested cancel of a relay task: a still-queued task
        reports straight back through mux_task_failed (the owner maps it
        to TaskCancelledError — rec.canceled is already set there); a
        dispatched one is forwarded to its worker."""
        tid = p.get("task_id")
        cid = p.get("client_id", "")
        owner_conn = None
        worker_conn = None
        with self.lock:
            queued = next((i for i, (_c, s) in enumerate(self.mux_queue)
                           if s.task_id == tid), None)
            if queued is not None:
                del self.mux_queue[queued]
                owner_conn = self.client_conns.get(cid)
            else:
                for mw in self.mux_workers.values():
                    if tid in mw["inflight"]:
                        worker_conn = mw["rec"].conn
                        break
        if owner_conn is not None:
            try:
                owner_conn.push("mux_task_failed",
                                [(tid, "cancelled before start")])
            except Exception:
                pass
        elif worker_conn is not None:
            try:
                worker_conn.push("mux_cancel", p)
            except Exception:
                pass
        return True

    def _mux_on_worker_gone(self, wid: str):
        """A relay worker died: report its in-flight tasks to their
        owners (retry vs error is the owner's call — same policy as a
        lost lease conn)."""
        per_client: Dict[str, List] = {}
        with self.lock:
            mw = self.mux_workers.pop(wid, None)
            if mw is None:
                return
            for task_id, (cid, _spec) in mw["inflight"].items():
                per_client.setdefault(cid, []).append(
                    (task_id, f"worker {wid[:12]} died"))
                self.mux_stats["failed"] += 1
            conns = {cid: self.client_conns.get(cid) for cid in per_client}
        for cid, items in per_client.items():
            c = conns.get(cid)
            if c is None:
                continue
            try:
                c.push("mux_task_failed", items)
            except Exception:
                pass
        self._mux_pump()

    def _mux_purge_client(self, cid: str):
        """Drop a departed client's queued relay tasks (its in-flight
        ones finish and their acks fall on the floor)."""
        with self.lock:
            self.mux_seen.pop(cid, None)
            if self.mux_queue:
                self.mux_queue = deque(
                    (c, s) for c, s in self.mux_queue if c != cid)

    def _mux_tick(self):
        """Periodic relay maintenance (grant-loop tick): re-pump in case
        capacity freed, and hand relay workers back to the shared pool
        once idle past the TTL — immediately when classic lease requests
        are starving and the relay queue is empty."""
        released = False
        gone: List[str] = []
        with self.lock:
            if not self.mux_on:
                return
            now = time.monotonic()
            force = bool(self.pending_leases) and not self.mux_queue
            for wid, mw in list(self.mux_workers.items()):
                rec = mw["rec"]
                if rec.state != "leased":
                    # reclaimed/killed behind our back (e.g. reap loop):
                    # report its in-flight work, outside the lock
                    gone.append(wid)
                    continue
                if mw["inflight"]:
                    continue
                if not force and (self.mux_queue
                                  or now - mw["idle_since"]
                                  < MUX_IDLE_RELEASE_S):
                    continue
                self.mux_workers.pop(wid, None)
                self._free_lease_resources(rec)
                rec.blocked = False
                rec.state = "idle"
                rec.lease_id = None
                rec.lease_client_id = None
                self.idle.append(rec)
                self.mux_stats["released"] += 1
                released = True
        for wid in gone:
            self._mux_on_worker_gone(wid)
        if released:
            self._try_grant()
        self._mux_pump()

    def _purge_pending_of_client(self, cid: str) -> int:
        canceled = []
        with self.lock:
            keep = deque()
            for pl in self.pending_leases:
                if pl.client_id == cid:
                    canceled.append(pl)
                else:
                    keep.append(pl)
            self.pending_leases = keep
        for pl in canceled:
            try:
                pl.deferred.resolve({"ok": False, "canceled": True})
            except Exception:
                pass
        return len(canceled)

    def h_cancel_lease_requests(self, conn, p):
        return self._purge_pending_of_client(p.get("client_id"))

    def h_task_blocked(self, conn, p):
        """A worker blocked in get() lends its CPUs (CPU only — never a
        physical device its process still holds) to the GENERAL pool, and
        a bundle-backed worker also releases its PG slot for nested
        same-bundle leases.  Crediting only the bundle deadlocks the
        canonical Train shape: PG-bound train workers block on a
        streaming-data coordinator whose read tasks need general-pool
        CPUs (reference: blocked workers release CPUs for any work).  A
        bundle worker's slot is thus transiently usable from BOTH pools —
        bounded oversubscription, same as the unblock path's."""
        wid = p.get("worker_id")
        with self.lock:
            rec = self.workers.get(wid)
            if rec is not None and rec.state in ("leased", "actor") \
                    and not rec.blocked:
                rec.blocked = True
                base = rec.lease_resources or rec.bundle_demand
                rec.lent = {k: v for k, v in base.items() if k == common.CPU}
                if rec.bundle_key is not None and rec.lease_resources:
                    b = self.bundles.get(rec.bundle_key)
                    if b is not None:
                        # release only the CPU slot — the process still
                        # owns any device the lease carried
                        subtract(b.setdefault("used", {}), rec.lent)
                add(self.available, rec.lent)
        self._try_grant()
        return True

    def h_task_unblocked(self, conn, p):
        wid = p.get("worker_id")
        with self.lock:
            rec = self.workers.get(wid)
            if rec is not None and rec.blocked:
                rec.blocked = False
                if rec.bundle_key is not None and rec.lease_resources:
                    b = self.bundles.get(rec.bundle_key)
                    if b is not None:
                        add(b.setdefault("used", {}), rec.lent)
                # may go negative transiently: oversubscription by design
                subtract(self.available, rec.lent)
                rec.lent = {}
        return True

    # -- actors ------------------------------------------------------------

    def h_start_actor_worker(self, conn, p, d: Deferred):
        demand = normalize_resources(p.get("resources"))
        with self.lock:
            bundle_key = (p.get("pg_id"), p.get("bundle_index", -1))
            if p.get("pg_id") and bundle_key[1] == -1:
                # "any bundle of this group": resolve to a committed one —
                # otherwise the actor wrongly competes for general-pool
                # CPUs its own PG already reserved (admission inside a
                # bundle is not re-gated: the PG reserved the capacity and
                # the control plane assigns actors to bundles)
                for k, b in self.bundles.items():
                    if k[0] == p["pg_id"] and b.get("state") == "committed":
                        bundle_key = k
                        break
            from_bundle = p.get("pg_id") and self.bundles.get(
                bundle_key, {}).get("state") == "committed"
            if not from_bundle:
                if not fits(self.available, demand):
                    d.resolve({"ok": False, "error": "insufficient resources"})
                    return
                subtract(self.available, demand)
        # prefer a prestarted idle worker: assign_actor turns it into the
        # actor's dedicated process with zero spawn latency (reference:
        # WorkerPool::PopWorker worker_pool.h:366).  GPU actors need a
        # device-visible process — the warm pool is CPU-only, so they spawn.
        wants_gpu = any(k.startswith(common.GPU) for k in demand)
        container = p.get("container")
        w = None
        with self.lock:
            # containerized actors never reuse the warm pool: those
            # processes run on the host, not in the requested image
            while not wants_gpu and not container and self.idle:
                cand = self.idle.popleft()
                if cand.state == "idle" and cand.conn is not None:
                    w = cand
                    break
            if w is not None:
                w.state = "actor"
                w.actor_id = p["actor_id"]
                w.incarnation = p.get("incarnation", 0)
                w.lease_resources = demand if not from_bundle else {}
                w.bundle_demand = demand if from_bundle else {}
                if from_bundle:
                    w.bundle_key = bundle_key
        if w is not None:
            ok = w.conn.push("assign_actor", {
                "actor_id": p["actor_id"],
                "incarnation": p.get("incarnation", 0)})
            if ok:
                d.resolve({"ok": True, "worker_addr": w.addr,
                           "worker_id": w.worker_id})
                return
            with self.lock:  # conn raced shut: fall through to fresh spawn
                w.state = "dead"
                if not from_bundle:
                    add(self.available, w.lease_resources)
                w.lease_resources = {}
                w.bundle_demand = {}
                w.bundle_key = None
        env = {}
        if p.get("incarnation") is not None:
            env["RAY_TPU_TORCH_ACTOR_INCARNATION"] = str(p["incarnation"])
        try:
            rec = self._spawn_worker(actor_id=p["actor_id"], env_extra=env,
                                     gpu=wants_gpu, container=container)
        except Exception as e:
            # release the admission and surface the reason instead of a
            # silent spawn.  Only CONTAINER failures are permanent
            # (missing runtime / unsupported combination — retrying on
            # this node can't help); a transient host error on a plain
            # spawn (ENOMEM, disk blip) keeps the pre-container retry
            # semantics
            with self.lock:
                if not from_bundle:
                    add(self.available, demand)
            d.resolve({"ok": False, "permanent": bool(container),
                       "error": f"worker spawn failed: {e}"})
            return
        rec.lease_resources = demand if not from_bundle else {}
        rec.bundle_demand = demand if from_bundle else {}
        rec.incarnation = p.get("incarnation", 0)
        if from_bundle:
            rec.bundle_key = bundle_key

        def waiter():
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not self._stop.is_set():
                with self.lock:
                    if rec.addr is not None:
                        d.resolve({"ok": True, "worker_addr": rec.addr,
                                   "worker_id": rec.worker_id})
                        return
                    if rec.state == "dead" or rec.worker_id not in self.workers:
                        break
                time.sleep(0.02)
            with self.lock:
                if not from_bundle:
                    add(self.available, rec.lease_resources)
            reply = {"ok": False, "error": "actor worker failed to start"}
            rc = rec.proc.poll() if rec.proc is not None else None
            if container and rc not in (None, 0):
                # `podman run` exited before the worker registered: bad
                # image tag, failed pull, broken entrypoint — respawning
                # outside the actor's restart budget can't fix it (the
                # budget still applies via the control's failure path)
                reply["permanent"] = True
                reply["error"] = (f"container worker exited with code {rc} "
                                  f"before registering (image "
                                  f"{container.get('image')!r})")
            d.resolve(reply)

        threading.Thread(target=waiter, daemon=True).start()

    def h_kill_actor_worker(self, conn, p):
        aid = p["actor_id"]
        want_addr = tuple(p["worker_addr"]) if p.get("worker_addr") else None
        with self.lock:
            rec = next((r for r in self.workers.values()
                        if r.actor_id == aid
                        and (want_addr is None or r.addr == want_addr)), None)
        logger.info("kill_actor_worker %s -> rec=%s lease=%s", aid[:12],
                    rec.worker_id[:12] if rec else None,
                    rec.lease_resources if rec else None)
        if rec is None:
            return False

        def do_kill():
            # ask politely first so the worker can run atexit handlers
            if rec.conn is not None:
                rec.conn.push("shutdown", {})
            time.sleep(0.05)
            self._kill_worker(rec)
            with self.lock:
                if rec.lease_resources or rec.bundle_demand or rec.lent:
                    self._free_lease_resources(rec)

        threading.Thread(target=do_kill, daemon=True).start()
        return True

    # -- placement group bundles (2-phase commit) -------------------------

    def h_prepare_bundle(self, conn, p):
        key = (p["pg_id"], p["bundle_index"])
        demand = normalize_resources(p["resources"])
        with self.lock:
            if key in self.bundles:
                return {"ok": True}
            if not fits(self.available, demand):
                return {"ok": False, "error": "insufficient resources"}
            subtract(self.available, demand)
            self.bundles[key] = {"resources": demand, "state": "prepared",
                                 "ts": time.monotonic()}
        return {"ok": True}

    def h_commit_bundle(self, conn, p):
        key = (p["pg_id"], p["bundle_index"])
        with self.lock:
            b = self.bundles.get(key)
            if b is None:
                return {"ok": False}
            b["state"] = "committed"
        return {"ok": True}

    def h_release_bundle(self, conn, p):
        key = (p["pg_id"], p["bundle_index"])
        with self.lock:
            b = self.bundles.pop(key, None)
            if b is not None:
                add(self.available, b["resources"])
        return {"ok": True}

    # -- object plane ------------------------------------------------------

    def h_fetch_object(self, conn, p):
        """Serve raw object bytes to a remote raylet (chunking: the frame
        layer handles large payloads; reference streams 1MiB chunks,
        object_manager.proto:61)."""
        data = self.store.read_bytes(p["object_id"])
        if data is None and self.spill is not None:
            data = self.spill.read_spilled(p["object_id"])
        return data

    def h_pull_object(self, conn, p, d: Deferred):
        oid, from_addr = p["object_id"], tuple(p["from_addr"])

        def do():
            if self.store.contains(oid):
                d.resolve(True)
                return
            if self.spill is not None and self.spill.restore(oid):
                d.resolve(True)
                return
            try:
                cli = self._peer(from_addr)
                data = cli.call("fetch_object", {"object_id": oid}, timeout=120.0)
                if data is None:
                    d.resolve(False)
                    return
                self.store.write_bytes(oid, data)
                d.resolve(True)
            except Exception as e:
                d.reject(f"pull {oid} from {from_addr} failed: {e}")

        threading.Thread(target=do, daemon=True).start()

    def _peer(self, addr: Tuple[str, int]) -> Client:
        with self.lock:
            cli = self.peer_clients.get(addr)
            if cli is not None and not cli.closed:
                return cli
        cli = Client(addr, name="raylet-peer")
        with self.lock:
            self.peer_clients[addr] = cli
        return cli

    def h_delete_objects(self, conn, p):
        n = 0
        for oid in p["object_ids"]:
            dropped = self.store.delete(oid)
            if self.spill is not None:
                dropped = self.spill.delete(oid) or dropped
            if dropped:
                n += 1
        return n

    def h_store_stats(self, conn, p):
        objs = self.store.list_objects()
        out = {"num_objects": len(objs),
               "bytes": sum(self.store.size(o) or 0 for o in objs)}
        if self.spill is not None:
            out["spill"] = self.spill.stats()
        if self.oom_killer is not None:
            out["oom_killed"] = self.oom_killer.n_killed
        if p and p.get("detail"):
            out["objects"] = [{"object_id": o,
                               "size_bytes": self.store.size(o) or 0}
                              for o in objs]
        return out

    def h_pending_demands(self, conn, p):
        """Queued lease demands — autoscaler scale-up signal (reference:
        raylet resource_load in ray_syncer feeding load_metrics)."""
        with self.lock:
            return [common.denormalize_resources(pl.demand)
                    for pl in self.pending_leases]

    def h_list_workers(self, conn, p):
        """State-API source (reference: WorkerInfoGcsService + raylet state)."""
        with self.lock:
            return [{
                "worker_id": r.worker_id,
                "pid": r.proc.pid if r.proc else None,
                "state": r.state,
                "actor_id": r.actor_id,
                "node_id": self.node_id,
                "gpu": r.gpu,
                "addr": r.addr,  # core server: get_object + profiling RPCs
                "blocked": r.blocked,
                "lease_client_id": r.lease_client_id,
                "lease_resources": dict(r.lease_resources),
            } for r in self.workers.values()]

    def h_list_logs(self, conn, p):
        """Names + sizes of this node's log files (reference: dashboard
        modules/log + `ray logs` CLI listing)."""
        log_dir = os.path.join(self.session_dir, "logs")
        out = []
        try:
            for name in sorted(os.listdir(log_dir)):
                path = os.path.join(log_dir, name)
                if os.path.isfile(path):
                    out.append({"name": name,
                                "size_bytes": os.path.getsize(path)})
        except OSError:
            pass
        return {"node_id": self.node_id, "logs": out}

    def h_read_log(self, conn, p):
        """Tail of one log file by name (no path components allowed)."""
        name = p.get("name", "")
        if not name or "/" in name or name.startswith("."):
            return None
        path = os.path.join(self.session_dir, "logs", name)
        tail = int(p.get("tail_bytes", 64 * 1024))
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail))
                return f.read().decode(errors="replace")
        except OSError:
            return None

    def h_list_leases(self, conn, p):
        """Debug introspection: every worker record's state + lease
        bookkeeping (who holds each CPU) — the first question when a
        node shows avail=0 with nothing visibly running."""
        with self.lock:
            return [{
                "worker_id": r.worker_id,
                "state": r.state,
                "actor_id": r.actor_id,
                "lease_resources": dict(r.lease_resources or {}),
                "lease_client_id": r.lease_client_id,
                "blocked": r.blocked,
                "lent": dict(r.lent or {}),
                "bundle_key": r.bundle_key,
            } for r in self.workers.values()]

    def h_node_info(self, conn, p):
        with self.lock:
            return {
                "node_id": self.node_id,
                "store_root": self.store.root,
                "control_addr": self.control_addr,
                "total": common.denormalize_resources(self.total),
                "available": common.denormalize_resources(self.available),
                "labels": self.labels,
                "num_workers": len(self.workers),
                "idle": len(self.idle),
                "pending_leases": len(self.pending_leases),
                "pid": os.getpid(),
                "bundles": [{"pg_id": k[0], "index": k[1],
                             "state": b["state"]}
                            for k, b in self.bundles.items()],
                "task_event_relay": self.task_event_relay_stats(),
                "submit_mux": {"on": self.mux_on,
                               "queued": len(self.mux_queue),
                               "workers": len(self.mux_workers),
                               **self.mux_stats},
            }

    # -- task-event relay --------------------------------------------------

    def task_event_relay_stats(self) -> Dict[str, Any]:
        with self._ev_relay_lock:
            return {**self._ev_relay_stats,
                    "buffered_events": self._ev_relay_buffered}

    def h_report_task_events(self, conn, p):
        """Workers flush task-event batches here (one-way notify on the
        socket they already hold) instead of each opening a control
        write; the relay loop forwards them coalesced."""
        nev = len(p.get("events", ()))
        with self._ev_relay_lock:
            self._ev_relay.append(p)
            self._ev_relay_buffered += nev
            rs = self._ev_relay_stats
            rs["batches_in"] += 1
            rs["events_in"] += nev
            while self._ev_relay_buffered > self._ev_relay_cap \
                    and len(self._ev_relay) > 1:
                old = self._ev_relay.popleft()
                n_old = len(old.get("events", ()))
                dropped = n_old + old.get("dropped", 0)
                self._ev_relay_buffered -= n_old
                self._ev_relay_pending_dropped += dropped
                rs["dropped"] += dropped
        return True

    def _task_event_relay_loop(self):
        from .task_events import FLUSH_INTERVAL_S

        while not self._stop.wait(FLUSH_INTERVAL_S):
            self._flush_task_event_relay()
        self._flush_task_event_relay()  # final drain on shutdown

    def _flush_task_event_relay(self):
        with self._ev_relay_lock:
            if not self._ev_relay and not self._ev_relay_pending_dropped:
                return
            batches = list(self._ev_relay)
            self._ev_relay.clear()
            self._ev_relay_buffered = 0
            dropped = self._ev_relay_pending_dropped
            self._ev_relay_pending_dropped = 0
        cli = self.control
        try:
            if cli is None or cli.closed:
                raise ConnectionLost("no control connection")
            # ONE framed write for the whole node-flush window
            cli.notify("report_task_events", {
                "batches": batches, "dropped": dropped,
                "node_id": self.node_id,
            })
            with self._ev_relay_lock:
                self._ev_relay_stats["sends"] += 1
                self._ev_relay_stats["coalesced"] += len(batches)
        except Exception:
            # control unreachable: requeue (bounded by the cap on the
            # next ingest) so a reconnect delivers rather than drops
            with self._ev_relay_lock:
                self._ev_relay.extendleft(reversed(batches))
                self._ev_relay_buffered += sum(
                    len(b.get("events", ())) for b in batches)
                self._ev_relay_pending_dropped += dropped

    # -- memory pressure ---------------------------------------------------

    def _memory_loop(self):
        """Spill under store pressure; kill workers under system memory
        pressure (reference: local_object_manager spilling loop +
        memory_monitor worker killing)."""
        spill_interval = 0.2
        next_mem = 0.0
        while not self._stop.is_set():
            try:
                if self.spill is not None and self.spill.over_high_water():
                    n = self.spill.maybe_spill()
                    if n:
                        logger.info("spilled %d objects to disk (%s)", n,
                                    self.spill.stats())
                now = time.monotonic()
                if self.oom_killer is not None and now >= next_mem:
                    self.oom_killer.step()
                    next_mem = now + self._mem_refresh_s
            except Exception:
                logger.exception("memory loop iteration failed")
            self._stop.wait(spill_interval)

    # -- heartbeats --------------------------------------------------------

    def _heartbeat_loop(self):
        """Liveness + resource sync (reference: ray_syncer.h:44-70 — a
        versioned RESOURCE_VIEW where only snapshots newer than the
        peer's last-seen version travel).  Heartbeats always carry
        liveness; the availability dict rides along ONLY when it changed
        since the last ACKED send, under a monotonically increasing
        version the control uses to drop stale/reordered updates.  At
        the reference's 2k-node envelope this is the difference between
        the control plane deserializing 2k resource dicts per beat and
        deserializing only what actually changed."""
        from .config import cfg as _hcfg
        from .control import HEARTBEAT_INTERVAL_S

        delta_sync = _hcfg().resource_sync_delta
        last_acked: Optional[Dict[str, float]] = None
        version = 0
        reg_seen = self._registered_at
        while not self._stop.is_set():
            try:
                if self._registered_at != reg_seen:
                    # re-registered (control restart / resurrect): the
                    # fresh NodeRecord assumed available == total, so
                    # force a full resync on the next beat
                    reg_seen = self._registered_at
                    last_acked = None
                with self.lock:
                    avail = common.denormalize_resources(
                        {k: max(v, 0) for k, v in self.available.items()})
                payload = {"node_id": self.node_id}
                send_avail = (not delta_sync) or avail != last_acked
                if send_avail:
                    version += 1
                    payload["available"] = avail
                    payload["avail_version"] = version
                sent = time.monotonic()
                r = self.control.call("heartbeat", payload, timeout=5.0)
                if r and r.get("ok") and send_avail:
                    last_acked = avail
                if r and r.get("resync"):
                    # the control's view diverged (optimistic pick_node
                    # reservation): resend ground truth next beat even
                    # if our own view hasn't changed
                    last_acked = None
                if r and not r.get("ok") and r.get("reregister"):
                    # not in the control's node table (restart/failover
                    # we haven't re-registered for, OR a false
                    # declared-dead while the control kept running).
                    # _rehome handles both: the control adopts live
                    # actors it restored, and rejects ones it already
                    # rescheduled elsewhere (those workers are reaped —
                    # the old clean-slate resurrect semantics).  The
                    # staleness guard skips if a racing reconnect-path
                    # rehome registered after this beat was sent.
                    last_acked = None   # new control: resend full view
                    self._rehome(if_stale_since=sent)
            except Exception:
                if not self._stop.is_set():
                    logger.warning("heartbeat to control failed")
            time.sleep(HEARTBEAT_INTERVAL_S)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--control", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--resources", default=None, help="JSON resource dict")
    ap.add_argument("--node-id", default=None)
    ap.add_argument("--session-dir", default=None)
    ap.add_argument("--addr-file", default=None,
                    help="control-plane rendezvous file; re-read on "
                         "reconnect so the raylet re-homes to a promoted "
                         "standby controller")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s raylet %(levelname)s %(message)s")
    host, port = args.control.rsplit(":", 1)
    import json

    resources = json.loads(args.resources) if args.resources else None
    labels = None
    if os.environ.get("RAY_TPU_TORCH_NODE_LABELS"):
        labels = json.loads(os.environ["RAY_TPU_TORCH_NODE_LABELS"])
    # on Kubernetes the provider injects the pod name via the downward
    # API so control-plane node ids match pod names (idle scale-down
    # resolves idleness per control node id)
    node_id = args.node_id or os.environ.get("RAY_TPU_TORCH_NODE_ID")
    r = Raylet((host, int(port)), host=args.host, port=args.port,
               resources=resources, session_dir=args.session_dir,
               node_id=node_id, labels=labels,
               control_addr_file=args.addr_file)

    # SIGTERM (bootstrap remove_node / scale-down) exits gracefully so the
    # control gets an immediate unregister_node instead of waiting out the
    # heartbeat-timeout death window
    import signal

    def _term(_sig, _frm):
        try:
            r.shutdown()
        finally:
            os._exit(0)

    try:
        signal.signal(signal.SIGTERM, _term)
    except (OSError, ValueError):
        pass
    r.start(block=True)


if __name__ == "__main__":
    main()
