"""Virtual-node swarm: hundreds of in-process raylets against one REAL
control daemon.

The control-plane flight recorder needs load to record: this module
spins up N ``VirtualNode``s — each a real ``protocol.Server`` granting
leases from a fake CPU pool plus a real ``protocol.Client`` that
registers, heartbeats (versioned delta sync) and subscribes to a swarm
pubsub topic — and drives the three control-plane hot paths the bench
reports on:

* heartbeat round-trip latency (client-observed, via ``call_cb``),
* pick_node -> request_lease -> return_lease grant cycles,
* pubsub publish -> deliver fan-out (wire-stamped, aggregated by
  ``rpc_stats.record_pubsub_delivery`` in the subscribing clients).

Everything runs in one process except the control daemon itself
(``bootstrap.Cluster.start_control`` subprocess), so the numbers isolate
the control plane: no workers, no object store, no scheduler churn.
Used by ``bench.py --control-only`` (BENCH_CONTROL.json) and the tier-1
swarm smoke test at N=50.

The port's copy of ``ray_tpu/_private/swarm.py``, against the port's
control daemon.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from . import rpc_stats
from .protocol import Client, Server

logger = logging.getLogger(__name__)

SWARM_TOPIC = "swarm"


class VirtualNode:
    """An in-process stand-in for a raylet: real RPC server + control
    client, fake everything else.  Lease grants draw from a plain CPU
    counter; exhaustion replies ``ok=False`` instead of queueing (the
    swarm driver returns leases fast enough that control-side optimistic
    reservation keeps picks and capacity in step)."""

    def __init__(self, index: int, control_addr: Tuple[str, int],
                 cpus: float = 8.0):
        self.node_id = f"vnode-{index:04d}"
        self._lock = threading.Lock()
        self._cpus = float(cpus)
        self._avail = float(cpus)
        self._version = 1          # bumped on every grant/return
        self._sent_version = 0     # last version shipped in a heartbeat
        self._next_lease = 0
        self._leases: Dict[str, float] = {}
        self.hb_errors = 0

        s = Server(name=f"swarm-{self.node_id}")
        s.handle("ping", lambda c, p: {"ok": True})
        s.handle("request_lease", self.h_request_lease)
        s.handle("request_leases", self.h_request_leases)
        s.handle("return_lease", self.h_return_lease)
        s.start()
        self.server = s
        self.control = Client(control_addr, name=self.node_id)

    # -- raylet-side handlers ----------------------------------------------

    def _grant_locked(self, need: float) -> Optional[str]:
        if need > self._avail:
            return None
        self._avail -= need
        self._version += 1
        lease_id = f"{self.node_id}-l{self._next_lease}"
        self._next_lease += 1
        self._leases[lease_id] = need
        return lease_id

    def h_request_lease(self, conn, p):
        need = float((p.get("resources") or {}).get("CPU", 1))
        with self._lock:
            lid = self._grant_locked(need)
        if lid is None:
            return {"ok": False, "reason": "exhausted"}
        return {"ok": True, "lease_id": lid, "node_id": self.node_id}

    def h_request_leases(self, conn, p):
        need = float((p.get("resources") or {}).get("CPU", 1))
        count = max(1, int(p.get("count", 1)))
        grants = []
        with self._lock:
            for _ in range(count):
                lid = self._grant_locked(need)
                if lid is None:
                    break
                grants.append({"lease_id": lid, "node_id": self.node_id})
        if not grants:
            return {"ok": False, "reason": "exhausted"}
        return {"ok": True, "grants": grants}

    def h_return_lease(self, conn, p):
        with self._lock:
            need = self._leases.pop(p.get("lease_id"), None)
            if need is not None:
                self._avail += need
                self._version += 1
        return {"ok": True}

    # -- control-side traffic ----------------------------------------------

    def register(self) -> None:
        self.control.call("register_node", {
            "node_id": self.node_id, "addr": self.server.addr,
            "resources": {"CPU": self._cpus},
            "labels": {"swarm": "1"}}, timeout=30.0)
        self.control.call("subscribe", {"topics": [SWARM_TOPIC]},
                          timeout=30.0)

    def heartbeat(self, hist: rpc_stats.LatencyHist,
                  hist_lock: threading.Lock) -> None:
        """One non-blocking heartbeat; the reply callback records the
        round trip.  Availability rides along only when it changed since
        the last send (the versioned delta protocol, ray_syncer-style)."""
        payload: Dict[str, Any] = {"node_id": self.node_id}
        with self._lock:
            if self._version != self._sent_version:
                payload["available"] = {"CPU": self._avail}
                payload["avail_version"] = self._version
                self._sent_version = self._version
        t0 = time.perf_counter()

        def cb(reply, exc):
            if exc is not None:
                self.hb_errors += 1
                return
            if isinstance(reply, dict) and reply.get("resync"):
                # control's optimistic pick_node reservations drifted its
                # view; force ground truth onto the next beat even though
                # our local version didn't change (delta-sync resync)
                with self._lock:
                    self._sent_version = 0
            dt = time.perf_counter() - t0
            with hist_lock:
                hist.observe(dt)

        try:
            self.control.call_cb("heartbeat", payload, cb)
        except Exception:
            self.hb_errors += 1

    def close(self) -> None:
        try:
            self.control.close()
        finally:
            self.server.stop()


class Swarm:
    """N virtual nodes + the driver loops that exercise the control."""

    def __init__(self, control_addr: Tuple[str, int], n_nodes: int,
                 cpus_per_node: float = 8.0,
                 hb_interval_s: float = 0.5):
        self.control_addr = tuple(control_addr)
        self.n_nodes = n_nodes
        self.cpus_per_node = cpus_per_node
        self.hb_interval_s = hb_interval_s
        self.nodes: List[VirtualNode] = []
        self._stop = threading.Event()
        self._hb_lock = threading.Lock()
        self._hb_hist = rpc_stats.LatencyHist()
        self._pacer: Optional[threading.Thread] = None

    def start(self) -> None:
        self.nodes = [VirtualNode(i, self.control_addr,
                                  cpus=self.cpus_per_node)
                      for i in range(self.n_nodes)]
        # parallel registration: 500 serial connect+register round trips
        # would dominate small-duration runs
        with ThreadPoolExecutor(max_workers=16) as ex:
            list(ex.map(lambda vn: vn.register(), self.nodes))
        self._pacer = threading.Thread(target=self._pace_loop,
                                       name="swarm-heartbeat", daemon=True)
        self._pacer.start()

    def _pace_loop(self) -> None:
        # one pacer thread for the whole swarm: sends are non-blocking
        # (call_cb enqueues), replies land on each client's reader thread
        while not self._stop.is_set():
            t_next = time.perf_counter() + self.hb_interval_s
            for vn in self.nodes:
                if self._stop.is_set():
                    return
                vn.heartbeat(self._hb_hist, self._hb_lock)
            delay = t_next - time.perf_counter()
            if delay > 0:
                self._stop.wait(delay)

    def heartbeat_snapshot(self) -> Dict[str, Any]:
        with self._hb_lock:
            snap = self._hb_hist.snapshot()
        snap["errors"] = sum(vn.hb_errors for vn in self.nodes)
        return snap

    def run_leases(self, duration_s: float, threads: int = 4) -> Dict[str, Any]:
        """Full pick_node -> request_lease -> return_lease cycles from
        `threads` concurrent drivers for `duration_s`; returns the grant
        rate the control plane + virtual raylets sustained."""
        stop = threading.Event()
        grants = [0] * threads
        misses = [0] * threads

        def driver(t: int):
            probe = Client(self.control_addr, name=f"swarm-lease-{t}")
            conns: Dict[Tuple[str, int], Client] = {}
            try:
                while not stop.is_set():
                    pick = probe.call("pick_node",
                                      {"resources": {"CPU": 1}},
                                      timeout=10.0)
                    if pick is None:
                        misses[t] += 1
                        time.sleep(0.005)
                        continue
                    addr = tuple(pick["addr"])
                    cli = conns.get(addr)
                    if cli is None:
                        cli = conns[addr] = Client(
                            addr, name=f"swarm-lease-{t}-vn")
                    r = cli.call("request_lease",
                                 {"resources": {"CPU": 1}}, timeout=10.0)
                    if r and r.get("ok"):
                        grants[t] += 1
                        cli.call("return_lease",
                                 {"lease_id": r["lease_id"]}, timeout=10.0)
                    else:
                        misses[t] += 1
            finally:
                probe.close()
                for c in conns.values():
                    c.close()

        ts = [threading.Thread(target=driver, args=(t,), daemon=True)
              for t in range(threads)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        time.sleep(duration_s)
        stop.set()
        for t in ts:
            t.join(timeout=10.0)
        wall = time.perf_counter() - t0
        total = sum(grants)
        return {"grants": total, "misses": sum(misses),
                "grants_per_s": round(total / wall, 1),
                "threads": threads}

    def run_pubsub(self, n_msgs: int = 20,
                   interval_s: float = 0.02) -> Dict[str, Any]:
        """Publish n_msgs to the swarm topic and wait for the full
        fan-out (n_msgs x n_nodes deliveries), then report the
        publish->deliver latency the subscribing clients recorded."""
        rpc_stats.pubsub_delivery_snapshot(reset=True)
        probe = Client(self.control_addr, name="swarm-pub")
        try:
            for i in range(n_msgs):
                probe.call("publish", {
                    "topic": SWARM_TOPIC,
                    "payload": {"seq": i, "pad": "x" * 128}}, timeout=10.0)
                time.sleep(interval_s)
            expected = n_msgs * self.n_nodes
            deadline = time.monotonic() + 30.0
            snap = {}
            while time.monotonic() < deadline:
                snap = rpc_stats.pubsub_delivery_snapshot().get(
                    SWARM_TOPIC, {})
                if snap.get("count", 0) >= expected:
                    break
                time.sleep(0.05)
            snap = dict(snap)
            snap["expected"] = expected
            return snap
        finally:
            probe.close()

    def control_stats(self) -> Dict[str, Any]:
        probe = Client(self.control_addr, name="swarm-stats")
        try:
            return probe.call("control_stats", {}, timeout=30.0)
        finally:
            probe.close()

    def close(self) -> None:
        self._stop.set()
        if self._pacer is not None:
            self._pacer.join(timeout=5.0)
        with ThreadPoolExecutor(max_workers=16) as ex:
            list(ex.map(lambda vn: vn.close(), self.nodes))
        self.nodes = []


def run_swarm_bench(n_nodes: int, *, hb_interval_s: float = 0.5,
                    settle_s: float = 1.0, lease_secs: float = 4.0,
                    lease_threads: int = 4, pub_msgs: int = 20,
                    control_addr: Optional[Tuple[str, int]] = None
                    ) -> Dict[str, Any]:
    """One bench row: start a fresh control daemon (unless given one),
    run a swarm of `n_nodes` against it, return the flight-recorder
    numbers.  Fresh daemon per N so dead prior-N nodes don't charge
    death-detection work to the next N."""
    cluster = None
    if control_addr is None:
        from .bootstrap import Cluster

        cluster = Cluster()
        control_addr = cluster.start_control()
    swarm = Swarm(control_addr, n_nodes, hb_interval_s=hb_interval_s)
    try:
        swarm.start()
        time.sleep(settle_s)
        leases = swarm.run_leases(lease_secs, threads=lease_threads)
        pubsub = swarm.run_pubsub(n_msgs=pub_msgs)
        hb = swarm.heartbeat_snapshot()
        cs = swarm.control_stats()
        handlers = cs.get("handlers") or {}
        loop = cs.get("loop") or {}
        lag = loop.get("lag_ms") or {}
        row = {
            "n_nodes": n_nodes,
            "hb_interval_s": hb_interval_s,
            "heartbeat_ms_p50": hb.get("p50_ms", 0.0),
            "heartbeat_ms_p99": hb.get("p99_ms", 0.0),
            "heartbeat_count": hb.get("count", 0),
            "heartbeat_errors": hb.get("errors", 0),
            "lease_grants_per_s": leases["grants_per_s"],
            "lease_grants": leases["grants"],
            "lease_misses": leases["misses"],
            "pubsub_fanout_ms_p50": pubsub.get("p50_ms", 0.0),
            "pubsub_fanout_ms_p99": pubsub.get("p99_ms", 0.0),
            "pubsub_delivered": pubsub.get("count", 0),
            "pubsub_expected": pubsub.get("expected", 0),
            "control_loop_lag_ms_p99": lag.get("p99_ms", 0.0),
            "handler_p99_ms": {
                m: (handlers[m].get("handle_ms") or {}).get("p99_ms", 0.0)
                for m in ("heartbeat", "pick_node", "publish",
                          "register_node")
                if m in handlers},
        }
        return row
    finally:
        swarm.close()
        if cluster is not None:
            cluster.shutdown()
