"""Cluster state observability API.

Analog of `ray.util.state` (reference: python/ray/util/state/api.py): typed
`list_*` / `get_*` / `summarize_*` queries over live cluster state.  Sources
of truth mirror the reference's: the control plane (GCS equivalent — nodes,
actors, placement groups, jobs, task events from the GcsTaskManager analog)
plus per-node raylets (workers, object-store stats), aggregated client-side
the way the reference's StateDataSourceClient/state_aggregator does
(reference: python/ray/util/state/state_manager.py,
python/ray/dashboard/state_aggregator.py).

All functions accept an optional ``address`` ("host:port" of the control
plane) so they work from an unconnected process (the CLI); inside a driver
they default to the current connection.

The port's copy of ``ray_tpu/util/state/api.py``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "list_nodes", "list_actors", "list_placement_groups", "list_jobs",
    "list_tasks", "list_objects", "list_workers",
    "get_node", "get_actor", "get_task", "get_placement_group",
    "summarize_tasks", "summarize_actors", "summarize_objects",
    "cluster_resources", "available_resources", "timeline", "StateApiClient",
    "control_stats", "device_stats",
]


def _parse_addr(address: str) -> Tuple[str, int]:
    host, port = address.rsplit(":", 1)
    return host, int(port)


class StateApiClient:
    """Owns the control-plane connection used by the free functions.

    With no address, piggybacks on the current driver's connection; with an
    address, opens a short-lived client (closed via ``close()``).
    """

    def __init__(self, address: Optional[str] = None):
        self._own = None
        if address is None:
            from ..._private.api import current_core

            core = current_core()
            if core is None:
                raise RuntimeError(
                    "not connected: call ray_tpu_torch.init() or pass "
                    "address=")
            self._control = core.control
        else:
            from ..._private.protocol import Client

            self._own = Client(_parse_addr(address), name="state-api")
            self._control = self._own

    def close(self):
        if self._own is not None:
            self._own.close()

    # -- raw sources -------------------------------------------------------

    def state_dump(self) -> Dict[str, Any]:
        return self._control.call("state_dump", {}, timeout=10.0)

    def task_events(self, filters=None, limit=10000) -> Dict[str, Any]:
        return self._control.call(
            "list_task_events", {"filters": filters, "limit": limit},
            timeout=10.0)

    def profile_events(self, limit=50000) -> List[Dict[str, Any]]:
        return self._control.call("list_profile_events", {"limit": limit},
                                  timeout=10.0)

    def control_stats(self) -> Dict[str, Any]:
        """Control-plane flight-recorder snapshot: per-handler RPC stats,
        loop lag, KV namespace counters, pubsub fan-out, event-queue
        depth (``python -m ray_tpu_torch control-stats`` renders this)."""
        return self._control.call("control_stats", {}, timeout=10.0)

    def device_stats(self) -> Dict[str, Any]:
        """Cluster-wide device runtime observability: merged program
        ledgers (signature counts, cause diffs, storm advisories,
        ``kernels.build`` events) + device-memory censuses (the
        ``python -m ray_tpu_torch device-stats`` CLI and ``GET
        /api/device/stats`` render this)."""
        from ray_tpu_torch.telemetry.device import collect_device_stats

        return collect_device_stats(self._control)

    def per_node(self, method: str, payload=None) -> Dict[str, Any]:
        """Fan a query out to every alive raylet (node_id -> reply)."""
        from ..._private.protocol import Client

        out = {}
        for n in self._control.call("get_nodes", {}, timeout=10.0):
            if n["state"] != "ALIVE":
                continue
            try:
                c = Client(tuple(n["addr"]), name="state-api-node")
                try:
                    out[n["node_id"]] = c.call(method, payload or {},
                                               timeout=10.0)
                finally:
                    c.close()
            except Exception as e:
                out[n["node_id"]] = {"error": str(e)}
        return out


def _client(address: Optional[str]) -> StateApiClient:
    return StateApiClient(address)


def _run(address, fn):
    c = _client(address)
    try:
        return fn(c)
    finally:
        c.close()


# -- list_* -----------------------------------------------------------------

def list_nodes(address: Optional[str] = None, *, filters=None,
               limit: int = 1000) -> List[Dict[str, Any]]:
    def go(c):
        nodes = c.state_dump()["nodes"]
        return _filter(nodes, filters)[:limit]
    return _run(address, go)


def list_actors(address: Optional[str] = None, *, filters=None,
                limit: int = 1000) -> List[Dict[str, Any]]:
    def go(c):
        return _filter(c.state_dump()["actors"], filters)[:limit]
    return _run(address, go)


def list_placement_groups(address: Optional[str] = None, *, filters=None,
                          limit: int = 1000) -> List[Dict[str, Any]]:
    def go(c):
        return _filter(c.state_dump()["pgs"], filters)[:limit]
    return _run(address, go)


def list_jobs(address: Optional[str] = None, *, filters=None,
              limit: int = 1000) -> List[Dict[str, Any]]:
    def go(c):
        jobs = [dict(v, job_id=k) for k, v in c.state_dump()["jobs"].items()]
        return _filter(jobs, filters)[:limit]
    return _run(address, go)


def list_cluster_events(address: Optional[str] = None, *,
                        severity: Optional[str] = None,
                        source: Optional[str] = None,
                        entity_id: Optional[str] = None,
                        after_seq: int = 0,
                        limit: int = 1000) -> List[Dict[str, Any]]:
    """Structured cluster events (reference: `ray list cluster-events`,
    src/ray/util/event.h): node/actor/PG/job lifecycle transitions with
    severity, distinct from free-text logs."""
    def go(c):
        return c._control.call("list_events", {
            "severity": severity, "source": source,
            "entity_id": entity_id, "after_seq": after_seq,
            "limit": limit}, timeout=10.0)
    return _run(address, go)


def list_tasks(address: Optional[str] = None, *, filters=None,
               limit: int = 1000) -> List[Dict[str, Any]]:
    def go(c):
        return c.task_events(filters=filters, limit=limit)["records"]
    return _run(address, go)


def list_workers(address: Optional[str] = None, *, filters=None,
                 limit: int = 10000) -> List[Dict[str, Any]]:
    def go(c):
        out = []
        for node_id, workers in c.per_node("list_workers").items():
            if isinstance(workers, list):
                out.extend(workers)
        return _filter(out, filters)[:limit]
    return _run(address, go)


def list_objects(address: Optional[str] = None, *, filters=None,
                 limit: int = 10000) -> List[Dict[str, Any]]:
    """Objects in per-node shared-memory stores (reference: `ray memory` /
    list_objects reads plasma store state via raylets)."""
    def go(c):
        out = []
        for node_id, stats in c.per_node("store_stats",
                                         {"detail": True}).items():
            for o in stats.get("objects", []):
                out.append(dict(o, node_id=node_id))
        return _filter(out, filters)[:limit]
    return _run(address, go)


def list_logs(address: Optional[str] = None, *, node_id: Optional[str] = None
              ) -> Dict[str, List[Dict[str, Any]]]:
    """node_id -> [{name, size_bytes}, ...] (reference: `ray logs` CLI
    listing via the dashboard log module)."""
    def go(c):
        out = {}
        for nid, reply in c.per_node("list_logs").items():
            if node_id is not None and nid != node_id:
                continue
            if isinstance(reply, dict):
                out[nid] = reply.get("logs", [])
        return out
    return _run(address, go)


def get_log(name: str, address: Optional[str] = None, *,
            node_id: Optional[str] = None,
            tail_bytes: int = 64 * 1024) -> Dict[str, Optional[str]]:
    """node_id -> tail of the named log file (None if absent there)."""
    def go(c):
        out = {}
        for nid, text in c.per_node(
                "read_log", {"name": name,
                             "tail_bytes": tail_bytes}).items():
            if node_id is not None and nid != node_id:
                continue
            out[nid] = text
        return out
    return _run(address, go)


def control_stats(address: Optional[str] = None,
                  *, per_node: bool = False) -> Dict[str, Any]:
    """Control-plane flight recorder snapshot; with ``per_node=True``
    also fans ``rpc_stats`` + ``loop_stats`` out to every alive raylet
    so one call covers every control-plane server in the cluster."""
    def go(c):
        out = {"control": c.control_stats()}
        if per_node:
            handlers = c.per_node("rpc_stats")
            loops = c.per_node("loop_stats")
            out["raylets"] = {
                nid: (reply if isinstance(reply, dict) and "error" in reply
                      else {"handlers": reply, "loop": loops.get(nid)})
                for nid, reply in handlers.items()}
        return out
    return _run(address, go)


def device_stats(address: Optional[str] = None) -> Dict[str, Any]:
    """Cluster-wide program-ledger + memory-census merge (see
    telemetry/device.py)."""
    return _run(address, lambda c: c.device_stats())


# -- get_* ------------------------------------------------------------------

def get_node(node_id: str, address: Optional[str] = None):
    return _first(list_nodes(address, filters={"node_id": node_id}))


def get_actor(actor_id: str, address: Optional[str] = None):
    return _first(list_actors(address, filters={"actor_id": actor_id}))


def get_task(task_id: str, address: Optional[str] = None):
    return _first(list_tasks(address, filters={"task_id": task_id}))


def get_placement_group(pg_id: str, address: Optional[str] = None):
    return _first(list_placement_groups(address, filters={"pg_id": pg_id}))


# -- summaries (reference: `ray summary tasks|actors|objects`) --------------

def summarize_tasks(address: Optional[str] = None) -> Dict[str, Any]:
    recs = list_tasks(address, limit=100000)
    by_func: Dict[str, Dict[str, int]] = {}
    for r in recs:
        d = by_func.setdefault(r.get("name", "?"), {})
        d[r.get("state", "?")] = d.get(r.get("state", "?"), 0) + 1
    return {"summary": by_func, "total": len(recs)}


def summarize_actors(address: Optional[str] = None) -> Dict[str, Any]:
    recs = list_actors(address, limit=100000)
    by_class: Dict[str, Dict[str, int]] = {}
    for r in recs:
        d = by_class.setdefault(r.get("class_name", "?"), {})
        d[r.get("state", "?")] = d.get(r.get("state", "?"), 0) + 1
    return {"summary": by_class, "total": len(recs)}


def summarize_objects(address: Optional[str] = None) -> Dict[str, Any]:
    def go(c):
        total_objs, total_bytes, per_node = 0, 0, {}
        for node_id, stats in c.per_node("store_stats").items():
            if "error" in stats:
                continue
            total_objs += stats.get("num_objects", 0)
            total_bytes += stats.get("bytes", 0)
            per_node[node_id] = stats
        return {"total_objects": total_objs, "total_bytes": total_bytes,
                "per_node": per_node}
    return _run(address, go)


def cluster_resources(address: Optional[str] = None) -> Dict[str, float]:
    def go(c):
        return c._control.call("cluster_resources", {}, timeout=10.0)["total"]
    return _run(address, go)


def available_resources(address: Optional[str] = None) -> Dict[str, float]:
    def go(c):
        return c._control.call("cluster_resources", {},
                               timeout=10.0)["available"]
    return _run(address, go)


# -- timeline (reference: `ray timeline` -> chrome://tracing) ---------------

def timeline(filename: Optional[str] = None,
             address: Optional[str] = None) -> Optional[str]:
    """Export task events as a Chrome trace (load in chrome://tracing or
    Perfetto).  Tasks become complete ('X') events on a (node, worker) row;
    profile spans nest beneath them."""
    def go(c):
        events = []
        recs = c.task_events(limit=100000)["records"]
        for r in recs:
            ts = r.get("state_ts", {})
            start = ts.get("RUNNING")
            end = ts.get("FINISHED") or ts.get("FAILED")
            if start is None:
                continue
            end = end if end is not None else time.time()
            events.append({
                "name": r.get("name", "?"),
                "cat": "task",
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(end - start, 1e-6) * 1e6,
                "pid": r.get("node_id", "?")[:12],
                "tid": r.get("worker_id", "?")[:12],
                "args": {k: v for k, v in r.items() if k != "state_ts"},
            })
        for p in c.profile_events(limit=100000):
            events.append({
                "name": p.get("event_name", "?"),
                "cat": "profile",
                "ph": "X",
                "ts": p["start_ts"] * 1e6,
                "dur": max(p["end_ts"] - p["start_ts"], 1e-6) * 1e6,
                "pid": p.get("node_id", "?")[:12],
                "tid": p.get("worker_id", "?")[:12],
            })
        return events
    events = _run(address, go)
    if filename is None:
        return json.dumps(events)
    with open(filename, "w") as f:
        json.dump(events, f)
    return None


# -- helpers ----------------------------------------------------------------

def _filter(rows: List[Dict[str, Any]], filters) -> List[Dict[str, Any]]:
    if not filters:
        return rows
    items = filters.items() if isinstance(filters, dict) else filters
    return [r for r in rows if all(r.get(k) == v for k, v in items)]


def _first(rows):
    return rows[0] if rows else None
