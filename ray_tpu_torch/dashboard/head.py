"""Dashboard head: HTTP API over cluster state + Prometheus metrics.

Analog of the reference's dashboard backend (reference:
python/ray/dashboard/dashboard.py + head.py + modules/): a separate
process on the head node serving JSON state endpoints and the Prometheus
scrape target.  Stdlib http.server (threaded) instead of aiohttp — the
data volumes are controlplane-sized, and it keeps the daemon
dependency-free.

Endpoints (mirroring the reference's dashboard REST surface):
  GET /                         live HTML dashboard (static.py — the
                                dependency-free stand-in for the
                                reference's React client)
  GET /api/version              build/version info
  GET /api/cluster_status       nodes + resource totals (reference: /api/cluster_status)
  GET /api/nodes                node table
  GET /api/actors               actor table
  GET /api/tasks                task events
  GET /api/jobs                 submitted jobs (reference: /api/jobs/)
  POST /api/jobs                submit a job (reference:
                                modules/job/job_head.py submit_job)
  GET /api/jobs/<id>            one job's info
  GET /api/jobs/<id>/logs       job driver logs
  POST /api/jobs/<id>/stop      stop a job
  GET /api/placement_groups     placement groups
  GET /api/objects              object-store summary
  GET /metrics                  Prometheus exposition (reference: agent scrape)
  GET /healthz                  liveness (reference: modules/healthz)

The port's copy of ``ray_tpu/dashboard/head.py`` (imports renamed).
Start it on the head with ``python -m ray_tpu_torch.dashboard.head
--control host:port --port N``; it loads no torch and holds no card.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger(__name__)


class DashboardHead:
    def __init__(self, control_address: str, host: str = "127.0.0.1",
                 port: int = 8265):
        from ray_tpu_torch._private.protocol import Client

        chost, cport = control_address.rsplit(":", 1)
        self.control = Client((chost, int(cport)), name="dashboard")
        self.control_address = control_address
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._jobs_lock = threading.Lock()

    # -- data providers ----------------------------------------------------

    def _state_dump(self) -> Dict[str, Any]:
        return self.control.call("state_dump", {}, timeout=10.0)

    def _node_calls(self, node: Dict[str, Any], *calls):
        """Several RPCs to a node's raylet over ONE connection
        (drill-down endpoints); each call is (method, payload).
        Returns a list of results; a failed call yields None and the
        error string is returned as the trailing element."""
        from ray_tpu_torch._private.protocol import Client

        out = []
        err = None
        try:
            c = Client(tuple(node["addr"]), name="dashboard-node")
            try:
                for method, payload in calls:
                    try:
                        out.append(c.call(method, payload or {},
                                          timeout=10.0))
                    except Exception as e:
                        out.append(None)
                        err = err or str(e)
            finally:
                c.close()
        except Exception as e:
            err = str(e)
            out += [None] * (len(calls) - len(out))
        return out + [err]

    def _job_client(self):
        """Lazy full driver connection for job submission (reference: the
        job head submits through an internal JobSubmissionClient).
        Locked: handler threads race on first use."""
        with self._jobs_lock:
            cli = getattr(self, "_jobs", None)
            if cli is None:
                from ray_tpu_torch.job.job_manager import JobSubmissionClient

                cli = self._jobs = JobSubmissionClient(self.control_address)
            return cli

    def route_post(self, path: str, body: Dict[str, Any]
                   ) -> Tuple[int, str, str]:
        """POST routes: job submission + stop (reference:
        modules/job/job_head.py)."""
        try:
            if path in ("/api/jobs", "/api/jobs/"):
                entrypoint = (body or {}).get("entrypoint")
                if not entrypoint:
                    return 400, "text/plain", "entrypoint required"
                sid = self._job_client().submit_job(
                    entrypoint=entrypoint,
                    runtime_env=body.get("runtime_env"),
                    submission_id=body.get("submission_id"),
                    metadata=body.get("metadata"))
                return self._json({"submission_id": sid})
            if path.startswith("/api/jobs/") and path.endswith("/stop"):
                sid = path[len("/api/jobs/"):-len("/stop")]
                return self._json(
                    {"stopped": self._job_client().stop_job(sid)})
            return 404, "text/plain", f"no POST route {path}"
        except Exception as e:
            logger.exception("dashboard POST %s failed", path)
            return 500, "text/plain", f"error: {e}"

    def route(self, path: str, query: Dict[str, Any]) -> Tuple[int, str, str]:
        """Returns (status, content_type, body)."""
        try:
            if path in ("/", "/index.html"):
                from .static import PAGE

                return 200, "text/html", PAGE
            if path == "/healthz":
                return 200, "text/plain", "success"
            if path == "/api/version":
                import ray_tpu_torch

                return self._json({
                    "ray_tpu_version": ray_tpu_torch.__version__,
                    "control_address": self.control_address})
            if path == "/api/cluster_status":
                dump = self._state_dump()
                res = self.control.call("cluster_resources", {},
                                        timeout=10.0)
                return self._json({
                    "nodes": dump["nodes"],
                    "total_resources": res["total"],
                    "available_resources": res["available"],
                    "alive_nodes": sum(1 for n in dump["nodes"]
                                       if n["state"] == "ALIVE"),
                })
            if path == "/api/nodes":
                return self._json(self._state_dump()["nodes"])
            if path == "/api/actors":
                return self._json(self._state_dump()["actors"])
            if path == "/api/placement_groups":
                return self._json(self._state_dump()["pgs"])
            if path == "/api/jobs":
                from ray_tpu_torch.job.job_manager import JOB_NS

                keys = self.control.call(
                    "kv_keys", {"ns": JOB_NS, "prefix": ""}, timeout=10.0)
                jobs = []
                for k in keys:
                    raw = self.control.call(
                        "kv_get", {"ns": JOB_NS, "key": k}, timeout=10.0)
                    if raw:
                        jobs.append(json.loads(raw))
                return self._json(jobs)
            if path.startswith("/api/jobs/"):
                rest = path[len("/api/jobs/"):]
                if rest.endswith("/logs"):
                    sid = rest[:-len("/logs")]
                    return self._json(
                        {"logs": self._job_client().get_job_logs(sid)})
                info = self._job_client().get_job_info(rest)
                if info is None:
                    return 404, "text/plain", f"no job {rest}"
                return self._json(info)
            if path == "/api/train":
                # run states the trainer publishes (train/trainer.py
                # _publish_state); newest first.  Fetches are BOUNDED —
                # run keys accumulate over a cluster's life, and the page
                # polls this every tick inside one Promise.all, so an
                # unbounded N+1 here would stall every other panel.
                keys = self.control.call(
                    "kv_keys", {"ns": "train", "prefix": ""}, timeout=10.0)
                runs = []
                for k in list(keys)[-200:]:
                    raw = self.control.call(
                        "kv_get", {"ns": "train", "key": k}, timeout=10.0)
                    if raw:
                        runs.append(json.loads(raw))
                runs.sort(key=lambda r: -(r.get("ts") or 0))
                return self._json(runs[:100])
            if path == "/api/train/timeline":
                # flight-recorder rings -> Chrome trace-event JSON (loads
                # straight into Perfetto); ?trial= filters to one run and
                # overlays that run's remediation markers
                from ray_tpu_torch.telemetry.timeline import (
                    chrome_trace, collect_remediations, collect_snapshots)

                trial = (query.get("trial") or [None])[0]
                snaps = collect_snapshots(self.control, trial=trial)
                rems = collect_remediations(self.control, trial=trial) \
                    if trial else []
                from ray_tpu_torch.telemetry.timeline import \
                    collect_device_workers

                # compile slices are cluster-wide, but a ?trial= that
                # matches no run must stay a truly empty trace
                dev = collect_device_workers(self.control) \
                    if (not trial or snaps) else {}
                return self._json(chrome_trace(snaps, remediations=rems,
                                               device_workers=dev))
            if path == "/api/train/remediations":
                # a run's cause→action→effect self-healing log (see
                # elastic/remediation.py); ?trial= selects the run
                from ray_tpu_torch.elastic.remediation import fetch_records

                trial = (query.get("trial") or [""])[0]
                return self._json(fetch_records(self.control, trial))
            if path == "/api/serve":
                # snapshot the serve controller publishes each reconcile
                # pass (serve/_controller.py _publish_status)
                raw = self.control.call(
                    "kv_get", {"ns": "serve", "key": "status"},
                    timeout=10.0)
                return self._json(json.loads(raw) if raw
                                  else {"ts": None, "apps": []})
            if path == "/api/events":
                # structured cluster events (reference: dashboard
                # modules/event); ?severity=&source=&limit=
                return self._json(self.control.call("list_events", {
                    "severity": (query.get("severity") or [None])[0],
                    "source": (query.get("source") or [None])[0],
                    "limit": int((query.get("limit") or ["200"])[0]),
                }, timeout=10.0))
            if path == "/api/tasks":
                limit = int(query.get("limit", ["1000"])[0])
                out = self.control.call("list_task_events",
                                        {"limit": limit}, timeout=10.0)
                return self._json(out)
            if path == "/api/node":
                # per-node drill-down: the node view + its raylet's live
                # worker/lease tables + log file list (reference: the
                # dashboard's node detail page)
                nid = (query.get("node_id") or [None])[0]
                node = next((n for n in self._state_dump()["nodes"]
                             if n["node_id"] == nid), None)
                if node is None:
                    return 404, "text/plain", f"no node {nid}"
                detail = dict(node)
                if node["state"] == "ALIVE":
                    workers, leases, logs, err = self._node_calls(
                        node, ("list_workers", None),
                        ("list_leases", None), ("list_logs", None))
                    # endpoint contract: these fields are LISTS; raylet
                    # failures ride a separate error key
                    detail["workers"] = workers \
                        if isinstance(workers, list) else []
                    detail["leases"] = leases \
                        if isinstance(leases, list) else []
                    detail["logs"] = logs.get("logs", []) \
                        if isinstance(logs, dict) else []
                    if err:
                        detail["error"] = err
                return self._json(detail)
            if path == "/api/actor":
                aid = (query.get("actor_id") or [None])[0]
                actor = self.control.call("get_actor",
                                          {"actor_id": aid}, timeout=10.0)
                if actor is None:
                    return 404, "text/plain", f"no actor {aid}"
                # this actor's task events round out the drill-down
                evs = self.control.call(
                    "list_task_events",
                    {"limit": 100, "filters": {"actor_id": aid}},
                    timeout=10.0)
                return self._json({**actor, "task_events":
                                   (evs or {}).get("records", [])})
            if path == "/api/log_tail":
                nid = (query.get("node_id") or [None])[0]
                name = (query.get("name") or [None])[0]
                tail = int((query.get("tail_bytes") or ["65536"])[0])
                node = next((n for n in self._state_dump()["nodes"]
                             if n["node_id"] == nid), None)
                if node is None or not name:
                    return 404, "text/plain", "need node_id and name"
                text, err = self._node_calls(
                    node, ("read_log", {"name": name,
                                        "tail_bytes": tail}))
                if text is None and not err:
                    # the raylet rejected the name (traversal guard)
                    err = f"log {name!r} not readable"
                out = {"node_id": nid, "name": name,
                       "text": text if isinstance(text, str) else ""}
                if err:
                    out["error"] = err
                return self._json(out)
            if path == "/api/objects":
                from ray_tpu_torch.util.state.api import StateApiClient

                c = StateApiClient(self.control_address)
                try:
                    return self._json(c.per_node("store_stats"))
                finally:
                    c.close()
            if path == "/api/workers":
                from ray_tpu_torch.util.state.api import StateApiClient

                c = StateApiClient(self.control_address)
                try:
                    return self._json(c.per_node("list_workers"))
                finally:
                    c.close()
            if path in ("/api/profile/stacks", "/api/profile/cpu",
                        "/api/profile/memory"):
                # worker=host:port of the target's core server (from
                # /api/workers).  Reference: reporter agent's py-spy /
                # memray endpoints (profile_manager.py:82,:189).
                from ray_tpu_torch._private.protocol import Client
                from ray_tpu_torch.util.state.api import StateApiClient

                waddr = query.get("worker", [""])[0]
                try:
                    whost, wport = waddr.rsplit(":", 1)
                    target = (whost, int(wport))
                    dur = float(query.get("duration", ["2"])[0])
                except ValueError:
                    return 400, "text/plain", "need worker=host:port"
                # only relay to addresses that ARE cluster workers — the
                # dashboard must not be an arbitrary connect-and-call proxy
                sc = StateApiClient(self.control_address)
                try:
                    known = {tuple(w["addr"])
                             for ws in sc.per_node("list_workers").values()
                             for w in ws if w.get("addr")}
                finally:
                    sc.close()
                if target not in known:
                    return 404, "text/plain", \
                        f"{waddr} is not a cluster worker"
                cli = Client(target, name="dash-profile")
                try:
                    if path.endswith("stacks"):
                        out = cli.call("dump_stacks", timeout=15.0)
                    elif path.endswith("memory"):
                        out = cli.call("memory_summary", timeout=15.0)
                    else:
                        out = cli.call("profile_cpu", {"duration": dur},
                                       timeout=dur + 15.0)
                finally:
                    cli.close()
                return 200, "text/plain", out
            if path == "/api/usage_stats":
                from ray_tpu_torch._private.usage_stats import usage_report

                return self._json(usage_report(self.control))
            if path == "/api/control/stats":
                return self._json(
                    self.control.call("control_stats", {}, timeout=10.0))
            if path == "/api/device/stats":
                # cluster-wide program ledger + device-memory
                # census (telemetry/device.py): per-program compile /
                # recompile counts, last recompile cause diffs, storm
                # advisories, live card bytes and KV page occupancy
                from ray_tpu_torch.telemetry.device import (
                    collect_device_stats)

                return self._json(collect_device_stats(self.control))
            if path.startswith("/api/traces"):
                # distributed traces from the span collector: /api/traces
                # lists ids, /api/traces/<id> returns the reassembled
                # trace (span tree + critical-path attribution); add
                # ?format=chrome for Perfetto trace-event JSON
                from ray_tpu_torch.telemetry import trace_assembly as ta

                rest = path[len("/api/traces"):].strip("/")
                if not rest:
                    return self._json({"traces": ta.list_trace_ids(
                        self.control)})
                spans = ta.fetch_trace(self.control, rest)
                if not spans:
                    return 404, "text/plain", f"no trace {rest}"
                if (query.get("format") or [""])[0] == "chrome":
                    return self._json(ta.chrome_trace(spans))
                return self._json(ta.analyze(spans))
            if path == "/metrics":
                from ray_tpu_torch.util.metrics import (
                    collect_cluster_metrics, control_stats_metrics,
                    prometheus_text)

                merged = collect_cluster_metrics(self.control)
                # the control daemon has no flusher of its own: synthesize
                # its ray_tpu_control_* series from the control_stats RPC
                try:
                    merged.extend(control_stats_metrics(
                        self.control.call("control_stats", {},
                                          timeout=10.0)))
                except Exception:
                    pass
                return 200, "text/plain; version=0.0.4", \
                    prometheus_text(merged)
            return 404, "text/plain", f"no route {path}"
        except Exception as e:
            logger.exception("dashboard route %s failed", path)
            return 500, "text/plain", f"error: {e}"

    def _json(self, obj) -> Tuple[int, str, str]:
        return 200, "application/json", json.dumps(obj, default=str)

    # -- server ------------------------------------------------------------

    def start(self, block: bool = False):
        head = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, status, ctype, body):
                data = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                parsed = urlparse(self.path)
                self._reply(*head.route(parsed.path,
                                        parse_qs(parsed.query)))

            def do_POST(self):
                parsed = urlparse(self.path)
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                try:
                    body = json.loads(raw) if raw else {}
                except ValueError:
                    self._reply(400, "text/plain", "invalid JSON body")
                    return
                self._reply(*head.route_post(parsed.path, body))

            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        if block:
            self._server.serve_forever()
        else:
            t = threading.Thread(target=self._server.serve_forever,
                                 name="dashboard-http", daemon=True)
            t.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self.control.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--control", required=True, help="host:port")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8265)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s dashboard %(levelname)s "
                               "%(message)s")
    head = DashboardHead(args.control, args.host, args.port)
    logger.info("dashboard serving at %s", head.url)
    head.start(block=True)


if __name__ == "__main__":
    main()
