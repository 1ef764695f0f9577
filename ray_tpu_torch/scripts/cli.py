"""The port's command line interface.

Analog of the reference's `ray` CLI (reference:
python/ray/scripts/scripts.py — start :626, stop :1102, status, submit
:1636, plus the state CLI `ray list/summary/timeline` from
python/ray/util/state/state_cli.py).  The port's copy of
``ray_tpu/scripts/cli.py``: ``start --head`` offers ``--num-gpus`` cards
(default: the cards this host shows, ``accelerators.num_gpus``) as
"GPU", ``job submit`` is ``submit``, and ``up`` launches a cluster
from a YAML config through the port's node providers (a worker type
with ``{GPU: n}`` offers cards), and ``timeline --job`` (or a trial
name) dumps a training run's flight recorder as a Chrome trace.
``analyze`` scans ``ray_tpu_torch/`` against the port's own baseline,
``analysis_baseline_torch.json``.

Run as ``python -m ray_tpu_torch <command>``.  Cluster bookkeeping: the
head writes ``/tmp/ray_tpu_torch/ray_current_cluster.json``
(``RAY_TPU_TORCH_CLUSTER_FILE`` overrides it; control address + daemon
pids), which stop/status/submit read back;
``ray_tpu_torch.init(address="auto")`` uses the same file.  The module
imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

CLUSTER_FILE_ENV = "RAY_TPU_TORCH_CLUSTER_FILE"
DEFAULT_CLUSTER_FILE = "/tmp/ray_tpu_torch/ray_current_cluster.json"
# the reference's head listens on 6380: the port's default differs, so
# both heads can run on one host
DEFAULT_PORT = 6390


def cluster_file() -> str:
    """The cluster file's path, read when it is used (a driver may set
    ``RAY_TPU_TORCH_CLUSTER_FILE`` after importing this module)."""
    return os.environ.get(CLUSTER_FILE_ENV, DEFAULT_CLUSTER_FILE)


def _write_cluster_file(info):
    path = cluster_file()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(info, f)


def read_cluster_file():
    path = cluster_file()
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None)
    if addr and addr != "auto":
        return addr
    info = read_cluster_file()
    if info is None:
        raise SystemExit("no running cluster found (python -m "
                         "ray_tpu_torch start --head first, or pass "
                         "--address)")
    return info["control_address"]


# -- start / stop / status ---------------------------------------------------

def cmd_start(args):
    from .._private import accelerators
    from .._private.bootstrap import Cluster, _spawn, _wait_ping

    if args.head:
        session_name = f"cli-{int(time.time())}"
        cluster = Cluster(session_name=session_name)
        host = args.node_ip_address
        port = args.port or DEFAULT_PORT
        cluster.control_proc = _spawn(
            [sys.executable, "-m", "ray_tpu_torch._private.control",
             "--host", host, "--port", str(port)],
            os.path.join(cluster.log_dir, "control.log"))
        cluster.control_addr = (host, port)
        _wait_ping(cluster.control_addr, what="control plane")
        control_address = f"{host}:{port}"
    else:
        control_address = _resolve_address(args) if args.address is None \
            else args.address
        cluster = None

    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    else:
        resources.setdefault("CPU", float(os.cpu_count() or 1))
    num_gpus = (args.num_gpus if args.num_gpus is not None
                else accelerators.num_gpus())
    if num_gpus:
        resources.setdefault("GPU", float(num_gpus))

    if args.head:
        node = cluster.add_node(resources=resources)
        _write_cluster_file({
            "control_address": control_address,
            "session_dir": cluster.session_dir,
            "control_pid": cluster.control_proc.pid,
            "raylet_pids": [node.proc.pid],
        })
        print(f"ray_tpu_torch head started at {control_address}")
        print(f"  connect: ray_tpu_torch.init(address='{control_address}')"
              f"  or ray_tpu_torch.init(address='auto')")
    else:
        # worker node joining an existing cluster
        from .._private.bootstrap import Cluster as _C

        c = _C(session_name=f"cli-worker-{int(time.time())}")
        c.control_addr = tuple(control_address.rsplit(":", 1))
        c.control_addr = (c.control_addr[0], int(c.control_addr[1]))
        node = c.add_node(resources=resources)
        info = read_cluster_file()
        if info:
            info.setdefault("raylet_pids", []).append(node.proc.pid)
            _write_cluster_file(info)
        print(f"ray_tpu_torch node joined {control_address} "
              f"(node id {node.node_id[:12]})")
        cluster = c

    if args.block:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            if cluster is not None:
                cluster.shutdown()


def cmd_config(args):
    """Print the resolved typed flag table (reference: ray_config_def.h
    flags + RAY_<name> env overrides)."""
    from .._private.config import describe

    print(describe())


def cmd_debug(args):
    """Attach to an active remote breakpoint (reference: `ray debug` /
    util/rpdb.py)."""
    from .._private.protocol import Client
    from ..util import rpdb

    address = _resolve_address(args) if args.address is None \
        else args.address
    host, port = address.rsplit(":", 1)
    control = Client((host, int(port)), name="cli-debug")
    try:
        bps = rpdb.list_breakpoints(control)
        if not bps:
            print("no active breakpoints")
            return
        for i, bp in enumerate(bps):
            print(f"[{i}] {bp['id']} pid={bp['pid']} "
                  f"worker={bp.get('worker_id', '?')[:12]}")
        idx = args.index if args.index is not None else 0
        bp = bps[idx]
        print(f"attaching to {bp['id']} — pdb commands go through; "
              f"'c' continues the task and detaches")
        rpdb.attach(bp["addr"])
    finally:
        control.close()


def cmd_up(args):
    """Launch a cluster from a YAML config (reference: `ray up`,
    scripts.py:1337 + autoscaler/_private/commands.py), driving the
    configured node provider."""
    import yaml

    from .._private.bootstrap import Cluster, _spawn, _wait_ping
    from ..autoscaler.node_provider import make_node_provider

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    name = cfg.get("cluster_name", "default")
    provider_cfg = dict(cfg.get("provider") or {"type": "local"})
    head_cfg = cfg.get("head_node") or {}
    worker_cfg = cfg.get("worker_nodes") or {}
    n_workers = int(worker_cfg.get("count", cfg.get("min_workers", 0)))

    # 1. control plane
    host = provider_cfg.get("head_ip", "127.0.0.1")
    port = int(provider_cfg.get("port", args.port or DEFAULT_PORT))
    if port == 0:
        from .._private.bootstrap import free_port

        port = free_port()
    cluster = Cluster(session_name=f"up-{name}-{int(time.time())}")
    cluster.control_proc = _spawn(
        [sys.executable, "-m", "ray_tpu_torch._private.control",
         "--host", host, "--port", str(port)],
        os.path.join(cluster.log_dir, "control.log"))
    cluster.control_addr = (host, port)
    _wait_ping(cluster.control_addr, what="control plane")
    control_address = f"{host}:{port}"
    provider_cfg["control_address"] = control_address

    # 2. head + worker nodes through the provider
    provider = make_node_provider(provider_cfg, name)
    head_ids = provider.create_node(
        {"resources": head_cfg.get("resources"),
         "labels": {**(head_cfg.get("labels") or {}),
                    "node-type": "head"}},
        {"ray-node-type": "head"}, 1)
    worker_ids = []
    if n_workers:
        worker_ids = provider.create_node(
            {"resources": worker_cfg.get("resources"),
             "labels": {**(worker_cfg.get("labels") or {}),
                        "node-type": "worker"}},
            {"ray-node-type": "worker"}, n_workers)

    pids = []
    for nid in head_ids + worker_ids:
        h = getattr(provider, "_nodes", {}).get(nid, {}).get("handle")
        if h is not None and getattr(h, "proc", None) is not None:
            pids.append(h.proc.pid)
    _write_cluster_file({
        "control_address": control_address,
        "cluster_name": name,
        "session_dir": cluster.session_dir,
        "control_pid": cluster.control_proc.pid,
        "raylet_pids": pids,
    })
    print(f"cluster {name!r} up at {control_address} "
          f"(1 head + {len(worker_ids)} workers)")
    print(f"  connect: ray_tpu_torch.init(address='{control_address}')")


def cmd_down(args):
    """Tear down a cluster started with `up` (reference: `ray down`)."""
    info = read_cluster_file()
    if info is None:
        print("no running cluster")
        return
    cmd_stop(args)



def cmd_device_stats(args):
    """Device runtime observability: per-program signature counts with
    new-signature cause diffs, storm advisories, ``kernels.build``
    events, and the card memory census / KV-page occupancy per
    worker."""
    from ray_tpu_torch.util.state import api as state

    snap = state.device_stats(address=_resolve_address(args))
    if args.format == "json":
        print(json.dumps(snap, indent=2, default=str))
        return

    def _mb(n):
        return f"{n / (1 << 20):.1f}MB"

    def _cause(cause):
        if isinstance(cause, dict):
            note = cause.get("note")
            cause = cause.get("changes")
            if not cause:
                return note or "-"
        if not cause:
            return "-"
        parts = [f"{c.get('arg')}: {c.get('kind')} "
                 f"{c.get('old')} -> {c.get('new')}" for c in cause[:3]]
        if len(cause) > 3:
            parts.append(f"(+{len(cause) - 3} more)")
        return "; ".join(parts)

    progs = snap.get("programs") or {}
    print(f"program ledger: {len(snap.get('workers') or {})} "
          f"worker(s), {snap.get('total_compiles', 0)} new signature(s), "
          f"{snap.get('total_recompiles', 0)} after a program's first, "
          f"live on cards {_mb(snap.get('live_bytes', 0))}")
    if progs:
        rows = [(name, st["compiles"], st["recompiles"],
                 st["storm_episodes"], st["workers"],
                 _cause(st.get("last_cause")))
                for name, st in sorted(progs.items())]
        hdr = ("program", "signatures", "new", "storms", "workers",
               "last new-signature cause")
        widths = [max(len(str(r[i])) for r in rows + [hdr])
                  for i in range(len(hdr))]
        for r in [hdr] + rows:
            print("  " + "  ".join(str(v).ljust(w)
                                   for v, w in zip(r, widths)).rstrip())
    else:
        print("  (no programs recorded)")
    advs = snap.get("advisories") or []
    if advs:
        print("advisories:")
        for a in advs[-10:]:
            kind = a.get("kind", "?")
            if kind == "recompile_storm":
                print(f"  [{a.get('worker_id', '?')[:12]}] storm: "
                      f"{a.get('program')} x{a.get('compiles_in_window')}"
                      f" in {a.get('window_s')}s — "
                      f"{_cause(a.get('cause'))}")
            elif kind == "memory_watermark":
                print(f"  [{a.get('worker_id', '?')[:12]}] watermark: "
                      f"live {_mb(a.get('live_bytes', 0))} >= "
                      f"{_mb(a.get('watermark_bytes', 0))}")
            else:
                print(f"  [{a.get('worker_id', '?')[:12]}] {kind}: {a}")
    for wid, wsnap in sorted((snap.get("workers") or {}).items()):
        mem = wsnap.get("memory") or {}
        live = mem.get("live") or {}
        line = (f"worker {wid[:16]}: live {_mb(live.get('total_bytes', 0))}"
                f" in {live.get('count', 0)} storage(s)")
        for card, a in sorted((live.get("allocator") or {}).items()):
            line += (f"; {card} allocated "
                     f"{_mb(a.get('allocated_bytes', 0))} reserved "
                     f"{_mb(a.get('reserved_bytes', 0))}")
        owners = mem.get("owners") or {}
        for tag, rep in sorted(owners.items()):
            pages = rep.get("pages")
            if isinstance(pages, dict):
                line += (f"; {tag}: pages free {pages.get('free', 0)} "
                         f"used {pages.get('used', 0)} "
                         f"shared {pages.get('shared', 0)} "
                         f"cow {pages.get('cow', 0)}")
            elif "bytes" in rep:
                line += f"; {tag}: {_mb(rep.get('bytes', 0))}"
        print(line)

def cmd_analyze(args):
    from ray_tpu_torch import analysis
    from ray_tpu_torch.analysis import baseline as bl

    findings = analysis.run_analysis(args.paths or None)
    bl_path = args.baseline or bl.default_path()
    if args.update_baseline:
        bl.save(bl_path, findings)
        print(f"baseline updated: {len(findings)} finding(s) -> {bl_path}")
        return
    known = bl.load(bl_path)
    new, suppressed, stale = bl.diff(findings, known)
    if args.format == "json":
        print(json.dumps({
            "new": [{"key": f.key, "line": f.line, "file": f.file,
                     "message": f.message} for f in new],
            "suppressed": len(suppressed),
            "stale": stale,
        }, indent=2))
    else:
        for f in new:
            print(f"NEW  {f.render()}")
        if args.verbose:
            for f in suppressed:
                print(f"okay {f.render()}  [baselined]")
        for k in stale:
            print(f"stale baseline entry (fixed?): {k}")
        print(f"analyze: {len(new)} new, {len(suppressed)} baselined, "
              f"{len(stale)} stale")
    if new:
        print("new findings: fix them or re-run with --update-baseline",
              file=sys.stderr)
        raise SystemExit(1)


def cmd_stop(args):
    info = read_cluster_file()
    if info is None:
        print("no running cluster")
        return
    pids = [info.get("control_pid")] + info.get("raylet_pids", [])
    killed = 0
    # raylets first so they fan shutdown out to their workers
    for pid in reversed([p for p in pids if p]):
        try:
            os.killpg(os.getpgid(pid), signal.SIGTERM)
            killed += 1
        except (ProcessLookupError, PermissionError):
            try:
                os.kill(pid, signal.SIGTERM)
                killed += 1
            except OSError:
                pass
    try:
        os.remove(cluster_file())
    except OSError:
        pass
    print(f"stopped {killed} daemon(s)")


def cmd_status(args):
    from ..util.state import api as state

    address = _resolve_address(args)
    nodes = state.list_nodes(address=address)
    total = state.cluster_resources(address=address)
    avail = state.available_resources(address=address)
    actors = state.list_actors(address=address)
    print(f"cluster at {address}")
    print(f"  nodes: {sum(1 for n in nodes if n['state'] == 'ALIVE')} alive"
          f" / {len(nodes)} total")
    for n in nodes:
        print(f"    {n['node_id'][:12]} {n['state']:6} {n['total']}")
    print(f"  resources: {avail} free of {total}")
    alive = sum(1 for a in actors if a.get("state") == "ALIVE")
    print(f"  actors: {alive} alive / {len(actors)} total")


# -- job commands ------------------------------------------------------------

def cmd_submit(args):
    from ..job import JobStatus, JobSubmissionClient

    address = _resolve_address(args)
    client = JobSubmissionClient(address=address)
    parts = args.entrypoint
    if parts and parts[0] == "--":
        parts = parts[1:]
    import shlex

    entrypoint = shlex.join(parts)
    sid = client.submit_job(
        entrypoint=entrypoint,
        runtime_env=json.loads(args.runtime_env) if args.runtime_env else None,
        submission_id=args.submission_id)
    print(f"submitted job {sid}")
    if args.no_wait:
        return
    status = client.wait_until_finish(sid, timeout=args.timeout)
    logs = client.get_job_logs(sid)
    if logs:
        sys.stdout.write(logs)
    print(f"job {sid}: {status}")
    if status != JobStatus.SUCCEEDED:
        raise SystemExit(1)


def cmd_job(args):
    if args.job_cmd == "submit":
        # `job submit` (the reference's `ray job submit`) == `submit`
        return cmd_submit(args)
    from ..job import JobSubmissionClient

    client = JobSubmissionClient(address=_resolve_address(args))
    if args.job_cmd == "list":
        for j in client.list_jobs():
            print(f"{j['submission_id']}  {j['status']:10} "
                  f"{j.get('entrypoint', '')[:60]}")
    elif args.job_cmd == "status":
        print(client.get_job_status(args.id))
    elif args.job_cmd == "logs":
        sys.stdout.write(client.get_job_logs(args.id))
    elif args.job_cmd == "stop":
        print("stopped" if client.stop_job(args.id) else "not running")


def cmd_logs(args):
    """`logs [glob]`: list or tail cluster log files (reference:
    `ray logs` state CLI)."""
    from ..util.state import api as state

    address = _resolve_address(args)
    if not args.name:
        for nid, logs in state.list_logs(address=address).items():
            for entry in logs:
                print(f"{nid[:12]}  {entry['size_bytes']:>9}  "
                      f"{entry['name']}")
        return
    for nid, text in state.get_log(args.name, address=address,
                                   tail_bytes=args.tail).items():
        if text is None:
            continue
        print(f"==== {nid[:12]}: {args.name}")
        sys.stdout.write(text)


def cmd_serve(args):
    """`serve deploy/status/shutdown` (reference: serve CLI over the
    declarative schema, serve/scripts.py)."""
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args),
                       ignore_reinit_error=True)
    from ray_tpu_torch import serve

    if args.serve_cmd == "deploy":
        names = serve.deploy_config_file(args.config)
        print(f"deployed applications: {', '.join(names)}")
    elif args.serve_cmd == "status":
        for name, st in serve.status().items():
            print(f"{name}: {getattr(st, 'status', st)}")
    elif args.serve_cmd == "shutdown":
        serve.shutdown()
        print("serve shut down")


# -- state commands ----------------------------------------------------------

_LISTABLE = ("nodes", "actors", "tasks", "workers", "objects",
             "placement_groups", "jobs", "cluster_events")


def cmd_list(args):
    from ..util.state import api as state

    fn = getattr(state, f"list_{args.resource}")
    rows = fn(address=_resolve_address(args), limit=args.limit)
    if args.format == "json":
        print(json.dumps(rows, indent=2, default=str))
    else:
        for r in rows:
            print(json.dumps(r, default=str))
    print(f"({len(rows)} {args.resource})", file=sys.stderr)


def cmd_summary(args):
    from ..util.state import api as state

    fn = getattr(state, f"summarize_{args.resource}")
    print(json.dumps(fn(address=_resolve_address(args)), indent=2,
                     default=str))


def cmd_timeline(args):
    job = args.trial or args.job
    if job:
        # training flight-recorder dump: per-step phase breakdowns from
        # every worker of one trial, as Chrome trace-event JSON
        from ray_tpu_torch._private.protocol import Client
        from ray_tpu_torch.telemetry.timeline import (chrome_trace,
                                                collect_remediations,
                                                collect_snapshots)

        address = _resolve_address(args)
        host, port = address.rsplit(":", 1)
        control = Client((host, int(port)), name="cli-timeline")
        try:
            snaps = collect_snapshots(control, trial=job)
            rems = collect_remediations(control, trial=job)
            trace = chrome_trace(snaps, remediations=rems)
        finally:
            control.close()
        with open(args.output, "w") as f:
            json.dump(trace, f)
        steps = sum(len(s.get("steps", [])) for s in snaps)
        print(f"wrote {args.output} ({len(snaps)} workers, {steps} step "
              f"records, {len(rems)} remediation markers for trial "
              f"{job!r})")
        return
    from ray_tpu_torch.util.state import api as state

    state.timeline(args.output, address=_resolve_address(args))
    print(f"wrote {args.output}")


def cmd_trace(args):
    """Reassemble a distributed trace from the control plane's span
    collector: span tree + critical-path phase/process attribution, or
    a cross-trace latency summary with --summary."""
    from ray_tpu_torch._private.protocol import Client
    from ray_tpu_torch.telemetry import trace_assembly as ta

    address = _resolve_address(args)
    host, port = address.rsplit(":", 1)
    control = Client((host, int(port)), name="cli-trace")
    try:
        if args.summary or not args.trace_id:
            summary = ta.summarize(control, job_id=args.job)
            if args.format == "json":
                print(json.dumps(summary, indent=2, default=str))
            else:
                print(ta.render_summary_text(summary))
            return
        spans = ta.fetch_trace(control, args.trace_id)
        if not spans:
            ids = ta.list_trace_ids(control)
            print(f"trace {args.trace_id!r} not found "
                  f"({len(ids)} trace(s) in the collector"
                  + (": " + ", ".join(i[:16] + "…" for i in ids[:8])
                     if ids else "") + ")", file=sys.stderr)
            raise SystemExit(1)
        analysis = ta.analyze(spans)
        if args.output:
            with open(args.output, "w") as f:
                json.dump(ta.chrome_trace(spans), f)
            print(f"wrote {args.output} ({len(spans)} spans)",
                  file=sys.stderr)
        if args.format == "json":
            print(json.dumps(analysis, indent=2, default=str))
        else:
            print(ta.render_text(analysis))
    finally:
        control.close()


def cmd_remediations(args):
    """List a training run's cause→action→effect self-healing log."""
    from ray_tpu_torch._private.protocol import Client
    from ray_tpu_torch.elastic.remediation import fetch_records

    address = _resolve_address(args)
    host, port = address.rsplit(":", 1)
    control = Client((host, int(port)), name="cli-remediations")
    try:
        records = fetch_records(control, args.job)
    finally:
        control.close()
    if args.format == "json":
        print(json.dumps(records, indent=2, default=str))
        return
    if not records:
        print(f"no remediation records for trial {args.job!r}")
        return
    for rec in records:
        cause = rec.get("cause") or {}
        action = rec.get("action") or {}
        effect = rec.get("effect")
        dry = " (dry-run)" if action.get("dry_run") else ""
        print(f"{rec.get('id')}  [{rec.get('mode')}]{dry}")
        print(f"  cause:  rank {cause.get('rank')} straggling — step "
              f"{cause.get('step_s')}s vs gang median "
              f"{cause.get('median_s')}s (x{cause.get('ratio')}), "
              f"sustained {action.get('confirmed_rounds')} rounds")
        tgt = f" node {str(action.get('node_id'))[:12]}" \
            if action.get("node_id") else ""
        world = f" -> world {action.get('new_world')}" \
            if action.get("new_world") is not None else ""
        print(f"  action: {action.get('kind')} rank {action.get('rank')}"
              f"{tgt} (grace {action.get('grace_s')}s){world}")
        if effect is None:
            print("  effect: (not yet measured)")
        else:
            verdict = "recovered" if effect.get("recovered") \
                else "NOT recovered"
            print(f"  effect: gang median busy {effect.get('post_busy_s')}s "
                  f"vs baseline {effect.get('baseline_busy_s')}s over "
                  f"{effect.get('measured_rounds')} rounds — {verdict} "
                  f"(tolerance {effect.get('tolerance'):.0%})")


def cmd_memory(args):
    from ..util.state import api as state

    address = _resolve_address(args)
    print(json.dumps(state.summarize_objects(address=address), indent=2))


def cmd_control_stats(args):
    """Control-plane flight recorder: per-handler latency table plus
    loop-lag / KV / pubsub / event-relay counters."""
    from ..util.state import api as state

    snap = state.control_stats(address=_resolve_address(args),
                               per_node=args.per_node)
    if args.format == "json":
        print(json.dumps(snap, indent=2, default=str))
        return

    def _table(handlers):
        rows = []
        for method, s in sorted(handlers.items()):
            if not s.get("count") and not args.all:
                continue
            q, h = s.get("queue_ms") or {}, s.get("handle_ms") or {}
            budget = s.get("budget_ms")
            rows.append((
                method, s.get("count", 0), s.get("errors", 0),
                s.get("in_flight", 0),
                f"{q.get('p50_ms', 0):g}/{q.get('p99_ms', 0):g}",
                f"{h.get('p50_ms', 0):g}/{h.get('p99_ms', 0):g}",
                f"{budget:g}" if budget is not None else "-",
                s.get("budget_exceeded", 0) if budget is not None else "-",
            ))
        if not rows:
            print("  (no calls recorded)")
            return
        hdr = ("handler", "count", "err", "infl", "queue p50/p99 ms",
               "handle p50/p99 ms", "budget", "over")
        widths = [max(len(str(r[i])) for r in rows + [hdr])
                  for i in range(len(hdr))]
        for r in [hdr] + rows:
            print("  " + "  ".join(str(v).ljust(w)
                                   for v, w in zip(r, widths)).rstrip())

    c = snap["control"]
    print(f"control plane (up {c.get('uptime_s', 0):.0f}s, "
          f"{c.get('nodes', {}).get('alive', 0)} alive node(s))")
    _table(c.get("handlers") or {})
    loop = c.get("loop") or {}
    lag = loop.get("lag_ms") or {}
    print(f"loop: lag p99 {lag.get('p99_ms', 0):g}ms "
          f"max {lag.get('max_ms', 0):g}ms over {lag.get('count', 0)} "
          f"ticks, {loop.get('frames', 0)} frames in "
          f"{loop.get('drains', 0)} drains "
          f"(max batch {loop.get('max_drain_batch', 0)}), "
          f"{loop.get('connections', 0)} connection(s)")
    kv = c.get("kv") or {}
    if kv:
        print("kv namespaces:")
        for ns, s in sorted(kv.items(), key=lambda i: -i[1]["ops"]):
            print(f"  {ns:24s} ops {s['ops']:<8d} "
                  f"in {s['bytes_in']:<10d} out {s['bytes_out']}")
    ps = c.get("pubsub") or {}
    if ps:
        print("pubsub topics:")
        for t, s in sorted(ps.items(), key=lambda i: -i[1]["publishes"]):
            n = max(1, s.get("publishes", 0))
            print(f"  {t:24s} pub {s['publishes']:<7d} "
                  f"deliv {s['deliveries']:<8d} "
                  f"drop {s['dropped_subscribers']:<4d} "
                  f"fanout avg {s['fanout_ms_total'] / n:.3f}ms "
                  f"max {s['fanout_ms_max']:.3f}ms")
    ev = c.get("events") or {}
    print(f"task events: queue {ev.get('queue_depth', 0)}, "
          f"records {ev.get('task_records', 0)}, "
          f"dropped {ev.get('dropped', 0)}, relay batches "
          f"{ev.get('relay_batches', 0)} "
          f"(+{ev.get('relay_dropped', 0)} dropped in relays)")
    tr = c.get("tracing") or {}
    if tr.get("spans") or tr.get("traces"):
        print(f"trace spans: queue {tr.get('queue_depth', 0)}, "
              f"traces {tr.get('traces', 0)}, "
              f"spans {tr.get('spans', 0)} in "
              f"{tr.get('span_batches', 0)} batches, "
              f"dropped {tr.get('dropped', 0)}, "
              f"per-trace overflow {tr.get('span_overflow', 0)}, "
              f"evicted {tr.get('traces_evicted', 0)}")
    for nid, r in (snap.get("raylets") or {}).items():
        if "error" in r:
            print(f"raylet {nid[:12]}: error: {r['error']}")
            continue
        rl = r.get("loop") or {}
        rlag = rl.get("lag_ms") or {}
        print(f"raylet {nid[:12]} (loop lag p99 "
              f"{rlag.get('p99_ms', 0):g}ms)")
        _table(r.get("handlers") or {})


# -- parser ------------------------------------------------------------------

def _submit_args(sp):
    sp.add_argument("--address", default=None)
    sp.add_argument("--runtime-env", default=None, help="JSON dict")
    sp.add_argument("--submission-id", default=None)
    sp.add_argument("--no-wait", action="store_true")
    sp.add_argument("--timeout", type=float, default=3600.0)
    sp.add_argument("entrypoint", nargs=argparse.REMAINDER)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch",
        description="ray_tpu_torch cluster CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default=None,
                    help="control address to join (worker nodes)")
    sp.add_argument("--port", type=int, default=None)
    sp.add_argument("--node-ip-address", default="127.0.0.1")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None,
                    help="cards to offer as GPU (default: the cards this "
                         "host shows)")
    sp.add_argument("--resources", default=None, help="JSON dict")
    sp.add_argument("--block", action="store_true")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("config", help="print the resolved flag table")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("debug", help="attach to a remote breakpoint")
    sp.add_argument("--address", default=None)
    sp.add_argument("--index", type=int, default=None,
                    help="breakpoint index (default: first)")
    sp.set_defaults(fn=cmd_debug)

    sp = sub.add_parser("up", help="launch a cluster from a YAML config")
    sp.add_argument("config", help="cluster YAML (cluster_name, provider, "
                                   "head_node, worker_nodes)")
    sp.add_argument("--port", type=int, default=None)
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down the cluster from `up`")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("stop", help="stop the local cluster")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster status")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("submit", help="submit a job")
    _submit_args(sp)
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser("job", help="manage jobs")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    for c in ("list", "status", "logs", "stop"):
        jp = jsub.add_parser(c)
        jp.add_argument("--address", default=None)
        if c != "list":
            jp.add_argument("id")
    _submit_args(jsub.add_parser("submit"))
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser("logs", help="list/tail cluster log files")
    sp.add_argument("name", nargs="?", default=None,
                    help="log file name (omit to list)")
    sp.add_argument("--tail", type=int, default=64 * 1024,
                    help="bytes from the end")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("serve", help="manage serve applications")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    dp = ssub.add_parser("deploy", help="deploy apps from a YAML config")
    dp.add_argument("config")
    dp.add_argument("--address", default=None)
    stp = ssub.add_parser("status")
    stp.add_argument("--address", default=None)
    shp = ssub.add_parser("shutdown")
    shp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument("resource", choices=_LISTABLE)
    sp.add_argument("--address", default=None)
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--format", choices=("jsonl", "json"), default="jsonl")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="summarize tasks/actors/objects")
    sp.add_argument("resource", choices=("tasks", "actors", "objects"))
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("timeline", help="export Chrome trace (pass a "
                        "trial name for the training flight recorder)")
    sp.add_argument("trial", nargs="?", default=None, metavar="job",
                    help="trial name: dump that run's per-step telemetry "
                         "instead of the cluster task timeline")
    sp.add_argument("--job", default=None,
                    help="the same trial name as an option")
    sp.add_argument("-o", "--output", default="timeline.json")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("memory", help="object store summary")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser(
        "control-stats",
        help="control-plane flight recorder: per-handler RPC latency, "
             "loop lag, KV/pubsub/event counters")
    sp.add_argument("--address", default=None)
    sp.add_argument("--per-node", action="store_true",
                    help="also query every raylet's rpc/loop stats")
    sp.add_argument("--all", action="store_true",
                    help="include handlers with zero calls")
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.set_defaults(fn=cmd_control_stats)

    sp = sub.add_parser(
        "trace",
        help="reassemble a distributed trace (span tree + critical-path "
             "attribution) from the control-plane span collector")
    sp.add_argument("trace_id", nargs="?", default=None,
                    help="32-hex trace id (from a span record or "
                         "trace --summary listing)")
    sp.add_argument("--summary", action="store_true",
                    help="aggregate phase attribution across all stored "
                         "traces instead of showing one")
    sp.add_argument("--job", default=None,
                    help="with --summary: only traces touching this job")
    sp.add_argument("-o", "--output", default=None,
                    help="also write the trace as Perfetto/Chrome "
                         "trace-event JSON")
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("remediations",
                        help="list a run's cause→action→effect "
                             "self-healing log")
    sp.add_argument("job", help="trial name")
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.set_defaults(fn=cmd_remediations)

    sp = sub.add_parser(
        "device-stats",
        help="program ledger + device-memory census: per-program "
             "signature counts, new-signature cause diffs, storm "
             "advisories, kernel builds, card memory / KV-page occupancy")
    sp.add_argument("--address", default=None)
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.set_defaults(fn=cmd_device_stats)

    sp = sub.add_parser(
        "analyze",
        help="static concurrency/torch-purity analysis (AST-based)")
    sp.add_argument("paths", nargs="*",
                    help="files or directories (default: the ray_tpu_torch "
                         "package)")
    sp.add_argument("--baseline", default=None,
                    help="baseline JSON path (default: "
                         "<repo>/analysis_baseline_torch.json)")
    sp.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this scan")
    sp.add_argument("--format", choices=("text", "json"), default="text")
    sp.add_argument("-v", "--verbose", action="store_true",
                    help="also list baselined findings")
    sp.set_defaults(fn=cmd_analyze)

    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
