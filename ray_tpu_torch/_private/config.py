"""Central typed flag table.

Analog of the reference's ``RAY_CONFIG`` system (reference:
src/ray/common/ray_config_def.h — 218 typed flags, each overridable via
a ``RAY_<name>`` env var or the ``_system_config`` JSON handed to every
process).  Here: a declarative table of (name, type, default, help); the
resolved value for flag NAME comes from, in priority order,

  1. the ``RAY_TPU_TORCH_<NAME>`` environment variable,
  2. the system-config JSON in ``RAY_TPU_TORCH_SYSTEM_CONFIG`` (set by
     ``ray_tpu_torch.init(_system_config=...)`` and propagated by the
     bootstrapper into every daemon it spawns),
  3. the table default.

Usage::

    from ray_tpu_torch._private.config import cfg
    timeout = cfg().node_death_timeout_s

The port's copy of ``ray_tpu/_private/config.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

# (name, type, default, help) — name doubles as the env suffix
CONFIG_DEFS: List[Tuple[str, type, Any, str]] = [
    # -- control plane / failure detection
    ("heartbeat_interval_s", float, 0.5,
     "raylet -> control heartbeat period"),
    ("resource_sync_delta", bool, True,
     "ship node availability only when it changed (versioned delta "
     "sync, the ray_syncer analog); False = full snapshot every beat"),
    ("node_death_timeout_s", float, 10.0,
     "missed-heartbeat window before a node is declared dead"),
    ("control_reconnect_s", float, 20.0,
     "how long clients retry re-attaching to a restarted control plane"),
    ("preemption_poll_s", float, 1.0,
     "raylet poll period of the preemption/maintenance-event source "
     "(RAY_TPU_TORCH_PREEMPTION_FILE sentinel or the GCE metadata endpoint)"),
    ("drain_grace_s", float, 30.0,
     "advisory deadline attached to a node drain notice that carries "
     "no explicit grace window"),
    ("preemption_debounce_s", float, 5.0,
     "flap suppression window: a preemption notice edge within this "
     "many seconds of the last fired notice is swallowed (drain -> "
     "cancel -> drain inside one window costs one drain report, not "
     "two); 0 disables"),
    ("rpc_backoff_base_s", float, 0.05,
     "initial delay of the jittered-exponential backoff used by RPC "
     "reconnect/retry loops (raylet re-home, driver control rebuild, "
     "idempotent lease replay)"),
    ("rpc_backoff_cap_s", float, 2.0,
     "ceiling of the jittered-exponential RPC reconnect/retry backoff"),
    ("restore_owner_grace_s", float, 60.0,
     "window for a driver job to re-register after a control restart "
     "before its restored non-detached actors are reaped"),
    ("actor_adopt_grace_s", float, 15.0,
     "window after a control restart/failover for raylets to re-home "
     "and adopt their still-running actor workers in place before the "
     "control plane falls back to rescheduling them fresh"),
    # -- task submission (NOTE: bound at module import in the driver's
    # own process — set via env or _system_config before daemons spawn)
    ("pipeline_depth", int, 8,
     "tasks pushed per leased worker before waiting on replies"),
    ("submit_batch", int, 64,
     "max TaskSpecs coalesced into one framed push_tasks RPC per leased "
     "worker; 1 = escape hatch, bypasses the combining flusher and ships "
     "one spec per frame (bit-identical semantics, no coalescing)"),
    ("submit_mux", bool, True,
     "multi-client submit multiplexer: when a raylet sees >=2 concurrent "
     "driver processes it relays their eligible plain tasks itself (one "
     "framed stream per driver, no per-driver lease conversations); "
     "0 = escape hatch, every driver keeps its own lease protocol"),
    ("lease_grant_batch", int, 16,
     "max leases requested from the raylet in one request_leases RPC "
     "(the vectorized ramp-up; 1 degrades to the old one-lease-per-"
     "round-trip behavior)"),
    ("pending_lease_cap", int, 64,
     "max outstanding lease requests per scheduling pool (bounds the "
     "one-request-per-queued-task aim during 100k-task bursts)"),
    ("small_arg_limit", int, 4096,
     "max serialized bytes for the small-arg inline fast path (plain "
     "scalars/bytes/ObjectRefs skip full pickle framing); 0 disables"),
    ("small_arg_memo", int, 512,
     "entries kept in the small-arg serialization memo (repeated "
     "identical ref-free arg tuples reuse their bytes); 0 disables"),
    ("idle_lease_ttl_s", float, 1.0,
     "idle time before a lease is returned to the raylet"),
    ("delete_grace_s", float, 0.5,
     "delay before a released object is reclaimed"),
    ("inline_object_limit", int, 100 * 1024,
     "max bytes for values carried inline instead of via the shm store"),
    # -- object store / spilling
    ("object_store_bytes", int, 0,
     "shm arena capacity per node (0 = auto-size)"),
    ("object_spilling", bool, True,
     "spill primary copies to disk under memory pressure"),
    ("spill_high", float, 0.8,
     "store fullness fraction that triggers spilling"),
    ("spill_low", float, 0.6,
     "store fullness fraction spilling drains down to"),
    ("memory_monitor_refresh_ms", int, 250,
     "OOM watchdog poll period"),
    # -- workers
    ("worker_prestart", int, 4,
     "warm workers each raylet keeps ready (capped to the CPU slots)"),
    ("native_sched", bool, True,
     "use the native C++ scheduling policy engine"),
    ("task_events", bool, True,
     "export task lifecycle events to the control plane"),
    ("max_task_events", int, 10000,
     "task events retained by the control plane"),
    ("max_dead_actors", int, 10000,
     "destroyed actor records kept for introspection (reference: "
     "maximum_gcs_destroyed_actor_cached_count)"),
    ("max_cluster_events", int, 10000,
     "structured cluster events retained by the control plane "
     "(node/actor/pg/job lifecycle; separate from task events so "
     "tuning one buffer never evicts the other's history)"),
    # -- distributed tracing
    ("trace_sample", float, 0.0,
     "head-based trace sampling ratio in [0,1]: >0 auto-enables "
     "tracing and samples that fraction of new traces (deterministic "
     "on trace_id, so every process agrees); 0 leaves the sampler off "
     "— tracing enabled explicitly via a startup hook records all"),
    ("trace_buffer_cap", int, 4096,
     "finished spans buffered per process before drop-oldest (the "
     "span buffer flushing batched report_spans to the control plane)"),
    ("trace_flush_interval_s", float, 0.5,
     "span-buffer flush period (rate limit on report_spans pushes)"),
    ("trace_store_cap", int, 512,
     "traces retained by the control plane's span collector (LRU "
     "eviction beyond this)"),
    ("trace_store_ttl_s", float, 600.0,
     "idle TTL before a collected trace is evicted from the control "
     "plane's _tracing KV namespace"),
    ("trace_spans_per_trace", int, 512,
     "max spans stored per trace (overflow counted, not stored)"),
    # -- runtime env
    ("rtenv_max_bytes", int, 256 * 1024 * 1024,
     "max size of one runtime_env package"),
    ("allow_pkg_install", bool, False,
     "allow runtime_env pip/conda materialization"),
    # -- collectives
    ("collective_compression", str, "",
     "default compression for collective ops: '' = off, or a spec like "
     "'int8' / 'int8:block=512,stochastic=1,ef=0' (block-wise quantized "
     "allreduce; see collective/compression.py).  Per-call compression= "
     "and the Train backend's CompressionConfig override this"),
    # -- serving (the LLM engine knobs live here, not as hardcoded
    # constants in serve/llm.py, so one RAY_TPU_TORCH_SERVE_* env var reaches
    # every replica the bootstrapper spawns)
    ("serve_engine", str, "paged",
     "LLM decode engine: 'paged' (continuous batching over the paged "
     "KV arena), 'contiguous' (continuous batching over per-slot "
     "contiguous caches; the parity baseline), or 'static' (legacy "
     "serve.batch micro-batching)"),
    ("serve_max_slots", int, 8,
     "decode slots per replica = the fixed batch width of the "
     "continuous-batching decode step"),
    ("serve_page_size", int, 16,
     "KV-cache page size in token positions"),
    ("serve_num_pages", int, 0,
     "pages in the device KV arena (incl. the reserved null page); "
     "0 = auto-size so every slot can hold a full-length sequence"),
    ("serve_max_total", int, 0,
     "max prompt+generation positions per sequence; 0 = the model's "
     "max_seq"),
    ("serve_queue_cap", int, 32,
     "waiting-queue length at which the engine rejects new requests "
     "(AdmissionRejected -> HTTP 503 + Retry-After)"),
    ("serve_shed_queue_depth", int, 16,
     "queue depth at which the replica advertises accepting=False so "
     "the router sheds before the hard queue_cap bounces requests"),
    ("serve_retry_after_s", float, 1.0,
     "Retry-After hint attached to shed/rejected serve requests"),
    ("serve_replay_budget", int, 2,
     "replays per request after a replica dies mid-call (actor-died / "
     "unreachable); exhausting the budget surfaces the ORIGINAL error"),
    ("serve_call_deadline_s", float, 0.0,
     "per-attempt deadline after which an unanswered replica call is "
     "treated as a dead replica and replayed elsewhere; 0 = disabled "
     "(rely on actor-death detection only)"),
    ("serve_health_check_period_s", float, 2.0,
     "controller-driven replica check_health probe cadence"),
    ("serve_health_check_timeout_s", float, 10.0,
     "an unanswered check_health probe older than this marks the "
     "replica wedged and restarts it"),
    ("serve_engine_stall_s", float, 10.0,
     "check_health fails when the engine has active slots but has "
     "finished neither a decode step nor a prefill chunk for this long "
     "(a hung step)"),
    ("serve_drain_grace_s", float, 10.0,
     "drain window granted to a replica's in-flight requests when its "
     "node is preempted without an explicit deadline"),
    # -- misc
    ("usage_stats_enabled", bool, True, "local usage tagging"),
    ("log_to_driver_batch_lines", int, 200,
     "worker-log lines per pubsub batch"),
]

_SYSTEM_CONFIG_ENV = "RAY_TPU_TORCH_SYSTEM_CONFIG"


def _coerce(typ: type, raw: Any) -> Any:
    if typ is bool:
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return typ(raw)


class Config:
    """Resolved flag values as attributes (see CONFIG_DEFS)."""

    def __init__(self, system_config: Optional[Dict[str, Any]] = None):
        sysconf = dict(system_config or {})
        raw_env = os.environ.get(_SYSTEM_CONFIG_ENV)
        if raw_env and not sysconf:
            try:
                sysconf = json.loads(raw_env)
            except ValueError:
                pass
        unknown = set(sysconf) - {n for n, *_ in CONFIG_DEFS}
        if unknown:
            raise ValueError(f"unknown _system_config keys: {sorted(unknown)}")
        self._explicit = set()
        for name, typ, default, _help in CONFIG_DEFS:
            env = os.environ.get(f"RAY_TPU_TORCH_{name.upper()}")
            if env is not None:
                val = _coerce(typ, env)
                self._explicit.add(name)
            elif name in sysconf:
                val = _coerce(typ, sysconf[name])
                self._explicit.add(name)
            else:
                val = default
            setattr(self, name, val)

    def is_set(self, name: str) -> bool:
        """True when the flag was explicitly set (env or system config),
        as opposed to carrying its table default."""
        return name in self._explicit

    def to_dict(self) -> Dict[str, Any]:
        return {n: getattr(self, n) for n, *_ in CONFIG_DEFS}


_lock = threading.Lock()
_current: Optional[Config] = None


def cfg() -> Config:
    """The process-wide resolved config.

    Rebuilt from the environment on each call unless set_system_config
    pinned an explicit config — env flags stay live for processes (and
    tests) that set them after import; daemons resolve once at their
    read sites anyway."""
    with _lock:
        if _current is not None:
            return _current
        return Config()


def set_system_config(system_config: Optional[Dict[str, Any]]) -> None:
    """Install a system-config dict (driver side) and export it so
    spawned daemons inherit it (the reference propagates _system_config
    from `ray.init` through the raylet to every worker)."""
    global _current
    with _lock:
        _current = Config(system_config)
        if system_config:
            os.environ[_SYSTEM_CONFIG_ENV] = json.dumps(system_config)


def describe() -> str:
    """Human-readable flag table (`ray-tpu config`)."""
    c = cfg()
    lines = []
    for name, typ, default, help_ in CONFIG_DEFS:
        cur = getattr(c, name)
        mark = "" if cur == default else "  [overridden]"
        lines.append(f"{name:32s} {typ.__name__:5s} = {cur!r}{mark}\n"
                     f"{'':40s}{help_}")
    return "\n".join(lines)
