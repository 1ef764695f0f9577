"""Task/actor span tracing with W3C traceparent propagation.

Reference: python/ray/util/tracing/tracing_helper.py — opt-in tracing
that wraps task/actor submission (PRODUCER span) and execution (CONSUMER
span) and propagates the span context inside the task spec, so a
distributed trace stitches across processes.

The recorder is native (this image ships only the opentelemetry API
package, not the SDK): spans carry OTel-shaped fields (trace_id,
span_id, parent_id, kind, ns timestamps) and context crosses processes
as a standard ``traceparent`` header, so exported traces drop into any
OTel pipeline.  Enable with
``ray_tpu_torch.init(_tracing_startup_hook="module:function")`` — the hook
runs in the driver AND every worker (its name travels through the
control KV) and must call ``configure(sink)`` (or use the built-in
``setup_file_exporter`` hook, which appends finished spans as JSON
lines to the configured ``trace_file``) — or by setting
``RAY_TPU_TORCH_TRACE_SAMPLE`` > 0, which enables tracing with head-based
ratio sampling and no local sink (spans flow to the control plane's
collector only).

Sampling is head-based and deterministic on the trace id: the root
span's process decides once (``trace_id`` low bits vs the ratio), the
decision rides in the traceparent flags byte (``-01`` sampled /
``-00`` not), and every downstream process agrees without coordination.
A sampled-out parent suppresses its whole subtree — context still
propagates so late descendants stay suppressed too.

Central collection: every process with a control-plane client installs
a ``SpanBuffer`` (``ensure_collector``) — a bounded ring drained by a
flush thread into batched framed ``report_spans`` notifies, mirroring
the task-event relay shape (``_private/task_events.py``).  The control
plane stores spans per-trace in the ``_tracing`` KV namespace where
``telemetry/trace_assembly.py`` reassembles them.

The port's copy of ``ray_tpu/util/tracing.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import json
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Deque, Dict, Optional

logger = logging.getLogger(__name__)

KV_NS = "_tracing"

_enabled = False
_sink: Optional[Callable[[Dict[str, Any]], None]] = None
# short process label stamped on every span record ("driver", "raylet",
# "worker:<id>") so the assembler can attribute wall time per process
_proc = ""
# contextvar, not thread-local: spans opened inside asyncio Tasks must
# attribute per-Task even though all coroutines share the loop thread
_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None)
# resolved trace_sample ratio; None = not yet read from config
_sample_ratio: Optional[float] = None


def is_enabled() -> bool:
    return _enabled


def configure(sink: Callable[[Dict[str, Any]], None]) -> None:
    """Install a span sink (called once per finished span) and enable."""
    global _enabled, _sink
    _sink = sink
    _enabled = True


def enable() -> None:
    global _enabled
    _enabled = True


def set_process(name: str) -> None:
    """Label this process's spans (driver / raylet / worker:<id>)."""
    global _proc
    _proc = name


# Mersenne Twister, not os.urandom: id generation sits on the per-task
# submit path and urandom is a syscall — under ratio sampling the 99%
# sampled-out tasks must not pay two syscalls each.  Seeded from the OS
# entropy pool at import, unique enough for trace correlation.
_rng = random.Random()


def _new_id(nbytes: int) -> int:
    return _rng.getrandbits(nbytes * 8) or 1


def _current() -> Optional[Dict[str, Any]]:
    return _ctx.get()


# shared sampled-out context/carrier: the 99% path under ratio sampling
# allocates no ids and formats no strings — suppression is the only
# information that has to propagate, so one constant serves every trace
_SUPPRESSED_CTX: Dict[str, Any] = {"trace_id": 0, "span_id": 0,
                                   "sampled": False}
_SUPPRESSED_CARRIER = {"traceparent":
                       "00-" + "0" * 32 + "-" + "0" * 16 + "-00"}
_NULL_CM = contextlib.nullcontext()  # reusable per the contextlib docs


class _Suppressed:
    """Context manager that propagates the sampled-out context (so every
    descendant suppresses itself) with no id generation, no span dict
    and no generator frame — the hot-path shape of a non-sampled span."""

    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _ctx.set(_SUPPRESSED_CTX)
        return None

    def __exit__(self, *exc):
        _ctx.reset(self._token)
        return False


# -- sampling ----------------------------------------------------------------

def _ratio() -> float:
    """trace_sample ratio, read from config once per process."""
    global _sample_ratio
    if _sample_ratio is None:
        try:
            from ray_tpu_torch._private.config import cfg
            _sample_ratio = float(cfg().trace_sample)
        except Exception:
            _sample_ratio = 0.0
    return _sample_ratio


def set_sample_ratio(ratio: Optional[float]) -> None:
    """Pin (or with None, re-resolve from config) the sampling ratio."""
    global _sample_ratio
    _sample_ratio = ratio


def sample_trace(trace_id: int) -> bool:
    """Head-based sampling decision for a new root, deterministic on the
    trace id so every process computes the same answer.  Ratio 0 means
    the sampler is off: tracing was enabled explicitly (hook/configure)
    and records everything, the pre-sampling behavior."""
    ratio = _ratio()
    if ratio <= 0.0 or ratio >= 1.0:
        return True
    return (trace_id & ((1 << 64) - 1)) < int(ratio * (1 << 64))


def maybe_enable_from_config() -> None:
    """Auto-enable tracing when RAY_TPU_TORCH_TRACE_SAMPLE > 0 — sampled spans
    then flow to the control collector without any startup hook."""
    if not _enabled and _ratio() > 0.0:
        enable()


# -- context propagation -----------------------------------------------------

def inject_context() -> Optional[Dict[str, str]]:
    """Current span context as a W3C traceparent carrier.  The flags
    byte carries the real sampling decision (01 sampled, 00 not) so a
    sampled-out parent suppresses the whole downstream subtree.  All
    suppressed contexts share one constant carrier — downstream only
    ever reads the flags bit, so the ids carry no information."""
    ctx = _current()
    if not _enabled or ctx is None:
        return None
    if not ctx.get("sampled", True):
        return _SUPPRESSED_CARRIER
    return {"traceparent":
            f"00-{ctx['trace_id']:032x}-{ctx['span_id']:016x}-01"}


def frame_traceparent() -> Optional[str]:
    """Traceparent for RPC frame meta — only for SAMPLED contexts.
    Suppressed contexts return None so the per-frame meta dict + string
    formatting cost vanishes from untraced requests; frame-level SERVER
    spans only exist for sampled traces anyway (suppression crosses
    processes in the task spec's carrier, not the frame meta)."""
    ctx = _current()
    if not _enabled or ctx is None or not ctx.get("sampled", True):
        return None
    return f"00-{ctx['trace_id']:032x}-{ctx['span_id']:016x}-01"


def _extract(carrier: Optional[Dict[str, str]]
             ) -> Optional[Dict[str, Any]]:
    tp = (carrier or {}).get("traceparent", "")
    parts = tp.split("-")
    if len(parts) != 4:
        return None
    try:
        return {"trace_id": int(parts[1], 16),
                "span_id": int(parts[2], 16),
                "sampled": bool(int(parts[3], 16) & 0x01)}
    except ValueError:
        return None


def carrier_sampled(carrier: Optional[Dict[str, str]]) -> bool:
    """Cheap hot-path check: does this carrier mark a sampled trace?
    The sampled bit is the flags byte's low bit — the traceparent's
    last hex digit is odd iff sampled, so one suffix probe replaces the
    full split-and-parse on the 99% sampled-out path."""
    if not carrier:
        return False
    return carrier.get("traceparent", "")[-1:] in "13579bdf"


def _emit(record: Dict[str, Any]) -> None:
    if _proc:
        record["proc"] = _proc
    if _sink is not None:
        try:
            _sink(record)
        except Exception:
            logger.exception("span sink failed")
    buf = _buffer
    if buf is not None:
        buf.add(record)


def _format(span: Dict[str, Any]) -> Dict[str, Any]:
    record = dict(span)
    record["trace_id"] = f"{span['trace_id']:032x}"
    record["span_id"] = f"{span['span_id']:016x}"
    if span["parent_id"] is not None:
        record["parent_id"] = f"{span['parent_id']:016x}"
    return record


def _span(name: str, kind: str,
          parent: Optional[Dict[str, Any]], **attrs):
    """Dispatch to the cheapest context manager that preserves the
    sampling semantics.  Sampled-out spans never reach the recording
    generator: an inherited suppressed context is already in place
    (_NULL_CM), an explicit suppressed parent only needs the shared
    suppressed context installed (_Suppressed), and a sampled-out new
    root likewise — no ids minted, no span dict built."""
    if not _enabled:
        return _NULL_CM
    explicit = parent is not None
    if parent is None:
        parent = _current()
    if parent is not None:
        if not parent.get("sampled", True):
            # the contextvar already holds a suppressed context when the
            # parent was inherited from it — nothing to install
            return _Suppressed() if explicit else _NULL_CM
        trace_id = parent["trace_id"]
        parent_sid = parent["span_id"]
    else:
        trace_id = _new_id(16)
        if not sample_trace(trace_id):
            return _Suppressed()
        parent_sid = None
    return _recording_span(name, kind, trace_id, parent_sid, attrs)


@contextlib.contextmanager
def _recording_span(name: str, kind: str, trace_id: int,
                    parent_sid: Optional[int], attrs: Dict[str, Any]):
    span_id = _new_id(8)
    token = _ctx.set({"trace_id": trace_id, "span_id": span_id,
                      "sampled": True})
    span = {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_sid,
        "kind": kind,
        "start_ns": time.time_ns(),
        "attributes": {k: v for k, v in attrs.items() if v is not None},
    }
    try:
        yield span
    finally:
        _ctx.reset(token)
        span["end_ns"] = time.time_ns()
        _emit(_format(span))


def record_span(name: str, kind: str, start_ns: int, end_ns: int,
                parent: Optional[Dict[str, Any]], **attrs) -> None:
    """Emit a retro-timed span from already-measured timestamps — the
    hot-path phases (stage-wait, queue-wait, ack-linger) are measured as
    plain clock reads on the fast path and only materialized into spans
    here, after the fact, for sampled traces.  No contextvar is touched.
    Requires an explicit sampled parent: retro phases never mint roots."""
    if not _enabled or parent is None or not parent.get("sampled", True):
        return
    _emit(_format({
        "name": name,
        "trace_id": parent["trace_id"],
        "span_id": _new_id(8),
        "parent_id": parent["span_id"],
        "kind": kind,
        "start_ns": int(start_ns),
        "end_ns": int(end_ns),
        "attributes": {k: v for k, v in attrs.items() if v is not None},
    }))


def span(name: str, kind: str = "INTERNAL", **attrs):
    """Public INTERNAL span, auto-parented to the current context — a
    span opened inside task execution links to the submitting task's
    trace through the propagated traceparent (the collective layer uses
    this so a stalled allreduce shows up under the task that issued it).
    No-op contextmanager when tracing is disabled."""
    return _span(name, kind, None, **attrs)


def phase_span(name: str, carrier: Optional[Dict[str, str]], **attrs):
    """INTERNAL span for a hot-path phase, parented to the trace carried
    in ``carrier`` (a task spec's ``trace_ctx``).  No-op when tracing is
    off or the carrier is absent/unsampled — batch phases only show up
    in traces that already exist."""
    if not _enabled or not carrier_sampled(carrier):
        return _NULL_CM
    return _span(name, "INTERNAL", _extract(carrier), **attrs)


def submit_span(kind: str, name: str):
    """PRODUCER span around task/actor submission (driver side)."""
    return _span(f"{kind} {name}", "PRODUCER", None)


def execute_span(kind: str, name: str,
                 carrier: Optional[Dict[str, str]], **attrs):
    """CONSUMER span around task execution (worker side), linked to the
    submitting span via the propagated traceparent.  A sampled-out
    carrier skips the parse entirely: only the suppressed context needs
    installing so spans opened inside the task suppress themselves."""
    if _enabled and carrier is not None and not carrier_sampled(carrier):
        return _Suppressed()
    return _span(f"{kind}.execute {name}", "CONSUMER",
                 _extract(carrier), **attrs)


def rpc_client_span(method: str, **attrs):
    """CLIENT span around one framed-RPC round trip.  Only opened when a
    span context is already active, so the control-plane conversation of
    a traced task (submit -> lease -> push -> reply) nests under the
    task's PRODUCER span instead of flooding the trace with orphans."""
    ctx = _current()
    if not _enabled or ctx is None:
        return _NULL_CM
    if not ctx.get("sampled", True):
        return _NULL_CM  # suppressed context already active, keep it
    return _span(f"rpc {method}", "CLIENT", None, **attrs)


def rpc_server_span(method: str, carrier: Optional[Dict[str, str]],
                    **attrs):
    """SERVER span around handler execution, linked to the caller's
    CLIENT span via the traceparent carried in the frame meta.  No-op
    without a parseable carrier: a server span never mints a root."""
    if not _enabled or not carrier:
        return _NULL_CM
    tp = carrier.get("traceparent", "")
    if len(tp) != 55:  # 2+1+32+1+16+1+2: not a parseable traceparent
        return _NULL_CM
    if tp[-1:] not in "13579bdf":
        return _Suppressed()  # sampled-out caller: suppress, don't parse
    ctx = _extract(carrier)
    if ctx is None:
        return _NULL_CM
    return _span(f"rpc.handle {method}", "SERVER", ctx, **attrs)


# -- span buffer + batched flusher (central collection) ----------------------

class SpanBuffer:
    """Bounded per-process span ring drained by a daemon flush thread
    into batched ``report_spans`` pushes — same shape as the task-event
    buffer (``_private/task_events.py``): drop-oldest at capacity with
    drop accounting, bounded re-queue when the control plane blips."""

    def __init__(self, transport: Callable[[Dict[str, Any]], None], *,
                 cap: int = 4096, interval_s: float = 0.5,
                 common: Optional[Dict[str, Any]] = None):
        self._transport = transport
        self._cap = cap
        self._common = dict(common or {})
        self._lock = threading.Lock()
        self._spans: Deque[Dict[str, Any]] = collections.deque(
            maxlen=cap)  # guarded-by: _lock
        self._dropped = 0            # guarded-by: _lock
        self._flushed_batches = 0    # guarded-by: _lock
        self._flushed_spans = 0      # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._flush_loop, name="trace-spans-flush", daemon=True)
        self._interval_s = interval_s
        self._thread.start()

    def add(self, span: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._spans) == self._cap:
                self._dropped += 1  # maxlen evicts the oldest on append
            self._spans.append(span)

    def _flush_loop(self) -> None:
        while not self._stop_evt.wait(self._interval_s):
            self.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._spans and not self._dropped:
                return
            batch = list(self._spans)
            self._spans.clear()
            dropped = self._dropped
            self._dropped = 0
        payload = {"spans": batch, "dropped": dropped,
                   "common": self._common}
        try:
            self._transport(payload)
            with self._lock:
                self._flushed_batches += 1
                self._flushed_spans += len(batch)
        except Exception:
            # control plane unreachable: re-queue (bounded) so a blip
            # doesn't lose the window; anything cut off the front counts
            # as dropped and the count retries with the next success
            with self._lock:
                merged = batch + list(self._spans)
                cut = max(0, len(merged) - self._cap)
                self._spans = collections.deque(merged[cut:],
                                                maxlen=self._cap)
                self._dropped += dropped + cut

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"buffered": len(self._spans),
                    "flushed_batches": self._flushed_batches,
                    "flushed_spans": self._flushed_spans,
                    "dropped": self._dropped}

    def stop(self) -> None:
        self._stop_evt.set()
        self.flush()


_buffer: Optional[SpanBuffer] = None


def ensure_collector(control_client, *, proc: str = "",
                     worker_id: str = "", node_id: str = "",
                     job_id: str = "") -> None:
    """Install the central span collector for this process: enables
    tracing if RAY_TPU_TORCH_TRACE_SAMPLE asks for it, then (if tracing is on
    and no buffer exists yet) starts a SpanBuffer flushing batched
    ``report_spans`` notifies over the given control-plane client.
    Idempotent; safe to call from driver, raylet, and worker startup."""
    global _buffer
    maybe_enable_from_config()
    if not _enabled or _buffer is not None or control_client is None:
        return
    if proc:
        set_process(proc)
    try:
        from ray_tpu_torch._private.config import cfg
        c = cfg()
        cap = int(getattr(c, "trace_buffer_cap", 4096))
        interval = float(getattr(c, "trace_flush_interval_s", 0.5))
    except Exception:
        cap, interval = 4096, 0.5
    _buffer = SpanBuffer(
        lambda payload: control_client.notify("report_spans", payload),
        cap=cap, interval_s=interval,
        common={"worker_id": worker_id, "node_id": node_id,
                "job_id": job_id, "proc": proc or _proc})


def detach_collector() -> None:
    """Stop the span buffer (final flush included); used at shutdown and
    by tests that cycle init/shutdown in one process."""
    global _buffer
    buf, _buffer = _buffer, None
    if buf is not None:
        try:
            buf.stop()
        except Exception:
            pass


def buffer_stats() -> Optional[Dict[str, int]]:
    buf = _buffer
    return buf.stats() if buf is not None else None


# -- built-in file exporter hook --------------------------------------------

class _FileExporter:
    """Line-oriented JSONL appender holding ONE open handle: the old
    exporter reopened the file and took a global lock per span, which
    serialized every traced worker through a syscall storm.  Writes are
    line-buffered; an explicit flush lands every FLUSH_EVERY spans and
    ``close()`` (atexit-registered) drains so worker exit never
    truncates the trace."""

    FLUSH_EVERY = 64

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)  # guarded-by: _lock
        self._since_flush = 0                   # guarded-by: _lock
        atexit.register(self.close)

    def __call__(self, span: Dict[str, Any]) -> None:
        line = json.dumps(span) + "\n"
        with self._lock:
            if self._f is None:
                return
            self._f.write(line)
            self._since_flush += 1
            if self._since_flush >= self.FLUSH_EVERY:
                self._since_flush = 0
                self._f.flush()

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.flush()
                f.close()
            except Exception:
                pass


_file_exporter: Optional[_FileExporter] = None


def setup_file_exporter(config: Optional[Dict[str, Any]] = None) -> None:
    """Startup hook: append finished spans as JSON lines to
    ``config["trace_file"]`` through a persistent buffered appender."""
    global _file_exporter
    path = (config or {}).get("trace_file")
    if not path:
        return
    _file_exporter = _FileExporter(path)
    configure(_file_exporter)


def register_hook(control, hook: str,
                  config: Optional[Dict[str, Any]] = None) -> None:
    """Driver side: record the startup hook so workers apply it too."""
    control.call("kv_put", {
        "ns": KV_NS, "key": "hook",
        "val": json.dumps({"hook": hook, "config": config or {}}).encode(),
        "overwrite": True,
    }, timeout=30.0)


def apply_hook_from_kv(control) -> None:
    """Worker side: pick up and run the registered startup hook."""
    try:
        raw = control.call("kv_get", {"ns": KV_NS, "key": "hook"},
                           timeout=10.0)
    except Exception:
        return
    if not raw:
        return
    try:
        rec = json.loads(raw.decode() if isinstance(raw, bytes) else raw)
        run_hook(rec["hook"], rec.get("config") or {})
    except Exception:
        logger.exception("tracing startup hook failed")


def run_hook(hook: str, config: Optional[Dict[str, Any]] = None) -> None:
    """Import and call a ``module:function`` hook, then enable tracing."""
    import importlib

    mod_name, _, fn_name = hook.partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    try:
        fn(config)
    except TypeError:
        fn()
    enable()
