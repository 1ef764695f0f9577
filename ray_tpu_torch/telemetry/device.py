"""Device runtime observability: the program ledger + card memory census.

The port's counterpart of ``ray_tpu/telemetry/device.py``.  Everything
above the device is instrumented — steps are timed, RPCs counted, the
task hot path traced — and this module watches the device layer itself:
which programs ran with which input signatures, and what the card's
memory holds.  Pod-scale runs live or die on warm-up time and
per-replica memory headroom (arXiv:1909.09756), and the KV page arena
is the memory budget that decides a serving engine's admission.

``CompilationLedger``
    Eager PyTorch compiles nothing per call, so the ledger keeps the
    reference's name, snapshot schema and advisory rules with a
    program's *input signature* in place of an XLA executable: a program
    is a callable wrapped by ``instrument(fn, name=)``, and an event is
    recorded at the first call with a signature the program has not seen
    (shapes, dtypes and devices of its tensor arguments, the values of
    the others), its seconds that first call's wall time.  A new
    signature after the first gets a **cause diff** against the previous
    one (which argument changed shape, dtype, device, static value or
    structure), and a sliding window per program detects **recompile
    storms** — in the port, unstable shapes: a program fed a new
    signature every few calls — publishing an advisory on the "train"
    pubsub topic once per episode.  The ``nvcc`` / ``g++`` builds of the
    port's kernels and native libraries are events of the program
    ``kernels.build``, each with its build time in ``backend_s``; they
    count toward no storm.  The reference's ``jax.monitoring`` durations
    and executable cost/memory analysis have no counterpart: opt-in
    analysis records why it has no fields.

``DeviceMemoryCensus``
    Walks the CUDA tensors that Python can reach (``gc``), counting each
    storage once (a view adds nothing), by dtype and shape, beside the
    caching allocator's ``memory_allocated`` / ``memory_reserved`` per
    card, plus registered owner reports — the serve engine registers its
    ``PageAllocator`` arena occupancy (free / used / shared / COW
    pages) and the emergency vault its footprint.  Crossing a configured
    watermark of the walked ``total_bytes`` publishes a
    ``memory_watermark`` advisory with the same episode semantics.

Snapshots flush to control-plane KV namespace ``_device`` (keyed
``device:<worker_id>``) over the same rate-limited, never-raises path
as the flight recorder, and surface through ``python -m ray_tpu_torch
device-stats``, ``GET /api/device/stats``, Prometheus series (the
reference's names: ``ray_tpu_compile_seconds``,
``ray_tpu_recompiles_total``, ``ray_tpu_hbm_live_bytes``,
``ray_tpu_kv_pages{state=…}``) and Chrome-trace compile slices.  The
module loads no torch: it reads ``torch`` from ``sys.modules`` only
where the process already has it.
"""

from __future__ import annotations

import gc
import functools
import inspect
import os
import pickle
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..util import metrics as metrics_mod

#: control-plane KV namespace for device snapshots.  Deliberately NOT
#: ``_metrics``: collect_cluster_metrics json-merges every key there.
DEVICE_NS = "_device"
DEVICE_KEY_PREFIX = "device:"

_COMPILE_BOUNDARIES = [0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                       5, 10, 30, 60, 120, 300]

_tls = threading.local()

# Strong refs so the weakref metric registry keeps these alive.
_metric_lock = threading.Lock()
_metric_cache: Dict[str, Any] = {}


def _get_metric(key: str, factory: Callable[[], Any]) -> Any:
    with _metric_lock:
        m = _metric_cache.get(key)
        if m is None:
            m = _metric_cache[key] = factory()
        return m


def _compile_histogram():
    return _get_metric("compile_hist", lambda: metrics_mod.Histogram(
        "ray_tpu_compile_seconds",
        description="First call per new input signature (s), per program",
        boundaries=_COMPILE_BOUNDARIES,
        tag_keys=("program",)))


def _recompile_counter():
    return _get_metric("recompile_ctr", lambda: metrics_mod.Counter(
        "ray_tpu_recompiles_total",
        description="New input signatures after a program's first",
        tag_keys=("program",)))


def _hbm_gauge():
    return _get_metric("hbm_gauge", lambda: metrics_mod.Gauge(
        "ray_tpu_hbm_live_bytes",
        description="Live CUDA tensor bytes (census walk)"))


def _kv_pages_gauge():
    return _get_metric("kv_pages", lambda: metrics_mod.Gauge(
        "ray_tpu_kv_pages",
        description="KV page arena occupancy by state "
                    "(free/used live; shared/cow cumulative)",
        tag_keys=("state",)))


def _default_publish(payload: Dict[str, Any]) -> None:
    """Advisories ride the existing "train" pubsub topic (the same one
    StepAggregator straggler advisories use) so RemediationEngine and
    dashboards need no new subscription."""
    from ray_tpu_torch._private import core as core_mod

    core = core_mod._current_core
    if core is None or getattr(core, "_shutdown", False):
        return
    core.control.call("publish", {"topic": "train", "payload": payload},
                      timeout=5.0)


# ---------------------------------------------------------------------------
# Signature fingerprints + cause diffs
# ---------------------------------------------------------------------------


def _is_arraylike(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype") \
        and not inspect.isclass(x)


def _dtype_name(dtype: Any) -> str:
    """"float32" for numpy's and torch's float32 alike."""
    return str(dtype).replace("torch.", "")


def _leaf_desc(x: Any) -> Dict[str, Any]:
    if _is_arraylike(x):
        d = {"kind": "array",
             "shape": tuple(int(s) for s in x.shape),
             "dtype": _dtype_name(x.dtype),
             "weak_type": bool(getattr(x, "weak_type", False))}
        dev = getattr(x, "device", None)
        if dev is not None and not isinstance(dev, str) \
                and hasattr(dev, "type"):
            d["device"] = str(dev)
        return d
    return {"kind": "static", "value": repr(x)[:80]}


def _flatten(x: Any, path: str = "") -> Tuple[List[Tuple[str, Any]], str]:
    """(leaves with their ``keystr``-style paths, a structure string) of
    nested dicts, lists and tuples — the pytree flatten the reference
    takes from ``jax.tree_util``."""
    if isinstance(x, dict):
        leaves: List[Tuple[str, Any]] = []
        parts = []
        for k in sorted(x, key=repr):
            sub, st = _flatten(x[k], f"{path}[{k!r}]")
            leaves += sub
            parts.append(f"{k!r}: {st}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(x, (list, tuple)):
        leaves = []
        parts = []
        for i, v in enumerate(x):
            sub, st = _flatten(v, f"{path}[{i}]")
            leaves += sub
            parts.append(st)
        o, c = ("[", "]") if isinstance(x, list) else ("(", ")")
        return leaves, o + ", ".join(parts) + c
    return [(path, x)], "*"


def _describe(x: Any) -> Dict[str, Any]:
    """Bounded structural descriptor of one call argument."""
    if _is_arraylike(x) or x is None or isinstance(
            x, (int, float, bool, complex, str, bytes)):
        return _leaf_desc(x)
    if isinstance(x, (dict, list, tuple)):
        flat, treedef = _flatten(x)
        leaves = [{"path": path, **_leaf_desc(leaf)}
                  for path, leaf in flat[:32]]
        return {"kind": "pytree", "num_leaves": len(flat),
                "treedef": treedef[:120], "leaves": leaves}
    return {"kind": "static", "value": repr(x)[:80]}


def _signature_key(args: Tuple, kwargs: Dict[str, Any],
                   dynamic: Tuple[int, ...] = (),
                   dynamic_names: Tuple[str, ...] = ()) -> Tuple:
    """Hashable input signature of one call: every tensor leaf's shape,
    dtype and device, every other leaf's value, and the nesting (what
    decides whether a program meets new shapes).  Arguments at the
    ``dynamic`` positions or named in ``dynamic_names`` count by type
    alone, as a Python scalar traced by ``jax.jit`` does.  Unlike
    ``_describe`` it is not truncated, and it is cheap: one pass over the
    leaves."""
    if dynamic or dynamic_names:
        args = tuple(type(a) if i in dynamic else a
                     for i, a in enumerate(args))
        kwargs = {k: type(v) if k in dynamic_names else v
                  for k, v in kwargs.items()}
    out: List[Any] = []

    append = out.append

    def walk(x: Any) -> None:
        if isinstance(x, dict):
            append(("{", len(x)))
            for k, v in x.items():
                append(k)
                walk(v)
        elif isinstance(x, (list, tuple)):
            append(("[", len(x)))
            for v in x:
                walk(v)
        elif hasattr(x, "shape") and hasattr(x, "dtype") \
                and not isinstance(x, type):
            append((x.shape, x.dtype, getattr(x, "device", None)))
        else:
            append(repr(x)[:200])

    walk(args)
    walk(kwargs)
    return tuple(out)


def _fmt_desc(d: Dict[str, Any]) -> str:
    if d.get("kind") == "array":
        shape = ",".join(str(s) for s in d.get("shape", ()))
        weak = "~" if d.get("weak_type") else ""
        dev = f"@{d['device']}" if d.get("device") not in (None, "cpu") \
            else ""
        return f"{weak}{d.get('dtype')}[{shape}]{dev}"
    if d.get("kind") == "pytree":
        return f"pytree({d.get('num_leaves')} leaves)"
    return str(d.get("value"))


def _fingerprint(sig: Optional[inspect.Signature], args: Tuple,
                 kwargs: Dict[str, Any],
                 dynamic_names: Tuple[str, ...] = ()
                 ) -> List[Dict[str, Any]]:
    """Per-arg descriptors, named from the wrapped fn's signature when
    it binds (fallback: positional ``argN``); a dynamic argument is
    described by its type."""
    named: List[Tuple[str, Any]] = []
    if sig is not None:
        try:
            bound = sig.bind_partial(*args, **kwargs)
            named = list(bound.arguments.items())
        except TypeError:
            named = []
    if not named:
        named = [(f"arg{i}", a) for i, a in enumerate(args)]
        named += sorted(kwargs.items())
    return [{"arg": name, **(
                {"kind": "static", "value": f"<{type(val).__name__}>"}
                if name in dynamic_names else _describe(val))}
            for name, val in named]


def _diff_entry(name: str, old: Dict[str, Any],
                new: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Field-level diff of one argument's descriptor (old vs new)."""
    if old.get("kind") != new.get("kind"):
        return [{"arg": name, "kind": "type",
                 "old": _fmt_desc(old), "new": _fmt_desc(new)}]
    kind = new.get("kind")
    out: List[Dict[str, Any]] = []
    if kind == "array":
        for field, label in (("shape", "shape"), ("dtype", "dtype"),
                             ("device", "device"),
                             ("weak_type", "weak_type")):
            if old.get(field) != new.get(field):
                out.append({"arg": name, "kind": label,
                            "old": _fmt_desc(old), "new": _fmt_desc(new)})
        return out
    if kind == "pytree":
        if (old.get("num_leaves") != new.get("num_leaves")
                or old.get("treedef") != new.get("treedef")):
            return [{"arg": name, "kind": "structure",
                     "old": _fmt_desc(old), "new": _fmt_desc(new)}]
        for o_leaf, n_leaf in zip(old.get("leaves", []),
                                  new.get("leaves", [])):
            if o_leaf != n_leaf:
                leaf_name = f"{name}{n_leaf.get('path', '')}"
                out.extend(_diff_entry(leaf_name,
                                       {k: v for k, v in o_leaf.items()
                                        if k != "path"},
                                       {k: v for k, v in n_leaf.items()
                                        if k != "path"}))
        return out
    if old.get("value") != new.get("value"):
        return [{"arg": name, "kind": "static",
                 "old": str(old.get("value")), "new": str(new.get("value"))}]
    return out


def diff_signatures(old: List[Dict[str, Any]],
                    new: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """All per-arg changes between two compile fingerprints."""
    changes: List[Dict[str, Any]] = []
    old_map = {e["arg"]: e for e in old}
    new_names = set()
    for e in new:
        name = e["arg"]
        new_names.add(name)
        o = old_map.get(name)
        if o is None:
            changes.append({"arg": name, "kind": "added",
                            "old": None, "new": _fmt_desc(e)})
        else:
            changes.extend(_diff_entry(name, o, e))
    for e in old:
        if e["arg"] not in new_names:
            changes.append({"arg": e["arg"], "kind": "removed",
                            "old": _fmt_desc(e), "new": None})
    return changes


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------


class _ProgramState:
    """Per-program compile history (owned by the ledger, all access
    under the ledger's lock)."""

    __slots__ = ("name", "compiles", "recompiles", "last_signature",
                 "last_cause", "last_compile_wall", "last_compile_mono",
                 "compile_times", "storm_open", "storm_episodes",
                 "durations_total")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.recompiles = 0
        self.last_signature: Optional[List[Dict[str, Any]]] = None
        self.last_cause: Optional[Dict[str, Any]] = None
        self.last_compile_wall = 0.0
        self.last_compile_mono = 0.0
        self.compile_times: deque = deque(maxlen=64)  # mono stamps
        self.storm_open = False
        self.storm_episodes = 0
        self.durations_total: Dict[str, float] = {}


class CompilationLedger:
    """Per-process program ledger (the reference's XLA compilation
    ledger, keyed by input signature in the port).

    Thread-safe; the per-call fast path (a signature the program has
    seen) costs one pass over the call's leaves and a set lookup, no
    lock.  Records, program state and advisories are guarded by
    ``_lock``.
    """

    def __init__(self, max_records: int = 256,
                 storm_threshold: Optional[int] = None,
                 storm_window_s: Optional[float] = None,
                 analysis: Optional[bool] = None,
                 publish: Optional[Callable[[Dict[str, Any]], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        if storm_threshold is None:
            storm_threshold = int(os.environ.get(
                "RAY_TPU_TORCH_DEVICE_STORM_THRESHOLD", "4"))
        if storm_window_s is None:
            storm_window_s = float(os.environ.get(
                "RAY_TPU_TORCH_DEVICE_STORM_WINDOW_S", "30"))
        if analysis is None:
            analysis = os.environ.get(
                "RAY_TPU_TORCH_DEVICE_ANALYSIS", "0") not in ("0", "", "false")
        self.storm_threshold = max(2, int(storm_threshold))
        self.storm_window_s = float(storm_window_s)
        self.analysis = bool(analysis)
        self._publish = publish or _default_publish
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._programs: Dict[str, _ProgramState] = {}  # guarded-by: _lock
        self._records: deque = deque(maxlen=max(1, int(max_records)))  # guarded-by: _lock
        self._advisories: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._total_compiles = 0   # guarded-by: _lock
        self._total_recompiles = 0  # guarded-by: _lock
        self._drain_idx = 0  # guarded-by: _lock
        self._last_flush = 0.0  # rate limiter state (monotonic)

    # -- instrumentation entry points ---------------------------------

    def instrument(self, fn: Any, name: Optional[str] = None,
                   analysis: Optional[bool] = None,
                   dynamic_argnames: Tuple[str, ...] = ()
                   ) -> "InstrumentedProgram":
        """Wrap a callable so its first call with each new input
        signature is recorded under ``name``; ``dynamic_argnames`` count
        by type alone (a seed, a step number).  Idempotent on
        already-instrumented programs."""
        if isinstance(fn, InstrumentedProgram):
            return fn
        return InstrumentedProgram(fn, name=name, ledger=self,
                                   analysis=analysis,
                                   dynamic_argnames=dynamic_argnames)

    # -- record path (called from InstrumentedProgram) ----------------

    def _record_compile(self, prog: "InstrumentedProgram", args: Tuple,
                        kwargs: Dict[str, Any], call_s: float,
                        durations: Dict[str, float]) -> None:
        """One new input signature.  Never raises (observability must
        not take down the workload)."""
        try:
            self._record_compile_inner(prog, args, kwargs, call_s,
                                       durations)
        except Exception:
            pass

    def record_build(self, source: str, seconds: float,
                     compiler: str = "nvcc", cached: bool = False) -> None:
        """One kernel or native library made ready in this process from
        ``source``: an event of the program ``kernels.build`` with the
        compiler's time in ``backend_s`` (0 when a library built earlier
        was loaded from the cache).  Builds are one-off events, so they
        count as no recompile and toward no storm."""
        try:
            self._record_event(
                "kernels.build",
                [{"arg": "source", "kind": "static", "value": source},
                 {"arg": "compiler", "kind": "static", "value": compiler},
                 {"arg": "cached", "kind": "static", "value": repr(cached)}],
                seconds, {"backend_s": 0.0 if cached else float(seconds)},
                None, storm=False)
        except Exception:
            pass

    def _record_compile_inner(self, prog: "InstrumentedProgram",
                              args: Tuple, kwargs: Dict[str, Any],
                              call_s: float,
                              durations: Dict[str, float]) -> None:
        signature = _fingerprint(prog._sig, args, kwargs,
                                 prog._dynamic_names)
        analysis = None
        if prog._analysis if prog._analysis is not None else self.analysis:
            analysis = _analyze_executable(prog._fn, args, kwargs)
        self._record_event(prog.name, signature, call_s, durations,
                           analysis)

    def _record_event(self, name: str, signature: List[Dict[str, Any]],
                      call_s: float, durations: Dict[str, float],
                      analysis: Optional[Dict[str, Any]],
                      storm: bool = True) -> None:
        compile_s = sum(durations.values()) if durations else call_s
        now_wall, now_mono = self._wall(), self._clock()

        advisory = None
        with self._lock:
            st = self._programs.get(name)
            if st is None:
                st = self._programs[name] = _ProgramState(name)
            st.compiles += 1
            self._total_compiles += 1
            cause: Optional[Dict[str, Any]] = None
            is_recompile = storm and st.compiles > 1
            if is_recompile:
                st.recompiles += 1
                self._total_recompiles += 1
                changes = diff_signatures(st.last_signature or [],
                                          signature)
                cause = {"changes": changes}
                if changes:
                    cause.update({"arg": changes[0]["arg"],
                                  "kind": changes[0]["kind"],
                                  "old": changes[0]["old"],
                                  "new": changes[0]["new"]})
                else:
                    cause["note"] = ("the change lies past the 32 "
                                     "leaves a signature describes")
            st.last_signature = signature
            st.last_cause = cause
            st.last_compile_wall = now_wall
            st.last_compile_mono = now_mono
            for k, v in durations.items():
                st.durations_total[k] = st.durations_total.get(k, 0.0) + v
            rec = {
                "program": name,
                "ts": now_wall,
                "nth_compile": st.compiles,
                "call_s": round(call_s, 6),
                "compile_s": round(compile_s, 6),
                "durations": {k: round(v, 6)
                              for k, v in durations.items()},
                "signature": signature,
                "cause": cause,
            }
            if analysis:
                rec["analysis"] = analysis
            self._records.append(rec)

            # storm detection: threshold compiles inside the sliding
            # window opens an episode; one advisory per episode, re-armed
            # only after the window drains.
            if storm:
                st.compile_times.append(now_mono)
            cutoff = now_mono - self.storm_window_s
            while st.compile_times and st.compile_times[0] < cutoff:
                st.compile_times.popleft()
            if st.storm_open and not st.compile_times:
                st.storm_open = False
            if (storm and not st.storm_open
                    and len(st.compile_times) >= self.storm_threshold):
                st.storm_open = True
                st.storm_episodes += 1
                advisory = {
                    "event": "device_advisory",
                    "kind": "recompile_storm",
                    "program": name,
                    "compiles_in_window": len(st.compile_times),
                    "window_s": self.storm_window_s,
                    "threshold": self.storm_threshold,
                    "cause": cause,
                    "ts": now_wall,
                }
                self._advisories.append(advisory)

        try:
            _compile_histogram().observe(compile_s,
                                         tags={"program": name})
            if is_recompile:
                _recompile_counter().inc(1.0, tags={"program": name})
        except Exception:
            pass
        if advisory is not None:
            try:
                self._publish(advisory)
            except Exception:
                pass
        # piggyback the KV flush on the compile path (rate-limited):
        # a storm flushes itself visible without any cooperating loop
        if storm:
            flush_device_snapshot()

    def push_advisory(self, payload: Dict[str, Any],
                      publish: bool = True) -> None:
        """Record (and optionally publish) an externally-raised device
        advisory — the memory census uses this for watermark events."""
        with self._lock:
            self._advisories.append(payload)
        if publish:
            try:
                self._publish(payload)
            except Exception:
                pass

    # -- read side -----------------------------------------------------

    def counts(self) -> Dict[str, int]:
        """Per-program compile counts — the bench zero-recompile gate
        diffs two of these around the timed region."""
        with self._lock:
            return {name: st.compiles
                    for name, st in self._programs.items()}

    def compiles_since(self, mark: Dict[str, int]) -> Dict[str, int]:
        """Programs that compiled since ``mark = ledger.counts()``."""
        now = self.counts()
        out = {}
        for name, n in now.items():
            delta = n - mark.get(name, 0)
            if delta > 0:
                out[name] = delta
        return out

    def storm_advisories(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [a for a in self._advisories
                    if a.get("kind") == "recompile_storm"]

    def drain_advisories(self) -> List[Dict[str, Any]]:
        """Advisories raised since the last drain — driver loops feed
        these to ``RemediationEngine.observe_advisory`` once per round."""
        with self._lock:
            new = list(self._advisories[self._drain_idx:])
            self._drain_idx = len(self._advisories)
            if len(self._advisories) > 512:  # bound the log
                drop = len(self._advisories) - 256
                del self._advisories[:drop]
                self._drain_idx = max(0, self._drain_idx - drop)
            return new

    def snapshot(self) -> Dict[str, Any]:
        """Picklable ledger state for the ``_device`` KV flush."""
        now_mono = self._clock()
        with self._lock:
            programs = {}
            for name, st in self._programs.items():
                if (st.storm_open and st.compile_times
                        and now_mono - st.compile_times[-1]
                        > self.storm_window_s):
                    st.storm_open = False  # episode drained
                programs[name] = {
                    "compiles": st.compiles,
                    "recompiles": st.recompiles,
                    "last_compile_ts": st.last_compile_wall,
                    "last_cause": st.last_cause,
                    "storm_open": st.storm_open,
                    "storm_episodes": st.storm_episodes,
                    "durations_total_s": {
                        k: round(v, 6)
                        for k, v in st.durations_total.items()},
                }
            return {
                "total_compiles": self._total_compiles,
                "total_recompiles": self._total_recompiles,
                "programs": programs,
                "records": list(self._records),
                "advisories": list(self._advisories),
                "storm_threshold": self.storm_threshold,
                "storm_window_s": self.storm_window_s,
            }

    def reset(self) -> None:
        """Forget all state (tests)."""
        with self._lock:
            self._programs.clear()
            self._records.clear()
            self._advisories.clear()
            self._drain_idx = 0
            self._total_compiles = 0
            self._total_recompiles = 0


ANALYSIS_NOTE = ("eager PyTorch builds no executable per program, so "
                 "there is no cost or memory analysis to record (the "
                 "reference reads XLA's)")


def _analyze_executable(fn: Any, args: Tuple,
                        kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Opt-in analysis: the reference lowers and compiles the program
    again for XLA's cost and memory analysis.  The port has none; the
    record says why instead of carrying empty fields."""
    return {"note": ANALYSIS_NOTE}


class InstrumentedProgram:
    """A callable routed through the ledger.

    Transparent: attribute access proxies to the wrapped callable, so
    instrumented programs drop into existing call sites unchanged.
    """

    def __init__(self, fn: Any, name: Optional[str] = None,
                 ledger: Optional["CompilationLedger"] = None,
                 analysis: Optional[bool] = None,
                 dynamic_argnames: Tuple[str, ...] = ()):
        self._fn = fn
        wrapped = getattr(fn, "__wrapped__", None)
        self.name = name or getattr(wrapped, "__qualname__", None) \
            or getattr(fn, "__qualname__", None) \
            or getattr(fn, "__name__", None) or repr(fn)
        self._ledger = ledger
        self._analysis = analysis
        self._seen: set = set()
        self._seen_lock = threading.Lock()
        try:
            self._sig: Optional[inspect.Signature] = \
                inspect.signature(wrapped if wrapped is not None else fn)
        except (TypeError, ValueError):
            self._sig = None
        functools.update_wrapper(self, wrapped or fn, updated=())
        self._dynamic_names = tuple(dynamic_argnames)
        params = list(self._sig.parameters) if self._sig is not None else []
        self._dynamic = tuple(i for i, p in enumerate(params)
                              if p in self._dynamic_names)

    def __call__(self, *args, **kwargs):
        try:
            key = _signature_key(args, kwargs, self._dynamic,
                                 self._dynamic_names)
            with self._seen_lock:
                new = key not in self._seen
                if new:
                    self._seen.add(key)
        except Exception:
            new = False
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if new:
            led = self._ledger if self._ledger is not None \
                else get_ledger()
            led._record_compile(self, args, kwargs,
                                time.perf_counter() - t0, {})
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self):
        return f"<InstrumentedProgram {self.name!r} of {self._fn!r}>"


# ---------------------------------------------------------------------------
# Memory census
# ---------------------------------------------------------------------------


#: the device types whose tensors the census walks (the CPU tests add
#: "cpu" to exercise the walk without a card)
CENSUS_DEVICE_TYPES: Tuple[str, ...] = ("cuda",)


class DeviceMemoryCensus:
    """Samples live device memory and registered owner reports.

    Owners (e.g. the serve engine) register a zero-arg callback
    returning a small dict; a callback reporting a ``pages`` sub-dict
    (``free/used/shared/cow``) feeds the ``ray_tpu_kv_pages`` gauge.
    """

    def __init__(self, watermark_bytes: Optional[int] = None,
                 ledger: Optional[CompilationLedger] = None,
                 wall: Callable[[], float] = time.time):
        if watermark_bytes is None:
            watermark_bytes = int(float(os.environ.get(
                "RAY_TPU_TORCH_DEVICE_WATERMARK_BYTES", "0")))
        self.watermark_bytes = int(watermark_bytes)
        self._ledger = ledger
        self._wall = wall
        self._lock = threading.Lock()
        self._owners: Dict[str, Callable[[], Dict[str, Any]]] = {}  # guarded-by: _lock
        self._watermark_open = False  # guarded-by: _lock

    def register_owner(self, tag: str,
                       report: Callable[[], Dict[str, Any]]) -> None:
        with self._lock:
            self._owners[tag] = report

    def unregister_owner(self, tag: str) -> None:
        with self._lock:
            self._owners.pop(tag, None)

    def _live_buffers(self) -> Dict[str, Any]:
        """The walk: every tensor on a card (``CENSUS_DEVICE_TYPES``) that
        Python can reach, each storage counted once — a view adds no
        bytes — attributed to the largest tensor over it; beside it the
        caching allocator's counters per card.  Tensors only C++ holds
        (autograd's saved activations, a kernel's workspace) show in the
        allocator's numbers alone."""
        t0 = time.perf_counter()
        total = 0
        by_dtype: Dict[str, int] = {}
        shapes: Dict[Tuple[str, Tuple[int, ...]], Dict[str, Any]] = {}
        allocator: Dict[str, Dict[str, int]] = {}
        storages: Dict[Tuple[str, int], Tuple[int, Any]] = {}
        torch = sys.modules.get("torch")
        if torch is not None:
            types = CENSUS_DEVICE_TYPES
            tensor_type = torch.Tensor
            for t in gc.get_objects():
                # type(), not isinstance(): a lazy module proxy answers
                # isinstance's __class__ probe with a warning
                if not issubclass(type(t), tensor_type):
                    continue
                try:
                    if t.device.type not in types:
                        continue
                    st = t.untyped_storage()
                    key = (str(t.device), st.data_ptr())
                    nbytes = int(st.nbytes())
                    held = storages.get(key)
                    if held is None or t.numel() > held[1].numel():
                        storages[key] = (nbytes, t)
                except Exception:
                    continue  # sparse / meta layouts have no storage
            if torch.cuda.is_initialized():
                for i in range(torch.cuda.device_count()):
                    allocator[f"cuda:{i}"] = {
                        "allocated_bytes": int(
                            torch.cuda.memory_allocated(i)),
                        "reserved_bytes": int(
                            torch.cuda.memory_reserved(i))}
        for nbytes, t in storages.values():
            dt = _dtype_name(t.dtype)
            shp = tuple(int(d) for d in t.shape)
            total += nbytes
            by_dtype[dt] = by_dtype.get(dt, 0) + nbytes
            slot = shapes.get((dt, shp))
            if slot is None:
                slot = shapes[(dt, shp)] = {"dtype": dt, "shape": list(shp),
                                            "count": 0, "bytes": 0}
            slot["count"] += 1
            slot["bytes"] += nbytes
        storages.clear()
        top = sorted(shapes.values(), key=lambda s: -s["bytes"])[:12]
        return {"total_bytes": total, "count": sum(
                    s["count"] for s in shapes.values()),
                "by_dtype": by_dtype, "top_shapes": top,
                "allocator": allocator,
                "walk_s": round(time.perf_counter() - t0, 6)}

    def census(self) -> Dict[str, Any]:
        """One sample: live buffers + owner reports + gauges, plus a
        watermark advisory (once per above-watermark episode)."""
        live = self._live_buffers()
        with self._lock:
            owners = dict(self._owners)
        reports: Dict[str, Dict[str, Any]] = {}
        for tag, cb in owners.items():
            try:
                reports[tag] = dict(cb())
            except Exception:
                reports[tag] = {"error": "owner report failed"}
        try:
            # built-in owner: this process's emergency-vault footprint
            # (elastic/emergency.py) — recovery headroom competes with
            # the KV arena for the same HBM budget
            from ..elastic.emergency import vault_footprint

            vf = vault_footprint()
            if vf.get("entries"):
                reports["emergency_vault"] = vf
        except Exception:
            pass

        try:
            _hbm_gauge().set(float(live["total_bytes"]))
            for rep in reports.values():
                pages = rep.get("pages")
                if isinstance(pages, dict):
                    for state in ("free", "used", "shared", "cow"):
                        if state in pages:
                            _kv_pages_gauge().set(
                                float(pages[state]),
                                tags={"state": state})
        except Exception:
            pass

        advisory = None
        with self._lock:
            if self.watermark_bytes > 0:
                over = live["total_bytes"] >= self.watermark_bytes
                if over and not self._watermark_open:
                    self._watermark_open = True
                    advisory = {
                        "event": "device_advisory",
                        "kind": "memory_watermark",
                        "live_bytes": live["total_bytes"],
                        "watermark_bytes": self.watermark_bytes,
                        "ts": self._wall(),
                    }
                elif (not over and self._watermark_open
                      and live["total_bytes"]
                      < 0.9 * self.watermark_bytes):
                    self._watermark_open = False  # hysteresis re-arm
        if advisory is not None:
            led = self._ledger if self._ledger is not None else get_ledger()
            led.push_advisory(advisory)
        return {"ts": self._wall(), "live": live, "owners": reports,
                "watermark_bytes": self.watermark_bytes}


# ---------------------------------------------------------------------------
# Process singletons + module-level entry points
# ---------------------------------------------------------------------------

_singleton_lock = threading.Lock()
_ledger: Optional[CompilationLedger] = None
_census: Optional[DeviceMemoryCensus] = None


def get_ledger() -> CompilationLedger:
    global _ledger
    with _singleton_lock:
        if _ledger is None:
            _ledger = CompilationLedger()
        return _ledger


def get_census() -> DeviceMemoryCensus:
    global _census
    with _singleton_lock:
        if _census is None:
            _census = DeviceMemoryCensus()
        return _census


def instrument(fn: Any, name: Optional[str] = None,
               analysis: Optional[bool] = None,
               dynamic_argnames: Tuple[str, ...] = ()
               ) -> InstrumentedProgram:
    """Route a callable through the process ledger::

        step = device.instrument(step_fn, name="train.step")
    """
    return get_ledger().instrument(fn, name=name, analysis=analysis,
                                   dynamic_argnames=dynamic_argnames)


def reset_for_tests() -> None:
    """Fresh singletons (unit tests share one process)."""
    global _ledger, _census
    with _singleton_lock:
        _ledger = None
        _census = None


# ---------------------------------------------------------------------------
# KV flush + cluster read side
# ---------------------------------------------------------------------------


def device_snapshot() -> Dict[str, Any]:
    """The local process's full device-observability snapshot."""
    return {
        "ts": time.time(),
        "ledger": get_ledger().snapshot(),
        "memory": get_census().census(),
    }


def flush_device_snapshot(interval_s: float = 2.0,
                          force: bool = False) -> bool:
    """Ship the device snapshot to control-plane KV ns ``_device``
    (rate-limited, never raises — the flight recorder's
    ``flush_snapshot`` contract)."""
    led = get_ledger()
    now = time.monotonic()
    if not force and interval_s > 0 and \
            now - led._last_flush < interval_s:
        return False
    try:
        from ray_tpu_torch._private import core as core_mod

        from .recorder import _kick_reattach

        core = core_mod._current_core
        if core is None or getattr(core, "_shutdown", False):
            return False
        led._last_flush = now
        cli = core.control
        if getattr(cli, "closed", False):
            _kick_reattach(core, cli)
            return False
        snap = device_snapshot()
        snap["worker_id"] = core.worker_id
        try:
            cli.call("kv_put", {
                "ns": DEVICE_NS,
                "key": f"{DEVICE_KEY_PREFIX}{core.worker_id}",
                "val": pickle.dumps(snap),
            }, timeout=5.0)
        except Exception:
            _kick_reattach(core, cli)
            return False
        return True
    except Exception:
        return False


def collect_device_stats(control_client) -> Dict[str, Any]:
    """Cluster-wide merge of every worker's ``_device`` snapshot — the
    shared read side for the dashboard route, the CLI and the state
    API."""
    workers: Dict[str, Dict[str, Any]] = {}
    try:
        keys = control_client.call(
            "kv_keys", {"ns": DEVICE_NS, "prefix": DEVICE_KEY_PREFIX},
            timeout=10.0) or []
        for k in keys:
            raw = control_client.call(
                "kv_get", {"ns": DEVICE_NS, "key": k}, timeout=10.0)
            if raw is None:
                continue
            try:
                snap = pickle.loads(raw)
            except Exception:
                continue
            wid = snap.get("worker_id") or k[len(DEVICE_KEY_PREFIX):]
            workers[wid] = snap
    except Exception:
        pass

    programs: Dict[str, Dict[str, Any]] = {}
    advisories: List[Dict[str, Any]] = []
    total_compiles = 0
    total_recompiles = 0
    live_bytes = 0
    for wid, snap in workers.items():
        led = snap.get("ledger") or {}
        total_compiles += int(led.get("total_compiles", 0))
        total_recompiles += int(led.get("total_recompiles", 0))
        for name, st in (led.get("programs") or {}).items():
            agg = programs.setdefault(name, {
                "compiles": 0, "recompiles": 0, "storm_episodes": 0,
                "workers": 0, "last_cause": None, "last_compile_ts": 0.0})
            agg["compiles"] += int(st.get("compiles", 0))
            agg["recompiles"] += int(st.get("recompiles", 0))
            agg["storm_episodes"] += int(st.get("storm_episodes", 0))
            agg["workers"] += 1
            if st.get("last_compile_ts", 0.0) >= agg["last_compile_ts"]:
                agg["last_compile_ts"] = st.get("last_compile_ts", 0.0)
                if st.get("last_cause") is not None:
                    agg["last_cause"] = st.get("last_cause")
        for adv in (led.get("advisories") or []):
            advisories.append({**adv, "worker_id": wid})
        mem = snap.get("memory") or {}
        live_bytes += int((mem.get("live") or {}).get("total_bytes", 0))
    advisories.sort(key=lambda a: a.get("ts", 0.0))
    return {
        "workers": workers,
        "programs": programs,
        "advisories": advisories,
        "total_compiles": total_compiles,
        "total_recompiles": total_recompiles,
        "live_bytes": live_bytes,
    }


def compile_trace_events(workers: Dict[str, Dict[str, Any]],
                         pid: int = 90) -> List[Dict[str, Any]]:
    """Chrome-trace complete slices for every recorded compile (one
    thread row per worker; ``timeline.chrome_trace`` appends these)."""
    events: List[Dict[str, Any]] = []
    for tid, (wid, snap) in enumerate(sorted(workers.items())):
        slices: List[Dict[str, Any]] = []
        for rec in (snap.get("ledger") or {}).get("records", []):
            dur_s = rec.get("compile_s") or rec.get("call_s") or 0.0
            ev = {
                "name": f"compile {rec.get('program')}",
                "ph": "X", "pid": pid, "tid": tid,
                "ts": rec.get("ts", 0.0) * 1e6 - dur_s * 1e6,
                "dur": max(1.0, dur_s * 1e6),
                "cat": "compile",
                "args": {
                    "program": rec.get("program"),
                    "nth_compile": rec.get("nth_compile"),
                    "durations": rec.get("durations"),
                },
            }
            cause = rec.get("cause")
            if cause and cause.get("arg") is not None:
                ev["args"]["cause"] = (f"{cause['arg']}: {cause['kind']} "
                                       f"{cause['old']} -> {cause['new']}")
            slices.append(ev)
        if slices:
            # meta rows only for workers that actually compiled, so an
            # empty (e.g. trial-filtered) timeline stays truly empty
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"xla-compile {wid[:12]}"}})
            events.extend(slices)
    if events:
        events.insert(0, {"name": "process_name", "ph": "M", "pid": pid,
                          "args": {"name": "xla compiles"}})
    return events
