"""Per-worker step timing: the flight recorder's write side.

``StepTimer`` splits each training step into phases (data wait, compute,
collective sync, checkpoint) using CUDA-event fences — without a fence,
the card's asynchronous launches attribute device time to whatever host
line happens to block next (the central pitfall called out in the
MLPerf pod-scaling report, arXiv:1909.09756 §4). Records land in a
bounded ring buffer; ``flush_snapshot`` ships them through the same
control-plane KV namespace ``util/metrics`` already uses (keyed
``telemetry:<worker_id>:<incarnation>``), so partition tolerance and
dashboard plumbing come for free.

The collective layer reports into the *current* timer through a
thread-local registry (``record_collective``) so ``collective.py`` /
``nccl_group.py`` need no handle threading.

The port's copy of ``ray_tpu/telemetry/recorder.py``.  One change:
``_fence`` records a CUDA event on the current stream of every card
holding a CUDA tensor of its argument and waits for each, where the
reference calls ``jax.block_until_ready``.  Phase times stay host
``perf_counter`` spans around the fence, as in the reference.  The
module loads no torch: a process without torch has nothing to fence.
"""

from __future__ import annotations

import pickle
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..util import metrics as metrics_mod

# Sub-namespace prefix inside METRICS_NS; collect_cluster_metrics reads
# snap["metrics"] which we keep as [] so plain metric merging is unharmed.
TELEMETRY_KEY_PREFIX = "telemetry:"

# Canonical phase order for timeline rendering; unknown phases append.
# Dotted names are SUB-phases nested under their parent ("collective" is
# also reported as quantize/transfer/dequantize when the collective layer
# measured its stages) — children overlap the parent's time, so summaries
# and the step residual must not double-count them (see step_end).
PHASE_ORDER = ("data", "compute", "collective", "collective.quantize",
               "collective.transfer", "collective.dequantize", "checkpoint",
               "pipeline", "pipeline.fwd", "pipeline.bwd", "pipeline.bwd_w",
               "pipeline.p2p", "pipeline.idle")

_STEP_BOUNDARIES = [0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5,
                    10, 30, 60, 300]

_tls = threading.local()

# Module-level caches hold strong refs so the weakref registry
# (util/metrics._Registry) keeps these alive across flush epochs.
_metric_lock = threading.Lock()
_metric_cache: Dict[str, Any] = {}


def _cuda_devices(x: Any, torch: Any, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (a tensor, or a
    mapping / sequence nesting them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, torch, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, torch, out)
    return out


def _fence(x: Any) -> None:
    """Block until the card work producing ``x`` is done: one CUDA event
    on the current stream of each device that holds a CUDA tensor of
    ``x``, then a wait on each.  CPU tensors and other values need no
    wait; without torch loaded in this process the call is a no-op."""
    if x is None:
        return
    torch = sys.modules.get("torch")
    if torch is None:
        return
    for dev in _cuda_devices(x, torch, set()):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def _get_metric(key: str, factory: Callable[[], Any]) -> Any:
    with _metric_lock:
        m = _metric_cache.get(key)
        if m is None:
            m = _metric_cache[key] = factory()
        return m


def _step_histogram():
    return _get_metric("step_hist", lambda: metrics_mod.Histogram(
        "ray_tpu_train_step_phase_seconds",
        description="Per-step train phase durations",
        boundaries=_STEP_BOUNDARIES,
        tag_keys=("phase",)))


def _collective_histogram():
    return _get_metric("coll_hist", lambda: metrics_mod.Histogram(
        "ray_tpu_collective_op_seconds",
        description="Collective op dispatch+sync time",
        boundaries=_STEP_BOUNDARIES,
        tag_keys=("op",)))


def _payload_counter():
    return _get_metric("payload_ctr", lambda: metrics_mod.Counter(
        "ray_tpu_collective_payload_bytes_total",
        description="Logical (fp32-equivalent) bytes moved by collectives",
        tag_keys=("op",)))


def _wire_counter():
    return _get_metric("wire_ctr", lambda: metrics_mod.Counter(
        "ray_tpu_collective_wire_bytes_total",
        description="Wire bytes moved by collectives (post-compression)",
        tag_keys=("op",)))


class _PhaseHandle:
    """Context manager for one phase of the current step."""

    __slots__ = ("_timer", "_name", "_t0", "_fence_on")

    def __init__(self, timer: "StepTimer", name: str):
        self._timer = timer
        self._name = name
        self._t0 = 0.0
        self._fence_on: Optional[Any] = None

    def fence(self, x: Any) -> Any:
        """Fence on ``x`` at phase exit so async device work counts here."""
        self._fence_on = x
        return x

    def __enter__(self) -> "_PhaseHandle":
        self._t0 = self._timer._clock()
        return self

    def __exit__(self, *exc) -> None:
        if self._fence_on is not None:
            _fence(self._fence_on)
            self._fence_on = None
        self._timer.add_phase_time(self._name, self._timer._clock() - self._t0)


class StepTimer:
    """Phase-resolved per-step stopwatch with a bounded ring buffer.

    Typical use inside a train loop (``session.get_session()`` creates
    one per worker and exposes it via ``telemetry.phase(...)``)::

        timer.step_start(step)
        with timer.phase("data"):
            batch = next(it)
        loss, state = train_step(state, batch)   # collective records itself
        rec = timer.step_end(fence=loss)         # residual -> "compute"
    """

    def __init__(self, ring_size: int = 512, rank: int = 0,
                 incarnation: int = 0, trial: str = "",
                 clock: Callable[[], float] = time.perf_counter,
                 wall: Callable[[], float] = time.time):
        self._ring: deque = deque(maxlen=max(1, int(ring_size)))
        self.rank = int(rank)
        self.incarnation = int(incarnation)
        self.trial = trial
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._wall0 = 0.0
        self._step: Optional[int] = None
        self._phases: Dict[str, float] = {}
        self._last_flush = 0.0
        # ONE wall<->monotonic anchor per incarnation: every wall stamp
        # this timer emits is derived from the monotonic clock via this
        # pair, so an NTP step mid-run shifts nothing — Chrome traces
        # and goodput windows stay mutually consistent (phases already
        # used perf_counter; mixing raw time.time() into "ts" let the
        # two clocks skew).
        self._anchor = (wall(), clock())

    def wall_now(self) -> float:
        """Anchor-derived wall time (monotonic progression since the
        one wall reading taken at construction)."""
        anchor_wall, anchor_mono = self._anchor
        return anchor_wall + (self._clock() - anchor_mono)

    # -- step lifecycle ------------------------------------------------

    def step_start(self, step: Optional[int] = None) -> None:
        with self._lock:
            self._t0 = self._clock()
            self._wall0 = self.wall_now()
            self._step = step
            self._phases = {}

    def phase(self, name: str) -> _PhaseHandle:
        return _PhaseHandle(self, name)

    def add_phase_time(self, name: str, seconds: float) -> None:
        if seconds < 0:
            seconds = 0.0
        with self._lock:
            if self._t0 is None:
                return  # between steps (e.g. collectives in group setup)
            self._phases[name] = self._phases.get(name, 0.0) + seconds

    def step_end(self, step: Optional[int] = None,
                 fence: Any = None) -> Optional[Dict[str, Any]]:
        if fence is not None:
            _fence(fence)
        with self._lock:
            if self._t0 is None:
                return None
            dur = self._clock() - self._t0
            phases = dict(self._phases)
            # residual host+device time not claimed by an explicit phase;
            # dotted sub-phases ("collective.quantize") overlap their
            # parent's time and must not be counted twice
            residual = dur - sum(v for k, v in phases.items()
                                 if "." not in k)
            if residual > 0:
                phases["compute"] = phases.get("compute", 0.0) + residual
            rec = {
                "step": self._step if step is None else step,
                "ts": self._wall0,
                "dur": dur,
                "phases": phases,
                "rank": self.rank,
                "incarnation": self.incarnation,
            }
            self._ring.append(rec)
            self._t0 = None
            self._step = None
            self._phases = {}
        try:
            h = _step_histogram()
            for name, secs in phases.items():
                h.observe(secs, tags={"phase": name})
        except Exception:
            pass
        return rec

    # -- read side -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "trial": self.trial,
                "rank": self.rank,
                "incarnation": self.incarnation,
                "ring_size": self._ring.maxlen,
                "steps": list(self._ring),
            }

    def aggregate(self) -> Dict[str, Any]:
        """Phase means/totals over the ring (bench/report summary)."""
        with self._lock:
            steps = list(self._ring)
        if not steps:
            return {"steps": 0}
        totals: Dict[str, float] = {}
        for rec in steps:
            for name, secs in rec["phases"].items():
                totals[name] = totals.get(name, 0.0) + secs
        n = len(steps)
        total_dur = sum(r["dur"] for r in steps)
        return {
            "steps": n,
            "step_mean_s": total_dur / n,
            "phase_totals_s": {k: round(v, 6) for k, v in totals.items()},
            "phase_means_s": {k: round(v / n, 6) for k, v in totals.items()},
        }


# -- current-timer registry (thread-local, like session._tls) ----------


class _NoopPhase:
    """Stands in for _PhaseHandle when no timer is active (telemetry
    disabled, or code running outside a train session)."""

    __slots__ = ()

    def fence(self, x: Any) -> Any:
        return x

    def __enter__(self) -> "_NoopPhase":
        return self

    def __exit__(self, *exc) -> None:
        pass


def phase(name: str):
    """User-facing phase marker for the current worker's train loop::

        with ray_tpu_torch.telemetry.phase("data"):
            batch = next(it)

    No-op when telemetry is off, so train loops need no gating."""
    timer = current_timer()
    if timer is None:
        return _NoopPhase()
    return timer.phase(name)


def set_current_timer(timer: Optional[StepTimer]) -> None:
    _tls.timer = timer


def current_timer() -> Optional[StepTimer]:
    return getattr(_tls, "timer", None)


def record_collective(op: str, seconds: float, payload_bytes: float = 0,
                      wire_bytes: Optional[float] = None,
                      breakdown: Optional[Dict[str, float]] = None) -> None:
    """Called by collective/nccl_group per op; feeds the current step's
    "collective" phase plus cluster-wide Prometheus series.

    ``breakdown`` carries measured quantize/transfer/dequantize sub-phase
    seconds (the kv backend times its codec/wire stages; the compiled
    backend reports them from mesh_allreduce(profile=True)'s fenced
    stages).  Sub-phases land as "collective.<stage>" children —
    NESTED inside the parent "collective" time, not additional to it."""
    timer = current_timer()
    if timer is not None:
        timer.add_phase_time("collective", seconds)
        if breakdown:
            for stage, secs in breakdown.items():
                if secs > 0:
                    timer.add_phase_time(f"collective.{stage}", secs)
    try:
        _collective_histogram().observe(seconds, tags={"op": op})
        if payload_bytes > 0:
            _payload_counter().inc(payload_bytes, tags={"op": op})
            wb = payload_bytes if wire_bytes is None else wire_bytes
            if wb > 0:
                _wire_counter().inc(wb, tags={"op": op})
    except Exception:
        pass


# -- KV flush ----------------------------------------------------------

_reattach_lock = threading.Lock()
_reattach_inflight = False


def _kick_reattach(core, failed_client) -> None:
    """Rebuild the core's control client off the hot path.  The core
    only re-attaches inside ``_control_call`` (user-facing RPCs), so an
    idle driver/worker whose only control traffic is telemetry flushes
    would otherwise stay disconnected forever after a partition heals.
    ``_rebuild_control`` blocks up to the reconnect grace — that wait
    must land on a background thread, never inside session.report()."""
    global _reattach_inflight
    with _reattach_lock:
        if _reattach_inflight:
            return
        _reattach_inflight = True

    def run():
        global _reattach_inflight
        try:
            core._rebuild_control(failed_client)
        except Exception:
            pass
        finally:
            with _reattach_lock:
                _reattach_inflight = False

    threading.Thread(target=run, daemon=True,
                     name="telemetry-reattach").start()


def flush_snapshot(timer: StepTimer, interval_s: float = 2.0,
                   force: bool = False) -> bool:
    """Ship the ring to control-plane KV (rate-limited, never raises —
    a partition flap must not take down the train loop)."""
    now = time.monotonic()
    if not force and interval_s > 0 and \
            now - timer._last_flush < interval_s:
        return False
    try:
        from ray_tpu_torch._private import core as core_mod

        core = core_mod._current_core
        if core is None or getattr(core, "_shutdown", False):
            return False
        timer._last_flush = now
        cli = core.control
        if getattr(cli, "closed", False):
            _kick_reattach(core, cli)
            return False
        # incarnation in the key: an elastic shrink reuses surviving
        # worker processes under new ranks, and the new gang's snapshots
        # must not clobber the pre-shrink ring (the timeline wants both)
        key = (f"{TELEMETRY_KEY_PREFIX}{core.worker_id}"
               f":{timer.incarnation}")
        try:
            cli.call("kv_put", {
                "ns": metrics_mod.METRICS_NS,
                "key": key,
                # anchor-derived stamp: must agree with the ring's
                # per-step "ts" values even across an NTP step
                "val": pickle.dumps({"ts": timer.wall_now(),
                                     "metrics": [],
                                     "telemetry": timer.snapshot()}),
            }, timeout=5.0)
        except Exception:
            # degraded, not dead: fail fast here, heal in the background
            _kick_reattach(core, cli)
            return False
        try:
            # piggyback the device-observability flush on the same
            # rate-limited heartbeat (telemetry/device.py)
            from .device import flush_device_snapshot

            flush_device_snapshot(interval_s=interval_s)
        except Exception:
            pass
        return True
    except Exception:
        return False
