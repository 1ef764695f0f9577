"""On-demand per-process profiling.

Reference parity: the dashboard's ReporterAgent runs py-spy stack dumps /
CPU flamegraphs and memray memory profiles against worker PIDs
(reference: dashboard/modules/reporter/profile_manager.py:82,:189).
Those tools attach from outside via ptrace; here every worker is our own
Python process with an RPC server, so the equivalents are in-process and
dependency-free:

  * ``dump_stacks()`` — all-thread stack dump (py-spy dump analog)
  * ``cpu_profile(duration)`` — sampling profiler over
    ``sys._current_frames`` producing collapsed stacks in the flamegraph
    "folded" format (py-spy record analog)
  * ``memory_summary()`` — tracemalloc-based top allocations
    (memray analog; enable with RAY_TPU_TORCH_TRACEMALLOC=1 at worker start)

If py-spy/memray ever are installed, they attach by pid exactly as in
the reference — these fallbacks keep the feature working without them.

The port's copy of ``ray_tpu/_private/profiling.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import Counter
from typing import Dict, Optional


def dump_stacks() -> str:
    """Formatted stacks of every thread (reference: py-spy dump)."""
    lines = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sorted(sys._current_frames().items()):
        lines.append(f"Thread {tid} ({names.get(tid, '?')}):")
        lines.extend(l.rstrip("\n")
                     for l in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)


def _folded_stack(frame) -> str:
    parts = []
    while frame is not None:
        code = frame.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:"
                     f"{code.co_name}:{frame.f_lineno}")
        frame = frame.f_back
    return ";".join(reversed(parts))


def cpu_profile(duration_s: float = 2.0, interval_s: float = 0.01,
                thread_id: Optional[int] = None) -> str:
    """Sampling CPU profile in collapsed-stack ("folded") format, one
    line per unique stack: ``a;b;c <count>`` — feed to any flamegraph
    renderer (reference: py-spy record -f raw)."""
    counts: Counter = Counter()
    deadline = time.monotonic() + duration_s
    me = threading.get_ident()
    n = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # don't profile the profiler
            if thread_id is not None and tid != thread_id:
                continue
            counts[_folded_stack(frame)] += 1
        n += 1
        time.sleep(interval_s)
    header = f"# {n} samples over {duration_s}s at {interval_s*1000:.0f}ms\n"
    return header + "\n".join(
        f"{stack} {c}" for stack, c in counts.most_common())


def memory_summary(top: int = 20) -> str:
    """Top allocation sites via tracemalloc (memray analog).  Starts
    tracing on first call if RAY_TPU_TORCH_TRACEMALLOC=1 wasn't set — later
    calls then see allocations made since."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return ("tracemalloc was not tracing; started now — call again "
                "to see allocations made from this point")
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    total = sum(s.size for s in snap.statistics("filename"))
    lines = [f"# total traced: {total / 1e6:.1f} MB; top {top} sites:"]
    for s in stats:
        lines.append(f"{s.size / 1024:.0f} KiB  {s.count} blocks  "
                     f"{s.traceback.format()[-1].strip()}")
    return "\n".join(lines)


def maybe_start_tracemalloc() -> None:
    if os.environ.get("RAY_TPU_TORCH_TRACEMALLOC") == "1":
        import tracemalloc

        tracemalloc.start()


def install_handlers(server) -> None:
    """Register the profiling RPCs on a worker/driver core server."""
    server.handle("dump_stacks", lambda c, p: dump_stacks())
    server.handle("memory_summary",
                  lambda c, p: memory_summary((p or {}).get("top", 20)))

    def h_profile(conn, p, d):
        def run():
            try:
                d.resolve(cpu_profile(
                    duration_s=float((p or {}).get("duration", 2.0)),
                    interval_s=float((p or {}).get("interval", 0.01))))
            except Exception as e:
                d.reject(f"cpu_profile failed: {e}")

        threading.Thread(target=run, daemon=True).start()

    server.handle("profile_cpu", h_profile, deferred=True)
