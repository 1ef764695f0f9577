"""Object spilling and memory pressure handling for the node daemon.

Reference parity:
  - spill/restore/delete of primary in-memory copies under store pressure
    (src/ray/raylet/local_object_manager.h:110 ``SpillObjects``,
    :122 ``AsyncRestoreSpilledObject``) — here the spill target is a
    directory of packed-layout files next to the shm arena, and restore
    re-seals the bytes back into the arena on demand;
  - system memory watchdog (src/ray/common/memory_monitor.h:52) with a
    retriable-first worker-killing policy
    (src/ray/raylet/worker_killing_policy.h) — the raylet kills the most
    recently leased task worker; the owner's task manager observes the
    death and retries, so under sustained pressure the oldest work keeps
    making progress (the reference's retriable-FIFO policy).

Differences from the reference, by design: there are no dedicated IO
worker processes — spill IO is a raylet thread writing files (the store
is a mapped arena, not a store daemon, so there is no plasma client
round-trip to amortize); and LRU order is approximated by entry-table
order (insertion order) rather than the arena's exact access clock.

The port's copy of ``ray_tpu/_private/spilling.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

from .config import cfg as _cfg

SPILL_HIGH_FRAC = _cfg().spill_high
SPILL_LOW_FRAC = _cfg().spill_low


class SpillManager:
    """Moves sealed objects from the shm store to disk files and back."""

    def __init__(self, store, spill_dir: str,
                 high: float = SPILL_HIGH_FRAC, low: float = SPILL_LOW_FRAC):
        self.store = store
        self.dir = spill_dir
        self.high = high
        self.low = low
        os.makedirs(spill_dir, exist_ok=True)
        self.lock = threading.Lock()
        self.spilled: Dict[str, str] = {}  # object_id -> file path
        self.n_spilled = 0
        self.n_restored = 0
        self.bytes_spilled = 0

    # -- pressure ----------------------------------------------------------

    def _usage(self) -> Tuple[int, int]:
        """(used, capacity) of the in-memory store; (0, 0) if unknown."""
        stats = getattr(self.store, "stats", None)
        if stats is None:
            return 0, 0
        try:
            s = stats()
            return int(s.get("used", 0)), int(s.get("capacity", 0))
        except Exception:
            return 0, 0

    def over_high_water(self) -> bool:
        used, cap = self._usage()
        return cap > 0 and used / cap > self.high

    # -- spill -------------------------------------------------------------

    def maybe_spill(self) -> int:
        """Spill until usage drops below the low-water mark; returns the
        number of objects moved to disk this pass.

        Only primary copies are spilled: non-primary objects (pulled
        remote copies, raw blobs) are already LRU-evictable and
        recoverable without disk IO, so the allocator reclaims them on
        demand."""
        used, cap = self._usage()
        if cap <= 0 or used / cap <= self.high:
            return 0
        target = int(cap * self.low)
        is_primary = getattr(self.store, "is_primary", None)
        n = 0
        for oid in self.store.list_objects():
            if used <= target:
                break
            if is_primary is not None and not is_primary(oid):
                continue
            size = self.store.size(oid) or 0
            if self._spill_one(oid):
                used -= size
                n += 1
        return n

    def _spill_one(self, oid: str) -> bool:
        with self.lock:
            on_disk = oid in self.spilled
        if not on_disk:
            data = self.store.read_bytes(oid)
            if data is None:
                return False
            path = os.path.join(self.dir, oid)
            tmp = path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.rename(tmp, path)
            except OSError as e:
                logger.warning("spill of %s failed: %s", oid, e)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return False
            with self.lock:
                self.spilled[oid] = path
                self.n_spilled += 1
                self.bytes_spilled += len(data)
        # Bytes are safe on disk: demote from primary (making the entry
        # evictable) and free the in-memory copy.  A pinned object survives
        # the free attempt — report failure so the caller doesn't count
        # memory that wasn't reclaimed; the disk copy is a prepaid spill
        # for a later pass.
        set_primary = getattr(self.store, "set_primary", None)
        if set_primary is not None:
            set_primary(oid, False)
        try_free = getattr(self.store, "try_free", None)
        if try_free is not None:
            return bool(try_free(oid))
        return bool(self.store.delete(oid))

    # -- restore -----------------------------------------------------------

    def restore(self, oid: str) -> bool:
        """Bring a spilled object back into the store (idempotent)."""
        if self.store.contains(oid):
            return True
        with self.lock:
            path = self.spilled.get(oid)
        if path is None:
            return False
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return False
        self.store.write_bytes(oid, data)
        with self.lock:
            self.n_restored += 1
        return True

    def read_spilled(self, oid: str) -> Optional[bytes]:
        """Serve spilled bytes directly (remote fetch path) without
        displacing resident objects."""
        with self.lock:
            path = self.spilled.get(oid)
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def contains(self, oid: str) -> bool:
        with self.lock:
            return oid in self.spilled

    def delete(self, oid: str) -> bool:
        with self.lock:
            path = self.spilled.pop(oid, None)
        if path is None:
            return False
        try:
            os.unlink(path)
        except OSError:
            pass
        return True

    def stats(self) -> dict:
        with self.lock:
            return {
                "num_spilled": self.n_spilled,
                "num_restored": self.n_restored,
                "bytes_spilled": self.bytes_spilled,
                "num_on_disk": len(self.spilled),
            }

    def destroy(self) -> None:
        import shutil

        with self.lock:
            self.spilled.clear()
        shutil.rmtree(self.dir, ignore_errors=True)


# ---------------------------------------------------------------------------


def _cgroup_usage() -> Optional[Tuple[int, int]]:
    """(current, max) from cgroup v2 if this process has a real limit."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw == "max":
            return None
        limit = int(raw)
        with open("/sys/fs/cgroup/memory.current") as f:
            cur = int(f.read().strip())
        return cur, limit
    except (OSError, ValueError):
        return None


def _meminfo_usage() -> Optional[Tuple[int, int]]:
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                fields[k] = int(v.split()[0]) * 1024
        total = fields["MemTotal"]
        avail = fields.get("MemAvailable", fields.get("MemFree", 0))
        return total - avail, total
    except (OSError, KeyError, ValueError, IndexError):
        return None


class MemoryMonitor:
    """Samples system/cgroup memory usage (reference: memory_monitor.h:52).

    The raylet polls :meth:`over_threshold` and applies its killing policy
    when usage crosses the threshold.  ``get_usage`` is injectable for
    tests (returns a 0..1 fraction).
    """

    def __init__(self, threshold: Optional[float] = None, get_usage=None):
        if threshold is None:
            threshold = float(os.environ.get(
                "RAY_TPU_TORCH_MEMORY_USAGE_THRESHOLD", "0.95"))
        self.threshold = threshold
        self._get_usage = get_usage
        self.last_fraction = 0.0

    def usage_fraction(self) -> float:
        fake = os.environ.get("RAY_TPU_TORCH_MEMORY_USAGE_FILE")
        if fake:
            # test hook: the file holds the fraction to report
            try:
                with open(fake) as f:
                    self.last_fraction = float(f.read().strip())
            except (OSError, ValueError):
                self.last_fraction = 0.0
            return self.last_fraction
        if self._get_usage is not None:
            f = float(self._get_usage())
        else:
            u = _cgroup_usage() or _meminfo_usage()
            if u is None:
                return 0.0
            used, total = u
            f = used / total if total else 0.0
        self.last_fraction = f
        return f

    def over_threshold(self) -> bool:
        return self.usage_fraction() > self.threshold


KILL_GRACE_S = 1.0  # between OOM kills, let memory settle


class OomKiller:
    """Retriable-FIFO worker-killing policy over a raylet's worker table
    (reference: worker_killing_policy_retriable_fifo.h): kill the most
    recently leased task worker so the earliest-submitted work finishes."""

    def __init__(self, raylet, monitor: MemoryMonitor):
        self.raylet = raylet
        self.monitor = monitor
        self.n_killed = 0
        self._last_kill = 0.0

    def step(self) -> bool:
        if not self.monitor.over_threshold():
            return False
        now = time.monotonic()
        if now - self._last_kill < KILL_GRACE_S:
            return False
        victim = None
        with self.raylet.lock:
            leased = [r for r in self.raylet.workers.values()
                      if r.state == "leased" and r.proc is not None]
            # retriable-FIFO: a max_retries=0 task dies permanently if
            # killed, so prefer retriable victims (most recent lease
            # first) and fall back to non-retriable only when none exist
            pool = ([r for r in leased if r.lease_retriable]
                    or leased)
            if pool:
                victim = max(pool, key=lambda r: r.leased_at)
        if victim is None:
            return False
        logger.warning(
            "memory usage %.1f%% above threshold %.1f%%: killing worker %s "
            "(most recent lease) to release memory",
            self.monitor.last_fraction * 100, self.monitor.threshold * 100,
            victim.worker_id[:12])
        if not self.raylet.kill_worker_for_oom(victim):
            return False
        self.n_killed += 1
        self._last_kill = now
        try:
            # structured cluster event (reference: the OOM killer's
            # ray.event emission) — dashboards/state API surface it
            self.raylet.control.notify("report_event", {
                "severity": "ERROR", "source": "raylet",
                "event_type": "worker_oom_killed",
                "entity_id": victim.worker_id,
                "message": (f"memory {self.monitor.last_fraction:.0%} > "
                            f"{self.monitor.threshold:.0%}: killed worker "
                            f"{victim.worker_id[:12]} (most recent lease)"),
            })
        except Exception:
            pass
        return True
