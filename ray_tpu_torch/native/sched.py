"""ctypes wrapper for the native cluster scheduler (sched.cc).

Mirrors the reference's C++ scheduling core surface
(ClusterResourceScheduler / HybridSchedulingPolicy /
BundleSchedulingPolicy) for the Python control plane.  Resources use the
same fixed-point integers as _private/common.normalize_resources.

The port's copy of ``ray_tpu/native/sched.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Dict, List, Optional, Sequence

from .build import build_extension

logger = logging.getLogger(__name__)

PACK = 0
SPREAD = 1
STRICT_PACK = 2
STRICT_SPREAD = 3

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build_extension("rsched", ["sched.cc"])
        lib = ctypes.CDLL(path)
        lib.rsched_create.restype = ctypes.c_void_p
        lib.rsched_create.argtypes = [ctypes.c_double, ctypes.c_int]
        lib.rsched_destroy.argtypes = [ctypes.c_void_p]
        lib.rsched_intern.restype = ctypes.c_int
        lib.rsched_intern.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        I = ctypes.POINTER(ctypes.c_int)
        Q = ctypes.POINTER(ctypes.c_int64)
        lib.rsched_upsert_node.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, I, Q, ctypes.c_int]
        lib.rsched_set_alive.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.rsched_remove_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rsched_set_avail.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, I, Q, ctypes.c_int]
        lib.rsched_acquire.restype = ctypes.c_int
        lib.rsched_acquire.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, I, Q, ctypes.c_int]
        lib.rsched_release.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, I, Q, ctypes.c_int]
        lib.rsched_pick.restype = ctypes.c_int
        lib.rsched_pick.argtypes = [
            ctypes.c_void_p, I, Q, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.rsched_pick_n.restype = ctypes.c_int
        lib.rsched_pick_n.argtypes = [
            ctypes.c_void_p, I, Q, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, I]
        lib.rsched_acquire_n.restype = ctypes.c_int
        lib.rsched_acquire_n.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, I, Q, ctypes.c_int,
            ctypes.c_int]
        lib.rsched_plan_bundles.restype = ctypes.c_int
        lib.rsched_plan_bundles.argtypes = [
            ctypes.c_void_p, I, Q, I, ctypes.c_int, ctypes.c_int, I]
        lib.rsched_node_name.restype = ctypes.c_int
        lib.rsched_node_name.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.rsched_get_avail.restype = ctypes.c_int64
        lib.rsched_get_avail.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return lib


class ClusterScheduler:
    """Native node-selection + resource accounting engine."""

    def __init__(self, spread_threshold: float = 0.5, topk: int = 1):
        self._lib = _load()
        self._h = self._lib.rsched_create(spread_threshold, topk)
        self._rids: Dict[str, int] = {}
        self._lock = threading.Lock()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.rsched_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def _rid(self, name: str) -> int:
        rid = self._rids.get(name)
        if rid is None:
            rid = self._lib.rsched_intern(self._h, name.encode())
            self._rids[name] = rid
        return rid

    def _pack(self, res: Dict[str, int]):
        n = len(res)
        ids = (ctypes.c_int * n)()
        vals = (ctypes.c_int64 * n)()
        with self._lock:
            for i, (k, v) in enumerate(res.items()):
                ids[i] = self._rid(k)
                vals[i] = int(v)
        return ids, vals, n

    def upsert_node(self, node_id: str, total: Dict[str, int]):
        ids, vals, n = self._pack(total)
        self._lib.rsched_upsert_node(self._h, node_id.encode(), ids, vals, n)

    def remove_node(self, node_id: str):
        self._lib.rsched_remove_node(self._h, node_id.encode())

    def set_alive(self, node_id: str, alive: bool):
        self._lib.rsched_set_alive(self._h, node_id.encode(), int(alive))

    def set_available(self, node_id: str, avail: Dict[str, int]):
        ids, vals, n = self._pack(avail)
        self._lib.rsched_set_avail(self._h, node_id.encode(), ids, vals, n)

    def acquire(self, node_id: str, demand: Dict[str, int]) -> bool:
        ids, vals, n = self._pack(demand)
        return bool(self._lib.rsched_acquire(self._h, node_id.encode(),
                                             ids, vals, n))

    def release(self, node_id: str, demand: Dict[str, int]):
        ids, vals, n = self._pack(demand)
        self._lib.rsched_release(self._h, node_id.encode(), ids, vals, n)

    def pick(self, demand: Dict[str, int],
             strategy: int = PACK) -> Optional[str]:
        ids, vals, n = self._pack(demand)
        out = ctypes.create_string_buffer(256)
        ok = self._lib.rsched_pick(self._h, ids, vals, n, strategy, out, 256)
        return out.value.decode() if ok else None

    def pick_n(self, demand: Dict[str, int], count: int,
               strategy: int = PACK) -> List[str]:
        """Pick AND reserve up to `count` placements of `demand` in one
        native call.  Unlike pick(), every returned node has the demand
        already subtracted from the native books — a pick the caller
        rejects must be handed back via release().  Returned names may
        repeat (one node can host several leases)."""
        if count <= 0:
            return []
        ids, vals, n = self._pack(demand)
        out = (ctypes.c_int * count)()
        got = self._lib.rsched_pick_n(self._h, ids, vals, n, strategy,
                                      count, out)
        names: List[str] = []
        buf = ctypes.create_string_buffer(256)
        for i in range(got):
            if self._lib.rsched_node_name(self._h, out[i], buf, 256):
                names.append(buf.value.decode())
        return names

    def acquire_n(self, node_id: str, demand: Dict[str, int],
                  count: int) -> int:
        """Atomically acquire up to `count` copies of `demand` on one
        node; returns how many fit (each already subtracted)."""
        if count <= 0:
            return 0
        ids, vals, n = self._pack(demand)
        return int(self._lib.rsched_acquire_n(
            self._h, node_id.encode(), ids, vals, n, count))

    def plan_bundles(self, bundles: Sequence[Dict[str, int]],
                     strategy: int = PACK) -> Optional[List[str]]:
        nb = len(bundles)
        flat_ids: List[int] = []
        flat_vals: List[int] = []
        offsets = [0]
        with self._lock:
            for b in bundles:
                for k, v in b.items():
                    flat_ids.append(self._rid(k))
                    flat_vals.append(int(v))
                offsets.append(len(flat_ids))
        ids = (ctypes.c_int * max(1, len(flat_ids)))(*flat_ids)
        vals = (ctypes.c_int64 * max(1, len(flat_vals)))(*flat_vals)
        offs = (ctypes.c_int * (nb + 1))(*offsets)
        out = (ctypes.c_int * max(1, nb))()
        ok = self._lib.rsched_plan_bundles(self._h, ids, vals, offs, nb,
                                           strategy, out)
        if not ok:
            return None
        names = []
        buf = ctypes.create_string_buffer(256)
        for i in range(nb):
            if not self._lib.rsched_node_name(self._h, out[i], buf, 256):
                return None
            names.append(buf.value.decode())
        return names

    def available(self, node_id: str, resource: str) -> int:
        return int(self._lib.rsched_get_avail(self._h, node_id.encode(),
                                              self._rid(resource)))


def try_create(spread_threshold: float = 0.5,
               topk: int = 1) -> Optional[ClusterScheduler]:
    """Build-or-None: callers fall back to the Python policy on failure."""
    try:
        return ClusterScheduler(spread_threshold, topk)
    except Exception as e:  # toolchain missing etc.
        logger.warning("native scheduler unavailable: %s", e)
        return None
