"""Continuous-batching decode engine with a paged KV cache.

Counterpart of ``ray_tpu/serve/_engine.py``: an iteration-level
scheduler over a fixed batch of **slots**.  Sequences join at prefill and
leave at EOS/max-tokens at every decode step.

Memory is a **paged arena** (``models/gpt.py`` ``init_paged_cache``):
fixed-size pages in one preallocated device tensor, per-slot page tables
gathered inside the decode step.  Pages are refcounted through a free
list; full prompt pages register in a prefix table so live sequences
with a common prompt prefix share pages, with copy-on-write when a new
sequence must write into a shared page.  Page 0 is the reserved null
page: inactive slots write there and their sampled tokens are discarded
host-side.

``cache="contiguous"`` runs the same scheduler over the slot cache; the
paged path gathers its pages into the identical [B, H, S, dh] attention
view, so greedy decode is bitwise-identical between the two.

Everything device-facing runs on one daemon thread (the engine loop)
under ``torch.inference_mode()``, on that thread's current CUDA stream;
``submit`` is thread-safe and hands back a ``_Sequence`` whose results
are consumed as a blocking token iterator or a Future.

The engine exports the reference's Prometheus series (``ray_tpu_serve_*``:
phase seconds, TTFT, tokens, request outcomes, slots, queue depth, free
pages), reports its page arena to the device-memory census as an owner,
and runs its prefill and decode programs through the program ledger
(``telemetry/device.py``).
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import (DeviceLike, check_params_on,
                                    resolve_device)

__all__ = ["AdmissionRejected", "ContinuousEngine", "PageAllocator"]


class AdmissionRejected(Exception):
    """Raised by submit() when the waiting queue is at capacity."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


# ---------------------------------------------------------------------------
# metrics (lazy, module-cached: strong refs keep them alive across the
# weakref registry's flush epochs — same pattern as telemetry/recorder)

_metric_lock = threading.Lock()
_metric_cache: Dict[str, Any] = {}

_PHASE_BOUNDARIES = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1, 2.5]
_TTFT_BOUNDARIES = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                    5, 10, 30]


def _metric(key: str, factory):
    with _metric_lock:
        m = _metric_cache.get(key)
        if m is None:
            try:
                m = _metric_cache[key] = factory()
            except Exception:
                return None
        return m


def _m_phase():
    from ..util import metrics as mm
    return _metric("phase", lambda: mm.Histogram(
        "ray_tpu_serve_step_phase_seconds",
        description="Engine loop phase durations (swap/prefill/decode)",
        boundaries=_PHASE_BOUNDARIES, tag_keys=("phase",)))


def _m_ttft():
    from ..util import metrics as mm
    return _metric("ttft", lambda: mm.Histogram(
        "ray_tpu_serve_ttft_seconds",
        description="Time from submit to first streamed token",
        boundaries=_TTFT_BOUNDARIES))


def _m_tokens():
    from ..util import metrics as mm
    return _metric("tokens", lambda: mm.Counter(
        "ray_tpu_serve_tokens_total",
        description="Generated tokens"))


def _m_requests():
    from ..util import metrics as mm
    return _metric("requests", lambda: mm.Counter(
        "ray_tpu_serve_requests_total",
        description="Engine request outcomes", tag_keys=("outcome",)))


def _m_gauge(which: str):
    from ..util import metrics as mm
    names = {
        "active": ("ray_tpu_serve_active_slots", "Occupied decode slots"),
        "queue": ("ray_tpu_serve_queue_depth", "Waiting (unadmitted) requests"),
        "free_pages": ("ray_tpu_serve_free_pages", "Free KV-cache pages"),
    }
    name, desc = names[which]
    return _metric(which, lambda: mm.Gauge(name, description=desc))


# ---------------------------------------------------------------------------
# paged allocator (host-side bookkeeping; the arena itself is on device)


class PageAllocator:
    """Free-list page allocator with refcounts and a prompt-prefix
    registry.

    The registry maps *full, page-aligned token prefixes* — the tuple of
    a prompt's first (i+1)*page_size token ids — to the page holding
    those positions' K/V.  Sharing is live-sequence only: when a page's
    refcount drops to zero it returns to the free list and its registry
    keys are purged, so a registered page always holds exactly the K/V
    its key promises.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: deque = deque(range(1, num_pages))
        self._refs: Dict[int, int] = {}
        self._prefix: Dict[Tuple[int, ...], int] = {}
        self._page_keys: Dict[int, List[Tuple[int, ...]]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("page arena exhausted")
        p = self._free.popleft()
        self._refs[p] = 1
        return p

    def ref(self, page: int) -> None:
        self._refs[page] += 1

    def unref(self, page: int) -> None:
        if page == 0:
            return
        n = self._refs[page] - 1
        if n > 0:
            self._refs[page] = n
            return
        del self._refs[page]
        for key in self._page_keys.pop(page, ()):
            if self._prefix.get(key) == page:
                del self._prefix[key]
        self._free.append(page)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def register_prefix(self, tokens: Tuple[int, ...], page: int) -> None:
        """Publish `page` as holding the K/V of this full-page prefix
        (first writer wins; a concurrent identical prefix is already
        byte-identical, so keeping the incumbent is free)."""
        if tokens in self._prefix:
            return
        self._prefix[tokens] = page
        self._page_keys.setdefault(page, []).append(tokens)

    def lookup_prefix(self, tokens: Tuple[int, ...]) -> Optional[int]:
        return self._prefix.get(tokens)

    def plan(self, tokens: List[int], n_pages_needed: int
             ) -> Optional[Dict[str, Any]]:
        """Plan the page set for a prompt: walk the registry for fully
        shared leading pages (clamped so the LAST prompt position is
        always recomputed — it must produce logits), then check the free
        list covers the rest.  Returns None when the arena can't fit
        the request right now (caller keeps it queued); on success
        returns {pages, shared_len, copies, n_shared} with all refcounts
        taken — `copies` lists (src, dst) device page copies the caller
        must apply before prefill (copy-on-write out of a shared page).
        """
        ps = self.page_size
        plen = len(tokens)
        shared: List[int] = []
        i = 0
        while (i + 1) * ps <= plen:
            page = self._prefix.get(tuple(tokens[:(i + 1) * ps]))
            if page is None:
                break
            shared.append(page)
            i += 1
        full_shared = len(shared) * ps
        shared_len = min(full_shared, plen - 1)
        cow = shared_len < full_shared   # exact full-page match: the last
        if cow:                          # shared page must be re-written
            cow_src = shared.pop()
        n_fresh = n_pages_needed - len(shared)
        if n_fresh > len(self._free):
            return None
        for p in shared:
            self.ref(p)
        pages = list(shared)
        copies: List[Tuple[int, int]] = []
        if cow:
            dst = self.alloc()
            copies.append((cow_src, dst))
            pages.append(dst)
        while len(pages) < n_pages_needed:
            pages.append(self.alloc())
        return {"pages": pages, "shared_len": shared_len,
                "copies": copies, "n_shared": len(shared)}

    def release(self, pages: List[int]) -> None:
        for p in pages:
            self.unref(p)

    def occupancy(self) -> Dict[str, int]:
        """Arena occupancy (page 0, the reserved null page, is in neither
        free nor used); ``live_shared`` counts pages currently referenced
        by more than one sequence."""
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "free": len(self._free),
            "used": len(self._refs),
            "live_shared": sum(1 for n in self._refs.values() if n > 1),
            "prefix_keys": len(self._prefix),
        }


# ---------------------------------------------------------------------------


class _Sequence:
    """Host-side state of one in-flight request."""

    __slots__ = ("rid", "tokens", "max_new", "temperature", "top_k",
                 "seed", "eos_id", "out_q", "result", "slot", "pages",
                 "generated", "keys", "t_submit", "t_first",
                 "peak", "stream", "request_id", "key_offset")

    def __init__(self, rid, tokens, max_new, temperature, top_k, seed,
                 eos_id, stream, request_id=None, key_offset=0):
        self.rid = rid
        self.request_id = request_id
        self.key_offset = int(key_offset)
        self.tokens = list(tokens)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.seed = int(seed)
        self.eos_id = eos_id
        self.stream = bool(stream)
        self.out_q: "queue.Queue" = queue.Queue()
        self.result = concurrent.futures.Future()
        self.slot = -1
        self.pages: List[int] = []
        self.generated: List[int] = []
        self.keys: List[int] = []      # per-token sampling keys, at admit
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.peak = 0               # max co-resident active slots seen


class ContinuousEngine:
    """Per-replica continuous-batching scheduler (one per model)."""

    _END = object()
    prefill_chunk = 32      # prompt positions between two progress marks

    def __init__(self, gpt_mod, cfg, params, *, cache: str = "paged",
                 max_slots: int = 8, page_size: int = 16,
                 num_pages: int = 0, max_total: int = 0,
                 queue_cap: int = 32, shed_queue_depth: int = 16,
                 retry_after_s: float = 1.0, ring_size: int = 256, stall_s: float = 10.0,
                 device: DeviceLike = None):
        if cache not in ("paged", "contiguous"):
            raise ValueError(f"unknown cache mode {cache!r}")
        self.device = resolve_device(device)
        check_params_on(params, self.device)
        self._gpt = gpt_mod
        # every engine program routes through the program ledger (the
        # reference's serve/_engine.py:865): a step meeting new shapes in
        # steady state shows as a new signature with its cause
        from ..telemetry import device as devtel

        paged = cache == "paged"
        self._prefill_fn = devtel.instrument(
            gpt_mod.paged_prefill if paged else gpt_mod.slot_prefill,
            name="serve.prefill",
            # a prompt's length is no new program in eager PyTorch (the
            # reference buckets it): the chunk, its start and slot count
            # by type
            dynamic_argnames=("toks", "start", "slot"))
        self._decode_fn = devtel.instrument(
            gpt_mod.paged_decode_step if paged else gpt_mod.slot_decode_step,
            name="serve.step")
        self._cfg, self._params = cfg, params
        self.cache_mode = cache
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.max_total = int(max_total) or cfg.max_seq
        self.max_pages_per_seq = -(-self.max_total // self.page_size)
        self.max_total = self.max_pages_per_seq * self.page_size
        self.num_pages = (int(num_pages)
                          or 1 + self.max_slots * self.max_pages_per_seq)
        self.queue_cap = int(queue_cap)
        self.shed_queue_depth = int(shed_queue_depth)
        self.retry_after_s = float(retry_after_s)

        self._lock = threading.Lock()
        self._waiting: "deque[_Sequence]" = deque()   # guarded-by: _lock
        self._slots: List[Optional[_Sequence]] = [None] * self.max_slots
        self._alloc = (PageAllocator(self.num_pages, self.page_size)
                       if cache == "paged" else None)
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stopped = False
        self._draining = False        # guarded-by: _lock
        self._rid = 0
        self.stall_s = float(stall_s)
        # when the loop last took a sequence into a slot or finished a
        # prefill chunk or a decode step: what the stall check reads, so a
        # long admission is progress, and the probes' cadence is moot
        self._progress_ts = time.monotonic()  # guarded-by: _lock
        self._last_prefill_s = 0.0
        # what the stall check sees, for its readers: the device setup's
        # seconds (before any slot is taken), the first prefill chunk's
        # and decode step's host seconds, and the longest quiet stretch a
        # probe found while slots were active
        self._health = {"setup_s": None, "first_chunk_s": None,
                        "first_step_s": None, "max_quiet_s": 0.0,
                        "probes": 0}               # guarded-by: _lock

        # device state (built lazily on the engine thread)
        self._cache = None
        self._logits = None          # [B, V] f32 carried across steps

        # host mirrors of the per-slot step operands
        B, maxp = self.max_slots, self.max_pages_per_seq
        self._pos = np.zeros(B, np.int64)
        self._ptab = np.zeros((B, maxp), np.int64)
        self._temps = np.zeros(B, np.float32)
        self._topks = np.zeros(B, np.int64)

        # telemetry: per-iteration phase ring + running totals
        self._ring: "deque[Dict[str, float]]" = deque(maxlen=ring_size)  # guarded-by: _lock
        self._ttfts: "deque[float]" = deque(maxlen=256)        # guarded-by: _lock
        self._t_window: "deque[Tuple[float, int]]" = deque(maxlen=512)  # guarded-by: _lock
        self._totals = {"requests": 0, "rejected": 0, "tokens": 0,
                        "steps": 0, "prefills": 0, "cow_copies": 0,
                        "shared_pages": 0}

        # device-memory census: report this engine's page-arena
        # occupancy under a per-instance tag (unregistered in stop())
        self._census_tag = f"serve.engine.{id(self):x}"
        try:
            devtel.get_census().register_owner(self._census_tag,
                                               self._census_report)
        except Exception:
            pass

    # -- public api ---------------------------------------------------------

    def submit(self, tokens: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0, seed: int = 0,
               top_k: Optional[int] = None, eos_id: Optional[int] = None,
               stream: bool = False, request_id: Optional[str] = None,
               key_offset: int = 0) -> _Sequence:
        """Thread-safe request entry: validates capacity, sheds when the
        waiting queue is full, wakes the engine loop."""
        if not tokens:
            raise ValueError("empty prompt")
        plen, max_new = len(tokens), int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plen + max_new > self.max_total:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) exceeds "
                f"engine capacity ({self.max_total})")
        need = -(-min(plen + max_new, self.max_total) // self.page_size)
        if self._alloc is not None and need > self.num_pages - 1:
            raise ValueError(
                f"request needs {need} pages but the arena only has "
                f"{self.num_pages - 1}")
        if (self._cfg.pos == "learned"
                and plen + max_new > self._cfg.max_seq):
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) exceeds "
                f"the model's learned-position capacity "
                f"({self._cfg.max_seq})")
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine stopped")
            if self._draining:
                self._totals["rejected"] += 1
                m = _m_requests()
                if m:
                    m.inc(tags={"outcome": "rejected"})
                raise AdmissionRejected(
                    "engine draining (replica shutting down)",
                    retry_after_s=self.retry_after_s)
            if len(self._waiting) >= self.queue_cap:
                self._totals["rejected"] += 1
                m = _m_requests()
                if m:
                    m.inc(tags={"outcome": "rejected"})
                raise AdmissionRejected(
                    f"waiting queue at capacity ({self.queue_cap})",
                    retry_after_s=self.retry_after_s)
            self._rid += 1
            seq = _Sequence(self._rid, tokens, max_new, temperature,
                            top_k, seed, eos_id, stream,
                            request_id=request_id, key_offset=key_offset)
            self._waiting.append(seq)
            self._totals["requests"] += 1
            self._ensure_thread()
        self._wake.set()
        return seq

    def stream(self, seq: _Sequence):
        """Blocking token iterator over one sequence's output queue."""
        while True:
            item = seq.out_q.get()
            if item is self._END:
                exc = seq.result.exception()
                if exc is not None:
                    raise exc
                return
            yield item

    def collect(self, seq: _Sequence, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        return seq.result.result(timeout=timeout)

    def engine_stats(self) -> Dict[str, Any]:
        """Scheduler snapshot for admission control and autoscaling."""
        now = time.perf_counter()
        with self._lock:
            active = sum(1 for s in self._slots if s is not None)
            qd = len(self._waiting)
            ttfts = sorted(self._ttfts)
            window = [(t, n) for t, n in self._t_window if now - t <= 10.0]
            draining = self._draining
            health = dict(self._health)
            req_ids = [s.request_id
                       for s in list(self._slots) + list(self._waiting)
                       if s is not None and s.request_id]
        toks = sum(n for _, n in window)
        span = (now - window[0][0]) if window else 0.0
        free_pages = self._alloc.free_pages if self._alloc else \
            (self.max_slots - active) * self.max_pages_per_seq

        def pct(p):
            return ttfts[min(len(ttfts) - 1, int(p * len(ttfts)))] \
                if ttfts else 0.0

        return {
            "cache": self.cache_mode,
            "active": active,
            "free_slots": self.max_slots - active,
            "queue_depth": qd,
            "free_pages": free_pages,
            "num_pages": self.num_pages,
            "accepting": (not draining) and qd < self.shed_queue_depth,
            "draining": draining,
            "active_request_ids": req_ids,
            "retry_after_s": self.retry_after_s,
            "ttft_p50_s": pct(0.50),
            "ttft_p99_s": pct(0.99),
            "tokens_per_s": (toks / span) if span > 0 else 0.0,
            "health": health,
            **self._totals,
        }

    def _census_report(self) -> Dict[str, Any]:
        """Owner callback for telemetry/device.DeviceMemoryCensus: the
        ``pages`` sub-dict feeds ``ray_tpu_kv_pages{state=…}`` — free /
        used are live arena occupancy, shared / cow are the engine's
        cumulative prefix-sharing totals (the serve bench row's
        ``shared_pages`` / ``cow_copies``)."""
        with self._lock:
            totals = dict(self._totals)
        rep: Dict[str, Any] = {"cache": self.cache_mode,
                               "num_pages": self.num_pages,
                               "max_slots": self.max_slots}
        if self._alloc is not None:
            occ = self._alloc.occupancy()
            rep["pages"] = {
                "free": occ["free"],
                "used": occ["used"],
                "shared": totals["shared_pages"],
                "cow": totals["cow_copies"],
                "live_shared": occ["live_shared"],
            }
            rep["prefix_keys"] = occ["prefix_keys"]
        return rep

    def phase_ring(self) -> List[Dict[str, float]]:
        with self._lock:
            return list(self._ring)

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Stop admitting (submit sheds, engine_stats advertises
        accepting=False) and give in-flight sequences a deadline-bounded
        chance to finish.  Returns True when everything drained."""
        with self._lock:
            self._draining = True
        self._wake.set()
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            with self._lock:
                busy = bool(self._waiting) or any(
                    s is not None for s in self._slots)
            if not busy:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def check_health(self) -> bool:
        """Liveness probe: raises when the scheduler thread died with
        work pending, neither a decode step nor a prefill chunk has
        finished for ``stall_s`` while slots are active, or the page
        free-list went inconsistent."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine stopped")
            active = sum(1 for s in self._slots if s is not None)
            queued = len(self._waiting)
            quiet_s = time.monotonic() - self._progress_ts
            self._health["probes"] += 1
            if active:
                self._health["max_quiet_s"] = max(
                    self._health["max_quiet_s"], quiet_s)
        thread = self._thread
        if thread is not None and not thread.is_alive() \
                and (active or queued):
            raise RuntimeError(
                f"engine scheduler thread died with work pending "
                f"({active} active, {queued} queued)")
        if active and quiet_s > self.stall_s:
            raise RuntimeError(
                f"engine stalled: {active} active slots but no decode "
                f"step or prefill chunk for {quiet_s:.1f}s "
                f"(> {self.stall_s:g}s)")
        if self._alloc is not None:
            a = self._alloc
            in_use = len(a._refs)
            if len(a._free) + in_use != a.num_pages - 1:
                raise RuntimeError(
                    f"page free-list inconsistent: {len(a._free)} free "
                    f"+ {in_use} referenced != {a.num_pages - 1}")
            if any(n <= 0 for n in a._refs.values()):
                raise RuntimeError("page refcount <= 0 in allocator")
        return True

    def stop(self):
        try:
            from ..telemetry import device as _devtel

            _devtel.get_census().unregister_owner(self._census_tag)
        except Exception:
            pass
        with self._lock:
            self._stopped = True
            waiting = list(self._waiting)
            self._waiting.clear()
        self._wake.set()
        # let the loop finish its current iteration before touching the
        # slots — clearing them mid-step would double-release pages
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            active = [s for s in self._slots if s is not None]
            self._slots = [None] * self.max_slots
        self._pos[:] = 0
        self._ptab[:] = 0
        if self._alloc is not None:
            for s in active:
                self._alloc.release(s.pages)
        err = RuntimeError("engine stopped")
        for s in waiting + active:
            self._finish(s, error=err)

    # -- engine loop --------------------------------------------------------

    def _ensure_thread(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="serve-engine", daemon=True)
            self._thread.start()

    def _loop(self):
        while True:
            with self._lock:
                if self._stopped:
                    return
                busy = bool(self._waiting) or any(
                    s is not None for s in self._slots)
            if not busy:
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            try:
                with torch.inference_mode():
                    self._iteration()
            except Exception as e:          # fail every in-flight request
                with self._lock:            # rather than wedge the loop
                    seqs = [s for s in self._slots if s is not None]
                    seqs += list(self._waiting)
                    self._waiting.clear()
                    self._slots = [None] * self.max_slots
                    self._pos[:] = 0
                    self._ptab[:] = 0
                if self._alloc is not None:
                    for s in seqs:
                        self._alloc.release(s.pages)
                for s in seqs:
                    self._finish(s, error=e)

    def _iteration(self):
        t0 = time.perf_counter()
        admitted = self._admit()
        t1 = time.perf_counter()
        stepped = 0
        if any(s is not None for s in self._slots):
            stepped = self._step()
        t2 = time.perf_counter()
        rec = {"swap_s": (t1 - t0) if admitted else 0.0,
               "prefill_s": self._last_prefill_s if admitted else 0.0,
               "decode_s": (t2 - t1) if stepped else 0.0,
               "active": stepped, "admitted": admitted, "ts": t2}
        with self._lock:
            self._ring.append(rec)
            qd = len(self._waiting)
        m = _m_phase()
        if m:
            if admitted:
                m.observe(max(0.0, rec["swap_s"] - rec["prefill_s"]),
                          tags={"phase": "swap"})
                m.observe(rec["prefill_s"], tags={"phase": "prefill"})
            if stepped:
                m.observe(rec["decode_s"], tags={"phase": "decode"})
        for which, val in (("active", stepped),
                           ("queue", qd),
                           ("free_pages",
                            self._alloc.free_pages if self._alloc else 0)):
            g = _m_gauge(which)
            if g:
                g.set(val)

    # -- admission ----------------------------------------------------------

    def _pages_needed(self, seq: _Sequence) -> int:
        total = min(len(seq.tokens) + seq.max_new, self.max_total)
        return -(-total // self.page_size)

    def _admit(self) -> int:
        """Admit waiting sequences into free slots while pages last —
        FIFO (a too-big head request waits for evictions rather than
        being overtaken)."""
        self._last_prefill_s = 0.0
        if self._cache is None:
            with self._lock:
                pending = bool(self._waiting)
            if pending:
                # the device setup (the caches, and the programs' first
                # launches) runs before the first sequence takes a slot:
                # a probe meanwhile sees no active slot, so a slow host's
                # one-time setup is not read as a stalled step
                t0 = time.perf_counter()
                self._ensure_device_state()
                with self._lock:
                    self._health["setup_s"] = time.perf_counter() - t0
        admitted = 0
        while True:
            with self._lock:
                if not self._waiting:
                    break
                try:
                    slot = self._slots.index(None)
                except ValueError:
                    break
                seq = self._waiting[0]
                plan = None
                if self._alloc is not None:
                    plan = self._alloc.plan(seq.tokens,
                                            self._pages_needed(seq))
                    if plan is None:
                        break               # page-starved: wait for evicts
                self._waiting.popleft()
                self._slots[slot] = seq
                self._progress_ts = time.monotonic()
            self._admit_one(seq, slot, plan)
            admitted += 1
        if admitted:
            n = sum(1 for s in self._slots if s is not None)
            for s in self._slots:
                if s is not None:
                    s.peak = max(s.peak, n)
        return admitted

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _admit_one(self, seq: _Sequence, slot: int, plan):
        gpt = self._gpt
        self._ensure_device_state()
        plen = len(seq.tokens)
        if plan is not None:
            seq.pages = plan["pages"]
            shared_len = plan["shared_len"]
            self._ptab[slot] = 0
            self._ptab[slot, :len(seq.pages)] = seq.pages
            self._totals["cow_copies"] += len(plan["copies"])
            self._totals["shared_pages"] += plan["n_shared"]
            for src, dst in plan["copies"]:
                gpt.copy_page(self._cache, dst, src)
        else:
            shared_len = 0
        seq.slot = slot
        # key_offset: a resumed continuation skips the keys its already
        # delivered tokens consumed — sampled decode stays identical
        seq.keys = [gpt.token_key(seq.seed, seq.key_offset + i)
                    for i in range(seq.max_new)]
        self._pos[slot] = plen                  # first decode write pos
        self._temps[slot] = seq.temperature
        self._topks[slot] = int(seq.top_k or 0)

        # prefill the non-shared prompt suffix, prefill_chunk positions
        # at a time (each position is its own decode step, so the split
        # changes no bit), marking progress after each chunk
        suffix = np.asarray(seq.tokens[shared_len:], np.int64)
        tp = time.perf_counter()
        ptab = self._tensor(self._ptab[slot])
        for lo in range(0, len(suffix), self.prefill_chunk):
            chunk = self._tensor(suffix[lo:lo + self.prefill_chunk])
            start = shared_len + lo
            if self._alloc is not None:
                logits, self._cache = self._prefill_fn(
                    self._params, self._cache, chunk, ptab, start,
                    self._cfg)
            else:
                logits, self._cache = self._prefill_fn(
                    self._params, self._cache, chunk, start, slot,
                    self._cfg)
            with self._lock:
                self._progress_ts = time.monotonic()
                if self._health["first_chunk_s"] is None:
                    self._health["first_chunk_s"] = time.perf_counter() - tp
        self._logits[slot] = logits.float()
        self._sync()
        self._last_prefill_s += time.perf_counter() - tp
        self._totals["prefills"] += 1

        # register this prompt's full pages for live prefix sharing
        if self._alloc is not None:
            for i in range(plen // self.page_size):
                self._alloc.register_prefix(
                    tuple(seq.tokens[:(i + 1) * self.page_size]),
                    seq.pages[i])

    # -- decode -------------------------------------------------------------

    def _step(self) -> int:
        """One sample+decode step over every slot.  Inactive slots ride
        along at pos 0 against the null page; their tokens are discarded
        here on the host."""
        gpt, cfg = self._gpt, self._cfg
        t_step = time.perf_counter()
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None]
        keys: List[Optional[int]] = [None] * self.max_slots
        for i, s in active:
            keys[i] = s.keys[len(s.generated)]
        # sample in cfg.dtype, as generate() does on its logits
        toks = gpt.sample_rows(self._logits.to(cfg.dtype),
                               self._temps.tolist(), self._topks.tolist(),
                               keys)
        pos = self._tensor(self._pos)
        if self._alloc is not None:
            logits, self._cache = self._decode_fn(
                self._params, self._cache, toks, self._tensor(self._ptab),
                pos, cfg)
        else:
            logits, self._cache = self._decode_fn(
                self._params, self._cache, toks, pos, cfg)
        self._logits = logits.float()
        toks = toks.cpu().numpy()               # waits for the step
        self._totals["steps"] += 1
        with self._lock:
            self._progress_ts = time.monotonic()
            if self._health["first_step_s"] is None:
                self._health["first_step_s"] = time.perf_counter() - t_step
        now = time.perf_counter()
        emitted = 0
        finished = []
        for i, s in active:
            tok = int(toks[i])
            s.generated.append(tok)
            emitted += 1
            if s.t_first is None:
                s.t_first = now
                ttft = now - s.t_submit
                with self._lock:
                    self._ttfts.append(ttft)
                m = _m_ttft()
                if m:
                    m.observe(ttft)
            s.out_q.put(tok)
            self._pos[i] += 1
            if (len(s.generated) >= s.max_new
                    or (s.eos_id is not None and tok == s.eos_id)):
                finished.append((i, s))
        self._totals["tokens"] += emitted
        with self._lock:
            self._t_window.append((now, emitted))
        m = _m_tokens()
        if m and emitted:
            m.inc(emitted)
        for i, s in finished:
            self._evict(i, s)
        return len(active)

    def _evict(self, slot: int, seq: _Sequence):
        with self._lock:
            self._slots[slot] = None
        self._pos[slot] = 0
        self._ptab[slot] = 0
        self._temps[slot] = 0.0
        self._topks[slot] = 0
        if self._alloc is not None:
            self._alloc.release(seq.pages)
        self._finish(seq)
        self._wake.set()          # page/slot freed: retry page-starved head

    def _finish(self, seq: _Sequence, error: Optional[Exception] = None):
        if error is not None:
            if not seq.result.done():
                seq.result.set_exception(error)
            m = _m_requests()
            if m:
                m.inc(tags={"outcome": "error"})
        elif not seq.result.done():
            seq.result.set_result({
                "tokens": seq.tokens + seq.generated,
                "completion": list(seq.generated),
                "batch_size": seq.peak,
                "ttft_s": (seq.t_first - seq.t_submit)
                if seq.t_first else None,
            })
            m = _m_requests()
            if m:
                m.inc(tags={"outcome": "ok"})
        seq.out_q.put(self._END)

    # -- device state -------------------------------------------------------

    def _ensure_device_state(self):
        if self._cache is not None:
            return
        if self.cache_mode == "paged":
            self._cache = self._gpt.init_paged_cache(
                self._cfg, self.num_pages, self.page_size,
                device=self.device)
        else:
            self._cache = self._gpt.init_slot_cache(
                self._cfg, self.max_slots, self.max_total,
                device=self.device)
        self._logits = torch.zeros(
            (self.max_slots, self._cfg.vocab_size), dtype=torch.float32,
            device=self.device)
        if self.device.type == "cuda":
            # the first matmul would otherwise create the BLAS handle
            torch.cuda.current_blas_handle()
        # a fresh process's first launches of the engine's device code
        # carry one-time costs (lazy loading of the code, library state):
        # one throwaway prefill position pays them here, before any slot
        # is taken.  Its K/V land where nothing is read before it is
        # written: the null page, or slot 0's position 0, which a
        # contiguous admission writes first; its logits are dropped.
        tok = torch.zeros(1, dtype=torch.long, device=self.device)
        if self.cache_mode == "paged":
            ptab = torch.zeros(self.max_pages_per_seq, dtype=torch.long,
                               device=self.device)
            self._gpt.paged_prefill(self._params, self._cache, tok, ptab, 0,
                                    self._cfg)
        else:
            self._gpt.slot_prefill(self._params, self._cache, tok, 0, 0,
                                   self._cfg)
        self._sync()
