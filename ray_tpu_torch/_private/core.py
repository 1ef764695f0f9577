"""CoreWorker: the in-process runtime linked into every driver and worker.

The runtime's analog of the reference's CoreWorker (reference:
src/ray/core_worker/core_worker.h:271): task submission with per-scheduling-
key lease pools (normal_task_submitter.h:75), ordered per-actor submission
queues (actor_task_submitter.h:75), ownership-based reference counting
(reference_count.h:64), in-process memory store for small/device objects
(store_provider/memory_store/), shared-memory store access for large host
objects, task retries + lineage-based object reconstruction
(task_manager.h:208, object_recovery_manager.h:41).

The port's copy of ``ray_tpu/_private/core.py``.  Design departures:
  * CUDA tensors never leave the device on put(): they are held
    device-resident in the in-process store (alone or in a dict, list or
    tuple); host staging happens only if a borrower in another process
    fetches them, and then once (``_stage_device_value``).  Device-to-
    device movement belongs to the collective plane, not here.
  * Ownership is fully owner-based: the owner process serves `get_object`
    to borrowers and receives add_ref/del_ref notifications — there is no
    separate distributed directory service.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import cloudpickle
import uuid

from . import common, serialization
from .common import (INLINE_OBJECT_LIMIT, STREAMING_RETURNS, ActorDiedError,
                     GetTimeoutError, ObjectLostError, RayTpuError,
                     SerializedRef, TaskCancelledError, TaskError, TaskSpec,
                     WorkerCrashedError, normalize_resources)
from .protocol import (IDEM_KEY, Backoff, Client, ConnectionLost,
                       DaemonPool, Deferred, RpcError, Server, ServerConn,
                       idem_token)
from .shm_store import ShmObjectStore

logger = logging.getLogger(__name__)

# typed flag table (reference: ray_config_def.h); RAY_TPU_TORCH_* env or
# _system_config overrides
from .config import cfg as _cfg

PIPELINE_DEPTH = _cfg().pipeline_depth  # pushes per lease before waiting
DELETE_GRACE_S = _cfg().delete_grace_s
IDLE_LEASE_TTL_S = _cfg().idle_lease_ttl_s
# how long a DEAD-actor verdict from the control plane is trusted before
# submit_actor_task re-probes for a revived incarnation
DEAD_RECHECK_TTL_S = 1.0


# ---------------------------------------------------------------------------
# ObjectRef
# ---------------------------------------------------------------------------

_current_core: Optional["CoreWorker"] = None


def current_core() -> "CoreWorker":
    if _current_core is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init()")
    return _current_core


def adopt_task_context() -> None:
    """Module-level form of CoreWorker.adopt_task_context for helper
    threads spawned inside tasks (train session loops, data
    prefetchers): no-op outside a worker, never raises — THE one place
    library code should call so the blocked-CPU-lending contract stays
    in sync everywhere."""
    try:
        core = _current_core
        if core is not None and not core._shutdown:
            core.adopt_task_context()
    except Exception:
        pass


def raise_stored(err: BaseException) -> None:
    """Raise a stored (in-process-store) exception without mutating it.

    Raising the stored object directly would attach the caller's frames
    to its ``__traceback__``, creating an uncollectable cycle rooted in
    the owner's object table (entry → error → traceback → caller frame →
    ObjectRef → entry): the frame's ObjectRefs never hit refcount zero,
    so the entry — and anything else the frame holds, like actor handles
    — leaks for the life of the process."""
    import copy as _copy

    try:
        clone = _copy.copy(err)
        clone.__traceback__ = None
        clone.__cause__ = err.__cause__
        clone.__suppress_context__ = True
    except Exception:
        clone = err
    raise clone


class ObjectRef:
    """Handle to a (possibly pending) object.  Owner-based, like the
    reference's ObjectRef + ownership protocol."""

    __slots__ = ("id", "owner_addr", "owner_id", "__weakref__")

    def __init__(self, object_id: str, owner_addr, owner_id: str):
        self.id = object_id
        self.owner_addr = tuple(owner_addr) if owner_addr else None
        self.owner_id = owner_id

    def __repr__(self):
        return f"ObjectRef({self.id})"

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __reduce__(self):
        raise TypeError(
            "ObjectRef can only be serialized by ray_tpu_torch (inside task args or "
            "ray_tpu_torch.put values), not by plain pickle."
        )

    def __del__(self):
        core = _current_core
        if core is not None and not core._shutdown:
            try:
                core._remove_local_ref(self)
            except Exception:
                pass

    def future(self):
        """concurrent.futures.Future resolving to the value."""
        core = current_core()
        return core.as_future(self)

    def __await__(self):
        """`await ref` / asyncio.gather(*refs) from async drivers and
        async actors (reference: ObjectRef.__await__, _raylet.pyx +
        async_compat.py)."""
        import asyncio

        return asyncio.wrap_future(current_core().as_future(self)).__await__()


def _marker_to_ref(marker: SerializedRef) -> ObjectRef:
    core = _current_core
    ref = ObjectRef(marker.object_id, marker.owner_addr, marker.owner_id)
    if core is not None:
        core._on_borrowed_ref(ref)
    return ref


def _ref_to_marker(ref: ObjectRef) -> SerializedRef:
    core = _current_core
    if core is not None:
        core._pin_for_serialization(ref)
    return SerializedRef(ref.id, ref.owner_addr, ref.owner_id)


serialization.install_ref_hooks(ObjectRef, _ref_to_marker, _marker_to_ref)

# Execution attribution for code running inside a task: which task is
# submitting (recursive-cancel parenting) and which driver job owns it
# (log routing for nested submissions).  contextvars, not thread-locals:
# async tasks/actor methods run as asyncio Tasks, each with its own
# context, so interleaved coroutines attribute correctly
# (worker_proc._execute / _finish set these).
import contextvars

EXECUTING_TASK_ID: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_executing_task_id", default=None)
EXECUTING_JOB_ID: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_executing_job_id", default=None)
# set while serializing a task's ARGS: actor-handle transit holds taken
# inside bind to this task and refresh while it is queued/running
TRANSIT_TASK_ID: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_transit_task_id", default=None)


class StreamState:
    """Owner-side bookkeeping for one streaming-generator task
    (reference: task_manager.h:355 HandleReportGeneratorItemReturns —
    per-item returns with backpressure + idempotent retries)."""

    __slots__ = ("spec", "cv", "ready", "produced", "consumed", "done",
                 "total", "error", "waiters", "closed")

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.cv = threading.Condition()
        self.ready: deque = deque()   # indices stored, not yet handed out
        self.produced = 0             # next expected item index
        self.consumed = 0             # items handed to the user
        self.done = False
        self.total: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.waiters: List = []       # deferred producer acks (backpressure)
        self.closed = False           # generator dropped by the user


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a streaming task's yields
    (reference: _raylet.pyx:281 ObjectRefGenerator).  Each __next__
    blocks until the worker reports the next item, then returns an
    ObjectRef that is immediately gettable."""

    def __init__(self, core: "CoreWorker", task_id: str):
        self._core = core
        self._task_id = task_id

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        ref = self._core._next_stream_item(self._task_id, timeout=None)
        if ref is None:
            raise StopIteration
        return ref

    def next_ready(self, timeout: Optional[float] = None) -> ObjectRef:
        """Like __next__ but with a timeout (GetTimeoutError)."""
        ref = self._core._next_stream_item(self._task_id, timeout=timeout)
        if ref is None:
            raise StopIteration
        return ref

    def completed(self) -> bool:
        st = self._core.streams.get(self._task_id)
        return st is None or (st.done and not st.ready)

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        """Async iteration: blocks in an executor thread, not the loop."""
        import asyncio

        loop = asyncio.get_running_loop()
        ref = await loop.run_in_executor(
            None, self._core._next_stream_item, self._task_id, None)
        if ref is None:
            raise StopAsyncIteration
        return ref

    @property
    def task_id(self) -> str:
        return self._task_id

    def __del__(self):
        core = self._core
        if core is not None and not core._shutdown:
            try:
                core._release_stream(self._task_id)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# In-process store entries
# ---------------------------------------------------------------------------


class ObjectEntry:
    __slots__ = ("value", "has_value", "error", "shm_node", "shm_addr", "event",
                 "pins", "lineage", "nbytes", "attempts")

    def __init__(self):
        self.value = None
        self.has_value = False
        self.error: Optional[BaseException] = None
        self.shm_node: Optional[str] = None          # node id holding shm copy
        self.shm_addr: Optional[Tuple[str, int]] = None  # that node's raylet
        self.event = threading.Event()
        self.pins = 0
        self.lineage: Optional[TaskSpec] = None
        self.nbytes = 0
        self.attempts = 0

    @property
    def ready(self) -> bool:
        return self.event.is_set()


class TaskRecord:
    __slots__ = ("spec", "pool_key", "deps", "pushed_to", "retries_left",
                 "done", "canceled", "mux", "staged_ns")

    def __init__(self, spec: TaskSpec, pool_key, retries_left: int):
        self.spec = spec
        self.pool_key = pool_key
        self.deps: Set[str] = set()
        self.pushed_to: Optional[str] = None
        self.retries_left = retries_left
        self.done = False
        self.canceled = False
        self.mux = False          # routed via the raylet submit relay
        self.staged_ns = None     # stage clock for sampled traces only


class LeasedWorker:
    def __init__(self, worker_id, addr, lease_id, node_id, raylet_addr, client):
        self.worker_id = worker_id
        self.addr = tuple(addr)
        self.lease_id = lease_id
        self.node_id = node_id
        self.raylet_addr = raylet_addr
        self.client: Client = client
        self.inflight: Set[str] = set()
        self.inflight_since: Dict[str, float] = {}  # task_id -> push ts
        self.idle_since = time.monotonic()


class SchedPool:
    """Per scheduling-key lease pool (reference: NormalTaskSubmitter's
    per-SchedulingKey worker lease pools, normal_task_submitter.h:75)."""

    def __init__(self, key):
        self.key = key
        self.queue: deque = deque()
        self.leases: Dict[str, LeasedWorker] = {}
        # rotation order for O(1) amortized lease picking: _pick_lease
        # inspects the front and rotates, so a 100k-task burst never
        # rebuilds/rescans the whole lease list per task.  Entries are
        # healed lazily — a lease removed from `leases` is dropped the
        # next time the rotation reaches it (identity check).
        self.rr: deque = deque()
        self.pending_requests = 0
        # EWMA of task execution time drives pipeline depth: tiny tasks are
        # pipelined deep (throughput), long tasks one-at-a-time so queued
        # work can land on other nodes (parallelism)
        self.avg_ms: Optional[float] = None

    def depth(self) -> int:
        if self.avg_ms is None:
            return 1
        if self.avg_ms < 2.0:
            return 16
        if self.avg_ms < 20.0:
            return 4
        return 1


# ---------------------------------------------------------------------------
# Actor bookkeeping (submitter side)
# ---------------------------------------------------------------------------


class ActorConn:
    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self.client: Optional[Client] = None   # guarded-by: lock
        self.addr = None
        self.incarnation = -1
        self.seq = 0                           # guarded-by: lock
        self.state = "PENDING"                 # guarded-by: lock
        # staging queue: specs not yet shipped.  In batched mode
        # (submit_batch > 1) submit_actor_task appends here and the
        # combining flusher drains it; in legacy mode it holds only
        # calls staged while the conn is PENDING/RECONNECTING.
        self.buffer: deque = deque()           # guarded-by: lock
        self.inflight: Dict[str, TaskSpec] = {}  # guarded-by: lock
        self.lock = threading.Lock()
        self.resolving = False
        self.dead_error: Optional[str] = None
        # monotonic deadline below which a DEAD verdict is trusted
        # without re-probing the control plane (revival-probe TTL)
        self.dead_recheck_at = 0.0             # guarded-by: lock
        self.max_task_retries = 0


class CoreWorker:
    def __init__(self, control_addr, raylet_addr=None, mode: str = "driver",
                 job: Optional[str] = None, worker_id: Optional[str] = None,
                 node_id: Optional[str] = None, store_root: Optional[str] = None,
                 namespace: Optional[str] = None, log_to_driver: bool = True,
                 keep_device_stand_ins: bool = False):
        global _current_core
        self.mode = mode
        # a core that only passes values on (the client server's) keeps a
        # tensor staged from a card as its stand-in when it loads a result
        self.keep_device_stand_ins = keep_device_stand_ins
        self.log_to_driver = log_to_driver and mode == "driver"
        self.namespace = (namespace
                          or os.environ.get("RAY_TPU_TORCH_NAMESPACE")
                          or "default")
        self.worker_id = worker_id or common.worker_id()
        self.job_id = job or common.job_id()
        self.node_id = node_id
        self._shutdown = False
        self.lock = threading.RLock()
        self._stage_lock = threading.Lock()  # device values staged once

        # RPC
        self.server = Server(name=f"core-{mode}")
        self.server.handle("get_object", self.h_get_object, deferred=True)
        self.server.handle("add_ref", self.h_add_ref)
        self.server.handle("del_ref", self.h_del_ref)
        self.server.handle("actor_add_ref", self.h_actor_add_ref)
        self.server.handle("actor_del_ref", self.h_actor_del_ref)
        self.server.handle("actor_transit", self.h_actor_transit)
        self.server.handle("actor_borrow_check", self.h_actor_borrow_check)
        self.server.handle("generator_item", self.h_generator_item,
                           deferred=True)
        self.server.handle("ping", lambda c, p: "pong")
        # streaming-generator tasks owned by this process
        self.streams: Dict[str, StreamState] = {}
        # user-dropped stream ids whose producer task is still live —
        # tells a late report "stop" vs "lineage-recovery re-report,
        # accept"; entries clear when the producer's final reply lands
        self._released_streams: Set[str] = set()
        # on-demand profiling RPCs (reference: dashboard reporter agent's
        # py-spy/memray endpoints, profile_manager.py:82)
        from . import profiling

        profiling.install_handlers(self.server)
        profiling.maybe_start_tracemalloc()
        self.server.start()
        self.addr = self.server.addr

        self.control_addr = tuple(control_addr)
        # rendezvous file outranks the configured address (a driver
        # started after a failover must reach the promoted controller)
        file_addr = common.read_addr_file(
            os.environ.get("RAY_TPU_TORCH_CONTROL_ADDR_FILE"))
        if file_addr and file_addr != self.control_addr:
            self.control_addr = file_addr
        self.control = Client(self.control_addr, name=f"{mode}->control",
                              on_push=self._on_control_push)
        self.raylet: Optional[Client] = None
        self.raylet_addr = None
        if raylet_addr is not None:
            self.raylet = Client(raylet_addr, name=f"{mode}->raylet",
                                 on_push=self._on_raylet_push,
                                 on_disconnect=self._on_raylet_lost)
            self.raylet_addr = tuple(raylet_addr)

        # local shm store access (same node as raylet)
        self.store: Optional[ShmObjectStore] = None
        if store_root:
            self.store = ShmObjectStore(store_root)

        # in-process object store
        self.objects: Dict[str, ObjectEntry] = {}
        self.local_ref_counts: Dict[str, int] = {}
        self.borrowed: Dict[str, SerializedRef] = {}

        # actor-handle borrow protocol (reference: distributed actor handle
        # reference counting — an actor lives while ANY handle exists, not
        # just the creator's):
        #   owner side: borrower worker-ids + in-transit serialization
        #   holds; release defers until both clear.
        #   borrower side: local handle counts per borrowed actor.
        # owner side: borrower worker-id -> [count, addr].  A COUNT, not
        # a set: add/del notifications ride the borrower's FIFO connection,
        # so counting makes a drop-to-zero racing a re-borrow on the same
        # worker net out correctly.  addr is probed for liveness while a
        # release is pending — a crashed borrower never sends actor_del_ref.
        self._actor_borrowers: Dict[str, Dict[str, list]] = {}
        # one hold deadline per in-flight serialized copy of a handle
        # aid -> {nonce: [expiry, bound_task_id|None]} (per-pickle holds)
        self._actor_transit: Dict[str, Dict[str, List]] = {}
        self._actor_pending_release: Set[str] = set()
        self._actor_probe_scheduled: Set[str] = set()
        self._borrowed_actors: Dict[str, list] = {}  # aid -> [count, owner]

        # task submission
        self.pools: Dict[Any, SchedPool] = {}
        self.task_records: Dict[str, TaskRecord] = {}  # live normal tasks
        self.functions: Dict[str, Any] = {}           # fid -> callable (exec side)
        self.registered_functions: Set[str] = set()   # fids pushed to control
        # fn object -> (fid, name); weak keys so task fns can be GC'd
        self._fn_registration_cache = weakref.WeakKeyDictionary()
        self._push_handlers: Dict[str, list] = {}
        self.actors: Dict[str, ActorConn] = {}
        self.owner_clients: Dict[Tuple[str, int], Client] = {}
        # negative cache of unreachable owner addrs (see _owner_client)
        self._owner_dead_until: Dict[Tuple[str, int], float] = {}
        # cached clients to remote raylets (see _remote_raylet_client)
        self._remote_raylets: Dict[Tuple[str, int], Client] = {}
        self.pool_executor = DaemonPool(max_workers=8, name="core")
        # object serving NEVER shares threads with scheduling: a
        # request_lease call can park its pool thread for up to 120 s on
        # the raylet's deferred grant, and with the shared pool full of
        # those, broadcast consumers waiting on h_get_object starved —
        # blocked workers lent CPU, the raylet granted MORE leases, the
        # driver parked MORE threads: a livelock (found via the 8 MiB
        # x200 broadcast-fanout envelope test)
        self.obj_serve_pool = DaemonPool(max_workers=4, name="core-obj")
        self._put_seq = 0
        self._blocked_depth = 0
        self._executing = threading.local()

        # submission batching (resolved once: these knobs sit on the
        # .remote() hot path, and cfg() rebuilds from the env per call)
        c = _cfg()
        self._submit_batch = max(1, int(c.submit_batch))
        self._lease_grant_batch = max(1, int(c.lease_grant_batch))
        self._pending_lease_cap = max(1, int(c.pending_lease_cap))
        self._small_arg_limit = int(c.small_arg_limit)
        self._small_arg_memo = int(c.small_arg_memo)
        # register_function identity fast path (cheaper than the weak-dict
        # hash when one fn is submitted in a tight loop — the common case)
        self._last_fn: Any = None
        self._last_fn_out: Optional[Tuple[str, str]] = None
        # combining submit flusher: .remote() appends to the pool queue
        # and marks the pool dirty; this thread ships whatever accumulated
        # since its last pass as framed push_tasks batches.  Batch size
        # adapts to the submission rate (busy flusher -> bigger batches).
        self._flush_cv = threading.Condition()
        self._flush_dirty: Set[SchedPool] = set()   # guarded-by: _flush_cv
        # actor conns with staged calls awaiting a flusher pass
        self._flush_dirty_actors: Set[ActorConn] = set()  # guarded-by: _flush_cv
        # multi-client submit multiplexer (raylet-side relay).  Eligible
        # plain tasks stage here instead of a SchedPool once the raylet
        # reports >=2 concurrent drivers; the flusher ships them as
        # framed mux_push_tasks envelopes and the raylet schedules them
        # without per-driver lease conversations.
        self._mux_enabled = bool(getattr(c, "submit_mux", True)) \
            and self._submit_batch > 1
        self._mux_on = False                        # guarded-by: lock
        self._mux_staged: deque = deque()           # guarded-by: lock
        self._mux_dirty = False                     # guarded-by: _flush_cv
        # telemetry: push_tasks batch-size histogram + flush-latency sums
        self._stats_lock = threading.Lock()
        self._submit_hist: Dict[int, int] = {}      # guarded-by: _stats_lock
        self._actor_hist: Dict[int, int] = {}       # guarded-by: _stats_lock
        self._actor_sends = 0                       # guarded-by: _stats_lock
        self._flush_stats = {"flushes": 0, "tasks": 0,  # guarded-by: _stats_lock
                             "latency_ms_total": 0.0, "latency_ms_max": 0.0}
        self._flush_thread = threading.Thread(
            target=self._submit_flush_loop, name="core-submit-flush",
            daemon=True)
        self._flush_thread.start()

        # task-event export (reference: task_event_buffer.h:220)
        from .task_events import NULL_BUFFER, TaskEventBuffer

        if _cfg().task_events:
            # workers relay batches through their raylet (one control
            # write per node per flush window instead of one per worker);
            # drivers and rayletless processes report directly
            transport = None
            if mode == "worker" and self.raylet is not None:
                raylet_cli = self.raylet
                transport = lambda payload: raylet_cli.notify(
                    "report_task_events", payload)
            self.task_events = TaskEventBuffer(
                self.control, worker_id=self.worker_id,
                node_id=self.node_id or "", job_id=self.job_id,
                transport=transport)
        else:
            self.task_events = NULL_BUFFER

        # distributed tracing: install this process's span collector
        # (SpanBuffer -> batched report_spans) — a no-op unless tracing
        # is already enabled or RAY_TPU_TORCH_TRACE_SAMPLE asks for it
        from ray_tpu_torch.util import tracing as _tracing

        _tracing.ensure_collector(
            self.control,
            proc=("driver" if mode == "driver"
                  else f"worker:{self.worker_id[:8]}"),
            worker_id=self.worker_id, node_id=self.node_id or "",
            job_id=self.job_id)

        if mode == "driver":
            self.control.call("register_job", {"job_id": self.job_id,
                                               "driver_pid": os.getpid()})
        self.control.call("subscribe", {"topics": self._sub_topics()})
        self._reaper = threading.Thread(target=self._lease_reaper_loop,
                                        name="core-lease-reaper", daemon=True)
        self._reaper.start()
        # as_future dispatcher (awaitable ObjectRefs)
        self._future_lock = threading.Lock()
        self._future_waiters: List[Tuple[ObjectEntry, Callable, Any]] = []
        self._future_event = threading.Event()
        self._future_thread = threading.Thread(
            target=self._future_dispatch_loop, name="core-future-dispatch",
            daemon=True)
        self._future_thread.start()
        # single delayed-deletion reaper (a Timer thread per released
        # object dominates the tiny-task hot path otherwise)
        self._delete_queue: deque = deque()
        self._delete_event = threading.Event()
        self._delete_thread = threading.Thread(
            target=self._delete_loop, name="core-object-reaper", daemon=True)
        self._delete_thread.start()
        # claim the process-global slot stack-wise: a scoped CoreWorker
        # (e.g. a test driver against its own cluster) restores the
        # previous live core on shutdown instead of stranding it
        self._prev_current_core = _current_core
        _current_core = self

    def _control_call(self, method, payload=None, timeout=30.0):
        """Control RPC with one reconnect-and-retry on connection loss.
        With a persistent control plane (reference: GCS fault tolerance)
        the daemon restarts at the same address and clients re-attach."""
        cli = self.control
        try:
            return cli.call(method, payload, timeout=timeout)
        except (ConnectionLost, OSError):
            if self._shutdown:
                raise
            self._rebuild_control(cli)
            return self.control.call(method, payload, timeout=timeout)

    def _rebuild_control(self, failed_client=None):
        with self.lock:
            # compare by identity, not by .closed: a send-path failure
            # (EPIPE in call) can precede the reader thread marking the
            # client closed — the caller's client is dead either way
            if failed_client is not None and self.control is not failed_client:
                return  # someone else already re-attached
        grace = _cfg().control_reconnect_s
        deadline = time.monotonic() + grace
        last: Optional[BaseException] = None
        bo = Backoff(_cfg().rpc_backoff_base_s, _cfg().rpc_backoff_cap_s)
        addr_file = os.environ.get("RAY_TPU_TORCH_CONTROL_ADDR_FILE")
        while time.monotonic() < deadline and not self._shutdown:
            # failover re-homing: a promoted standby publishes its
            # address in the rendezvous file
            new_addr = common.read_addr_file(addr_file)
            if new_addr and new_addr != tuple(self.control_addr):
                logger.warning("control plane moved: %s -> %s",
                               self.control_addr, new_addr)
                self.control_addr = new_addr
            try:
                cli = Client(self.control_addr,
                             name=f"{self.mode}->control(re)",
                             on_push=self._on_control_push,
                             connect_timeout=2.0)
                if self.mode == "driver":
                    cli.call("register_job", {"job_id": self.job_id,
                                              "driver_pid": os.getpid()})
                cli.call("subscribe", {"topics": self._sub_topics()})
                with self.lock:
                    old, self.control = self.control, cli
                if hasattr(self.task_events, "_client"):
                    self.task_events._client = cli
                if old is not None:
                    old.close()
                logger.info("re-attached to control plane at %s",
                            self.control_addr)
                return
            except Exception as e:
                last = e
                # jittered exponential backoff: every driver and worker
                # re-attaches at once after a control restart
                bo.sleep(max_s=max(0.0, deadline - time.monotonic()))
        raise ConnectionLost(f"control plane unreachable: {last}")

    def _delete_loop(self):
        while not self._shutdown:
            if not self._delete_queue:
                self._delete_event.wait(0.5)
                self._delete_event.clear()
                continue
            try:
                # flush_pending_deletes drains concurrently: the peek and
                # the pop can both lose the race
                due, oid = self._delete_queue[0]
            except IndexError:
                continue
            now = time.monotonic()
            if due > now:
                time.sleep(min(due - now, 0.5))
                continue
            try:
                item = self._delete_queue.popleft()
            except IndexError:
                continue
            if item[0] > now:
                # raced a concurrent drain: the popped item is a FRESH
                # enqueue whose grace window has not elapsed — deleting
                # it now would shave DELETE_GRACE_S off in-flight gets
                self._delete_queue.append(item)
                continue
            try:
                self._maybe_delete(item[1])
            except Exception:
                pass

    def _submit_flush_loop(self):
        """Ship staged submissions.  One pass pumps every pool that went
        dirty since the previous pass — while this thread is busy doing
        socket sends, .remote() keeps staging, so the next pass naturally
        carries more tasks per frame (a combining flusher: batch size is
        adaptive, bounded by submit_batch, with no added latency when the
        submission rate is low)."""
        while not self._shutdown:
            with self._flush_cv:
                while (not self._flush_dirty and not self._flush_dirty_actors
                       and not self._mux_dirty and not self._shutdown):
                    self._flush_cv.wait(0.5)
                dirty, self._flush_dirty = self._flush_dirty, set()
                dirty_actors, self._flush_dirty_actors = \
                    self._flush_dirty_actors, set()
                mux_dirty, self._mux_dirty = self._mux_dirty, False
            if self._shutdown:
                return
            t0 = time.monotonic()
            for pool in dirty:
                try:
                    self._pump(pool)
                except Exception:
                    logger.exception("submit flush failed")
            for ac in dirty_actors:
                try:
                    self._flush_actor_conn(ac)
                except Exception:
                    logger.exception("actor submit flush failed")
            if mux_dirty:
                try:
                    self._flush_mux()
                except Exception:
                    logger.exception("mux submit flush failed")
            ms = (time.monotonic() - t0) * 1000.0
            with self._stats_lock:
                st = self._flush_stats
                st["flushes"] += 1
                st["latency_ms_total"] += ms
                if ms > st["latency_ms_max"]:
                    st["latency_ms_max"] = ms

    def submit_telemetry(self) -> Dict[str, Any]:
        """Snapshot of the submission-batching counters (bench/debug)."""
        with self._stats_lock:
            return {"batch_hist": dict(self._submit_hist),
                    "actor_batch_hist": dict(self._actor_hist),
                    "actor_sends": self._actor_sends,
                    "flush": dict(self._flush_stats)}

    def _lease_reaper_loop(self):
        """Return leases that have sat idle past the TTL so their resources
        free up for other clients (reference: worker lease idle timeout)."""
        while not self._shutdown:
            time.sleep(IDLE_LEASE_TTL_S / 2)
            with self.lock:
                pools = list(self.pools.values())
            for pool in pools:
                try:
                    self._maybe_return_idle_leases(pool)
                except Exception:
                    pass

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def shutdown(self):
        if self._shutdown:
            return
        # tell owners this core's borrowed actor handles are gone (a
        # crashed borrower instead leaks its registration until the owner
        # core exits; actors die with their job regardless)
        with self.lock:
            borrowed_actors = {aid: tuple(rec[1])
                               for aid, rec in self._borrowed_actors.items()}
            self._borrowed_actors.clear()
        for aid, owner_addr in borrowed_actors.items():
            if owner_addr == self.addr:
                continue
            try:
                # best-effort with a FAST connect bound: the 30s default
                # connect retry is for owners still booting; here a dead
                # owner (its actors die with it) must not stall shutdown
                # — N dead owners once cost N x 30s of teardown
                self._owner_client(owner_addr, connect_timeout=0.5).notify(
                    "actor_del_ref", {"actor_id": aid,
                                      "borrower": self.worker_id,
                                      "all": True})
            except Exception:
                pass
        self._shutdown = True
        with self._flush_cv:
            self._flush_cv.notify_all()  # wake the submit flusher to exit
        # fail pending awaited futures instead of hanging their loops
        with self._future_lock:
            waiters, self._future_waiters = self._future_waiters, []
        for _entry, _run, fut in waiters:
            if not fut.done():
                try:
                    fut.set_exception(
                        RayTpuError("ray_tpu_torch shut down while awaiting"))
                except Exception:
                    pass
        self._future_event.set()
        global _current_core
        if _current_core is self:
            prev = self._prev_current_core
            _current_core = prev if (prev is not None
                                     and not prev._shutdown) else None
        with self.lock:
            pools = list(self.pools.values())
            actors = list(self.actors.values())
            owners = list(self.owner_clients.values())
        # withdraw our queued lease requests: granting one to a departing
        # client books resources nobody will use (conn-drop purging on
        # the raylet is the backstop for crashes)
        try:
            if self.raylet is not None:
                self.raylet.notify("cancel_lease_requests",
                                   {"client_id": self.worker_id})
        except Exception:
            pass
        # return IDLE leases explicitly, one client per granting raylet:
        # a departing driver's conn teardown also reclaims
        # (h_disconnect), but the polite return frees resources without
        # waiting for the socket.  An INFLIGHT lease is not returned —
        # recycling a worker mid-task would queue the next lessee behind
        # abandoned work; conn-drop reclaim kills those instead.
        by_raylet: Dict[Tuple, List] = {}
        for pool in pools:
            for lw in list(pool.leases.values()):
                if not lw.inflight:
                    by_raylet.setdefault(tuple(lw.raylet_addr),
                                         []).append(lw.worker_id)
        for addr, wids in by_raylet.items():
            try:
                if addr == self.raylet_addr and self.raylet is not None:
                    cli, transient = self.raylet, False
                else:
                    cli = Client(addr, name="core-return",
                                 connect_timeout=1.0)
                    transient = True
                for wid in wids:
                    cli.notify("return_lease", {"worker_id": wid})
                if transient:
                    cli.close()
            except Exception:
                pass
        for pool in pools:
            for lw in list(pool.leases.values()):
                try:
                    lw.client.close()
                except Exception:
                    pass
        for ac in actors:
            if ac.client:
                ac.client.close()
        for c in owners:
            c.close()
        try:
            self.task_events.stop()
        except Exception:
            pass
        # final span flush while the control client is still open
        from ray_tpu_torch.util import tracing as _tracing

        _tracing.detach_collector()
        try:
            self.control.close()
        except Exception:
            pass
        if self.raylet:
            self.raylet.close()
        self.server.stop()
        self.pool_executor.shutdown(wait=False)

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------

    def _new_entry(self, oid: str) -> ObjectEntry:
        e = ObjectEntry()
        self.objects[oid] = e
        return e

    def _estimate_nbytes(self, value) -> Optional[int]:
        dev = serialization.device_nbytes(value)
        if dev is not None:
            return dev
        try:
            import numpy as np

            if isinstance(value, np.ndarray):
                return int(value.nbytes)
        except Exception:
            pass
        if isinstance(value, (bytes, bytearray, memoryview)):
            return len(value)
        return None

    def put(self, value) -> ObjectRef:
        with self.lock:
            self._put_seq += 1
            oid = common.put_object_id(self.worker_id, self._put_seq)
            e = self._new_entry(oid)
            e.pins = 1
            self.local_ref_counts[oid] = 1
        size = self._estimate_nbytes(value)
        # CUDA tensors (alone or in a dict/list/tuple) stay device-resident
        # in this process; a borrower's fetch stages them to host once
        # (_stage_device_value)
        is_device = serialization.holds_cuda_tensor(value)
        if is_device or (size is not None and size <= INLINE_OBJECT_LIMIT):
            e.value = value
            e.has_value = True
            e.nbytes = size or 0
            e.event.set()
        else:
            meta, bufs = serialization.dumps_oob(value)
            raw = [b.raw() for b in bufs]
            total = len(meta) + sum(len(b) for b in raw)
            if total <= INLINE_OBJECT_LIMIT or self.store is None:
                e.value = value
                e.has_value = True
                e.nbytes = total
                e.event.set()
            else:
                self._store_create(oid, meta, raw)
                e.shm_node = self.node_id
                e.shm_addr = self.raylet_addr
                e.nbytes = total
                e.event.set()
        return ObjectRef(oid, self.addr, self.worker_id)

    def _store_create(self, oid: str, meta: bytes, raw) -> None:
        """store.create with pressure relief: when the arena can't place
        the object in warm (already-touched) space, flush this core's
        grace-delayed deletes and retry before growing into cold pages or
        overflowing to disk files (memory pressure overrides the delete
        grace period, like the reference's eviction-under-pressure)."""
        st = self.store
        if st.create(oid, meta, raw, warm_only=True) is not None:
            return
        self.flush_pending_deletes()
        if st.create(oid, meta, raw, warm_only=True) is not None:
            return
        st.create(oid, meta, raw)

    def flush_pending_deletes(self) -> None:
        """Delete every grace-queued object NOW, and wait for the local
        raylet to drop them from the shm arena (the normal path only
        notifies) — the caller is about to retry an allocation."""
        local: List[str] = []
        while True:
            try:
                _, oid = self._delete_queue.popleft()
            except IndexError:
                break
            try:
                self._maybe_delete(oid, collect_local=local)
            except Exception:
                pass
        if local and self.raylet is not None:
            try:
                self.raylet.call("delete_objects", {"object_ids": local},
                                 timeout=10.0)
            except Exception:
                pass

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        self._mark_blocked(True)
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            out = [self._get_one(r, deadline) for r in refs]
        finally:
            self._mark_blocked(False)
        return out[0] if single else out

    def _remaining(self, deadline) -> Optional[float]:
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    def _get_one(self, ref: ObjectRef, deadline):
        if not isinstance(ref, ObjectRef):
            raise TypeError(f"get() expects ObjectRef, got {type(ref)}")
        with self.lock:
            entry = self.objects.get(ref.id)
        if entry is not None:
            return self._materialize_local(ref, entry, deadline)
        return self._fetch_from_owner(ref, deadline)

    def _materialize_local(self, ref, entry: ObjectEntry, deadline):
        if not entry.event.wait(self._remaining(deadline)):
            raise GetTimeoutError(f"get() timed out waiting for {ref.id}")
        if entry.error is not None:
            raise_stored(entry.error)
        if entry.has_value:
            return entry.value
        if entry.shm_node is not None:
            value = self._read_shm_value(ref.id, entry, deadline)
            return value
        raise ObjectLostError(f"object {ref.id} has no value or location")

    def _read_shm_value(self, oid: str, entry: ObjectEntry, deadline):
        # local node?
        if self.store is not None and (entry.shm_node == self.node_id
                                       or self.store.contains(oid)):
            got = self.store.get(oid)
            if got is None and entry.shm_addr is not None:
                got = self._pull_then_get(oid, entry, deadline)
        elif entry.shm_addr is not None:
            got = self._pull_then_get(oid, entry, deadline)
        else:
            got = None
        if got is None:
            return self._recover_object(oid, entry, deadline)
        meta, bufs = got
        return serialization.loads_oob(
            meta, bufs, keep_stand_ins=self.keep_device_stand_ins)

    def _pull_then_get(self, oid, entry, deadline):
        if self.raylet is None or self.store is None:
            # no local store: fetch raw bytes via owner's raylet
            try:
                peer = Client(entry.shm_addr, name="core-pull")
                data = peer.call("fetch_object", {"object_id": oid},
                                 timeout=self._remaining(deadline) or 300.0)
                peer.close()
            except Exception:
                return None
            if data is None:
                return None
            from .shm_store import unpack

            return unpack(memoryview(data))
        try:
            ok = self.raylet.call("pull_object", {
                "object_id": oid, "from_addr": entry.shm_addr,
            }, timeout=self._remaining(deadline) or 300.0)
        except Exception:
            ok = False
        if not ok:
            return None
        return self.store.get(oid)

    def _recover_object(self, oid, entry: ObjectEntry, deadline):
        """Lineage reconstruction: resubmit the creating task
        (reference: object_recovery_manager.h:41)."""
        if entry.lineage is None:
            raise ObjectLostError(f"object {oid} lost and has no lineage")
        logger.warning("reconstructing lost object %s by resubmitting %s",
                       oid, entry.lineage.task_id)
        entry.event.clear()
        entry.shm_node = None
        entry.shm_addr = None
        self._submit_spec(entry.lineage, retries_left=1, recovery=True)
        if not entry.event.wait(self._remaining(deadline)):
            raise GetTimeoutError(f"timed out reconstructing {oid}")
        if entry.error is not None:
            raise_stored(entry.error)
        if entry.has_value:
            return entry.value
        return self._read_shm_value(oid, entry, deadline)

    def _fetch_from_owner(self, ref: ObjectRef, deadline):
        if ref.owner_addr is None:
            raise ObjectLostError(f"{ref.id}: no owner address")
        cli = self._owner_client(ref.owner_addr)
        try:
            r = cli.call("get_object", {"object_id": ref.id},
                         timeout=self._remaining(deadline))
        except ConnectionLost:
            raise ObjectLostError(f"owner of {ref.id} at {ref.owner_addr} died")
        except TimeoutError:
            raise GetTimeoutError(f"get() timed out waiting for {ref.id}")
        kind = r["kind"]
        if kind == "inline":
            meta, bufs = r["meta"], [memoryview(b) for b in r["bufs"]]
            return serialization.loads_oob(
                meta, bufs, keep_stand_ins=self.keep_device_stand_ins)
        if kind == "shm":
            entry = ObjectEntry()
            entry.shm_node = r["node_id"]
            entry.shm_addr = tuple(r["addr"]) if r["addr"] else None
            entry.event.set()
            return self._read_shm_value(ref.id, entry, deadline)
        if kind == "error":
            raise serialization.loads_inline(r["error"])
        raise ObjectLostError(f"{ref.id}: owner replied {kind}")

    def _owner_client(self, addr, connect_timeout: float = 30.0) -> Client:
        addr = tuple(addr)
        housekeeping = connect_timeout <= 5.0
        with self.lock:
            cli = self.owner_clients.get(addr)
            if cli is not None and not cli.closed:
                return cli
            dead_until = self._owner_dead_until.get(addr, 0.0)
        if housekeeping and dead_until > time.monotonic():
            # negative cache for NOTIFY flows only (short timeouts): a
            # churned-away owner (dead coordinator, exited driver) must
            # not cost every ref-release a fresh connect retry.  The
            # data path (long default timeout: get/add_ref — owners may
            # still be booting) always attempts, and success clears the
            # quarantine.
            raise ConnectionLost(f"owner {addr} recently unreachable")
        try:
            cli = Client(addr, name="core->owner",
                         connect_timeout=connect_timeout)
        except ConnectionLost:
            with self.lock:
                if len(self._owner_dead_until) > 64:
                    now = time.monotonic()
                    self._owner_dead_until = {
                        a: t for a, t in self._owner_dead_until.items()
                        if t > now}
                self._owner_dead_until[addr] = time.monotonic() + 60.0
            raise
        with self.lock:
            self._owner_dead_until.pop(addr, None)
            self.owner_clients[addr] = cli
        return cli

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: List[ObjectRef] = []
        self._mark_blocked(True)
        try:
            while len(ready) < num_returns:
                progressed = False
                still = []
                for r in pending:
                    with self.lock:
                        e = self.objects.get(r.id)
                    if e is not None and e.ready:
                        ready.append(r)
                        progressed = True
                    elif e is None:
                        # borrowed ref: poll owner cheaply
                        try:
                            cli = self._owner_client(r.owner_addr)
                            st = cli.call("get_object",
                                          {"object_id": r.id, "poll": True},
                                          timeout=5.0)
                            if st["kind"] != "pending":
                                ready.append(r)
                                progressed = True
                            else:
                                still.append(r)
                        except Exception:
                            ready.append(r)  # owner gone: surfaces on get
                            progressed = True
                    else:
                        still.append(r)
                pending = still
                if len(ready) >= num_returns:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                if not progressed:
                    time.sleep(0.002)
        finally:
            self._mark_blocked(False)
        ready_set = {r.id for r in ready}
        returned = [r for r in refs if r.id in ready_set][:num_returns]
        returned_ids = {r.id for r in returned}
        # ready-but-not-returned refs stay in the second list (reference
        # semantics): dropping them loses objects for wait-loop consumers
        return (returned,
                [r for r in refs if r.id not in returned_ids])

    def as_future(self, ref: ObjectRef):
        """concurrent.futures.Future resolving to the ref's value.  Local
        refs park in a dispatcher (no thread held while pending — an
        async driver may gather thousands); only ready values pay a pool
        thread to materialize (shm reads can block)."""
        from concurrent.futures import Future

        fut: Future = Future()

        def run():
            try:
                res = self.get(ref)
                if not fut.cancelled():
                    fut.set_result(res)
            except BaseException as e:
                if not fut.cancelled():
                    fut.set_exception(e)

        with self.lock:
            entry = self.objects.get(ref.id)
        if entry is None:
            # borrowed ref: the owner fetch blocks start-to-finish
            self.pool_executor.submit(run)
            return fut
        with self._future_lock:
            self._future_waiters.append((entry, run, fut))
        self._future_event.set()
        return fut

    def _future_dispatch_loop(self):
        """Multiplexes pending as_future waiters over entry events."""
        while not self._shutdown:
            with self._future_lock:
                pending = list(self._future_waiters)
            if not pending:
                self._future_event.wait(0.5)
                self._future_event.clear()
                continue
            fired = [t for t in pending
                     if t[0].event.is_set() or t[2].cancelled()]
            if fired:
                with self._future_lock:
                    for t in fired:
                        try:
                            self._future_waiters.remove(t)
                        except ValueError:
                            pass
                for _entry, run, fut in fired:
                    if not fut.cancelled():
                        self.pool_executor.submit(run)
            else:
                time.sleep(0.005)

    # ------------------------------------------------------------------
    # ref counting
    # ------------------------------------------------------------------

    def _remove_local_ref(self, ref: ObjectRef):
        notify_owner = False
        with self.lock:
            if ref.id in self.objects:
                n = self.local_ref_counts.get(ref.id, 0) - 1
                self.local_ref_counts[ref.id] = n
                if n <= 0:
                    self._unpin(ref.id)
            elif ref.id in self.borrowed:
                self.borrowed.pop(ref.id, None)
                notify_owner = bool(ref.owner_addr)
        if notify_owner:
            # OUTSIDE the lock: connecting to a dead owner retries for
            # seconds, and holding the core lock through that froze the
            # entire core in 30s quanta whenever refs to a dead owner
            # (e.g. a finished split coordinator) were dropped
            try:
                self._owner_client(ref.owner_addr,
                                   connect_timeout=2.0).notify(
                    "del_ref", {"object_id": ref.id})
            except Exception:
                pass

    def _pin(self, oid: str, n: int = 1):
        with self.lock:
            e = self.objects.get(oid)
            if e is not None:
                e.pins += n

    def _unpin(self, oid: str):
        with self.lock:
            e = self.objects.get(oid)
            if e is None:
                return
            e.pins -= 1
            if e.pins <= 0:
                self._delete_queue.append(
                    (time.monotonic() + DELETE_GRACE_S, oid))
                self._delete_event.set()

    def _maybe_delete(self, oid: str, collect_local: Optional[list] = None):
        with self.lock:
            e = self.objects.get(oid)
            if e is None or e.pins > 0:
                return
            self.objects.pop(oid, None)
            self.local_ref_counts.pop(oid, None)
            shm_addr = e.shm_addr
        if shm_addr is not None:
            try:
                if shm_addr == self.raylet_addr and self.raylet is not None:
                    if collect_local is not None:
                        # pressure flush: caller batches one synchronous
                        # delete_objects call so the arena space is truly
                        # free before the allocation retry
                        collect_local.append(oid)
                    else:
                        self.raylet.notify("delete_objects",
                                           {"object_ids": [oid]})
                else:
                    Client(shm_addr, name="core-del").notify(
                        "delete_objects", {"object_ids": [oid]})
            except Exception:
                pass
        if self.store is not None:
            self.store.release(oid)

    def _on_borrowed_ref(self, ref: ObjectRef):
        if ref.id in self.objects:
            with self.lock:
                self.local_ref_counts[ref.id] = self.local_ref_counts.get(ref.id, 0) + 1
            return
        with self.lock:
            known = ref.id in self.borrowed
            self.borrowed[ref.id] = SerializedRef(ref.id, ref.owner_addr, ref.owner_id)
        if not known and ref.owner_addr:
            try:
                self._owner_client(ref.owner_addr).notify("add_ref",
                                                          {"object_id": ref.id})
            except Exception:
                pass

    def _pin_for_serialization(self, ref: ObjectRef):
        self._pin(ref.id)  # owner: pin while in flight; borrower pin is remote

    # owner-side handlers
    def h_add_ref(self, conn, p):
        self._pin(p["object_id"])
        return True

    def h_del_ref(self, conn, p):
        self._unpin(p["object_id"])
        return True

    def h_get_object(self, conn, p, d: Deferred):
        oid = p["object_id"]
        poll = p.get("poll", False)
        with self.lock:
            e = self.objects.get(oid)
        if e is None:
            d.resolve({"kind": "error", "error": serialization.dumps_inline(
                ObjectLostError(f"{oid}: unknown to owner"))})
            return
        if poll and not e.ready:
            d.resolve({"kind": "pending"})
            return
        if e.ready:
            if e.error is None and e.has_value is False \
                    and e.shm_node is not None:
                # shm redirect: a tiny dict, safe on the loop thread —
                # the hot broadcast path never waits on any pool
                self._reply_get_object(e, oid, d)
            else:
                self.obj_serve_pool.submit(self._reply_get_object, e, oid, d)
        else:
            # pending objects wait on a dedicated thread so they can never
            # starve the shared pool (lease requests, actor resolution)
            threading.Thread(target=self._wait_then_reply_get_object,
                             args=(e, oid, d), daemon=True).start()

    def _wait_then_reply_get_object(self, e: "ObjectEntry", oid: str, d: Deferred):
        while not e.event.wait(1.0):
            if self._shutdown:
                d.resolve({"kind": "error",
                           "error": serialization.dumps_inline(
                               ObjectLostError(f"{oid}: owner shut down"))})
                return
        self._reply_get_object(e, oid, d)

    def _reply_get_object(self, e: "ObjectEntry", oid: str, d: Deferred):
        try:
            if e.error is not None:
                d.resolve({"kind": "error",
                           "error": serialization.dumps_inline(e.error)})
            elif e.has_value and e.shm_node is None and \
                    not self._stage_device_value(e, oid):
                meta, bufs = serialization.dumps_oob(e.value)
                d.resolve({"kind": "inline", "meta": meta,
                           "bufs": [b.raw().tobytes() for b in bufs]})
            elif e.shm_node is not None:
                d.resolve({"kind": "shm", "node_id": e.shm_node,
                           "addr": e.shm_addr})
            else:
                d.resolve({"kind": "error", "error": serialization.dumps_inline(
                    ObjectLostError(f"{oid}: no value at owner"))})
        except Exception as ex:
            d.reject(f"get_object({oid}) failed at owner: {ex}")

    def _stage_device_value(self, e: "ObjectEntry", oid: str) -> bool:
        """Stage a device-resident value to this node's shm store on its
        first remote fetch, once: the owner keeps the device value for its
        own gets and every borrower reads the one host copy (the
        reference re-serializes per fetch).  False when the value holds
        no CUDA tensor, is small enough to travel inline, or there is no
        store."""
        if self.store is None or not serialization.holds_cuda_tensor(e.value):
            return False
        with self._stage_lock:
            if e.shm_node is not None:
                return True
            meta, bufs = serialization.dumps_oob(e.value)
            raw = [b.raw() for b in bufs]
            total = len(meta) + sum(len(b) for b in raw)
            if total <= INLINE_OBJECT_LIMIT:
                return False
            self._store_create(oid, meta, raw)
            e.shm_addr = self.raylet_addr
            e.shm_node = self.node_id
            return True

    # ------------------------------------------------------------------
    # blocked notifications (nested-get deadlock avoidance)
    # ------------------------------------------------------------------

    def in_task_context(self) -> bool:
        """True on a thread currently executing (or adopted into) a task."""
        return bool(getattr(self._executing, "active", False))

    def adopt_task_context(self) -> None:
        """Mark THIS thread as part of the running task.  Helper threads a
        task spawns (e.g. data prefetchers) must call this, or their
        blocking get() never notifies the raylet and the worker's CPUs
        are not lent out while it waits (the Train+streaming deadlock).
        Library code should prefer the module-level
        `adopt_task_context()` (safe outside workers)."""
        self._executing.active = True

    def _mark_blocked(self, blocked: bool):
        if self.mode != "worker" or self.raylet is None:
            return
        if not getattr(self._executing, "active", False):
            return
        with self.lock:
            self._blocked_depth += 1 if blocked else -1
            fire = (self._blocked_depth == 1) if blocked else (self._blocked_depth == 0)
        if fire:
            try:
                self.raylet.notify("task_blocked" if blocked else "task_unblocked",
                                   {"worker_id": self.worker_id})
            except Exception:
                pass

    # ------------------------------------------------------------------
    # functions
    # ------------------------------------------------------------------

    def register_function(self, fn) -> Tuple[str, str]:
        # hot path: hashing cloudpickles the function, so memoize per
        # function object (the reference's function table is likewise
        # populated once per unique function, not per .remote() call).
        # Identity guard first: a tight .remote() loop over one function
        # skips even the weak-dict hash.
        if fn is self._last_fn:
            return self._last_fn_out
        try:
            cached = self._fn_registration_cache.get(fn)
        except TypeError:  # unhashable callables fall through
            cached = None
        if cached is not None:
            self._last_fn = fn
            self._last_fn_out = cached
            return cached
        fid, blob = common.hash_function(fn)
        with self.lock:
            new = fid not in self.registered_functions
            if new:
                self.registered_functions.add(fid)
                self.functions[fid] = fn
        if new:
            self._control_call("register_function", {"function_id": fid, "blob": blob})
        out = (fid, getattr(fn, "__qualname__", str(fn)))
        try:
            self._fn_registration_cache[fn] = out
        except TypeError:
            pass
        self._last_fn = fn
        self._last_fn_out = out
        return out

    def get_function(self, fid: str):
        with self.lock:
            fn = self.functions.get(fid)
        if fn is not None:
            return fn
        blob = self._control_call("get_function", {"function_id": fid}, timeout=30.0)
        if blob is None:
            raise RuntimeError(f"function {fid} not found in cluster function table")
        fn = cloudpickle.loads(blob)
        with self.lock:
            self.functions[fid] = fn
        return fn

    # ------------------------------------------------------------------
    # normal task submission
    # ------------------------------------------------------------------

    _EMPTY_ARGS_BLOB = serialization.dumps_inline(((), {}))
    _DEFAULT_RESOURCES = normalize_resources({common.CPU: 1})

    def serialize_args(self, args, kwargs,
                       task_id: Optional[str] = None) -> bytes:
        if not args and not kwargs:
            return self._EMPTY_ARGS_BLOB  # no-arg calls skip pickling
        if not kwargs and type(args) is tuple:
            # small-arg shortcut: plain scalars/bytes/ObjectRefs skip the
            # CloudPickler framing entirely (ref pin bookkeeping still
            # runs; actor handles are ineligible so no transit holds are
            # skipped).  None = ineligible, fall through to the full path.
            blob = serialization.dumps_args_small(
                args, limit=self._small_arg_limit,
                memo_cap=self._small_arg_memo)
            if blob is not None:
                return blob
        if task_id is None:
            return serialization.dumps_inline((args, kwargs))
        # actor handles pickled inside these args take transit holds
        # bound to this task: they refresh while the task is queued
        token = TRANSIT_TASK_ID.set(task_id)
        try:
            return serialization.dumps_inline((args, kwargs))
        finally:
            TRANSIT_TASK_ID.reset(token)

    def submit_task(self, fn, args, kwargs, *, num_returns=1, resources=None,
                    max_retries=3, strategy=None, pg=None, bundle_index=-1,
                    name="", runtime_env=None, generator_backpressure=0):
        if num_returns == "streaming":
            num_returns = STREAMING_RETURNS
        if runtime_env:
            from . import runtime_env as rtenv

            runtime_env = rtenv.prepare(runtime_env, self.control)
        fid, fname = self.register_function(fn)
        tid = common.task_id()
        spec = TaskSpec(
            task_id=tid,
            function_id=fid,
            function_name=name or fname,
            args_blob=self.serialize_args(args, kwargs, task_id=tid),
            num_returns=num_returns,
            # the default-resources dict is shared across specs (never
            # mutated downstream: _pool_key and the lease path only read
            # it, and the wire copy is a pickle)
            resources=(self._DEFAULT_RESOURCES if resources is None
                       else normalize_resources(resources)),
            max_retries=max_retries,
            scheduling_strategy=strategy,
            placement_group_id=pg,
            placement_bundle_index=bundle_index,
            owner_id=self.worker_id,
            owner_addr=self.addr,
            runtime_env=runtime_env,
            parent_task_id=EXECUTING_TASK_ID.get(),
            generator_backpressure=generator_backpressure,
            # nested tasks keep the ROOT driver's job so their logs
            # route to that driver (a worker core's own job_id is random)
            job_id=EXECUTING_JOB_ID.get() or self.job_id,
        )
        from ray_tpu_torch.util import tracing

        if tracing.is_enabled():
            with tracing.submit_span("task", spec.function_name):
                spec.trace_ctx = tracing.inject_context()
        return self._submit_spec(spec, retries_left=max_retries)

    @staticmethod
    def _trace_stage_ns(carrier) -> Optional[int]:
        """Stage-clock read for the driver.stage_wait phase — taken only
        for specs riding a sampled trace, so the untraced hot path pays
        one None check."""
        if carrier is None:
            return None
        from ray_tpu_torch.util import tracing

        if tracing.carrier_sampled(carrier):
            return time.time_ns()
        return None

    def _submit_spec(self, spec: TaskSpec, retries_left: int,
                     recovery: bool = False):
        # recovery resubmission of a streaming spec: the stream is long
        # consumed — re-executed items land straight into their awaited
        # object entries (h_generator_item fallback), no StreamState
        if spec.num_returns == STREAMING_RETURNS and not recovery \
                and spec.task_id not in self.streams:
            self.streams[spec.task_id] = StreamState(spec)
        refs = []
        key = self._pool_key(spec)
        rec = TaskRecord(spec, key, retries_left)
        rec.staged_ns = self._trace_stage_ns(spec.trace_ctx)
        # ONE lock acquisition for all submission bookkeeping: this path
        # runs once per .remote() and ping-pongs the core lock with the
        # reply thread during 100k-task bursts
        pool = None
        with self.lock:
            for oid in spec.return_ids():
                e = self.objects.get(oid)
                if e is None:
                    e = self._new_entry(oid)
                    self.local_ref_counts[oid] = 0
                # every ObjectRef we hand out counts, including the ones the
                # reconstruction path discards — their __del__ decrements
                self.local_ref_counts[oid] += 1
                e.pins = max(e.pins, 1)
                e.lineage = spec
                e.attempts += 1
                refs.append(ObjectRef(oid, self.addr, self.worker_id))
            if self._mux_on and self._mux_eligible(spec):
                # relay mode: the raylet schedules this task itself, no
                # per-driver lease conversation.  Staged specs still live
                # in task_records so cancel()/liveness checks see them.
                rec.mux = True
                self._mux_staged.append(rec)
            else:
                pool = self.pools.get(key)
                if pool is None:
                    pool = self.pools[key] = SchedPool(key)
                pool.queue.append(rec)
            self.task_records[spec.task_id] = rec  # cancel() lookup
        self.task_events.record_submit(
            spec.task_id, spec.function_name, "NORMAL_TASK")
        if pool is None:
            with self._flush_cv:
                self._mux_dirty = True
                self._flush_cv.notify()
        elif self._submit_batch <= 1:
            # escape hatch: bypass the combining flusher, ship inline
            # exactly like the pre-batching path
            self._pump(pool)
        else:
            # hand the pump to the combining flusher; by the time it runs,
            # a tight .remote() loop has queued more work and the whole
            # backlog ships as framed push_tasks batches
            with self._flush_cv:
                self._flush_dirty.add(pool)
                self._flush_cv.notify()
        if spec.num_returns == STREAMING_RETURNS and not recovery:
            return [ObjectRefGenerator(self, spec.task_id)]
        return refs

    def _pool_key(self, spec: TaskSpec):
        strat = spec.scheduling_strategy
        # retriability is part of the key so a lease's OOM-victim hint
        # (request_lease "retriable") holds for every task it ever serves
        return (tuple(sorted(spec.resources.items())),
                spec.placement_group_id, spec.placement_bundle_index,
                repr(strat) if strat else None,
                spec.max_retries > 0)

    def _pump(self, pool: SchedPool):
        to_push: List[Tuple[LeasedWorker, TaskRecord]] = []
        request_new = 0
        with self.lock:
            while pool.queue:
                lw = self._pick_lease(pool)
                if lw is None:
                    # every lease is saturated (or stalled on a slow task):
                    # aim for one outstanding lease request per queued task
                    # so queued work can run in parallel instead of
                    # stacking behind busy workers.  The whole shortfall is
                    # charged at once and served by ONE vectorized
                    # request_leases round-trip (capped per request).
                    cap = min(len(pool.queue), self._pending_lease_cap)
                    if pool.pending_requests < cap:
                        request_new = min(cap - pool.pending_requests,
                                          self._lease_grant_batch)
                        pool.pending_requests += request_new
                    break
                rec = pool.queue.popleft()
                rec.pushed_to = lw.worker_id
                lw.inflight.add(rec.spec.task_id)
                lw.inflight_since[rec.spec.task_id] = time.monotonic()
                to_push.append((lw, rec))
        if to_push:
            self._push_batched(pool, to_push)
        if request_new:
            self.pool_executor.submit(self._request_lease, pool, request_new)

    PIPELINE_STALL_S = 0.1

    def _pick_lease(self, pool: SchedPool) -> Optional[LeasedWorker]:
        """O(1) amortized pick over the rotation deque: inspect the front
        lease, rotate, return the first one with pipeline room.  The old
        per-task rebuild of list(pool.leases.values()) re-scanned every
        lease per submitted task — O(leases) per pick.  Rotation spreads
        work round-robin, which converges to the same balance the
        least-loaded scan produced (depth caps per-lease load either
        way).  Worst case (all saturated/stalled) is one full rotation,
        identical to the old scan."""
        depth = pool.depth()
        now = time.monotonic()
        # The EWMA depth is a *prediction*; a worker whose oldest
        # in-flight task has overrun the expected full-pipeline drain
        # time (2x slack) is evidence the prediction is stale — e.g. a
        # long task after a burst of tiny ones.  Don't stack more work
        # behind it; the caller leases another worker instead.
        stall_s = max(self.PIPELINE_STALL_S,
                      (pool.avg_ms or 0.0) * depth * 2 / 1000.0)
        rr = pool.rr
        for _ in range(len(rr)):
            lw = rr[0]
            rr.rotate(-1)  # the inspected lease is now at the back
            if pool.leases.get(lw.worker_id) is not lw:
                rr.pop()   # removed elsewhere: heal the rotation lazily
                continue
            if lw.client is not None and lw.client.closed:
                pool.leases.pop(lw.worker_id, None)
                rr.pop()
                continue
            n = len(lw.inflight)
            if n >= depth:
                continue
            # dict preserves insertion order and push timestamps are
            # monotonic, so the first inflight_since value IS the oldest
            if n and lw.inflight_since and \
                    now - next(iter(lw.inflight_since.values())) > stall_s:
                continue
            return lw
        return None

    @staticmethod
    def _strategy_is_hard(strategy) -> bool:
        """True when the strategy forbids running on an arbitrary node."""
        if not isinstance(strategy, dict):
            return False
        kind = strategy.get("kind")
        if kind == "node_label":
            return True
        if kind == "node_affinity":
            return not strategy.get("soft")
        return False

    def _remote_raylet_client(self, addr) -> Client:
        """One cached client per remote raylet (reference: the raylet
        client pool): a fresh conn per lease request would leak a socket
        + two threads each, and the remote raylet's reclaim/disconnect
        tracking keys off the conn — churning conns per request would
        false-signal client death on any one socket error."""
        addr = tuple(addr)
        with self.lock:
            cli = self._remote_raylets.get(addr)
            if cli is not None and not cli.closed:
                return cli
        cli = Client(addr, name="core->remote-raylet",
                     on_push=self._on_raylet_push)
        with self.lock:
            self._remote_raylets[addr] = cli
        return cli

    def _request_lease(self, pool: SchedPool, count: int = 1):
        """Acquire up to `count` leases for this pool in one vectorized
        round-trip: pick_nodes reserves the placements at the control
        plane, then each chosen raylet serves its whole share via a
        single request_leases RPC.  _pump pre-charged pending_requests by
        `count`; it is decremented by exactly `count` here on every path
        (partial grants simply leave the shortfall for the next _pump)."""
        from ray_tpu_torch.util import tracing

        carrier = None
        if tracing.is_enabled():
            with self.lock:
                spec0 = pool.queue[0].spec if pool.queue else None
            carrier = spec0.trace_ctx if spec0 is not None else None
        outcome, err = "error", None
        try:
            # the lease phase span covers pick_nodes + request_leases;
            # their CLIENT rpc spans nest under it via the contextvar
            with tracing.phase_span("driver.lease", carrier, count=count):
                outcome = self._request_lease_inner(pool, count)
        except Exception as e:
            err = e
        finally:
            with self.lock:
                pool.pending_requests -= count
                had_queue = bool(pool.queue)
        if self._shutdown or not had_queue or outcome == "canceled":
            return
        if outcome == "ok":
            self._pump(pool)
        elif outcome == "reprobe":
            # no node satisfies the hard constraint right now: stay
            # pending and re-probe (falling back to the local raylet
            # would violate the strategy — reference keeps such tasks
            # queued as demand)
            def reprobe():
                time.sleep(0.5)
                self._pump(pool)

            self.pool_executor.submit(reprobe)
        else:
            logger.warning("lease request failed (%s); retrying", err)
            time.sleep(0.2)
            self._pump(pool)

    def _request_lease_inner(self, pool: SchedPool, count: int) -> str:
        resources = dict(pool.key[0])
        pg_id, bundle_index = pool.key[1], pool.key[2]
        strategy = None
        spec0 = None
        with self.lock:
            if pool.queue:
                spec0 = pool.queue[0].spec
        if spec0 is not None:
            strategy = spec0.scheduling_strategy
        if pg_id:
            strategy = {"kind": "placement_group", "pg_id": pg_id,
                        "bundle_index": bundle_index}
        demand = common.denormalize_resources(dict(resources))
        picked = self._control_call("pick_nodes", {
            "resources": demand,
            "strategy": strategy,
            "count": count,
        }, timeout=30.0)
        if not picked:
            if self._strategy_is_hard(strategy):
                return "reprobe"
            # soft/no strategy with nothing reserved: aim the whole batch
            # at the local raylet (mirrors the old single-lease fallback)
            picked = [None] * count
        # one request_leases RPC per granting raylet, carrying its share
        shares: Dict[Optional[Tuple], int] = {}
        for pk in picked:
            addr = tuple(pk["addr"]) if pk is not None else None
            shares[addr] = shares.get(addr, 0) + 1
        got_any = False
        canceled = False
        spilled = False
        for addr, share in shares.items():
            raylet_addr = self.raylet_addr
            raylet_cli = self.raylet
            if addr is not None and addr != self.raylet_addr:
                raylet_addr = addr
                raylet_cli = self._remote_raylet_client(addr)
            if raylet_cli is None:
                raise RuntimeError("no raylet available for lease request")
            payload = {"resources": demand,
                       "client_id": self.worker_id,
                       "count": share,
                       # OOM-victim hint (reference retriable-FIFO policy):
                       # whether the work heading for this lease can be
                       # retried if the raylet kills the worker
                       "retriable": (spec0.max_retries > 0
                                     if spec0 is not None else True)}
            if pg_id:
                payload["bundle"] = (pg_id, bundle_index)
            # Idempotency token: if the connection drops after the raylet
            # granted the leases but before the reply lands, the blind
            # retry below replays the SAME request and the raylet's replay
            # cache answers with the original grant — a retry can never
            # double-place a lease.
            payload[IDEM_KEY] = idem_token()
            lease_deadline = time.monotonic() + 120.0
            bo = Backoff(_cfg().rpc_backoff_base_s,
                         _cfg().rpc_backoff_cap_s)
            while True:
                try:
                    r = raylet_cli.call(
                        "request_leases", payload,
                        timeout=max(1.0, lease_deadline - time.monotonic()))
                    break
                except (ConnectionLost, OSError) as lease_err:
                    if self._shutdown or time.monotonic() >= lease_deadline:
                        raise
                    logger.warning("request_leases connection lost (%s); "
                                   "replaying with idempotency token",
                                   lease_err)
                    bo.sleep(max_s=max(
                        0.0, lease_deadline - time.monotonic()))
                    if raylet_addr != self.raylet_addr:
                        raylet_cli = self._remote_raylet_client(raylet_addr)
                    elif self.raylet is not None \
                            and not self.raylet.closed:
                        raylet_cli = self.raylet
            if not (r and r.get("ok")):
                if r and r.get("canceled"):
                    canceled = True
                    continue
                if r and r.get("spillback"):
                    # queued where it can never run, and a node that can
                    # run it has joined: pick again
                    spilled = True
                    continue
                raise RuntimeError(f"lease request failed: {r}")
            if r.get("mux") and self._mux_enabled \
                    and addr in (None, self.raylet_addr):
                # the local raylet sees multiple concurrent submitters:
                # route future eligible submissions through the relay
                self._mux_flip_on()
            node_id = r["node_id"]
            for g in r.get("grants", []):
                with self.lock:
                    unneeded = not pool.queue
                if unneeded:
                    # queue drained while the grant was pending: hand the
                    # rest of the vector back
                    try:
                        raylet_cli.notify("return_lease",
                                          {"worker_id": g["worker_id"]})
                    except Exception:
                        pass
                    continue
                lw = LeasedWorker(g["worker_id"], g["worker_addr"],
                                  g["lease_id"], node_id, raylet_addr, None)
                lw.client = Client(
                    lw.addr, name="core->leased",
                    on_disconnect=lambda pool=pool, lw=lw:
                        self._on_worker_lost(pool, lw),
                    on_push=lambda topic, payload, pool=pool, lw=lw:
                        self._on_lease_push(pool, lw, topic, payload))
                with self.lock:
                    pool.leases[lw.worker_id] = lw
                    pool.rr.append(lw)
                got_any = True
        if got_any:
            return "ok"
        if spilled:
            return "reprobe"
        return "canceled" if canceled else "ok"

    def _push_task(self, lw: LeasedWorker, rec: TaskRecord, pool: SchedPool):
        """Legacy single-task push (submit_batch <= 1 escape hatch):
        one call_cb round-trip per task, reply handled per task."""
        def on_reply(reply, exc):
            if exc is not None:
                self._on_task_failure(pool, lw, rec, exc)
                return
            self._on_task_reply(pool, lw, rec, reply)

        lw.client.call_cb("push_task", rec.spec, on_reply)

    def _trace_flush_cm(self, chunk: List[TaskRecord], transport: str):
        """Sampled-trace bookkeeping for one shipped batch: emit a retro
        driver.stage_wait span per sampled rec (staged -> picked up by
        the combining flusher), then return a driver.flush_batch span
        contextmanager parented to the first sampled trace in the chunk,
        annotated with batch size and payload bytes.  nullcontext when
        tracing is off or nothing in the chunk is sampled."""
        from ray_tpu_torch.util import tracing

        if not tracing.is_enabled():
            return contextlib.nullcontext()
        carrier = None
        now_ns = time.time_ns()
        for rec in chunk:
            if rec.staged_ns is None:
                continue
            tracing.record_span(
                "driver.stage_wait", "INTERNAL", rec.staged_ns, now_ns,
                tracing._extract(rec.spec.trace_ctx), batch=len(chunk))
            rec.staged_ns = None   # a retried rec must not re-report
            if carrier is None:
                carrier = rec.spec.trace_ctx
        if carrier is None:
            return contextlib.nullcontext()
        payload_bytes = sum(len(rec.spec.args_blob or b"")
                            for rec in chunk)
        return tracing.phase_span(
            "driver.flush_batch", carrier, batch=len(chunk),
            payload_bytes=payload_bytes, transport=transport)

    def _push_batched(self, pool: SchedPool,
                      to_push: List[Tuple[LeasedWorker, TaskRecord]]):
        """Ship the picked (lease, task) pairs.  Batched mode groups by
        lease and frames up to submit_batch specs per one-way push_tasks
        notify — O(bytes) on the wire, no per-task reply slot; the worker
        acks via coalesced tasks_done pushes instead."""
        if self._submit_batch <= 1:
            for lw, rec in to_push:
                self._push_task(lw, rec, pool)
            return
        groups: Dict[str, Tuple[LeasedWorker, List[TaskRecord]]] = {}
        for lw, rec in to_push:   # dict keeps insertion order = FIFO
            groups.setdefault(lw.worker_id, (lw, []))[1].append(rec)
        for lw, recs in groups.values():
            for i in range(0, len(recs), self._submit_batch):
                chunk = recs[i:i + self._submit_batch]
                with self._stats_lock:
                    h = self._submit_hist
                    h[len(chunk)] = h.get(len(chunk), 0) + 1
                    self._flush_stats["tasks"] += len(chunk)
                try:
                    with self._trace_flush_cm(chunk, "lease"):
                        lw.client.notify("push_tasks",
                                         [rec.spec for rec in chunk])
                except (ConnectionLost, OSError) as e:
                    # synchronous failure only (conn already closed at
                    # enqueue); async write failures surface through the
                    # client's on_disconnect -> _on_worker_lost
                    for rec in chunk:
                        self._on_task_failure(pool, lw, rec, e)

    def _on_lease_push(self, pool: SchedPool, lw: LeasedWorker,
                       topic: str, payload):
        """Server-push from a leased worker (reader thread)."""
        if topic == "tasks_done":
            self._on_tasks_done(pool, lw, payload)

    def _on_task_reply(self, pool, lw: LeasedWorker, rec: TaskRecord, reply):
        self._on_tasks_done(pool, lw, [(rec.spec.task_id, reply)])

    def _on_tasks_done(self, pool: SchedPool, lw: LeasedWorker, items):
        """Handle a coalesced batch of task completions from one lease.
        ONE lock acquisition for the whole batch's bookkeeping: this path
        ping-pongs the core lock with the submitting thread — every extra
        acquire/release pair is contention at 100k-task submission
        bursts — and one _pump refills the freed pipeline slots for all
        completions at once."""
        finished: List[Tuple[TaskRecord, Dict[str, Any]]] = []
        with self.lock:
            for task_id, reply in items:
                lw.inflight.discard(task_id)
                lw.inflight_since.pop(task_id, None)
                ms = reply.get("exec_ms")
                if ms is not None:
                    pool.avg_ms = ms if pool.avg_ms is None else \
                        0.8 * pool.avg_ms + 0.2 * ms
                rec = self.task_records.get(task_id)
                if rec is None or rec.done:
                    continue   # late duplicate (e.g. post-retry ack)
                rec.done = True
                self.task_records.pop(task_id, None)
                finished.append((rec, reply))
            lw.idle_since = time.monotonic()
        for rec, reply in finished:
            self._released_streams.discard(rec.spec.task_id)
            if rec.canceled and reply.get("status") != "ok":
                # the worker raised out of the injected cancellation:
                # surface TaskCancelledError, not the interrupt artifact
                reply = {"status": "error",
                         "error": serialization.dumps_inline(
                             TaskCancelledError(
                                 f"task {rec.spec.function_name} "
                                 f"was cancelled"))}
            self._store_results(rec.spec, reply)
            if rec.spec.num_returns == STREAMING_RETURNS:
                self._finish_stream(rec.spec.task_id, reply)
        self._pump(pool)
        self._maybe_return_idle_leases(pool)

    # -- streaming generators (owner side) --------------------------------
    # reference: task_manager.h:355 HandleReportGeneratorItemReturns +
    # _raylet.pyx:281 ObjectRefGenerator

    def h_generator_item(self, conn, p, d):
        """A worker reports one yielded item of a streaming task.  The
        reply is the producer's backpressure ack: deferred while too many
        items sit unconsumed; {"stop": True} tells the producer to quit
        (stream closed/cancelled/unknown)."""
        tid, index = p["task_id"], p["index"]
        st = self.streams.get(tid)
        if st is None or st.closed:
            if (st is not None and st.closed) \
                    or tid in self._released_streams:
                # the consumer explicitly dropped the generator: stop
                d.resolve({"ok": False, "stop": True})
                return
            with self.lock:
                recovering = tid in self.task_records
            if not recovering:
                # not released, not recovering: a stray report from a
                # long-finished stream — nothing wants it
                d.resolve({"ok": False, "stop": True})
                return
            # lineage-recovery re-execution of a consumed stream — store
            # items someone is waiting on, ack the rest to completion
            oid = common.object_id_for_return(tid, index)
            with self.lock:
                e = self.objects.get(oid)
            if e is not None and not e.ready:
                self._store_one(e, p["result"])
            d.resolve({"ok": True})
            return
        ack = None
        with st.cv:
            if index < st.produced:
                # duplicate from a retry/recovery attempt: usually
                # already stored, but a lost-and-reconstructing item's
                # entry was reset (event cleared) — re-store those
                oid = common.object_id_for_return(tid, index)
                with self.lock:
                    e = self.objects.get(oid)
                if e is not None and not e.ready:
                    self._store_one(e, p["result"])
                ack = {"ok": True}
            else:
                oid = common.object_id_for_return(tid, index)
                with self.lock:
                    e = self.objects.get(oid) or self._new_entry(oid)
                    e.pins = max(e.pins, 1)
                    e.lineage = st.spec
                    self.local_ref_counts.setdefault(oid, 0)
                self._store_one(e, p["result"])
                st.produced = index + 1
                st.ready.append(index)
                st.cv.notify_all()
                bp = st.spec.generator_backpressure
                if bp and (st.produced - st.consumed) >= bp:
                    st.waiters.append(d)   # ack later, when consumed
                else:
                    ack = {"ok": True}
        if ack is not None:
            # the ack is a framed socket send (sock.sendall can block on
            # a slow worker): never do it while holding st.cv, or every
            # consumer in _next_stream_item stalls behind that socket
            d.resolve(ack)

    def _next_stream_item(self, tid: str, timeout: Optional[float]):
        """Blocking pop of the next stream index -> ObjectRef (None =
        exhausted)."""
        st = self.streams.get(tid)
        if st is None:
            return None
        deadline = None if timeout is None else time.monotonic() + timeout
        with st.cv:
            while True:
                if st.ready:
                    index = st.ready.popleft()
                    st.consumed += 1
                    # consumption opens backpressure windows
                    waiters, st.waiters = st.waiters, []
                    break
                if st.error is not None and st.done:
                    err = st.error
                    raise_stored(err)
                if st.done:
                    self.streams.pop(tid, None)
                    return None
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"streaming task {tid} produced no item in time")
                st.cv.wait(remaining if remaining is not None else 0.5)
        for w in waiters:
            try:
                w.resolve({"ok": True})
            except Exception:
                pass
        oid = common.object_id_for_return(tid, index)
        with self.lock:
            self.local_ref_counts[oid] = \
                self.local_ref_counts.get(oid, 0) + 1
        return ObjectRef(oid, self.addr, self.worker_id)

    def _finish_stream(self, tid: str, reply: Dict[str, Any]):
        st = self.streams.get(tid)
        if st is None:
            return
        with st.cv:
            st.done = True
            if reply.get("status") == "ok":
                st.total = reply.get("streaming_done", st.produced)
            else:
                try:
                    st.error = serialization.loads_inline(reply["error"])
                except Exception as e:
                    st.error = RayTpuError(f"stream failed: {e}")
            waiters, st.waiters = st.waiters, []
            st.cv.notify_all()
        for w in waiters:
            try:
                w.resolve({"ok": False, "stop": True})
            except Exception:
                pass

    def _fail_stream(self, tid: str, err: BaseException):
        self._finish_stream(tid, {
            "status": "error", "error": serialization.dumps_inline(err)})

    def _release_stream(self, tid: str):
        """Generator dropped by the user: stop the producer and release
        never-consumed items."""
        st = self.streams.pop(tid, None)
        if st is None:
            return
        # remember the drop so late/retried item reports are told to stop
        # (vs. lineage-recovery re-reports, which must be accepted);
        # cleared when the producer's final reply arrives
        self._released_streams.add(tid)
        with st.cv:
            st.closed = True
            pending = list(st.ready)
            st.ready.clear()
            waiters, st.waiters = st.waiters, []
            st.cv.notify_all()
        for w in waiters:
            try:
                w.resolve({"ok": False, "stop": True})
            except Exception:
                pass
        for index in pending:
            oid = common.object_id_for_return(tid, index)
            with self.lock:
                if self.local_ref_counts.get(oid, 0) <= 0:
                    self._unpin(oid)

    def _store_one(self, e: ObjectEntry, result):
        """Store one (kind, payload) wire result into an entry."""
        kind, payload = result
        if kind == "inline":
            meta, bufs = payload
            try:
                e.value = serialization.loads_oob(
                    meta, [memoryview(b) for b in bufs],
                    keep_stand_ins=self.keep_device_stand_ins)
                e.has_value = True
            except BaseException as ex:
                e.error = ex
        else:  # shm
            e.shm_node = payload["node_id"]
            e.shm_addr = tuple(payload["addr"])
            e.nbytes = payload.get("nbytes", 0)
        e.event.set()

    def _store_results(self, spec: TaskSpec, reply: Dict[str, Any]):
        status = reply.get("status")
        results = reply.get("results", [])
        for i, oid in enumerate(spec.return_ids()):
            with self.lock:
                e = self.objects.get(oid)
                if e is None:
                    continue
            if status == "ok":
                self._store_one(e, results[i])
            else:
                err = serialization.loads_inline(reply["error"])
                e.error = err
                e.event.set()

    def _on_task_failure(self, pool, lw: LeasedWorker, rec: TaskRecord, exc):
        """Worker died or connection lost mid-task: retry or error out
        (reference: TaskManager retry bookkeeping, task_manager.h:208)."""
        with self.lock:
            # idempotency guard: a lost worker can report the same task
            # through two paths (pending-call ConnectionLost callback in
            # legacy mode AND _on_worker_lost's sweep) — only the first
            # claim for this (task, worker) assignment acts
            if rec.done or rec.pushed_to != lw.worker_id:
                return
            rec.pushed_to = None
            lw.inflight.discard(rec.spec.task_id)
            lw.inflight_since.pop(rec.spec.task_id, None)
            if lw.client is not None and lw.client.closed:
                pool.leases.pop(lw.worker_id, None)
        if rec.retries_left > 0 and not self._shutdown and not rec.canceled:
            rec.retries_left -= 1
            logger.warning("task %s failed on %s (%s); retrying (%d left)",
                           rec.spec.task_id[:12], lw.worker_id[:12], exc,
                           rec.retries_left)
            with self.lock:
                pool.queue.append(rec)
            self._pump(pool)
        else:
            with self.lock:
                self.task_records.pop(rec.spec.task_id, None)
            self._released_streams.discard(rec.spec.task_id)
            if rec.canceled:
                err: BaseException = TaskCancelledError(
                    f"task {rec.spec.function_name} was cancelled")
            else:
                err = WorkerCrashedError(
                    f"task {rec.spec.function_name} failed: worker died ({exc})")
            self.task_events.record_status(
                rec.spec.task_id, "FAILED", name=rec.spec.function_name,
                error=str(err))
            for oid in rec.spec.return_ids():
                with self.lock:
                    e = self.objects.get(oid)
                if e is not None:
                    e.error = err
                    e.event.set()
            if rec.spec.num_returns == STREAMING_RETURNS:
                self._fail_stream(rec.spec.task_id, err)

    def _on_worker_lost(self, pool: SchedPool, lw: LeasedWorker):
        with self.lock:
            pool.leases.pop(lw.worker_id, None)
            lost = list(lw.inflight)
            recs = [self.task_records.get(t) for t in lost]
        # batched pushes are one-way notifies with no per-task reply slot,
        # so a dead connection surfaces ONLY here: sweep every in-flight
        # task into the retry/error path.  In legacy (submit_batch<=1)
        # mode the pending call_cb futures also fire ConnectionLost —
        # _on_task_failure's pushed_to guard keeps the two claims from
        # double-handling a task.
        err = ConnectionLost(f"worker {lw.worker_id} connection lost")
        for rec in recs:
            if rec is not None and not rec.done:
                self._on_task_failure(pool, lw, rec, err)

    def _on_raylet_push(self, topic, payload):
        """Raylet -> core notifications (worker_proc forwards unhandled
        worker-level pushes here)."""
        if topic == "reclaim_idle_leases":
            # off the push thread: returning leases does RPCs
            self.pool_executor.submit(self.flush_idle_leases)
        elif topic == "submit_mux":
            if self._mux_enabled and payload.get("on"):
                self._mux_flip_on()
        elif topic == "mux_tasks_done":
            self._on_mux_tasks_done(payload)
        elif topic == "mux_task_failed":
            self._on_mux_task_failed(payload)

    # ------------------------------------------------------------------
    # multi-client submit multiplexer (driver side).  The raylet flips
    # mux on when it observes >=2 concurrent external submitters; from
    # then on eligible plain tasks ship as framed mux_push_tasks
    # notifies on the ONE existing driver->raylet connection and the
    # raylet schedules them itself — N drivers stop holding N separate
    # pick_nodes/request_leases/push conversations with the control
    # plane and each other's reclaim storms.
    # ------------------------------------------------------------------

    def _mux_flip_on(self):
        """First submit_mux signal: route future eligible submissions
        through the relay AND migrate eligible tasks already staged in
        classic pools.  On a saturated node the relay can hold every
        worker slot, so a task parked in a pool behind an unanswered
        lease request would otherwise starve until the relay queue
        drains; moving it keeps one burst from straddling both paths."""
        moved = False
        with self.lock:
            if self._mux_on:
                return
            self._mux_on = True
            for pool in self.pools.values():
                keep: deque = deque()
                while pool.queue:
                    rec = pool.queue.popleft()
                    if not rec.canceled and not rec.done \
                            and self._mux_eligible(rec.spec):
                        rec.mux = True
                        self._mux_staged.append(rec)
                        moved = True
                    else:
                        keep.append(rec)
                pool.queue.extend(keep)
        if moved:
            with self._flush_cv:
                self._mux_dirty = True
                self._flush_cv.notify()

    def _mux_eligible(self, spec: TaskSpec) -> bool:
        # only the plain-CPU fast path rides the relay: placement
        # groups, affinity strategies, custom resources and streaming
        # generators keep the classic per-driver lease conversation
        return (self.raylet is not None
                and spec.placement_group_id is None
                and spec.scheduling_strategy is None
                and spec.num_returns != STREAMING_RETURNS
                and spec.resources == self._DEFAULT_RESOURCES)

    def _flush_mux(self):
        """Flusher-thread drain of the mux staging queue (mirrors
        _push_batched, with the raylet as the single destination)."""
        with self.lock:
            staged = list(self._mux_staged)
            self._mux_staged.clear()
            for rec in staged:
                rec.pushed_to = "__mux__"
            raylet = self.raylet
        if not staged or raylet is None:
            return
        for i in range(0, len(staged), self._submit_batch):
            chunk = staged[i:i + self._submit_batch]
            with self._stats_lock:
                h = self._submit_hist
                h[len(chunk)] = h.get(len(chunk), 0) + 1
                self._flush_stats["tasks"] += len(chunk)
            try:
                with self._trace_flush_cm(chunk, "mux"):
                    raylet.notify("mux_push_tasks",
                                  {"client_id": self.worker_id,
                                   "specs": [rec.spec for rec in chunk]})
            except (ConnectionLost, OSError) as e:
                for rec in chunk:
                    self._mux_task_failed(rec, str(e))

    def _on_mux_tasks_done(self, items):
        """Coalesced completions relayed by the raylet (reader thread);
        the lease-free twin of _on_tasks_done."""
        finished: List[Tuple[TaskRecord, Dict[str, Any]]] = []
        with self.lock:
            for task_id, reply in items:
                rec = self.task_records.get(task_id)
                if rec is None or rec.done:
                    continue   # late duplicate (e.g. post-retry ack)
                rec.done = True
                self.task_records.pop(task_id, None)
                finished.append((rec, reply))
        for rec, reply in finished:
            if rec.canceled and reply.get("status") != "ok":
                reply = {"status": "error",
                         "error": serialization.dumps_inline(
                             TaskCancelledError(
                                 f"task {rec.spec.function_name} "
                                 f"was cancelled"))}
            self._store_results(rec.spec, reply)

    def _on_mux_task_failed(self, items):
        """The raylet reports relay tasks whose worker died: retry by
        restaging, else error out (same policy as _on_task_failure)."""
        retry = False
        failed: List[Tuple[TaskRecord, str]] = []
        with self.lock:
            for task_id, errstr in items:
                rec = self.task_records.get(task_id)
                # pushed_to guard: a restaged rec (pushed_to None) must
                # not be claimed twice by duplicate failure reports
                if rec is None or rec.done or not rec.mux \
                        or rec.pushed_to != "__mux__":
                    continue
                rec.pushed_to = None
                if rec.retries_left > 0 and not self._shutdown \
                        and not rec.canceled:
                    rec.retries_left -= 1
                    self._mux_staged.append(rec)
                    retry = True
                else:
                    self.task_records.pop(task_id, None)
                    failed.append((rec, errstr))
        if retry:
            with self._flush_cv:
                self._mux_dirty = True
                self._flush_cv.notify()
        for rec, errstr in failed:
            self._mux_error_out(rec, errstr)

    def _mux_task_failed(self, rec: TaskRecord, errstr: str):
        """Synchronous-send failure for ONE staged rec (raylet conn
        already closed at enqueue)."""
        self._on_mux_task_failed([(rec.spec.task_id, errstr)])

    def _mux_error_out(self, rec: TaskRecord, errstr: str):
        if rec.canceled:
            err: BaseException = TaskCancelledError(
                f"task {rec.spec.function_name} was cancelled")
        else:
            err = WorkerCrashedError(
                f"task {rec.spec.function_name} failed: worker died "
                f"({errstr})")
        self.task_events.record_status(
            rec.spec.task_id, "FAILED", name=rec.spec.function_name,
            error=str(err))
        for oid in rec.spec.return_ids():
            with self.lock:
                e = self.objects.get(oid)
            if e is not None and not e.ready:
                e.error = err
                e.event.set()

    def _on_raylet_lost(self):
        """The raylet connection died: every relay-routed task loses its
        transport AND its completion channel — error them all out (the
        classic path's lease conversations die through their own worker
        conns)."""
        if self._shutdown:
            return
        with self.lock:
            recs = [r for r in self.task_records.values()
                    if r.mux and not r.done]
            for r in recs:
                self.task_records.pop(r.spec.task_id, None)
            self._mux_staged.clear()
        for rec in recs:
            self._mux_error_out(rec, "raylet connection lost")

    def flush_idle_leases(self) -> None:
        """Return EVERY currently-idle lease now (on-demand reclaim: the
        raylet pushes this when other clients' lease requests are starved
        — the reference's ReleaseUnusedWorkers role).  Without it, idle
        leases sit for IDLE_LEASE_TTL_S while a queued request waits:
        each new scheduling key (new remote function) builds its own
        lease pool, so a sequence of one-shot workloads once degraded to
        one 30s reap-quantum per round."""
        with self.lock:
            pools = list(self.pools.values())
        for pool in pools:
            # 1s threshold: a just-idled lease may be mid-assignment in
            # the submit pipeline; anything idle a full second is truly
            # surplus (vs the 30s TTL reaper)
            self._maybe_return_idle_leases(pool, ttl_s=1.0,
                                           allow_cancel=False)

    def _maybe_return_idle_leases(self, pool: SchedPool,
                                  ttl_s: float = IDLE_LEASE_TTL_S,
                                  allow_cancel: bool = True):
        now = time.monotonic()
        to_return = []
        cancel = False
        with self.lock:
            if pool.queue:
                return
            if pool.pending_requests > 0:
                # the pool still wants workers: in the on-demand flush
                # (allow_cancel=False) leave it entirely alone — its
                # in-flight requests are someone's live work, and
                # canceling them here starves the flushing client itself
                if not allow_cancel:
                    return
                cancel = True
            for wid, lw in list(pool.leases.items()):
                if not lw.inflight and now - lw.idle_since > ttl_s:
                    pool.leases.pop(wid)
                    to_return.append(lw)
        if cancel and self.raylet is not None:
            try:
                self.raylet.notify("cancel_lease_requests",
                                   {"client_id": self.worker_id})
            except Exception:
                pass
        for lw in to_return:
            try:
                cli = Client(lw.raylet_addr, name="core-return")
                cli.notify("return_lease", {"worker_id": lw.worker_id})
                cli.close()
            except Exception:
                pass
            lw.client.close()

    # ------------------------------------------------------------------
    # actors (submitter side)
    # ------------------------------------------------------------------

    def create_actor(self, cls, args, kwargs, *, resources=None, name=None,
                     max_restarts=0, max_task_retries=0, max_concurrency=1,
                     pg=None, bundle_index=-1, detached=False,
                     runtime_env=None, namespace=None, strategy=None) -> str:
        aid = common.actor_id()
        common._ensure_picklable_by_value(cls)
        container = None
        if runtime_env:
            from . import runtime_env as rtenv

            runtime_env = rtenv.prepare(runtime_env, self.control)
            container = rtenv.container_spec(runtime_env)
        spec = {
            "class_blob": cloudpickle.dumps(cls),
            "args_blob": self.serialize_args(args, kwargs),
            "max_concurrency": max_concurrency,
            "runtime_env": runtime_env,
        }
        ac = ActorConn(aid)
        ac.max_task_retries = max_task_retries
        with self.lock:
            self.actors[aid] = ac
        self._control_call("create_actor", {
            "actor_id": aid,
            "container": container,
            "spec_blob": cloudpickle.dumps(spec),
            "name": name,
            "class_name": getattr(cls, "__name__", "Actor"),
            "resources": {common.CPU: 1} if resources is None else resources,
            "namespace": namespace or self.namespace,
            "max_restarts": max_restarts,
            "owner_id": self.worker_id,
            # only driver jobs register with control, so only they can
            # "claim" restored actors after a control restart; actors
            # created from workers send "" (exempt from orphan reaping)
            "job_id": self.job_id if self.mode == "driver" else "",
            "pg_id": pg,
            "bundle_index": bundle_index,
            "detached": detached,
            "strategy": strategy,
        }, timeout=120.0)
        self.pool_executor.submit(self._resolve_actor, aid)
        return aid

    def _actor_conn(self, actor_id: str) -> ActorConn:
        with self.lock:
            ac = self.actors.get(actor_id)
            if ac is None:
                ac = self.actors[actor_id] = ActorConn(actor_id)
                self.pool_executor.submit(self._resolve_actor, actor_id)
            return ac

    def _resolve_actor(self, actor_id: str, min_incarnation: int = 0):
        ac = self._actor_conn(actor_id)
        with ac.lock:
            if ac.resolving:
                return
            ac.resolving = True
        try:
            # no overall deadline: an actor queued behind busy resources
            # stays PENDING arbitrarily long and must not be failed for it
            # (callers bound their own waits via get(timeout)); only a
            # DEAD/missing actor is fatal
            while not self._shutdown:
                view = self._control_call(
                    "wait_actor_alive",
                    {"actor_id": actor_id, "timeout": 60.0,
                     "min_incarnation": min_incarnation},
                    timeout=70.0)
                if view is None or view["state"] == "DEAD":
                    err = (view or {}).get("error") or "actor not found"
                    self._fail_actor(ac, err)
                    return
                if view["state"] != "ALIVE":
                    time.sleep(0.05)
                    continue
                try:
                    client = Client(
                        tuple(view["worker_addr"]),
                        name=f"core->actor-{actor_id[:8]}",
                        on_disconnect=lambda: self._on_actor_conn_lost(actor_id),
                        on_push=lambda topic, payload, aid=actor_id:
                            self._on_actor_push(aid, topic, payload),
                        connect_timeout=5.0)
                except (ConnectionLost, OSError):
                    # stale view: this incarnation already died and the
                    # control plane hasn't processed the death yet — wait
                    # for a newer incarnation (or DEAD)
                    min_incarnation = view["incarnation"] + 1
                    continue
                with ac.lock:
                    ac.client = client
                    ac.addr = tuple(view["worker_addr"])
                    ac.incarnation = view["incarnation"]
                    ac.state = "ALIVE"
                    if self._submit_batch > 1:
                        # batched mode: leave the backlog staged and let
                        # the flusher ship it as framed envelopes
                        buffered = None
                        has_backlog = bool(ac.buffer)
                    else:
                        buffered = list(ac.buffer)
                        ac.buffer.clear()
                        has_backlog = False
                if buffered is None:
                    if has_backlog:
                        with self._flush_cv:
                            self._flush_dirty_actors.add(ac)
                            self._flush_cv.notify()
                else:
                    for spec in buffered:
                        self._send_actor_task(ac, spec)
                return
        finally:
            with ac.lock:
                ac.resolving = False

    def _fail_actor(self, ac: ActorConn, err: str):
        logger.debug("marking actor %s DEAD at driver: %s", ac.actor_id, err)
        with ac.lock:
            ac.state = "DEAD"
            ac.dead_error = err
            pending = list(ac.buffer) + list(ac.inflight.values())
            ac.buffer.clear()
            ac.inflight.clear()
        e = ActorDiedError(err)
        for spec in pending:
            if spec.num_returns == STREAMING_RETURNS:
                self._fail_stream(spec.task_id, e)
            for oid in spec.return_ids():
                with self.lock:
                    ent = self.objects.get(oid)
                if ent is not None:
                    ent.error = e
                    ent.event.set()

    def submit_actor_task(self, actor_id: str, method_name: str, args, kwargs,
                          num_returns: int = 1,
                          generator_backpressure: int = 0) -> List[ObjectRef]:
        if num_returns == "streaming":
            num_returns = STREAMING_RETURNS
        ac = self._actor_conn(actor_id)
        tid = common.task_id()
        spec = TaskSpec(
            task_id=tid,
            function_id="",
            function_name=method_name,
            args_blob=self.serialize_args(args, kwargs, task_id=tid),
            num_returns=num_returns,
            actor_id=actor_id,
            seq_no=0,   # assigned with the stage/send decision below
            owner_id=self.worker_id,
            owner_addr=self.addr,
            parent_task_id=EXECUTING_TASK_ID.get(),
            job_id=EXECUTING_JOB_ID.get() or self.job_id,
            generator_backpressure=generator_backpressure,
        )
        from ray_tpu_torch.util import tracing

        if tracing.is_enabled():
            with tracing.submit_span("actor_task", method_name):
                spec.trace_ctx = tracing.inject_context()
            staged_ns = self._trace_stage_ns(spec.trace_ctx)
            if staged_ns is not None:
                # local-only attr: TaskSpec.__reduce__ pickles declared
                # fields, so the stage clock never rides the wire
                spec._staged_ns = staged_ns
        streaming = spec.num_returns == STREAMING_RETURNS
        task_id_for_stream = spec.task_id
        if streaming and spec.task_id not in self.streams:
            self.streams[spec.task_id] = StreamState(spec)
        refs = []
        with self.lock:
            for oid in spec.return_ids():
                e = self._new_entry(oid)
                e.pins = 1
                self.local_ref_counts[oid] = 1
                refs.append(ObjectRef(oid, self.addr, self.worker_id))
        if streaming:
            refs = [ObjectRefGenerator(self, spec.task_id)]
        self.task_events.record_submit(
            spec.task_id, method_name, "ACTOR_TASK", actor_id=actor_id)
        # A locally-DEAD conn may be stale: during control-plane failover
        # the conn can be marked dead (lost worker + transient control
        # unavailability) while the restored control has since restarted
        # the actor.  Re-check the authoritative record and revive the
        # conn if the actor is in fact coming back.  The verdict is
        # TTL-cached per conn: the probe is a synchronous control
        # round-trip (timeout=10.0) that must not tax every call to a
        # genuinely dead actor.
        if ac.state == "DEAD":
            with ac.lock:
                probe = ac.state == "DEAD" \
                    and time.monotonic() >= ac.dead_recheck_at
            if probe:
                try:
                    view = self._control_call(
                        "get_actor", {"actor_id": actor_id}, timeout=10.0)
                except Exception:
                    view = None
                with ac.lock:
                    if view and view["state"] in ("ALIVE", "RESTARTING",
                                                  "PENDING"):
                        if ac.state == "DEAD":
                            ac.state = "RECONNECTING"
                            ac.dead_error = None
                            ac.client = None
                    else:
                        ac.dead_recheck_at = \
                            time.monotonic() + DEAD_RECHECK_TTL_S
        # single critical section assigns the seq AND decides
        # stage/send — splitting the two let a concurrent submitter
        # interleave between seq assignment and enqueue, shipping seqs
        # out of FIFO order; it also closes the double-send race with
        # _resolve_actor's buffer flush
        batched = self._submit_batch > 1
        with ac.lock:
            if ac.state == "DEAD":
                dead = True
                need_resolve = False
                staged = False
            else:
                dead = False
                ac.seq += 1
                spec.seq_no = ac.seq
                if batched or ac.client is None:
                    ac.buffer.append(spec)
                    staged = True
                    need_resolve = ac.client is None and not ac.resolving
                    spec = None
                else:
                    staged = False
                    need_resolve = False
        if dead:
            e = ActorDiedError(ac.dead_error or "actor is dead")
            if streaming:
                self._fail_stream(task_id_for_stream, e)
                return refs
            for oid in [r.id for r in refs]:
                with self.lock:
                    ent = self.objects.get(oid)
                if ent is not None:
                    ent.error = e
                    ent.event.set()
            return refs
        if need_resolve:
            self.pool_executor.submit(self._resolve_actor, actor_id)
        if staged and batched:
            # hand the send to the combining flusher (a conn with no
            # client yet is skipped there; _resolve_actor re-marks it)
            with self._flush_cv:
                self._flush_dirty_actors.add(ac)
                self._flush_cv.notify()
        elif spec is not None:
            self._send_actor_task(ac, spec)
        return refs

    def _send_actor_task(self, ac: ActorConn, spec: TaskSpec):
        with ac.lock:
            client = ac.client
            if client is None:
                ac.buffer.append(spec)
                return
            ac.inflight[spec.task_id] = spec
        # actor sends bypass the combining flusher (one frame per call,
        # straight to the actor's worker) — record them in the same
        # batch histogram as size-1 rows so submit telemetry covers the
        # actor path too, not just push_tasks batches
        with self._stats_lock:
            self._submit_hist[1] = self._submit_hist.get(1, 0) + 1
            self._actor_sends += 1
        fut = client.call_async("actor_task", spec)

        def on_done(f):
            try:
                reply = f.result()
            except (ConnectionLost, RpcError) as e:
                # connection-level failure: handled by _on_actor_conn_lost,
                # which decides retry vs error using the control plane state
                return
            with ac.lock:
                ac.inflight.pop(spec.task_id, None)
            self._store_results(spec, reply)
            if spec.num_returns == STREAMING_RETURNS:
                self._finish_stream(spec.task_id, reply)

        fut.add_done_callback(on_done)

    def _flush_actor_conn(self, ac: ActorConn):
        """Flusher-thread drain of one actor conn's staging queue: move
        the whole backlog to inflight under the conn lock, ship it as
        framed push_tasks envelopes outside it.  seq/FIFO order is
        preserved end to end: submit stages in seq order, one flusher
        thread drains, and the client's combining writer is strict FIFO
        per conn."""
        with ac.lock:
            if ac.client is None or ac.state != "ALIVE" or not ac.buffer:
                # PENDING/RECONNECTING: _resolve_actor re-marks the conn
                # dirty once it lands; DEAD drains through _fail_actor
                return
            specs = list(ac.buffer)
            ac.buffer.clear()
            for spec in specs:
                ac.inflight[spec.task_id] = spec
            client = ac.client
        for i in range(0, len(specs), self._submit_batch):
            chunk = specs[i:i + self._submit_batch]
            with self._stats_lock:
                h = self._actor_hist
                h[len(chunk)] = h.get(len(chunk), 0) + 1
                self._actor_sends += len(chunk)
                self._flush_stats["tasks"] += len(chunk)
            try:
                with self._trace_actor_flush_cm(chunk):
                    client.notify("push_tasks", chunk)
            except (ConnectionLost, OSError):
                # conn died between stage and ship: everything already
                # sits in inflight, and the on_disconnect sweep
                # (_on_actor_conn_lost) claims it all — retry vs error
                # is decided there from the control-plane view
                return

    def _trace_actor_flush_cm(self, chunk: List[TaskSpec]):
        """Actor twin of _trace_flush_cm: the staging queue holds bare
        specs, so the stage clock rides a local-only spec attribute."""
        from ray_tpu_torch.util import tracing

        if not tracing.is_enabled():
            return contextlib.nullcontext()
        carrier = None
        now_ns = time.time_ns()
        for spec in chunk:
            staged_ns = getattr(spec, "_staged_ns", None)
            if staged_ns is None:
                continue
            tracing.record_span(
                "driver.stage_wait", "INTERNAL", staged_ns, now_ns,
                tracing._extract(spec.trace_ctx), batch=len(chunk))
            spec._staged_ns = None
            if carrier is None:
                carrier = spec.trace_ctx
        if carrier is None:
            return contextlib.nullcontext()
        payload_bytes = sum(len(spec.args_blob or b"") for spec in chunk)
        return tracing.phase_span(
            "driver.flush_batch", carrier, batch=len(chunk),
            payload_bytes=payload_bytes, transport="actor")

    def _on_actor_push(self, actor_id: str, topic: str, payload):
        """Server-push from an actor's worker (reader thread): coalesced
        tasks_done acks for batched actor calls (the actor twin of
        _on_tasks_done; lease/pool bookkeeping does not apply)."""
        if topic != "tasks_done":
            return
        with self.lock:
            ac = self.actors.get(actor_id)
        if ac is None:
            return
        finished = []
        with ac.lock:
            for task_id, reply in payload:
                spec = ac.inflight.pop(task_id, None)
                if spec is None:
                    continue   # late duplicate after a conn-loss sweep
                finished.append((spec, reply))
        for spec, reply in finished:
            self._store_results(spec, reply)
            if spec.num_returns == STREAMING_RETURNS:
                self._finish_stream(spec.task_id, reply)

    def _on_actor_conn_lost(self, actor_id: str):
        ac = self._actor_conn(actor_id)
        with ac.lock:
            ac.client = None
            ac.state = "RECONNECTING"
            pending = list(ac.inflight.values())
            ac.inflight.clear()
            # a lost connection means this incarnation is gone: anything we
            # hear about the actor next must be a newer incarnation or DEAD
            next_inc = ac.incarnation + 1
        if self._shutdown:
            return

        def recover():
            view = None
            try:
                view = self._control_call(
                    "wait_actor_alive",
                    {"actor_id": actor_id, "timeout": 60.0,
                     "min_incarnation": next_inc},
                    timeout=70.0)
            except Exception:
                pass
            logger.debug("actor %s recover view: %s", actor_id, view)
            if view is not None and view["state"] == "ALIVE":
                if ac.max_task_retries != 0:
                    with ac.lock:
                        for spec in pending:
                            ac.buffer.appendleft(spec)
                else:
                    self._error_specs(pending, ActorDiedError(
                        "actor restarted; pending calls lost (max_task_retries=0)"))
                self._resolve_actor(actor_id, min_incarnation=next_inc)
            else:
                err = (view or {}).get("error") if view else "actor died"
                self._error_specs(pending, ActorDiedError(str(err)))
                with ac.lock:
                    ac.state = "DEAD"
                    ac.dead_error = str(err)
                    buffered = list(ac.buffer)
                    ac.buffer.clear()
                self._error_specs(buffered, ActorDiedError(str(err)))

        self.pool_executor.submit(recover)

    def _error_specs(self, specs, err):
        for spec in specs:
            if spec.num_returns == STREAMING_RETURNS:
                # a consumer may be blocked in ObjectRefGenerator.next()
                # waiting for the item the dead actor never reported:
                # finish the stream with the error so the wait raises now
                # instead of hanging on the reconnect quantum
                self._fail_stream(spec.task_id, err)
            for oid in spec.return_ids():
                with self.lock:
                    e = self.objects.get(oid)
                if e is not None and not e.ready:
                    e.error = err
                    e.event.set()

    def cancel(self, ref, force: bool = False,
               recursive: bool = True) -> bool:
        """Cancel the task producing `ref` (reference: ray.cancel,
        core_worker CancelTask + HandleRemoteCancelTask).  Queued tasks
        are dropped; a running task gets TaskCancelledError injected into
        its thread (force=True kills the worker process instead; not
        supported for actor tasks).  recursive=True also cancels the
        tasks the cancelled task submitted.  Cancelled tasks are never
        retried.  Returns False if the task already finished or isn't
        cancellable."""
        if isinstance(ref, ObjectRefGenerator):
            # cancelling a streaming task: the generator IS the handle
            return self._cancel_task_id(ref.task_id, force, recursive)
        tid = "tsk-" + ref.id[4:].rsplit("-", 1)[0] \
            if ref.id.startswith("obj-") else None
        if tid is None:
            return False
        return self._cancel_task_id(tid, force, recursive)

    def _cancel_task_id(self, tid: str, force: bool,
                        recursive: bool) -> bool:
        with self.lock:
            rec = self.task_records.get(tid)
            if rec is not None and rec.done:
                return False
            if rec is not None:
                rec.canceled = True
                rec.retries_left = 0
                if rec.mux:
                    pool = None
                    queued = rec in self._mux_staged
                    if queued:
                        self._mux_staged.remove(rec)
                        self.task_records.pop(tid, None)
                else:
                    pool = self.pools.get(rec.pool_key)
                    queued = pool is not None and rec in pool.queue
                    if queued:
                        pool.queue.remove(rec)
                        self.task_records.pop(tid, None)
        if rec is None:
            return self._cancel_actor_task(tid, force, recursive)
        if queued:
            err = TaskCancelledError(
                f"task {rec.spec.function_name} was cancelled before it "
                f"started")
            self.task_events.record_status(
                rec.spec.task_id, "FAILED", name=rec.spec.function_name,
                error=str(err))
            for oid in rec.spec.return_ids():
                with self.lock:
                    e = self.objects.get(oid)
                if e is not None and not e.ready:
                    e.error = err
                    e.event.set()
            if rec.spec.num_returns == STREAMING_RETURNS:
                self._fail_stream(tid, err)
            return True
        if rec.mux:
            # relay-routed: only the raylet knows which worker (if any)
            # runs it.  Delivery is best-effort with the same 15s
            # owner-side fallback as the direct path — the cancelled
            # reply arrives through mux_tasks_done when confirmed.
            def mux_fallback(rec=rec):
                if not rec.done:
                    logger.warning(
                        "mux cancel of %s not confirmed; resolving "
                        "owner-side", rec.spec.task_id[:12])
                    self._fail_canceled_entries(rec)

            raylet = self.raylet
            if raylet is None:
                self._fail_canceled_entries(rec)
                return True
            try:
                raylet.notify("mux_cancel",
                              {"task_id": tid, "client_id": self.worker_id,
                               "force": force, "recursive": recursive})
            except Exception:
                mux_fallback()
                return True
            t = threading.Timer(15.0, mux_fallback)
            t.daemon = True
            t.start()
            return True
        # pushed: tell the executing worker (it propagates to children
        # when recursive — they are owned by that worker, not us).
        # Delivery is CONFIRMED off-thread: if the worker never handles
        # the cancel (conn hiccup, handler fault), the owner resolves the
        # refs itself — a cancelled task never retries, so nobody else
        # ever would, and get() must not hang forever.
        with self.lock:
            lw = None
            if pool is not None and rec.pushed_to:
                lw = pool.leases.get(rec.pushed_to)
        client = lw.client if lw is not None else None
        if client is None:
            # no live lease to deliver to: resolve immediately
            self._fail_canceled_entries(rec)
            return True

        # async confirmation — never parks a shared pool thread: the ack
        # resolves via callback; a timer catches a worker that never
        # replies at all
        def fallback(rec=rec):
            if not rec.done:
                logger.warning(
                    "cancel of %s not confirmed by worker; resolving "
                    "owner-side", rec.spec.task_id[:12])
                self._fail_canceled_entries(rec)

        timer = threading.Timer(15.0, fallback)
        timer.daemon = True

        def on_ack(f):
            try:
                f.result()
                timer.cancel()
            except Exception:
                timer.cancel()
                fallback()

        try:
            fut = client.call_async(
                "cancel_task", {"task_id": rec.spec.task_id,
                                "force": force, "recursive": recursive})
        except Exception:
            fallback()
            return True
        timer.start()
        fut.add_done_callback(on_ack)
        return True

    def _fail_canceled_entries(self, rec: TaskRecord):
        err = TaskCancelledError(
            f"task {rec.spec.function_name} was cancelled")
        for oid in rec.spec.return_ids():
            with self.lock:
                e = self.objects.get(oid)
            if e is not None and not e.ready:
                e.error = err
                e.event.set()
        if rec.spec.num_returns == STREAMING_RETURNS:
            self._fail_stream(rec.spec.task_id, err)
            # and CLOSE it: an unconfirmed producer that later wakes must
            # be told to stop, not have its items stored and pinned
            self._release_stream(rec.spec.task_id)

    def _cancel_actor_task(self, tid: str, force: bool,
                           recursive: bool) -> bool:
        """Cancel an actor task: drop it if still buffered client-side,
        else ask the actor's worker (reference: core_worker.cc
        HandleCancelTask actor path; force-kill is not supported for
        actor tasks, matching ray.cancel semantics)."""
        with self.lock:
            conns = list(self.actors.values())
        for ac in conns:
            with ac.lock:
                buffered = next(
                    (s for s in ac.buffer if s.task_id == tid), None)
                if buffered is not None:
                    ac.buffer.remove(buffered)
                inflight = ac.inflight.get(tid)
                client = ac.client
            if buffered is not None:
                err = TaskCancelledError(
                    f"actor task {buffered.function_name} was cancelled "
                    f"before it was sent")
                self.task_events.record_status(
                    tid, "FAILED", name=buffered.function_name,
                    actor_id=ac.actor_id, error=str(err))
                for oid in buffered.return_ids():
                    with self.lock:
                        e = self.objects.get(oid)
                    if e is not None and not e.ready:
                        e.error = err
                        e.event.set()
                return True
            if inflight is not None:
                if force:
                    raise ValueError(
                        "force=True is not supported for actor tasks")
                if client is not None:
                    try:
                        client.notify("cancel_task",
                                      {"task_id": tid, "force": False,
                                       "recursive": recursive})
                    except Exception:
                        pass
                return True
        return False

    def cancel_children(self, parent_tid: str, force: bool = False):
        """Cancel every not-yet-finished task this process submitted on
        behalf of `parent_tid` (reference: ray.cancel(recursive=True) —
        each worker cancels the children it owns, recursing down)."""
        child_tids = []
        with self.lock:
            child_tids += [rec.spec.task_id
                           for rec in self.task_records.values()
                           if rec.spec.parent_task_id == parent_tid
                           and not rec.done]
            conns = list(self.actors.values())
        for ac in conns:
            with ac.lock:
                child_tids += [
                    s.task_id
                    for s in list(ac.buffer) + list(ac.inflight.values())
                    if s.parent_task_id == parent_tid]
        for tid in child_tids:
            try:
                self._cancel_task_id(tid, force, recursive=True)
            except ValueError:
                # actor child: force unsupported — plain cancel instead
                self._cancel_task_id(tid, False, recursive=True)

    def _task_is_live_locked(self, tid: str) -> bool:
        """Caller holds self.lock.  True while `tid` is still tracked:
        queued/running/retrying as a normal task, or buffered/in-flight
        on an actor connection.  ac.buffer/inflight are mutated under
        ac.lock (NOT self.lock) — taking ac.lock here would invert the
        lock order, so snapshot with list()/`in` (atomic under the GIL)
        instead of iterating the live deque."""
        if tid in self.task_records:
            return True
        for ac in list(self.actors.values()):
            if tid in ac.inflight:
                return True
            if any(getattr(s, "task_id", None) == tid
                   for s in list(ac.buffer)):
                return True
        return False

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        self._control_call("kill_actor", {"actor_id": actor_id,
                                         "no_restart": no_restart}, timeout=30.0)

    # -- actor-handle borrow protocol --------------------------------------
    # reference: actor handles are reference-counted cluster-wide; the
    # actor is GC'd when no handle (owned or borrowed) remains.  Borrowed
    # handles register with the owner at deserialization; serialization
    # itself takes a time-bounded "transit" hold that bridges the gap
    # between pickling a handle and the receiver registering its borrow
    # (the window in which the old implementation killed the actor).

    # Baseline bound for holds not tied to a tracked task: a pickled
    # handle neither deserialized nor dropped within this window stops
    # protecting the actor.  Holds taken while serializing TASK ARGS are
    # bound to that task and auto-refresh while it is still queued /
    # running / retrying, so a call queued behind >60s of work keeps its
    # protection (the exact-tracking role of the reference's borrow acks).
    ACTOR_TRANSIT_S = 60.0
    # how long a dead actor's still-open connection may deliver the acks
    # of calls that ran before its death (_on_control_push, "pub:actor")
    ACTOR_DEAD_DRAIN_S = 5.0

    def on_actor_handle_serialized(self, actor_id: str,
                                   owner_addr) -> Optional[str]:
        """Take one per-pickle transit hold; returns its nonce (embedded
        in the pickle so the borrower's add_ref retires exactly THIS
        hold, never another in-flight copy's)."""
        if owner_addr is None:
            # a weak handle (get_actor lookup): extends nothing, matching
            # the reference — named lookups don't own or pin lifetime
            return None
        nonce = uuid.uuid4().hex[:16]
        bound_task = TRANSIT_TASK_ID.get()
        if tuple(owner_addr) == self.addr:
            with self.lock:
                self._actor_transit.setdefault(actor_id, {})[nonce] = \
                    [time.monotonic() + self.ACTOR_TRANSIT_S, bound_task]
            return nonce
        try:
            # cross-core owner: no task binding (the owner cannot observe
            # this core's task liveness) — fixed window, nonce-retired
            self._owner_client(tuple(owner_addr)).notify(
                "actor_transit", {"actor_id": actor_id, "nonce": nonce})
        except Exception:
            pass
        return nonce

    def on_actor_handle_borrowed(self, actor_id: str, owner_addr,
                                 nonce: Optional[str] = None) -> bool:
        if owner_addr is None:
            return False
        owner_addr = tuple(owner_addr)
        if owner_addr == self.addr:
            # a handle round-tripped back to its owner: count it like any
            # other borrower (loopback entry, no RPC)
            self._register_actor_borrow(actor_id, self.worker_id, self.addr,
                                        nonce=nonce)
            with self.lock:
                self._borrowed_actors.setdefault(
                    actor_id, [0, owner_addr])[0] += 1
            return True
        with self.lock:
            rec = self._borrowed_actors.setdefault(actor_id, [0, owner_addr])
            rec[0] += 1
        # notify on EVERY deserialization, not just the first: the owner's
        # borrower set is idempotent, and the carried nonce retires
        # exactly this pickle's transit hold — a re-deserialized copy
        # retires nothing extra, so other in-flight pickles keep theirs
        try:
            self._owner_client(owner_addr).notify(
                "actor_add_ref", {"actor_id": actor_id,
                                  "borrower": self.worker_id,
                                  "borrower_addr": self.addr,
                                  "nonce": nonce})
        except Exception:
            pass
        return True

    def on_actor_handle_dropped(self, actor_id: str):
        # symmetric with on_actor_handle_borrowed: one del notification
        # per dropped handle (the owner counts adds per deserialization)
        with self.lock:
            rec = self._borrowed_actors.get(actor_id)
            if rec is None:
                return
            rec[0] -= 1
            if rec[0] <= 0:
                self._borrowed_actors.pop(actor_id, None)
            owner_addr = tuple(rec[1])
        if owner_addr == self.addr:
            self._deregister_actor_borrow(actor_id, self.worker_id)
            self._maybe_release_actor(actor_id)
            return
        try:
            # short timeout → the dead-owner negative cache applies: this
            # runs from __del__ via flush_pending_deletes/_delete_loop, and
            # dropping N handles of a killed actor must not stall put() and
            # gc in 30s connect-retry quanta (same fix as object del_ref)
            self._owner_client(owner_addr, connect_timeout=2.0).notify(
                "actor_del_ref", {"actor_id": actor_id,
                                  "borrower": self.worker_id})
        except Exception:
            pass

    def _register_actor_borrow(self, aid: str, borrower: str, addr,
                               nonce: Optional[str] = None):
        """Owner side: count one borrowed handle and retire THE pickle's
        in-transit hold (matched by nonce — retiring the oldest would let
        one twice-deserialized pickle strip another copy's protection)."""
        with self.lock:
            ent = self._actor_borrowers.setdefault(aid, {}) \
                .setdefault(borrower, [0, addr])
            ent[0] += 1
            ent[1] = addr or ent[1]
            holds = self._actor_transit.get(aid)
            if holds and nonce is not None:
                holds.pop(nonce, None)
                if not holds:
                    self._actor_transit.pop(aid, None)

    def _deregister_actor_borrow(self, aid: str, borrower: str,
                                 drop_all: bool = False):
        with self.lock:
            bs = self._actor_borrowers.get(aid)
            ent = bs.get(borrower) if bs else None
            if ent is not None:
                ent[0] -= 1
                if ent[0] <= 0 or drop_all:
                    bs.pop(borrower, None)
                if not bs:
                    self._actor_borrowers.pop(aid, None)

    def h_actor_add_ref(self, conn, p):
        self._register_actor_borrow(
            p["actor_id"], p["borrower"],
            tuple(p.get("borrower_addr") or ()) or None,
            nonce=p.get("nonce"))
        return True

    def h_actor_del_ref(self, conn, p):
        self._deregister_actor_borrow(p["actor_id"], p["borrower"],
                                      drop_all=bool(p.get("all")))
        self._maybe_release_actor(p["actor_id"])
        return True

    def h_actor_transit(self, conn, p):
        with self.lock:
            self._actor_transit.setdefault(p["actor_id"], {})[
                p.get("nonce") or uuid.uuid4().hex[:16]] = \
                [time.monotonic() + self.ACTOR_TRANSIT_S, None]
        return True

    ACTOR_BORROW_PROBE_S = 20.0

    def _probe_actor_borrowers(self, actor_id: str):
        """A release is pending but borrowers block it: verify they are
        still alive and still hold the handle — a crashed borrower never
        sends actor_del_ref and would block release forever."""
        with self.lock:
            self._actor_probe_scheduled.discard(actor_id)
            if actor_id not in self._actor_pending_release:
                return
            borrowers = dict(self._actor_borrowers.get(actor_id) or {})
        stale = []
        for bid, ent in borrowers.items():
            addr = ent[1] if isinstance(ent, list) else ent
            if bid == self.worker_id:
                continue  # loopback entries validated by local state
            alive = False
            if addr:
                try:
                    cli = Client(tuple(addr), name="core-borrow-probe",
                                 connect_timeout=5.0)
                    alive = bool(cli.call("actor_borrow_check",
                                          {"actor_id": actor_id},
                                          timeout=10.0))
                    cli.close()
                except Exception:
                    alive = False
            if not alive:
                stale.append(bid)
        if stale:
            with self.lock:
                bs = self._actor_borrowers.get(actor_id)
                for bid in stale:
                    if bs is not None:
                        bs.pop(bid, None)
                if bs is not None and not bs:
                    self._actor_borrowers.pop(actor_id, None)
        self._maybe_release_actor(actor_id)

    def h_actor_borrow_check(self, conn, p):
        with self.lock:
            return p["actor_id"] in self._borrowed_actors

    def _maybe_release_actor(self, actor_id: str):
        with self.lock:
            if actor_id not in self._actor_pending_release:
                return
            if self._actor_borrowers.get(actor_id):
                # a borrower still holds a handle; schedule a liveness
                # probe in case it crashed without deregistering
                if actor_id not in self._actor_probe_scheduled:
                    self._actor_probe_scheduled.add(actor_id)
                    t = threading.Timer(
                        self.ACTOR_BORROW_PROBE_S,
                        lambda: self.pool_executor.submit(
                            self._probe_actor_borrowers, actor_id))
                    t.daemon = True
                    t.start()
                return
            now = time.monotonic()
            holds = {}
            for nonce, (exp, tid) in \
                    self._actor_transit.get(actor_id, {}).items():
                if tid is not None and self._task_is_live_locked(tid):
                    # hold bound to a still-queued/running/retrying task:
                    # its pickled handle is still in the args — refresh
                    # (ADVICE r2: a call queued >60s must stay protected)
                    exp = now + self.ACTOR_TRANSIT_S
                if exp > now:
                    holds[nonce] = [exp, tid]
            if holds:
                self._actor_transit[actor_id] = holds
                delay = min(h[0] for h in holds.values()) - now
            else:
                self._actor_pending_release.discard(actor_id)
                self._actor_transit.pop(actor_id, None)
                delay = None
        if delay is not None:
            t = threading.Timer(delay + 0.05,
                                self._maybe_release_actor, (actor_id,))
            t.daemon = True
            t.start()
            return
        self._terminate_actor(actor_id)

    def release_actor(self, actor_id: str):
        """Every owner handle went out of scope: terminate — unless a
        borrowed handle (or an in-transit serialized copy) still exists,
        in which case the release defers until they clear."""
        with self.lock:
            self._actor_pending_release.add(actor_id)
        self._maybe_release_actor(actor_id)

    def _terminate_actor(self, actor_id: str):
        """Terminate gracefully.  The __ray_terminate__ marker rides the
        ordered actor queue, so calls already submitted finish first
        (reference: ActorHandle.__del__ -> __ray_terminate__ semantics); a
        hard kill_actor is the fallback when the actor has no live
        connection to drain.

        Runs off-thread: __del__ may fire inside GC while this thread
        holds an ActorConn lock the submit path needs."""

        def do():
            with self.lock:
                ac = self.actors.get(actor_id)
            try:
                if ac is not None and ac.state in ("ALIVE", "PENDING",
                                                   "RECONNECTING"):
                    self.submit_actor_task(actor_id, "__ray_terminate__",
                                           (), {})
                    return
            except Exception:
                pass
            try:
                self.control.call_async(
                    "kill_actor", {"actor_id": actor_id,
                                   "no_restart": True})
            except Exception:
                pass

        try:
            self.pool_executor.submit(do)
        except Exception:
            pass

    def get_actor_by_name(self, name: str, namespace: Optional[str] = None):
        view = self._control_call(
            "get_actor", {"name": name,
                          "namespace": namespace or self.namespace},
            timeout=30.0)
        return view

    # ------------------------------------------------------------------
    # control pushes
    # ------------------------------------------------------------------

    def add_push_handler(self, topic: str, fn) -> None:
        """Register a callback for a control pubsub topic this process is
        subscribed to (callers also need control.call("subscribe", ...))."""
        with self.lock:
            self._push_handlers.setdefault(topic, []).append(fn)

    def remove_push_handler(self, topic: str, fn) -> None:
        """Detach a callback registered with add_push_handler (no-op if
        it was never registered — teardown paths call this defensively)."""
        with self.lock:
            handlers = self._push_handlers.get(topic)
            if handlers and fn in handlers:
                handlers.remove(fn)

    def _sub_topics(self) -> List[str]:
        topics = ["actor", "node"]
        if self.log_to_driver:
            topics.append("worker_logs")
        return topics

    def _on_control_push(self, topic: str, payload):
        if topic == "pub:worker_logs":
            # worker stdout routed to this driver (reference:
            # log_monitor.py -> pubsub -> driver console)
            if self.log_to_driver and payload.get("job_id") == self.job_id:
                import sys as _sys

                wid = payload.get("worker_id", "?")
                for line in payload.get("lines", ()):
                    print(f"({wid}) {line}", file=_sys.stderr)
            return
        if topic == "pub:actor":
            actor = payload.get("actor", {})
            aid = actor.get("actor_id")
            with self.lock:
                ac = self.actors.get(aid)
            if ac is not None and payload["event"] == "dead":
                err = actor.get("error") or "actor died"
                with ac.lock:
                    connected = ac.client is not None
                if connected:
                    # acks of calls that ran before the death may still be
                    # in flight on the actor's own connection (a released
                    # actor is killed right after its last reply): what
                    # remains fails when that connection closes
                    # (_on_actor_conn_lost), or after a grace period if it
                    # never does; the reference fails them here at once
                    t = threading.Timer(self.ACTOR_DEAD_DRAIN_S,
                                        self._fail_actor, (ac, err))
                    t.daemon = True
                    t.start()
                else:
                    self._fail_actor(ac, err)
        handlers = getattr(self, "_push_handlers", {}).get(topic, ())
        for fn in list(handlers):
            try:
                fn(payload)
            except Exception:
                logger.exception("push handler for %s failed", topic)

    # ------------------------------------------------------------------
    # execution-side helpers (used by worker_proc)
    # ------------------------------------------------------------------

    def store_task_results(self, spec: TaskSpec, values: List[Any]) -> Dict[str, Any]:
        """Serialize task return values into a push_task reply.  Large values
        go to the node shm store; small ones travel inline in the reply
        (reference: small returns into the PushTask reply -> owner memory
        store; large into plasma, core_worker.cc:1246)."""
        results = []
        for i, v in enumerate(values):
            oid = common.object_id_for_return(spec.task_id, i)
            meta, bufs = serialization.dumps_oob(v)
            raw = [b.raw() for b in bufs]
            total = len(meta) + sum(len(b) for b in raw)
            if total > INLINE_OBJECT_LIMIT and self.store is not None:
                self._store_create(oid, meta, raw)
                results.append(("shm", {"node_id": self.node_id,
                                        "addr": self.raylet_addr,
                                        "nbytes": total}))
            else:
                results.append(("inline", (meta, [b.raw().tobytes() for b in bufs])))
        return {"status": "ok", "results": results}

    def store_stream_item(self, spec: TaskSpec, index: int, value):
        """Producer-side: serialize one yielded item (shm for big values,
        inline otherwise) into the wire (kind, payload) form."""
        oid = common.object_id_for_return(spec.task_id, index)
        meta, bufs = serialization.dumps_oob(value)
        raw = [b.raw() for b in bufs]
        total = len(meta) + sum(len(b) for b in raw)
        if total > INLINE_OBJECT_LIMIT and self.store is not None:
            self._store_create(oid, meta, raw)
            return ("shm", {"node_id": self.node_id,
                            "addr": self.raylet_addr,
                            "nbytes": total})
        return ("inline", (meta, [b.raw().tobytes() for b in bufs]))

    def resolve_args(self, spec: TaskSpec):
        args, kwargs = serialization.loads_inline(
            spec.args_blob, keep_stand_ins=self.keep_device_stand_ins)
        args = [self.get(a) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {k: self.get(v) if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
        return args, kwargs
