"""Worker process main loop.

Analog of the reference worker: registers with its raylet using the startup
token (reference: worker_pool.h startup token protocol), then serves
push_task / actor_task RPCs (reference: CoreWorker::HandlePushTask
core_worker.cc:3489 -> scheduling queues -> ExecuteTask :2914).  Normal tasks
run sequentially on one executor thread; actor tasks run FIFO in arrival
order (TCP preserves per-caller order, giving the reference's per-caller
sequence semantics); max_concurrency>1 uses a thread pool like the
reference's concurrency groups.

The port's copy of ``ray_tpu/_private/worker_proc.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import logging
import os
import queue
import sys
import threading
import time
import traceback

import cloudpickle

from . import common, serialization
from .common import TaskError, TaskSpec
from .core import CoreWorker, ObjectRef
from .protocol import Deferred, ServerConn
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

_ASYNC_INFLIGHT = object()  # sentinel: reply will come from the aio loop


# ack coalescing knobs: while the worker's run queue is non-empty a
# completed reply may wait up to the linger for batchmates (and never
# longer than the hold cap in total) before its frame ships — the hold
# cap bounds how long a dependent task parked on ANOTHER worker can be
# stalled by ack framing.  An idle queue always flushes immediately, so
# sequential get() chains pay zero added latency.
ACK_LINGER_S = 0.002
ACK_HOLD_MAX_S = 0.005
ACK_BATCH_CAP = 64


_gpu_checked = False


def check_granted_gpu() -> None:
    """A worker spawned for a GPU lease computes on a card or not at all:
    when CUDA finds no card it raises instead of letting the task run on
    the CPU while it holds the lease.  Checked once per process, at the
    first task or actor creation (importing torch there, which a GPU task
    does anyway); workers without the lease never import torch here."""
    global _gpu_checked
    if _gpu_checked or os.environ.get("RAY_TPU_TORCH_WORKER_GPU") != "1":
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"worker pid {os.getpid()} holds a GPU lease but CUDA finds no "
            f"card (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); refusing to run "
            f"on the CPU")
    _gpu_checked = True


class _ReplyBatcher:
    """Combining sender for coalesced task acks: completions are framed
    into `tasks_done` pushes on the owner connection (or, for
    mux-relayed tasks, one framed `mux_tasks_done` stream to the
    raylet).  With the worker's run queue idle the ack ships inline on
    the completing thread (the pre-linger latency path, bit-for-bit);
    under backlog a dedicated sender thread lingers briefly so
    back-to-back completions coalesce into one frame instead of one
    push per task."""

    def __init__(self, conn: ServerConn = None, send=None, backlog=None):
        # default transport: tasks_done pushes on the owner connection;
        # mux-relayed tasks instead ack through the raylet (one framed
        # mux_tasks_done stream per node, fanned back out to owners)
        self._conn = conn
        self._send = send if send is not None \
            else (lambda batch: conn.push("tasks_done", batch))
        # "more completions are imminent" probe (the worker's run-queue
        # emptiness); lingering is pointless — pure latency — without it
        self._backlog = backlog if backlog is not None else (lambda: False)
        self._cv = threading.Condition()
        self._pending: list = []        # guarded-by: _cv
        # (traceparent carrier, add-clock) per sampled ack awaiting its
        # frame — swapped out together with _pending so each ship pass
        # reports its own linger spans; wire batches stay 2-tuples
        self._tp_pending: list = []     # guarded-by: _cv
        self._thread = None             # guarded-by: _cv
        self._draining = False          # guarded-by: _cv

    def add(self, task_id: str, reply, tp=None):
        with self._cv:
            self._pending.append((task_id, reply))
            if tp is not None:
                self._tp_pending.append((tp, time.time_ns()))
            if self._draining:
                self._cv.notify()   # the active sender picks this up
                return
            if self._backlog():
                # more completions imminent: hand off to the linger
                # thread so this frame can fill up
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="ack-batcher", daemon=True)
                    self._thread.start()
                else:
                    self._cv.notify()
                return
            # idle queue: ship inline on the executor thread (it has
            # nothing else to do) — the exact pre-linger latency path
            self._draining = True
        self._drain()

    def _drain(self):
        """Send frames until _pending runs dry.  Caller owns _draining;
        acks landing while a frame is on the wire coalesce into the
        next one."""
        while True:
            with self._cv:
                batch, self._pending = self._pending, []
                traced, self._tp_pending = self._tp_pending, []
                if not batch:
                    self._draining = False
                    return
            if traced:
                self._emit_linger_spans(traced, len(batch))
            try:
                # push failure = owner gone; its on_disconnect resched-
                # ules.  Any other failure (one unserializable reply)
                # must not kill the sender for future acks.
                self._send(batch)
            except Exception:
                logger.exception("ack batch push failed")

    def flush(self, timeout: float = 5.0) -> None:
        """Ship every queued ack now, on this thread, after the frame a
        sender may have on the wire (waiting up to ``timeout`` for it)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._draining and time.monotonic() < deadline:
                self._cv.wait(0.005)
            batch, self._pending = self._pending, []
            traced, self._tp_pending = self._tp_pending, []
        if traced:
            self._emit_linger_spans(traced, len(batch))
        if batch:
            try:
                self._send(batch)
            except Exception:
                logger.exception("ack batch push failed")

    @staticmethod
    def _emit_linger_spans(traced, batch_n: int):
        """Retro worker.ack_linger spans: completion handed to the
        batcher -> its tasks_done frame actually shipping (the coalesce
        wait a sampled task's reply paid, with the frame it rode in)."""
        from ray_tpu_torch.util import tracing

        now_ns = time.time_ns()
        for tp, add_ns in traced:
            tracing.record_span("worker.ack_linger", "INTERNAL", add_ns,
                                now_ns, tracing._extract(tp),
                                batch=batch_n)

    def _run(self):
        while True:
            with self._cv:
                while not self._pending or self._draining:
                    self._cv.wait(timeout=60.0)
                    if not self._pending and not self._draining \
                            and not getattr(self._conn, "alive", True):
                        # owner gone and nothing queued: let the thread
                        # die (a late add() starts a fresh one)
                        self._thread = None
                        return
                held0 = time.monotonic()
                while (len(self._pending) < ACK_BATCH_CAP
                       and self._backlog()
                       and time.monotonic() - held0 < ACK_HOLD_MAX_S):
                    n = len(self._pending)
                    self._cv.wait(timeout=ACK_LINGER_S)
                    if len(self._pending) == n:
                        break   # linger expired with no new completion
                self._draining = True
            self._drain()


class _BatchSlot:
    """Pseudo-Deferred for batch-pushed tasks: the execution pipeline
    resolves replies through the same interface either way, but here the
    reply routes into the per-connection ack batcher instead of a
    per-call reply frame."""

    __slots__ = ("_batcher", "_task_id", "_tp")

    def __init__(self, batcher: _ReplyBatcher, task_id: str, tp=None):
        self._batcher = batcher
        self._task_id = task_id
        self._tp = tp   # traceparent carrier when the task is sampled

    def resolve(self, reply):
        self._batcher.add(self._task_id, reply, tp=self._tp)

    def reject(self, exc):
        self._batcher.add(self._task_id, {
            "status": "error",
            "error": serialization.dumps_inline(exc)}, tp=self._tp)


class WorkerMain:
    def __init__(self, control_addr, raylet_addr):
        self.token = int(os.environ["RAY_TPU_TORCH_STARTUP_TOKEN"])
        wid = os.environ.get("RAY_TPU_TORCH_WORKER_ID")
        nid = os.environ.get("RAY_TPU_TORCH_NODE_ID")
        session_dir = os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
        self.actor_id = os.environ.get("RAY_TPU_TORCH_ACTOR_ID")
        self.incarnation = int(os.environ.get("RAY_TPU_TORCH_ACTOR_INCARNATION", "0"))
        store_root = os.path.join(session_dir, "objects") if session_dir else None
        self.core = CoreWorker(control_addr, raylet_addr, mode="worker",
                               worker_id=wid, node_id=nid, store_root=store_root)
        self.core.server.handle("push_task", self.h_push_task, deferred=True)
        self.core.server.handle("push_tasks", self.h_push_tasks)
        self.core.server.handle("actor_task", self.h_actor_task, deferred=True)
        self.core.server.handle("exit", lambda c, p: self._exit_soon())
        self.core.server.handle("cancel_task", self.h_cancel_task)

        self.task_queue: "queue.Queue" = queue.Queue()
        # one reply batcher per owner connection (batched submissions)
        self._reply_batchers: dict = {}
        # lazily-built ack batcher for mux-relayed tasks (acks go to the
        # raylet, which fans them back out to the owning drivers)
        self._mux_batcher = None        # guarded-by: _batcher_lock
        self._batcher_lock = threading.Lock()
        # cancellation state (reference: core_worker HandleCancelTask):
        # queued task ids to drop + the id/thread of the running task
        self._cancelled: set = set()
        self._cancel_lock = threading.Lock()
        self._running_task: dict = {}  # thread ident -> task_id
        self._aio_tasks: dict = {}  # task_id -> asyncio.Task (async exec)
        self.actor_instance = None
        self.actor_concurrency = 1
        self._stop = threading.Event()
        # Async actors (reference: core_worker fiber.h / async actor event
        # loop): methods returning coroutines run on this loop; the exec
        # thread does NOT block on them — the Deferred resolves from the
        # loop when the coroutine finishes, so one actor can interleave
        # many in-flight async calls.
        self._aio_loop: asyncio.AbstractEventLoop = None
        self._aio_lock = threading.Lock()
        self._stream_executor = None  # created with the aio loop

        # raylet client push handling (shutdown) + death of raylet kills us
        self.core.raylet._on_push = self._on_raylet_push
        self.core.raylet._on_disconnect = self._exit_soon

        r = self.core.raylet.call("register_worker", {
            "token": self.token, "addr": self.core.addr,
        }, timeout=30.0)
        if not r.get("ok"):
            raise RuntimeError(f"worker registration rejected: {r}")

        # apply the driver-registered tracing startup hook, if any
        # (reference: tracing_helper.py hook runs in every worker)
        from ray_tpu_torch.util import tracing

        tracing.apply_hook_from_kv(self.core.control)
        # the hook (or RAY_TPU_TORCH_TRACE_SAMPLE) may have enabled tracing
        # after CoreWorker init skipped the collector — attach it now
        tracing.ensure_collector(
            self.core.control,
            proc=f"worker:{self.core.worker_id[:8]}",
            worker_id=self.core.worker_id,
            node_id=self.core.node_id or "", job_id=self.core.job_id)

        n_threads = 1
        self.exec_threads = [
            threading.Thread(target=self._exec_loop, name=f"exec-{i}", daemon=True)
            for i in range(n_threads)
        ]
        for t in self.exec_threads:
            t.start()

        if self.actor_id:
            threading.Thread(target=self._init_actor, daemon=True).start()

    # -- actor bootstrap ---------------------------------------------------

    def _init_actor(self):
        err = None
        try:
            # _control_call: a worker booting during a control-plane blip
            # reconnects and retries instead of failing actor creation
            blob = self.core._control_call("get_actor_spec",
                                           {"actor_id": self.actor_id},
                                           timeout=30.0)
            if blob is None:
                raise RuntimeError("actor spec missing in control plane")
            spec = cloudpickle.loads(blob)
            check_granted_gpu()
            if spec.get("runtime_env"):
                from . import runtime_env as rtenv

                # env applies BEFORE deserializing the class/args (their
                # unpickling may import py_modules/working_dir code) and
                # lasts for the actor process lifetime
                rtenv.materialize(spec["runtime_env"],
                                  self.core.control).apply_permanent()
            cls = cloudpickle.loads(spec["class_blob"])
            args, kwargs = serialization.loads_inline(spec["args_blob"])
            args = [self.core.get(a) if isinstance(a, ObjectRef) else a
                    for a in args]
            kwargs = {k: self.core.get(v) if isinstance(v, ObjectRef) else v
                      for k, v in kwargs.items()}
            self.actor_instance = cls(*args, **kwargs)
            # async actors (any coroutine method) run ALL their methods on
            # the event-loop thread — the reference's async-actor model:
            # cooperative concurrency on one thread, sync methods block the
            # loop.  This keeps actor state single-threaded.
            self.actor_is_async = any(
                inspect.iscoroutinefunction(getattr(cls, m, None))
                for m in dir(cls) if not m.startswith("__"))
            self.actor_concurrency = spec.get("max_concurrency", 1) or 1
            if self.actor_concurrency > 1:
                for i in range(self.actor_concurrency - 1):
                    t = threading.Thread(target=self._exec_loop,
                                         name=f"exec-actor-{i}", daemon=True)
                    t.start()
                    self.exec_threads.append(t)
        except BaseException as e:
            err = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            logger.error("actor creation failed: %s", err)
        try:
            self.core._control_call("actor_ready", {
                "actor_id": self.actor_id,
                "worker_addr": self.core.addr,
                "incarnation": self.incarnation,
                # lets the control plane adopt this placement even if its
                # start_actor_worker call failed mid-flight (reply lost)
                "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID"),
                "error": err,
            }, timeout=30.0)
        except Exception:
            logger.exception("failed to report actor_ready")
        if err is not None:
            self._exit_soon()

    # -- rpc handlers ------------------------------------------------------

    @staticmethod
    def _trace_enqueue(spec) -> None:
        """Stamp the run-queue entry clock on sampled specs (local-only
        attr; feeds the retro worker.queue_wait span at dequeue)."""
        if tracing.is_enabled() and tracing.carrier_sampled(
                getattr(spec, "trace_ctx", None)):
            spec._enq_ns = time.time_ns()

    @staticmethod
    def _trace_tp(spec):
        """Traceparent carrier for sampled specs, else None (what the
        ack batcher needs to report linger spans).  Also stamps the
        run-queue entry clock — one sampling probe covers both, keeping
        the batched enqueue loops at a single call per spec."""
        if tracing.is_enabled() and tracing.carrier_sampled(
                getattr(spec, "trace_ctx", None)):
            spec._enq_ns = time.time_ns()
            return spec.trace_ctx
        return None

    def h_push_task(self, conn: ServerConn, spec: TaskSpec, d: Deferred):
        self._trace_enqueue(spec)
        self.task_queue.put(("normal", spec, d))

    def h_push_tasks(self, conn: ServerConn, specs):
        """Batched submission (one-way notify, no per-task reply slot):
        enqueue every framed spec FIFO; completions ack through the
        per-connection tasks_done batcher."""
        batcher = self._reply_batchers.get(conn)
        if batcher is None:
            with self._batcher_lock:
                batcher = self._reply_batchers.get(conn)
                if batcher is None:
                    # prune batchers of disconnected owners while here
                    for c in [c for c in self._reply_batchers
                              if not c.alive]:
                        del self._reply_batchers[c]
                    batcher = self._reply_batchers[conn] = \
                        _ReplyBatcher(conn, backlog=self._ack_backlog)
        for spec in specs:
            # actor calls ride the same framed envelopes since the owner
            # flusher batches them too — route by spec, not by handler
            kind = "actor" if spec.actor_id else "normal"
            self.task_queue.put(
                (kind, spec,
                 _BatchSlot(batcher, spec.task_id, self._trace_tp(spec))))

    def h_actor_task(self, conn: ServerConn, spec: TaskSpec, d: Deferred):
        self._trace_enqueue(spec)
        self.task_queue.put(("actor", spec, d))

    def h_cancel_task(self, conn: ServerConn, p):
        """Cancel a queued or running normal task (reference:
        CoreWorker::HandleCancelTask).  force kills the process; plain
        cancel injects TaskCancelledError into the executing thread."""
        tid = p.get("task_id")
        force = p.get("force", False)
        recursive = p.get("recursive", False)
        with self._cancel_lock:
            # async task/actor-method first: looked up under _cancel_lock,
            # the same lock _register_aio claims under — a cancel either
            # finds the registered asyncio.Task or parks in _cancelled
            # for _register_aio to observe before running the coroutine
            entry = self._aio_tasks.get(tid)
            if entry is not None:
                aio_task, aio_kind = entry
                if force and aio_kind == "normal":
                    # force semantics are unchanged for normal tasks:
                    # kill the process (a stuck/shielded coroutine never
                    # observes a soft cancel)
                    os._exit(1)
                loop = self._aio_loop
                if loop is not None:
                    loop.call_soon_threadsafe(aio_task.cancel)
            else:
                running_thread = next(
                    (th for th, t in self._running_task.items()
                     if t == tid), None)
                if running_thread is None:
                    self._cancelled.add(tid)
                elif force:
                    os._exit(1)
                else:
                    import ctypes

                    from .common import TaskCancelledError

                    # inject while still holding the lock: the exec loop
                    # clears _running_task under this same lock, so the
                    # exception can only be scheduled while the task is
                    # genuinely the current one (a late landing between
                    # tasks is absorbed by _exec_loop)
                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(running_thread),
                        ctypes.py_object(TaskCancelledError))
        if recursive:
            # children submitted BY the cancelled task are owned by this
            # process — cancel them off the server thread (they may need
            # RPCs of their own)
            self.core.pool_executor.submit(
                self.core.cancel_children, tid, force)
        return True

    def _mux_batcher_get(self) -> _ReplyBatcher:
        with self._batcher_lock:
            if self._mux_batcher is None:
                raylet = self.core.raylet
                self._mux_batcher = _ReplyBatcher(
                    send=lambda batch: raylet.notify(
                        "mux_tasks_done", batch),
                    backlog=self._ack_backlog)
            return self._mux_batcher

    def _flush_acks(self) -> None:
        with self._batcher_lock:
            batchers = list(self._reply_batchers.values())
            if self._mux_batcher is not None:
                batchers.append(self._mux_batcher)
        for b in batchers:
            b.flush()

    def _ack_backlog(self) -> bool:
        """More completions imminent? drives ack-frame lingering."""
        return not self.task_queue.empty()

    def _on_raylet_push(self, topic, payload):
        if topic == "shutdown":
            self._exit_soon()
        elif topic == "mux_push_tasks":
            # relay-routed batch from the raylet: same execution pipeline
            # as h_push_tasks, but acks flow back through the raylet
            batcher = self._mux_batcher_get()
            for spec in payload:
                kind = "actor" if spec.actor_id else "normal"
                self.task_queue.put(
                    (kind, spec,
                     _BatchSlot(batcher, spec.task_id, self._trace_tp(spec))))
        elif topic == "mux_cancel":
            self.h_cancel_task(None, payload)
        elif topic == "assign_actor":
            # prestarted-worker reuse (reference: worker_pool.h PopWorker):
            # a warm idle worker becomes this actor's dedicated process,
            # skipping the interpreter (+ torch) import cost of a fresh spawn
            self.actor_id = payload["actor_id"]
            self.incarnation = payload.get("incarnation", 0)
            threading.Thread(target=self._init_actor, daemon=True).start()
        else:
            # core-level pushes (reclaim_idle_leases etc.)
            self.core._on_raylet_push(topic, payload)

    def _exit_soon(self):
        self._stop.set()
        threading.Thread(target=self._do_exit, daemon=True).start()
        return True

    def _do_exit(self):
        time.sleep(0.05)
        os._exit(0)

    # -- execution ---------------------------------------------------------

    def _exec_loop(self):
        from .common import TaskCancelledError

        while not self._stop.is_set():
            try:
                self._exec_one()
            except TaskCancelledError:
                # a cancel injection that landed after its task already
                # finished (between tasks); the cancel is void — survive
                continue
            except Exception:
                logger.exception("exec loop error")

    def _exec_one(self):
        from .common import TaskCancelledError

        try:
            kind, spec, d = self.task_queue.get(timeout=0.2)
        except queue.Empty:
            return
        enq_ns = getattr(spec, "_enq_ns", None)
        if enq_ns is not None:
            spec._enq_ns = None
            from ray_tpu_torch.util import tracing

            tracing.record_span(
                "worker.queue_wait", "INTERNAL", enq_ns, time.time_ns(),
                tracing._extract(spec.trace_ctx),
                queue_depth=self.task_queue.qsize())
        with self._cancel_lock:
            if spec.task_id in self._cancelled:
                self._cancelled.discard(spec.task_id)
                cancelled = True
            else:
                cancelled = False
                self._running_task[threading.get_ident()] = spec.task_id
        if cancelled:
            d.resolve(self._error_reply(
                TaskCancelledError("cancelled before start"), spec))
            return
        reply = None
        try:
            try:
                from ray_tpu_torch.util import tracing

                with tracing.execute_span(
                        "task" if kind == "normal" else "actor",
                        spec.function_name,
                        getattr(spec, "trace_ctx", None),
                        task_id=spec.task_id, actor_id=spec.actor_id):
                    reply = self._execute(kind, spec, d)
            except TaskCancelledError as e:
                # injection landed inside _execute's own error handling;
                # still owe the owner a reply
                reply = self._error_reply(e, spec)
        finally:
            # a cancel injected while _execute was unwinding may land at
            # any bytecode below; keep clearing + resolving until it's
            # done (at most one async exc can be pending)
            for _attempt in range(3):
                try:
                    with self._cancel_lock:
                        self._running_task.pop(threading.get_ident(), None)
                    if reply is not None and reply is not _ASYNC_INFLIGHT:
                        d.resolve(reply)
                        reply = None
                    break
                except TaskCancelledError:
                    continue

    def _register_aio(self, spec: TaskSpec, kind: str = "normal") -> bool:
        """First statement of every async execution coroutine: atomically
        either claim the task (register its asyncio.Task for
        cancellation) or observe a cancel that arrived before the loop
        ran us.  Returns False when already cancelled.  Also stamps the
        execution contextvars — each asyncio Task has its own context,
        so interleaved async methods attribute children correctly."""
        from .core import EXECUTING_JOB_ID, EXECUTING_TASK_ID

        with self._cancel_lock:
            if spec.task_id in self._cancelled:
                self._cancelled.discard(spec.task_id)
                return False
            self._aio_tasks[spec.task_id] = (asyncio.current_task(), kind)
        EXECUTING_TASK_ID.set(spec.task_id)
        EXECUTING_JOB_ID.set(getattr(spec, "job_id", "") or None)
        return True

    def _get_aio_loop(self) -> asyncio.AbstractEventLoop:
        with self._aio_lock:
            if self._aio_loop is None:
                from concurrent.futures import ThreadPoolExecutor

                loop = asyncio.new_event_loop()

                def _mark_executing():
                    # blocking get() from the loop thread (or from
                    # run_in_executor workers) must still notify the raylet
                    # it is blocked, else CPU slots are never lent back
                    self.core._executing.active = True

                loop.set_default_executor(ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="actor-aio-exec",
                    initializer=_mark_executing))
                # streaming generators get their OWN pool: each in-flight
                # stream pins a thread for its whole duration, and 8
                # long-lived streams (SSE clients) would otherwise starve
                # every other blocking hop on the default executor
                self._stream_executor = ThreadPoolExecutor(
                    max_workers=64, thread_name_prefix="actor-stream",
                    initializer=_mark_executing)

                def _loop_main():
                    _mark_executing()
                    asyncio.set_event_loop(loop)
                    loop.run_forever()

                t = threading.Thread(target=_loop_main, name="actor-aio",
                                     daemon=True)
                t.start()
                self._aio_loop = loop
            return self._aio_loop

    WINDOW = 8  # in-flight unacked item reports per generator

    def _run_generator(self, spec: TaskSpec, out, t0: float):
        """Execute a streaming task: push each yielded item to the owner
        as it is produced (reference: HandleReportGeneratorItemReturns,
        task_manager.h:355).  The per-item acks double as backpressure —
        the owner defers them while its unconsumed buffer is full."""
        if not hasattr(out, "__iter__"):
            raise TypeError(
                f"task {spec.function_name} declared "
                f'num_returns="streaming" but returned non-iterable '
                f"{type(out).__name__}")
        from collections import deque

        owner = self.core._owner_client(tuple(spec.owner_addr))
        outstanding = deque()
        count = 0
        stopped = False

        def drain(limit: int):
            nonlocal stopped
            while len(outstanding) > limit:
                ack = outstanding.popleft().result(timeout=600.0)
                if ack and ack.get("stop"):
                    stopped = True
                    return

        try:
            for item in out:
                result = self.core.store_stream_item(spec, count, item)
                outstanding.append(owner.call_async(
                    "generator_item",
                    {"task_id": spec.task_id, "index": count,
                     "result": result}))
                count += 1
                drain(self.WINDOW - 1)
                if stopped:
                    break
        except BaseException:
            # make sure every already-yielded item is acked by the owner
            # BEFORE the error reply: the reply rides a different
            # connection and must not overtake the items
            try:
                drain(0)
            except Exception:
                pass
            raise
        finally:
            close = getattr(out, "close", None)
            if stopped and close is not None:
                close()
        drain(0)
        self.core.task_events.record_status(
            spec.task_id, "FINISHED", name=spec.function_name)
        return {"status": "ok", "streaming_done": count,
                "exec_ms": (time.monotonic() - t0) * 1000.0}

    def _store_reply(self, spec: TaskSpec, out, t0: float):
        if spec.num_returns > 1:
            values = list(out)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"task {spec.function_name} declared num_returns="
                    f"{spec.num_returns} but returned {len(values)} values")
        else:
            values = [out]
        reply = self.core.store_task_results(spec, values)
        reply["exec_ms"] = (time.monotonic() - t0) * 1000.0
        self.core.task_events.record_status(
            spec.task_id, "FINISHED", name=spec.function_name,
            actor_id=spec.actor_id)
        return reply

    def _error_reply(self, e: BaseException, spec: TaskSpec):
        tb = traceback.format_exc()
        self.core.task_events.record_status(
            spec.task_id, "FAILED", name=spec.function_name,
            actor_id=spec.actor_id, error=f"{type(e).__name__}: {e}")
        try:
            err_blob = serialization.dumps_inline(
                TaskError(e, tb, spec.function_name))
        except BaseException:
            err_blob = serialization.dumps_inline(
                TaskError(RuntimeError(f"{type(e).__name__}: {e}"), tb,
                          spec.function_name))
        return {"status": "error", "error": err_blob}

    _last_job_marker: str = None

    def _execute(self, kind: str, spec: TaskSpec, d: Deferred = None):
        from .core import EXECUTING_JOB_ID, EXECUTING_TASK_ID

        self.core._executing.active = True
        # children submitted while this task runs carry it as parent
        # (ray.cancel(recursive=True)) and keep the root driver's job
        # (log routing); contextvars so async tasks attribute per-Task
        EXECUTING_TASK_ID.set(spec.task_id)
        EXECUTING_JOB_ID.set(getattr(spec, "job_id", "") or None)
        # job marker: the raylet's log tailer attributes the stdout that
        # follows to this job (workers are shared across jobs here,
        # unlike the reference's per-job workers — log_monitor.py)
        job = getattr(spec, "job_id", "") or ""
        if job != self._last_job_marker:
            self._last_job_marker = job
            print(f"\x01RAYTPU-JOB {job}", flush=True)
        t0 = time.monotonic()
        self.core.task_events.record_status(
            spec.task_id, "RUNNING", name=spec.function_name,
            actor_id=spec.actor_id)
        try:
            check_granted_gpu()
            if kind == "actor":
                if spec.function_name == "__ray_terminate__":
                    # graceful release (reference: the owner handle going
                    # out of scope queues __ray_terminate__ BEHIND pending
                    # calls; the actor drains, then exits).  Reply first,
                    # then mark DEAD at the control (so the exit isn't
                    # "restarted"), then exit.  The acks of the calls
                    # before it may still wait in a lingering batcher:
                    # ship them first, or the control's kill reaps this
                    # process before they leave and their owner sees
                    # ActorDiedError for calls that ran (the reference
                    # loses them so, ray_tpu/_private/worker_proc.py:706)
                    d.resolve(self._store_reply(spec, None, t0))
                    self._flush_acks()
                    try:
                        self.core._control_call(
                            "kill_actor",
                            {"actor_id": spec.actor_id,
                             "no_restart": True}, timeout=10.0)
                    except Exception:
                        pass
                    self._exit_soon()
                    return _ASYNC_INFLIGHT
                # wait for actor init to finish (creation runs async)
                deadline = time.monotonic() + 120.0
                while self.actor_instance is None and time.monotonic() < deadline \
                        and not self._stop.is_set():
                    time.sleep(0.005)
                if self.actor_instance is None:
                    raise common.ActorDiedError("actor instance not initialized")
                if spec.function_name == "__apply__":
                    # free function applied to the actor instance
                    # (reference: ActorHandle.__ray_call__) — powers
                    # compiled-graph exec loops without user-class changes
                    inst = self.actor_instance

                    def fn(_f, *a, **k):
                        return _f(inst, *a, **k)
                else:
                    fn = getattr(self.actor_instance, spec.function_name)
                if getattr(self, "actor_is_async", False):
                    # async actor: invoke on the event loop (even sync
                    # methods — they block the loop, the reference's
                    # semantics) so actor state stays single-threaded; the
                    # Deferred resolves from the loop and this exec thread
                    # moves on to the next queued task.
                    args, kwargs = self.core.resolve_args(spec)

                    async def _finish(spec=spec, t0=t0, d=d):
                        if not self._register_aio(spec, kind="actor"):
                            d.resolve(self._error_reply(
                                common.TaskCancelledError(
                                    "cancelled before start"), spec))
                            return
                        from ray_tpu_torch.util import tracing

                        try:
                            with tracing.execute_span(
                                    "actor", spec.function_name,
                                    getattr(spec, "trace_ctx", None),
                                    task_id=spec.task_id,
                                    actor_id=spec.actor_id):
                                out = fn(*args, **kwargs)
                                if inspect.iscoroutine(out):
                                    out = await out
                                if spec.num_returns == \
                                        common.STREAMING_RETURNS:
                                    # sync generator method on an async
                                    # actor: stream from the dedicated
                                    # stream pool, not the loop (acks
                                    # block) nor the 8-thread default
                                    # executor (streams are long-lived)
                                    loop = asyncio.get_running_loop()
                                    reply = await loop.run_in_executor(
                                        self._stream_executor,
                                        self._run_generator,
                                        spec, out, t0)
                                else:
                                    reply = self._store_reply(spec, out,
                                                              t0)
                        except asyncio.CancelledError:
                            reply = self._error_reply(
                                common.TaskCancelledError(
                                    f"actor task {spec.function_name} "
                                    f"was cancelled"), spec)
                        except BaseException as e:
                            reply = self._error_reply(e, spec)
                        finally:
                            self._aio_tasks.pop(spec.task_id, None)
                        d.resolve(reply)

                    asyncio.run_coroutine_threadsafe(_finish(),
                                                     self._get_aio_loop())
                    return _ASYNC_INFLIGHT
            else:
                fn = self.core.get_function(spec.function_id)
            ctx = None
            if kind != "actor" and spec.runtime_env:
                from . import runtime_env as rtenv

                # enter the env BEFORE deserializing args: py_modules /
                # working_dir code may be needed at unpickle time
                ctx = rtenv.materialize(spec.runtime_env, self.core.control)
                ctx.__enter__()
            try:
                args, kwargs = self.core.resolve_args(spec)
                out = fn(*args, **kwargs)
            except BaseException:
                if ctx is not None:
                    ctx.__exit__(None, None, None)
                    ctx = None
                raise
            if spec.num_returns == common.STREAMING_RETURNS:
                try:
                    return self._run_generator(spec, out, t0)
                finally:
                    if ctx is not None:
                        ctx.__exit__(None, None, None)
            if inspect.iscoroutine(out):
                # async function task: run to completion on the loop; the
                # env context stays open until the coroutine finishes
                async def _finish(coro=out, spec=spec, t0=t0, d=d, ctx=ctx):
                    if not self._register_aio(spec):
                        coro.close()
                        if ctx is not None:
                            ctx.__exit__(None, None, None)
                        d.resolve(self._error_reply(
                            common.TaskCancelledError(
                                "cancelled before start"), spec))
                        return
                    from ray_tpu_torch.util import tracing

                    try:
                        with tracing.execute_span(
                                "task", spec.function_name,
                                getattr(spec, "trace_ctx", None),
                                task_id=spec.task_id):
                            value = await coro
                        reply = self._store_reply(spec, value, t0)
                    except asyncio.CancelledError:
                        reply = self._error_reply(
                            common.TaskCancelledError(
                                f"task {spec.function_name} was "
                                f"cancelled"), spec)
                    except BaseException as e:
                        reply = self._error_reply(e, spec)
                    finally:
                        self._aio_tasks.pop(spec.task_id, None)
                        if ctx is not None:
                            ctx.__exit__(None, None, None)
                    d.resolve(reply)

                asyncio.run_coroutine_threadsafe(_finish(),
                                                 self._get_aio_loop())
                return _ASYNC_INFLIGHT
            if ctx is not None:
                ctx.__exit__(None, None, None)
            return self._store_reply(spec, out, t0)
        except BaseException as e:
            return self._error_reply(e, spec)
        finally:
            self.core._executing.active = False
            EXECUTING_TASK_ID.set(None)
            EXECUTING_JOB_ID.set(None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--raylet", required=True)
    ap.add_argument("--control", required=True)
    args = ap.parse_args()
    # `kill -USR1 <worker pid>` dumps all thread stacks to a per-pid file
    # — the py-spy-dump analog for diagnosing wedged workers (reference:
    # dashboard ReporterAgent stack dumps).  The file is created lazily
    # on the first signal so worker churn doesn't litter /tmp.
    try:
        import faulthandler
        import signal

        def _dump_stacks(signum, frame):
            with open(f"/tmp/ray_tpu_torch_worker_stacks_{os.getpid()}.txt",
                      "w") as f:
                faulthandler.dump_traceback(file=f)

        signal.signal(signal.SIGUSR1, _dump_stacks)
    except (AttributeError, OSError, ValueError):
        pass
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s worker[{os.getpid()}] %(levelname)s %(message)s")
    rh, rp = args.raylet.rsplit(":", 1)
    ch, cp = args.control.rsplit(":", 1)
    w = WorkerMain((ch, int(cp)), (rh, int(rp)))
    try:
        while not w._stop.is_set():
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
