"""Per-worker training session: the bridge between the user's
train_loop_per_worker and the driver-side BackendExecutor.

Mirrors the reference (reference: python/ray/train/_internal/session.py —
_TrainSession :111, report :403, module-level report/get_context :667/:754):
the user loop runs in a thread inside the worker actor; `report()` persists
an optional checkpoint to run storage and enqueues the metrics, which the
actor's `next_result()` hands to the driver.  `report()` blocks until the
driver consumed the previous result — that back-pressure keeps all workers
in lockstep on the report boundary (the reference does the same via
a result queue of size 1).

The port's copy of ``ray_tpu/train/session.py``: one flight-recorder
``StepTimer`` per session (``ray_tpu_torch.telemetry``, on unless the
run's ``JaxConfig(telemetry=False)``), ``checkpoint`` timed as a phase,
each report carrying its step's ``telemetry`` record.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from .checkpoint import Checkpoint


@dataclass
class TrainContext:
    """What a worker knows about its place in the run."""

    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    trial_name: str = ""
    trial_id: str = ""
    trial_dir: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id


class _FinishedMarker:
    def __init__(self, error: Optional[BaseException] = None,
                 final: Optional[Dict[str, Any]] = None):
        self.error = error
        self.final = final


class SessionAborted(BaseException):
    """Raised inside the user train loop when the driver aborts the session
    (trial paused/stopped).  BaseException so user `except Exception`
    blocks don't swallow it; `finally` blocks (worker-group shutdown,
    placement-group release) still run as the loop unwinds."""


class TrainSession:
    """Owns the user-loop thread inside one training worker."""

    def __init__(self, ctx: TrainContext, train_fn: Callable[[], Any],
                 checkpoint: Optional[Checkpoint] = None,
                 checkpoint_upload_dir: Optional[str] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 start_iteration: int = 0):
        from .storage import StorageContext

        self.ctx = ctx
        self._train_fn = train_fn
        self._restore_checkpoint = checkpoint
        self._upload_dir = checkpoint_upload_dir
        self._storage = StorageContext(
            checkpoint_upload_dir or ctx.trial_dir or ".",
            ctx.experiment_name, ctx.trial_name)
        self._dataset_shards = dataset_shards or {}
        self._results: "queue.Queue" = queue.Queue(maxsize=1)
        self._continue = threading.Semaphore(0)
        # after an elastic restart the new session continues numbering from
        # the rounds already consumed, so checkpoint_<n> dirs never collide
        # with (and never clobber) pre-failure checkpoints
        self._iteration = start_iteration
        self._aborted = False
        # flight recorder: one StepTimer per session, armed from
        # the telemetry config BackendExecutor rode in through ctx.extra
        self._step_timer = None
        self._flush_interval = 2.0
        tel = ctx.extra.get("telemetry")
        if tel is None or (isinstance(tel, dict) and tel.get("enabled", True)):
            try:
                from ray_tpu_torch.telemetry import StepTimer, resolve_telemetry

                tc = resolve_telemetry(tel)
                if tc.enabled:
                    self._step_timer = StepTimer(
                        ring_size=tc.ring_size,
                        rank=ctx.world_rank,
                        incarnation=int(
                            ctx.extra.get("elastic_incarnation", 0)),
                        trial=ctx.trial_name)
                    self._flush_interval = tc.flush_interval_s
            except Exception:
                pass
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"train-rank{ctx.world_rank}")
        self._started = False

    # -- lifecycle (called from the worker actor) --------------------------

    def start(self):
        self._started = True
        _set_session(self)
        self._thread.start()

    def _run(self):
        # this helper thread IS the actor task's work: adopt its context
        # so a blocking get() inside the user loop (dataset shards,
        # collective rendezvous) lends the worker's CPUs — without this,
        # 2 train workers blocked on a 1-CPU split coordinator deadlock
        # a fully-booked cluster
        from ray_tpu_torch._private.core import adopt_task_context

        adopt_task_context()
        # bind THIS loop thread to THIS session: after an elastic abort +
        # restart, a zombie loop thread (still unwinding from a blocked
        # collective) must see its own aborted session — not the fresh
        # one installed in the module global — so its next report()
        # raises SessionAborted instead of corrupting the new lockstep
        _tls.session = self
        if self._step_timer is not None:
            from ray_tpu_torch.telemetry import recorder as _recorder

            _recorder.set_current_timer(self._step_timer)
            self._step_timer.step_start(self._iteration)
        try:
            out = self._train_fn()
            # the last checkpoint upload may still be in flight: the
            # driver reads `latest complete checkpoint` right after the
            # finish marker, so land it (and surface its error) first
            self._storage.wait()
            if self._step_timer is not None:
                # final forced flush: the worker group is torn down right
                # after the finish marker, and a worker shorter-lived than
                # FLUSH_INTERVAL_S would otherwise never land its ring or
                # its Prometheus series in KV
                from ray_tpu_torch.telemetry import recorder as _recorder
                from ray_tpu_torch.util.metrics import _registry as _mreg

                _recorder.flush_snapshot(self._step_timer, force=True)
                try:
                    _mreg.flush()
                except Exception:
                    pass
            self._results.put(_FinishedMarker(final=out if isinstance(out, dict) else None))
        except SessionAborted:
            return  # driver-initiated teardown; nobody is consuming results
        except BaseException as e:  # surfaced to the driver, not swallowed
            if self._aborted:
                return
            self._results.put(_FinishedMarker(error=e))

    def next_result(self, timeout: Optional[float] = None):
        """Blocking: next reported result, or a finish/error marker.

        Returns ("result", metrics, ckpt_path) | ("finished", final, None)
        and raises the user exception on failure.
        """
        item = self._results.get(timeout=timeout)
        if isinstance(item, _FinishedMarker):
            if item.error is not None:
                raise item.error
            return ("finished", item.final, None)
        metrics, ckpt_path = item
        self._continue.release()  # unblock the user loop's report()
        return ("result", metrics, ckpt_path)

    def finish(self, timeout: float = 10.0):
        if self._started:
            self._thread.join(timeout=timeout)

    def abort(self, timeout: float = 10.0):
        """Unwind the user loop: its next (or currently blocked) report()
        raises SessionAborted, so nested resources held by the loop (worker
        groups, placement groups) are released by its finally blocks."""
        self._aborted = True
        self._continue.release()
        # drain a possibly queued result so a blocked put() can't wedge
        try:
            self._results.get_nowait()
        except queue.Empty:
            pass
        # ... and unblock a next_result() call already parked on the
        # queue: the worker actor has bounded concurrency, so a forever-
        # blocked result lane would wedge the actor after an elastic
        # restart (the driver abandons the old ref, but the lane must
        # free itself)
        try:
            self._results.put_nowait(
                _FinishedMarker(error=RuntimeError("session aborted")))
        except queue.Full:
            pass
        if self._started:
            self._thread.join(timeout=timeout)

    # -- user-facing (called from the train loop thread) -------------------

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        if self._aborted:
            raise SessionAborted()
        self._iteration += 1
        ckpt_path = None
        timer = self._step_timer
        if checkpoint is not None:
            if timer is not None:
                with timer.phase("checkpoint"):
                    ckpt_path = self._persist_checkpoint(checkpoint)
            else:
                ckpt_path = self._persist_checkpoint(checkpoint)
        metrics = dict(metrics)
        if timer is not None:
            rec = timer.step_end(step=self._iteration - 1)
            if rec is not None and "telemetry" not in metrics:
                metrics["telemetry"] = rec
            from ray_tpu_torch.telemetry import recorder as _recorder

            _recorder.flush_snapshot(timer,
                                     interval_s=self._flush_interval)
        self._results.put((metrics, ckpt_path))
        self._continue.acquire()  # lockstep with the driver's consumption
        if self._aborted:
            raise SessionAborted()
        if timer is not None:
            # start the next step only after the driver consumed this
            # round: the lockstep wait is driver time, not step time
            timer.step_start(self._iteration)

    def _persist_checkpoint(self, checkpoint: Checkpoint) -> str:
        """Copy the worker-local checkpoint dir into run storage.

        Layout: <trial_dir>/checkpoint_<iter>/rank_<k>/... so sharded
        checkpoints (each worker saving its own shard) land in one
        logical checkpoint directory.

        Remote storage (URI trial dir): each worker uploads its own shard
        directly to the remote filesystem — the hosts of a multi-node run
        have no shared local disk.  Uploads are ASYNC and pipelined (snapshot the
        dir now, upload in the background, write the completion marker
        only after the upload lands): the next training step overlaps the
        previous upload, and restore paths skip marker-less dirs.
        """
        from . import storage

        base = self._upload_dir or self.ctx.trial_dir
        dest = storage.join(base, f"checkpoint_{self._iteration - 1:06d}")
        if self.ctx.world_size > 1:
            dest_rank = storage.join(dest, f"rank_{self.ctx.world_rank}")
        else:
            dest_rank = dest
        marker = storage.join(
            dest, f".complete_rank_{self.ctx.world_rank}")
        if storage.is_uri(base):
            import tempfile

            # snapshot before returning: the user loop may rewrite the
            # local dir while the background upload is still reading it
            snap = tempfile.mkdtemp(prefix="ckpt-up-")
            shutil.copytree(checkpoint.path, snap, dirs_exist_ok=True)

            def on_complete(_snap=snap, _marker=marker):
                storage.write_text(_marker, "")
                shutil.rmtree(_snap, ignore_errors=True)

            self._storage.upload_dir_async(snap, dest_rank,
                                           on_complete=on_complete)
            return dest
        os.makedirs(dest, exist_ok=True)
        if os.path.abspath(checkpoint.path) != os.path.abspath(dest_rank):
            shutil.copytree(checkpoint.path, dest_rank, dirs_exist_ok=True)
        # completion marker, written last: restore paths skip checkpoint
        # dirs that died mid-copy (no marker present)
        with open(marker, "w"):
            pass
        return dest

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._restore_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        return self._dataset_shards.get(name)


# -- module-level accessors (the `ray_tpu_torch.train.report(...)` API) ----------

_session_lock = threading.Lock()
_session: Optional[TrainSession] = None
_tls = threading.local()


def _set_session(s: Optional[TrainSession]):
    global _session
    with _session_lock:
        _session = s


def _get_session() -> Optional[TrainSession]:
    # loop threads resolve their own session (see TrainSession._run);
    # anything else (actor control lane, user helper threads) gets the
    # process-current one
    tls = getattr(_tls, "session", None)
    return tls if tls is not None else _session


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ optional checkpoint) from the train loop
    (reference: session.py:667)."""
    s = _get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() called outside a "
                           "training worker")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = _get_session()
    if s is None:
        return TrainContext()
    return s.ctx


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    return None if s is None else s.get_checkpoint()


def get_dataset_shard(name: str = "train"):
    s = _get_session()
    return None if s is None else s.get_dataset_shard(name)
