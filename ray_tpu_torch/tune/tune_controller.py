"""TuneController: the experiment event loop.

Mirrors the reference (reference: python/ray/tune/execution/
tune_controller.py:68 TuneController, step :666): start trial actors up to
the concurrency/resource budget, consume reported results, apply scheduler
decisions (CONTINUE/PAUSE/STOP), retry failed trials from their last
checkpoint, snapshot experiment state for resume, and run PBT
exploit/explore by restarting paused trials from a donor checkpoint.

Each trial runs in one actor (`_TrialRunnerActor`) which hosts the user
trainable inside a TrainSession — the same report/lockstep machinery Train
uses, which is exactly how the reference unifies the two (Train runs *on*
Tune; tune session == train session).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import ActorDiedError, WorkerCrashedError
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, TrainSession

from . import schedulers as sched_mod
from .schedulers import CONTINUE, PAUSE, STOP, FIFOScheduler, TrialScheduler
from .search import Searcher
from .trial import (ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial)

logger = logging.getLogger(__name__)


class _TuneSessionShim:
    """What a trainer-adapter trainable sees as `tune_session`."""

    def __init__(self, trial_dir: str, experiment_name: str, trial_name: str):
        self.trial_dir = trial_dir
        self.experiment_name = experiment_name
        self.trial_name = trial_name

    def report(self, metrics: Dict[str, Any]):
        from ray_tpu_torch.train.session import report

        report(metrics)

    def get_checkpoint(self):
        from ray_tpu_torch.train.session import get_checkpoint

        return get_checkpoint()


class _TrialRunnerActor:
    """Actor hosting one trial's trainable."""

    def __init__(self):
        self._session: Optional[TrainSession] = None
        self._iteration = 0

    def start(self, trainable: Callable, config: Dict[str, Any],
              trial_dir: str, experiment_name: str, trial_id: str,
              checkpoint_path: Optional[str], start_iteration: int):
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        ctx = TrainContext(world_size=1, world_rank=0,
                           experiment_name=experiment_name,
                           trial_name=trial_id, trial_id=trial_id,
                           trial_dir=trial_dir)
        self._iteration = start_iteration
        if getattr(trainable, "_is_trainer_adapter", False):
            shim = _TuneSessionShim(trial_dir, experiment_name, trial_id)
            fn = lambda: trainable(config, shim)  # noqa: E731
        else:
            import inspect

            params = list(inspect.signature(trainable).parameters)
            fn = (lambda: trainable(config)) if params else trainable
        self._session = TrainSession(ctx, fn, checkpoint=ckpt,
                                     checkpoint_upload_dir=trial_dir,
                                     start_iteration=start_iteration)
        self._session.start()
        return True

    def next_result(self):
        kind, metrics, ckpt_path = self._session.next_result()
        if kind == "result":
            self._iteration += 1
            metrics = dict(metrics or {})
            metrics.setdefault("training_iteration", self._iteration)
            metrics.setdefault("timestamp", time.time())
        return (kind, metrics, ckpt_path)

    def stop(self):
        """Graceful teardown: unwind the trainable so nested resources
        (trainer-adapter worker groups + placement groups) are released
        before the actor dies."""
        if self._session is not None:
            self._session.abort()
            self._session = None
        return True


class Callback:
    """Experiment callbacks (reference: tune/callback.py)."""

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial: Trial):
        pass

    def on_trial_error(self, trial: Trial):
        pass


class JsonLoggerCallback(Callback):
    """Append each result as a JSON line in the trial dir (reference:
    tune/logger/json.py)."""

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]):
        from ray_tpu_torch.train import storage

        try:
            storage.append_text(
                storage.join(trial.trial_dir, "result.json"),
                json.dumps(result, default=str) + "\n")
        except OSError:
            pass


class TuneController:
    def __init__(self, trainable: Callable, *, searcher: Searcher,
                 scheduler: Optional[TrialScheduler] = None,
                 experiment_dir: str, experiment_name: str,
                 max_concurrent: int = 0,
                 stop: Optional[Dict[str, Any]] = None,
                 max_failures: int = 0,
                 callbacks: Optional[List[Callback]] = None,
                 trial_resources: Optional[Dict[str, float]] = None,
                 resumed_trials: Optional[List[Trial]] = None):
        self._trainable = trainable
        self._searcher = searcher
        self._scheduler = scheduler or FIFOScheduler()
        self._experiment_dir = experiment_dir
        self._experiment_name = experiment_name
        self._max_concurrent = max_concurrent
        self._stop_criteria = stop or {}
        self._max_failures = max_failures
        self._callbacks = callbacks if callbacks is not None else [
            JsonLoggerCallback()]
        if getattr(trainable, "_is_trainer_adapter", False):
            self._trial_resources = {"CPU": 0}
        else:
            self._trial_resources = dict(trial_resources or {"CPU": 1})
        self.trials: List[Trial] = list(resumed_trials or [])
        self._actors: Dict[str, Any] = {}          # trial_id -> actor handle
        self._inflight: Dict[Any, Trial] = {}      # next_result ref -> trial
        self._start_refs: set = set()              # refs that are start-acks
        self._searcher_done = False
        self._runner_cls = ray_tpu_torch.remote(_TrialRunnerActor)
        from ray_tpu_torch._private import common as _common

        _common._ensure_picklable_by_value(trainable)

    # -- trial lifecycle ---------------------------------------------------

    def _new_trial(self) -> Optional[Trial]:
        if self._searcher_done:
            return None
        tid = f"{self._experiment_name}_{len(self.trials):05d}"
        cfg = self._searcher.suggest(tid)
        if cfg is Searcher.DEFER:
            # searcher (e.g. ConcurrencyLimiter) will have more later
            return None
        if cfg is None:
            self._searcher_done = True
            return None
        t = Trial(tid, cfg, self._experiment_dir, self._experiment_name)
        self.trials.append(t)
        self._scheduler.on_trial_add(t)
        return t

    def _running_count(self) -> int:
        return sum(1 for t in self.trials if t.status == RUNNING)

    def _start_trial(self, trial: Trial):
        opts = {"num_cpus": self._trial_resources.get("CPU", 1),
                "max_concurrency": 2}
        extra = {k: v for k, v in self._trial_resources.items() if k != "CPU"}
        if extra:
            opts["resources"] = extra
        actor = self._runner_cls.options(**opts).remote()
        ref = actor.start.remote(self._trainable, trial.config,
                                 trial.trial_dir, self._experiment_name,
                                 trial.trial_id, trial.checkpoint_path,
                                 trial.iteration)
        trial.status = RUNNING
        self._actors[trial.trial_id] = actor
        # non-blocking: the start-ack joins the inflight set so the
        # controller keeps consuming results while this actor waits for
        # resources (a blocking get here deadlocks once trials > CPUs:
        # nothing can finish/tear down to free the CPU being waited for)
        self._inflight[ref] = trial
        self._start_refs.add(ref)

    def _poll(self, trial: Trial):
        actor = self._actors[trial.trial_id]
        ref = actor.next_result.remote()
        self._inflight[ref] = trial

    def _teardown_actor(self, trial: Trial):
        actor = self._actors.pop(trial.trial_id, None)
        if actor is not None:
            # graceful first: unwind the trainable (releases nested worker
            # groups / placement groups held by trainer adapters)
            try:
                ray_tpu_torch.get(actor.stop.remote(), timeout=15.0)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        dropped = [r for r, t in self._inflight.items()
                   if t.trial_id == trial.trial_id]
        for r in dropped:
            self._inflight.pop(r, None)
            self._start_refs.discard(r)

    # -- result handling ---------------------------------------------------

    def _should_stop_by_criteria(self, result: Dict[str, Any]) -> bool:
        for k, v in self._stop_criteria.items():
            if k in result and result[k] >= v:
                return True
        return False

    def _handle_result(self, trial: Trial, kind: str,
                       metrics: Optional[Dict[str, Any]],
                       ckpt_path: Optional[str]):
        if kind == "finished":
            if metrics:
                trial.last_result = {**(trial.last_result or {}), **metrics}
            trial.status = TERMINATED
            self._teardown_actor(trial)
            self._searcher.on_trial_complete(trial.trial_id,
                                             trial.last_result)
            self._scheduler.on_trial_complete(trial)
            for cb in self._callbacks:
                cb.on_trial_complete(trial)
            return
        trial.iteration = metrics["training_iteration"]
        trial.last_result = metrics
        trial.results.append(metrics)
        if ckpt_path:
            trial.checkpoint_path = ckpt_path
        self._searcher.on_trial_result(trial.trial_id, metrics)
        for cb in self._callbacks:
            cb.on_trial_result(trial, metrics)
        decision = CONTINUE
        if self._should_stop_by_criteria(metrics):
            decision = STOP
        elif self._scheduler.metric and self._scheduler.metric in metrics:
            decision = self._scheduler.on_trial_result(trial, metrics)
        if decision == CONTINUE:
            self._poll(trial)
        elif decision == STOP:
            trial.status = TERMINATED
            self._teardown_actor(trial)
            self._searcher.on_trial_complete(trial.trial_id, metrics)
            self._scheduler.on_trial_complete(trial)
            for cb in self._callbacks:
                cb.on_trial_complete(trial)
        elif decision == PAUSE:
            trial.status = PAUSED
            self._teardown_actor(trial)
            self._maybe_exploit(trial)
            if trial.status == PAUSED:
                # no exploit pending (non-PBT scheduler, or donor not ready):
                # requeue so the trial resumes from its checkpoint rather
                # than stranding in PAUSED (the experiment would exit)
                trial.status = PENDING

    def _maybe_exploit(self, trial: Trial):
        """PBT exploit/explore: clone a donor's config+checkpoint."""
        pbt = self._scheduler
        if not isinstance(pbt, sched_mod.PopulationBasedTraining):
            return
        pending = pbt.pending_exploits.pop(trial.trial_id, None)
        if not pending:
            return
        donor = next((t for t in self.trials if t.trial_id == pending[0]),
                     None)
        if donor is None:
            trial.status = PENDING
            return
        trial.config = pbt.make_exploit_config(donor)
        if donor.checkpoint_path:
            trial.checkpoint_path = donor.checkpoint_path
        trial.status = PENDING
        logger.info("PBT exploit: %s <- %s config=%s", trial.trial_id,
                    donor.trial_id, trial.config)

    def _handle_failure(self, trial: Trial, err: BaseException):
        if isinstance(err, (ActorDiedError, WorkerCrashedError)):
            trial.num_failures += 1
            self._teardown_actor(trial)
            if (self._max_failures == -1
                    or trial.num_failures <= self._max_failures):
                logger.warning("trial %s failed (%d); restarting from %s",
                               trial.trial_id, trial.num_failures,
                               trial.checkpoint_path)
                trial.status = PENDING
                return
        trial.status = ERROR
        trial.error_msg = str(err)
        self._teardown_actor(trial)
        self._searcher.on_trial_complete(trial.trial_id, error=True)
        self._scheduler.on_trial_error(trial)
        for cb in self._callbacks:
            cb.on_trial_error(trial)

    # -- the loop ----------------------------------------------------------

    def _effective_max_concurrent(self) -> int:
        """Trial-start pacing.  max_concurrent=0 ("unlimited") paces to
        cluster CPU capacity instead of literally unlimited: eagerly
        draining the searcher turns every future trial into a pending
        actor record at once (an unbounded ask/tell searcher made this
        an infinite loop), and lazy suggestion also means ask/tell
        searchers observe completed results before later asks."""
        if self._max_concurrent:
            return self._max_concurrent
        now = time.time()
        if now - getattr(self, "_cap_ts", 0.0) > 5.0:
            try:
                total = ray_tpu_torch.cluster_resources().get("CPU", 0)
            except Exception:
                total = 0
            per = float(self._trial_resources.get("CPU", 1))
            if per <= 0:
                # trainer adapters request CPU:0 at the trial layer (the
                # worker group inside holds the real CPUs) — assume one
                # core per trial rather than dividing by ~zero
                per = 1.0
            self._cap = max(2, int(total / per)) if total else 16
            self._cap_ts = now
        return self._cap

    def _fill(self):
        # FINITE bare searchers (grid/random expose total_trials)
        # materialize every remaining suggestion as a PENDING record up
        # front: records are cheap, save_state persists them, so an
        # interrupted run's restore() sees the full budget.  Actor
        # STARTS are paced below either way.  Wrapped finite searchers
        # (ConcurrencyLimiter(grid)) and ask/tell searchers stay lazy —
        # limiting/learning means suggestions must wait on completions,
        # and their internal state was never resumable (same restore
        # semantics those shapes always had).
        if hasattr(self._searcher, "total_trials"):
            while not self._searcher_done and self._new_trial() is not None:
                pass
        while True:
            if self._running_count() >= self._effective_max_concurrent():
                return
            nxt = self._scheduler.choose_trial_to_run(
                [t for t in self.trials if t.status == PENDING])
            if nxt is None:
                nxt = self._new_trial()
            if nxt is None:
                return
            try:
                self._start_trial(nxt)
            except ray_tpu_torch.TaskError as e:
                self._handle_failure(nxt, e)
            except (ActorDiedError, WorkerCrashedError) as e:
                self._handle_failure(nxt, e)

    def _drain_scheduler_stops(self):
        """Cull trials the scheduler condemned outside their own report
        (HyperBand successive-halving losers waiting as PENDING)."""
        for tid in self._scheduler.trials_to_stop():
            t = next((x for x in self.trials if x.trial_id == tid), None)
            if t is None or t.status in (TERMINATED, ERROR):
                continue
            t.status = TERMINATED
            self._teardown_actor(t)
            self._searcher.on_trial_complete(t.trial_id, t.last_result)
            for cb in self._callbacks:
                cb.on_trial_complete(t)

    def step(self) -> bool:
        """One controller iteration; returns False when the experiment is
        done (reference: tune_controller.py:666)."""
        self._drain_scheduler_stops()
        self._fill()
        if not self._inflight:
            live = any(t.status in (PENDING, RUNNING) for t in self.trials)
            if not live and self._searcher_done:
                return False
            if not live and not self._searcher_done:
                # searcher has more but nothing running: loop to fill again
                return True
            return bool(self._inflight)
        refs = list(self._inflight.keys())
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=5.0)
        for ref in ready:
            trial = self._inflight.pop(ref)
            if ref in self._start_refs:
                self._start_refs.discard(ref)
                try:
                    ray_tpu_torch.get(ref)
                except (ActorDiedError, WorkerCrashedError,
                        ray_tpu_torch.TaskError) as e:
                    self._handle_failure(trial, e)
                    continue
                if trial.status == RUNNING:
                    self._poll(trial)
                continue
            try:
                kind, metrics, ckpt = ray_tpu_torch.get(ref)
            except (ActorDiedError, WorkerCrashedError,
                    ray_tpu_torch.TaskError) as e:
                self._handle_failure(trial, e)
                continue
            self._handle_result(trial, kind, metrics, ckpt)
        # periodic, not per-step: serializing every trial record each
        # iteration is O(total_trials) — a 50k-sample sweep would spend
        # its steps writing JSON (reference: TUNE_GLOBAL_CHECKPOINT_S
        # periodic experiment snapshots); run() writes a final one
        now = time.time()
        if now - getattr(self, "_last_save", 0.0) > 5.0:
            self._last_save = now
            self.save_state()
        return True

    def run(self):
        while self.step():
            pass
        self.save_state()
        self.cleanup()

    def cleanup(self):
        for t in list(self.trials):
            if t.trial_id in self._actors:
                self._teardown_actor(t)

    # -- experiment state --------------------------------------------------

    def save_state(self):
        from ray_tpu_torch.train import storage

        state = {
            "experiment_name": self._experiment_name,
            "timestamp": time.time(),
            "trials": [t.to_json() for t in self.trials],
        }
        path = storage.join(self._experiment_dir, "experiment_state.json")
        if storage.is_uri(path):
            storage.write_text(path, json.dumps(state, default=str))
        else:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f, default=str)
            os.replace(tmp, path)
        # searcher AFTER the trial records: a crash between the writes
        # then means a stale searcher that re-suggests (benign
        # duplicates) rather than a fresh cursor whose already-consumed
        # suggestions have no trial records (silent budget loss)
        self._save_searcher()

    def _save_searcher(self):
        """Pickle the searcher next to the experiment state (reference:
        Searcher.save/restore + experiment_state searcher checkpointing)
        so Tuner.restore continues it — cursor position for grid/random,
        learned observations for TPE/GP/ask-tell wrappers.  Best-effort:
        an unpicklable user optimizer just skips (restore then reruns
        saved trials only, the pre-existing semantics)."""
        import cloudpickle

        from ray_tpu_torch._private import fileio
        from ray_tpu_torch.train import storage

        try:
            blob = cloudpickle.dumps(self._searcher)
        except Exception:
            return
        path = storage.join(self._experiment_dir, "searcher_state.pkl")
        try:
            if fileio.is_uri(path):
                with fileio.open_file(path, "wb") as f:
                    f.write(blob)
            else:
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)   # atomic locally
        except Exception:
            logger.debug("searcher state save failed", exc_info=True)

    @staticmethod
    def load_searcher(experiment_dir: str):
        """The pickled searcher of an interrupted run, or None."""
        import cloudpickle

        from ray_tpu_torch._private import fileio
        from ray_tpu_torch.train import storage

        path = storage.join(experiment_dir, "searcher_state.pkl")
        try:
            with fileio.open_file(path, "rb") as f:
                return cloudpickle.loads(f.read())
        except FileNotFoundError:
            return None
        except Exception:
            logger.warning("searcher state unreadable; resuming saved "
                           "trials only", exc_info=True)
            return None

    @staticmethod
    def load_trials(experiment_dir: str) -> List[Trial]:
        from ray_tpu_torch.train import storage

        path = storage.join(experiment_dir, "experiment_state.json")
        state = json.loads(storage.read_text(path))
        name = state["experiment_name"]
        trials = []
        for d in state["trials"]:
            t = Trial.from_json(d, experiment_dir, name)
            if t.status in (RUNNING, PAUSED):
                t.status = PENDING  # interrupted: rerun from checkpoint
            trials.append(t)
        return trials
