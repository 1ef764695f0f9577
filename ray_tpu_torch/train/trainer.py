"""JaxTrainer: the data-parallel trainer of the port (the reference's
name: "Jax" names the reference's API; the loops it runs are torch).

Mirrors the reference's DataParallelTrainer (reference:
python/ray/train/data_parallel_trainer.py; fit flow
train/base_trainer.py:567): spawn a worker gang, run
`train_loop_per_worker` on every worker, stream reported results back,
persist + rank checkpoints, and restart the group from the latest
checkpoint on worker failure (FailureConfig.max_failures).

The port's copy of ``ray_tpu/train/trainer.py``: the backend joins the
workers into one collective group (see backend.JaxConfig), and the train
loop syncs its gradients over it (``parallel.GradientSynchronizer``).
With telemetry on (the default), the run keeps a goodput accountant and
a straggler aggregator over the workers' step records, publishes both
with the run's state into KV namespace ``train`` (where the autoscaler's
``LoadMetrics`` reads ``train_goodput``), and, with
``ElasticConfig(remediation_mode=...)``, a ``RemediationEngine``.
``datasets=`` shards each port ``Dataset`` over the workers with
``streaming_split(n, equal=True)`` at every (re)start, as the reference
does.

``as_trainable()`` adapts the trainer into a trial of the port's Tune
(``ray_tpu_torch.tune``): each trial's config is merged into
``train_loop_config``, and the trial holds no CPU of its own while its
gang holds what ``ScalingConfig`` asks (cards with ``use_gpu=True``).
"""

from __future__ import annotations

import logging
import re
import time
from typing import Any, Callable, Dict, List, Optional

from .backend import BackendConfig, JaxConfig
from .backend_executor import (BackendExecutor, TrainingFailedError,
                               TrainingWorkerError, WorkerDrainedError,
                               WorkerQuarantinedError)
from .checkpoint import Checkpoint
from .checkpoint_manager import CheckpointManager
from .config import RunConfig, ScalingConfig
from .result import Result

logger = logging.getLogger(__name__)


def _find_latest_checkpoint(trial_dir: str,
                            world_size: int = 1) -> Optional[Checkpoint]:
    """Scan <trial_dir>/checkpoint_* for the newest complete checkpoint.

    Complete = a `.complete_rank_k` marker exists for EVERY rank (markers
    are written after each rank's copy/upload lands): a checkpoint where
    one worker died mid-report has a subset of ranks and restoring from
    it would hand the missing ranks someone else's shard — or nothing.
    Works on local dirs and remote URIs alike (train.storage)."""
    from . import storage

    need = {f".complete_rank_{k}" for k in range(world_size)}
    cands = []
    for name in storage.listdir(trial_dir):
        if not re.fullmatch(r"checkpoint_\d+", name):
            continue
        cdir = storage.join(trial_dir, name)
        if need <= set(storage.listdir(cdir)):
            cands.append((name, cdir))
    if not cands:
        return None
    return Checkpoint(max(cands)[1])


class JaxTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 backend_config: Optional[BackendConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self._train_fn = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or JaxConfig()
        self._datasets = datasets or {}
        self._resume_checkpoint = resume_from_checkpoint

    # -- dataset sharding --------------------------------------------------

    def _shard_datasets(self, n: int) -> Optional[List[Dict[str, Any]]]:
        """Per-worker dataset shards.  ray_tpu_torch.data Datasets shard via
        streaming_split (one coordinator actor streams blocks; workers get
        serializable DataIterators — reference: get_dataset_shard returns
        a DataIterator backed by streaming_split(equal=True)); anything
        else is replicated."""
        if not self._datasets:
            return None
        per_worker: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self._datasets.items():
            shards = None
            streaming_split = getattr(ds, "streaming_split", None)
            split = getattr(ds, "split", None)  # ray_tpu_torch.data Dataset
            if callable(streaming_split):
                shards = streaming_split(n, equal=True)
            elif callable(split):
                try:
                    shards = split(n, equal=True)
                except TypeError:
                    shards = split(n)
            if shards is None or len(shards) != n:
                shards = [ds] * n
            for i in range(n):
                per_worker[i][name] = shards[i]
        return per_worker

    # -- the run loop (shared by fit() and the Tune trainable) -------------

    def _publish_state(self, trial_name: str, status: str,
                       metrics: Optional[Dict[str, Any]], rounds: int,
                       telemetry: Optional[Dict[str, Any]] = None):
        """Run-state snapshot into the control KV (ns 'train') for the
        dashboard (reference: TrainStateActor feeding
        dashboard/modules/train/train_head.py) — advisory, never fails
        the run."""
        from ray_tpu_torch.train.backend import publish_run_state

        publish_run_state(trial_name, status,
                          name=self.run_config.name,
                          workers=self.scaling_config.num_workers,
                          rounds=rounds, metrics=metrics,
                          telemetry=telemetry)

    def _run(self, trial_dir: str, experiment_name: str, trial_name: str,
             on_report: Optional[Callable[[Dict[str, Any]], None]] = None,
             ) -> Result:
        ckpt_mgr = CheckpointManager(self.run_config.checkpoint_config)
        max_failures = self.run_config.failure_config.max_failures
        failures = 0
        restore = self._resume_checkpoint
        executor = BackendExecutor(self.backend_config, self.scaling_config)
        # flight recorder: goodput state machine + cross-worker straggler
        # detection, armed before start() so early drain notices stamp
        goodput = aggregator = remediation = None
        try:
            from ray_tpu_torch.telemetry import (GoodputAccountant, StepAggregator,
                                           resolve_telemetry,
                                           set_current_accountant)

            _tc = resolve_telemetry(
                getattr(self.backend_config, "telemetry", None))
            if _tc.enabled:
                goodput = GoodputAccountant()
                aggregator = StepAggregator(_tc, trial=trial_name)
                executor.goodput = goodput
                set_current_accountant(goodput)
                # close the detect->act loop: the engine watches the
                # aggregator's straggler episodes and (in enforce mode)
                # quarantines + rebalances; advisory mode records only
                _ec = getattr(self.backend_config, "elastic", None)
                if _ec is not None and \
                        getattr(_ec, "remediation_mode", "off") != "off":
                    from ray_tpu_torch.elastic.remediation import RemediationEngine

                    remediation = RemediationEngine(_ec, trial=trial_name)
        except Exception:
            pass

        def _telemetry_state():
            if goodput is None and aggregator is None:
                return None
            out: Dict[str, Any] = {}
            if goodput is not None:
                out["goodput"] = goodput.report()
            if aggregator is not None:
                out["stragglers"] = aggregator.summary()
            if remediation is not None:
                out["remediations"] = remediation.summary()
            return out

        executor.start()
        last_metrics: Optional[Dict[str, Any]] = None
        error: Optional[BaseException] = None
        n = self.scaling_config.num_workers
        rounds = 0  # report rounds consumed, survives restarts
        elastic = getattr(self.backend_config, "elastic", None)
        # safety net: every genuine loss shrinks the width toward
        # min_workers, so recoveries are naturally bounded — this cap only
        # guards against a pathological notice/restart loop
        elastic_recoveries = 0
        max_elastic_recoveries = 2 * n + 2
        per_worker_cks: Optional[List[Optional[Checkpoint]]] = None
        self._publish_state(trial_name, "RUNNING", None, 0)
        try:
            while True:
                try:
                    executor.start_training(
                        self._train_fn, self._config, experiment_name,
                        trial_name, trial_dir, checkpoint=restore,
                        dataset_shards_per_worker=self._shard_datasets(n),
                        start_iteration=rounds,
                        per_worker_checkpoints=per_worker_cks)
                    per_worker_cks = None
                    if goodput is not None:
                        goodput.transition(
                            "productive",
                            incarnation=getattr(executor.worker_group,
                                                "incarnation", 0))
                    while True:
                        results = executor.get_next_results()
                        if results is None:
                            break
                        rounds += 1
                        if aggregator is not None:
                            aggregator.ingest_round([
                                m.get("telemetry")
                                if isinstance(m, dict) else None
                                for _, m, _ in results])
                            if remediation is not None:
                                try:
                                    from ray_tpu_torch.telemetry import (
                                        device as _devtel)

                                    for adv in (_devtel.get_ledger()
                                                .drain_advisories()):
                                        remediation.observe_advisory(adv)
                                except Exception:
                                    pass
                                decision = remediation.observe_round(
                                    aggregator)
                                if decision is not None:
                                    nid = executor.quarantine_worker(
                                        decision["rank"],
                                        reason=decision["reason"],
                                        grace_s=decision["grace_s"])
                                    remediation.note_enforced(decision, nid)
                                    raise WorkerQuarantinedError(
                                        f"rank {decision['rank']} (node "
                                        f"{str(nid)[:12]}) quarantined: "
                                        f"{decision['reason']}")
                        # rank-0 metrics are authoritative (reference keeps
                        # per-rank results; rank 0 drives callbacks)
                        _, metrics, ckpt_path = results[0]
                        ckpt_paths = {p for _, _, p in results if p}
                        last_metrics = metrics
                        if ckpt_paths:
                            assert len(ckpt_paths) == 1, (
                                f"workers reported different checkpoint dirs: "
                                f"{ckpt_paths}")
                            ckpt = Checkpoint(next(iter(ckpt_paths)))
                            ckpt_mgr.register_checkpoint(ckpt, metrics or {})
                        if on_report is not None and metrics is not None:
                            on_report(metrics)
                        self._publish_state(trial_name, "RUNNING",
                                            metrics, rounds,
                                            telemetry=_telemetry_state())
                    executor.finish_training()
                    break
                except TrainingWorkerError as e:
                    if goodput is not None:
                        goodput.transition(
                            "draining" if isinstance(e, WorkerDrainedError)
                            else "recovering")
                    if (elastic is not None
                            and elastic_recoveries < max_elastic_recoveries):
                        try:
                            cks, step, new_n = executor.elastic_recover()
                        except Exception as rec_err:
                            logger.warning(
                                "elastic recovery unavailable (%s); falling "
                                "back to storage-checkpoint restart",
                                rec_err)
                        else:
                            # in-memory recovery: does NOT count against
                            # max_failures (bounded by width shrinking to
                            # min_workers + the recoveries cap above)
                            elastic_recoveries += 1
                            per_worker_cks = cks
                            n = new_n
                            ckpt_mgr.note_emergency(step)
                            if remediation is not None:
                                remediation.note_recovered(new_n, step)
                            logger.warning(
                                "elastic recovery %d: resuming %d-wide from "
                                "replicated snapshot step=%d (trigger: %s)",
                                elastic_recoveries, new_n, step, e)
                            self._publish_state(trial_name, "RESTARTING",
                                                last_metrics, rounds,
                                                telemetry=_telemetry_state())
                            continue
                    failures += 1
                    if max_failures != -1 and failures > max(max_failures, 0):
                        error = e
                        break
                    logger.warning(
                        "training worker died (%s); restarting group "
                        "(failure %d/%s) from latest checkpoint", e,
                        failures, max_failures if max_failures != -1 else "inf")
                    # the dir scan is marker-validated (an upload that
                    # died with its worker left no marker), so it is the
                    # safe restore source; the manager's latest may point
                    # at an in-flight upload
                    restore = (_find_latest_checkpoint(trial_dir, n)
                               or self._resume_checkpoint)
                    executor.restart()
                    # a full restart rebuilds at the configured width even
                    # after elastic shrinks
                    n = executor.worker_group.num_workers
                    per_worker_cks = None
                except TrainingFailedError as e:
                    error = e
                    break
        finally:
            executor.shutdown()
            if goodput is not None:
                try:
                    goodput.transition("idle")
                    from ray_tpu_torch.telemetry import set_current_accountant

                    set_current_accountant(None)
                except Exception:
                    pass
            self._publish_state(trial_name,
                                "ERRORED" if error else "FINISHED",
                                last_metrics, rounds,
                                telemetry=_telemetry_state())
        return Result(metrics=last_metrics,
                      checkpoint=ckpt_mgr.latest_checkpoint,
                      path=trial_dir, error=error,
                      best_checkpoints=ckpt_mgr.best_checkpoints())

    def fit(self) -> Result:
        from ray_tpu_torch._private.usage_stats import record_library_usage

        record_library_usage("train")
        from . import storage

        name = self.run_config.name or f"JaxTrainer_{int(time.time())}"
        exp_dir = storage.join(self.run_config.resolved_storage_path(), name)
        trial_name = f"{name}_00000"
        trial_dir = storage.join(exp_dir, trial_name)
        storage.makedirs(trial_dir)
        callbacks = list(self.run_config.callbacks or ())
        on_report = None
        trial_shim = None
        if callbacks:
            # standalone fit() fires RunConfig.callbacks too (reference:
            # trainers always run through Tune's callback plumbing); the
            # shim carries the trial fields callbacks read
            trial_shim = type("TrialShim", (), {})()
            trial_shim.trial_id = trial_name
            trial_shim.trial_dir = trial_dir
            trial_shim.config = dict(self._config)

            def on_report(metrics, _t=trial_shim):
                for cb in callbacks:
                    cb.on_trial_result(_t, metrics)

        result = self._run(trial_dir, name, trial_name, on_report=on_report)
        for cb in callbacks:
            if result.error is not None:
                cb.on_trial_error(trial_shim)
            else:
                cb.on_trial_complete(trial_shim)
        if result.error is not None:
            raise TrainingFailedError(
                f"training failed: {result.error}") from result.error
        return result

    # -- Tune integration --------------------------------------------------

    def as_trainable(self):
        """Adapt this trainer into a Tune function-trainable.  Tune merges
        each trial's hyperparameter `config` into train_loop_config."""
        trainer = self

        def _trainable(config, tune_session):
            import copy

            t = copy.copy(trainer)
            t._config = {**trainer._config, **config}
            t._resume_checkpoint = (tune_session.get_checkpoint()
                                    or trainer._resume_checkpoint)
            result = t._run(tune_session.trial_dir,
                            tune_session.experiment_name,
                            tune_session.trial_name,
                            on_report=tune_session.report)
            if result.error is not None:
                raise result.error
            return result.metrics

        _trainable.__name__ = "JaxTrainerTrainable"
        _trainable._is_trainer_adapter = True
        _trainable._scaling_config = self.scaling_config
        return _trainable


# Torch users of the reference map to this 1:1.
DataParallelTrainer = JaxTrainer
