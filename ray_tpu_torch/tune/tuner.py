"""Tuner: the user-facing experiment API.

Mirrors the reference (reference: python/ray/tune/tuner.py:44 Tuner, fit
:344; result_grid.py ResultGrid): Tuner(trainable, param_space=...,
tune_config=TuneConfig(...), run_config=RunConfig(...)).fit() ->
ResultGrid.  Trainers plug in via JaxTrainer.as_trainable(), matching the
reference where BaseTrainer.fit constructs a single-trial Tuner
(train/base_trainer.py:567-623).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.result import Result

from .schedulers import TrialScheduler
from .search import BasicVariantGenerator, Searcher
from .trial import ERROR, TERMINATED, Trial
from .tune_controller import Callback, TuneController


@dataclass
class TuneConfig:
    """(reference: tune/tune_config.py)"""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 0
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    trial_resources: Optional[Dict[str, float]] = None
    seed: Optional[int] = None


class ResultGrid:
    """(reference: tune/result_grid.py)"""

    def __init__(self, results: List[Result], trials: List[Trial]):
        self._results = results
        self._trials = trials

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    @property
    def num_errors(self) -> int:
        """reference: tune/result_grid.py ResultGrid.num_errors"""
        return len(self.errors)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or getattr(self, "_default_metric", None)
        mode = mode or getattr(self, "_default_mode", "max")
        if metric is None:
            raise ValueError("metric required (none set in TuneConfig)")
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        key = lambda r: float(r.metrics[metric])  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics or {} for r in self._results])


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _resumed_trials: Optional[List[Trial]] = None,
                 _experiment_dir: Optional[str] = None):
        # trainer instances are adapted automatically (reference:
        # base_trainer.py wraps itself into a trainable the same way)
        from ray_tpu_torch.train.trainer import JaxTrainer

        if isinstance(trainable, JaxTrainer):
            if run_config is None:
                run_config = trainable.run_config
            trainable = trainable.as_trainable()
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._resumed_trials = _resumed_trials
        self._experiment_dir = _experiment_dir

    def fit(self) -> ResultGrid:
        from ray_tpu_torch._private.usage_stats import record_library_usage

        record_library_usage("tune")
        cfg = self._tune_config
        from ray_tpu_torch.train import storage

        name = self._run_config.name or f"tune_{int(time.time())}"
        exp_dir = (self._experiment_dir
                   or storage.join(self._run_config.resolved_storage_path(),
                                   name))
        storage.makedirs(exp_dir)
        if self._resumed_trials is not None:
            # resumed run: continue the ORIGINAL searcher if its pickled
            # state was saved (reference: Searcher.save/restore — an
            # ask/tell optimizer picks up with everything it learned);
            # otherwise rerun the saved trials only
            searcher = TuneController.load_searcher(exp_dir)
            if searcher is None:
                searcher = BasicVariantGenerator(
                    {}, num_samples=0, metric=cfg.metric, mode=cfg.mode)
        else:
            searcher = cfg.search_alg or BasicVariantGenerator(
                self._param_space, num_samples=cfg.num_samples, seed=cfg.seed,
                metric=cfg.metric, mode=cfg.mode)
        # user-supplied search_alg inherits unset metric/mode from the
        # TuneConfig (same backfill the scheduler gets below) — an unset
        # metric silently drops every observation, an unset mode
        # silently optimizes the wrong direction.  Walk .searcher
        # chains (ConcurrencyLimiter/Repeater delegate completion to
        # the INNER searcher); explicit inner settings always win.
        # Independent gates: TuneConfig(mode=...) must apply even when
        # the searcher carries its own metric.
        s = searcher
        while s is not None:
            if cfg.metric and getattr(s, "metric", None) is None:
                s.metric = cfg.metric
            if cfg.mode and getattr(s, "mode", None) is None:
                s.mode = cfg.mode
            s = getattr(s, "searcher", None)
        scheduler = cfg.scheduler
        if scheduler is not None and scheduler.metric is None:
            scheduler.metric = cfg.metric
            scheduler.mode = cfg.mode
        from .tune_controller import JsonLoggerCallback

        controller = TuneController(
            self._trainable, searcher=searcher, scheduler=scheduler,
            experiment_dir=exp_dir, experiment_name=name,
            max_concurrent=cfg.max_concurrent_trials,
            stop=self._run_config.stop,
            max_failures=self._run_config.failure_config.max_failures,
            trial_resources=cfg.trial_resources,
            resumed_trials=self._resumed_trials,
            # user callbacks (RunConfig.callbacks — e.g. TBX/W&B/MLflow
            # from air.integrations) ride alongside the default logger
            callbacks=[JsonLoggerCallback()]
            + list(self._run_config.callbacks or ()),
        )
        controller.run()
        results = []
        for t in controller.trials:
            err = None
            if t.status == ERROR:
                err = RuntimeError(t.error_msg or "trial failed")
            ckpt = Checkpoint(t.checkpoint_path) if t.checkpoint_path else None
            metrics = dict(t.last_result or {})
            metrics.setdefault("config", t.config)
            results.append(Result(metrics=metrics or None, checkpoint=ckpt,
                                  path=t.trial_dir, error=err))
        grid = ResultGrid(results, controller.trials)
        grid._default_metric = cfg.metric
        grid._default_mode = cfg.mode
        return grid

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its directory (reference:
        tune/tuner.py Tuner.restore; experiment_state.py)."""
        trials = TuneController.load_trials(path)
        run_config = run_config or RunConfig(name=os.path.basename(path))
        t = cls(trainable, tune_config=tune_config, run_config=run_config,
                _resumed_trials=trials, _experiment_dir=path)
        return t


def run(trainable: Callable, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, metric: Optional[str] = None,
        mode: str = "max", scheduler: Optional[TrialScheduler] = None,
        storage_path: Optional[str] = None, name: Optional[str] = None,
        stop: Optional[Dict[str, Any]] = None) -> ResultGrid:
    """Functional entry point (reference: tune/tune.py tune.run)."""
    tuner = Tuner(
        trainable, param_space=config,
        tune_config=TuneConfig(metric=metric, mode=mode,
                               num_samples=num_samples, scheduler=scheduler),
        run_config=RunConfig(name=name, storage_path=storage_path, stop=stop),
    )
    return tuner.fit()
