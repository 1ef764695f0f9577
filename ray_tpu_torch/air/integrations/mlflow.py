"""MLflow logging callback (reference:
python/ray/air/integrations/mlflow.py MLflowLoggerCallback — one mlflow
run per trial, params logged once, metrics per result).

Every call is targeted by run_id: TuneController runs trials
CONCURRENTLY, and mlflow's fluent module-level API routes through a
single global "active run" — interleaved trials would log into each
other's runs.  The real library is therefore wrapped in an
MlflowClient-backed adapter; injected fakes implement the same
run_id-explicit surface (see _FakeMlflow in tests/test_air_integrations.py):

    start_run(run_name, tags) -> run (with .info.run_id)
    log_params(params, run_id)
    log_metrics(metrics, step, run_id)
    end_run(run_id)
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.tune_controller import Callback


class _ClientAdapter:
    """run_id-targeted adapter over the real mlflow module (reference:
    air/integrations/mlflow.py _MLflowLoggerUtil, which likewise keeps
    an MlflowClient and passes run ids explicitly)."""

    def __init__(self, mlflow, tracking_uri: Optional[str],
                 experiment_name: Optional[str]):
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        self._client = mlflow.tracking.MlflowClient(tracking_uri)
        self._exp_id = "0"
        if experiment_name:
            exp = self._client.get_experiment_by_name(experiment_name)
            self._exp_id = (exp.experiment_id if exp is not None
                            else self._client.create_experiment(
                                experiment_name))

    def start_run(self, run_name, tags):
        return self._client.create_run(
            self._exp_id, tags={**(tags or {}),
                                "mlflow.runName": run_name})

    def log_params(self, params, run_id):
        for k, v in params.items():
            self._client.log_param(run_id, k, v)

    def log_metrics(self, metrics, step, run_id):
        for k, v in metrics.items():
            self._client.log_metric(run_id, k, v, step=step)

    def end_run(self, run_id):
        self._client.set_terminated(run_id)


def _resolve_mlflow(injected, tracking_uri, experiment_name):
    if injected is not None:
        if tracking_uri and hasattr(injected, "set_tracking_uri"):
            injected.set_tracking_uri(tracking_uri)
        if experiment_name and hasattr(injected, "set_experiment"):
            injected.set_experiment(experiment_name)
        return injected
    try:
        import mlflow  # type: ignore
    except ImportError:
        raise ImportError(
            "MLflowLoggerCallback needs the mlflow library (not bundled "
            "in this environment) or an injected mlflow-shaped object: "
            "MLflowLoggerCallback(mlflow=fake)") from None
    return _ClientAdapter(mlflow, tracking_uri, experiment_name)


class MLflowLoggerCallback(Callback):
    """reference: air/integrations/mlflow.py MLflowLoggerCallback."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: Optional[str] = None, *, mlflow=None,
                 tags: Optional[Dict[str, str]] = None):
        self._mlflow = _resolve_mlflow(mlflow, tracking_uri,
                                       experiment_name)
        self.tags = tags or {}
        self._run_ids: Dict[str, Any] = {}

    def _run_id(self, trial):
        rid = self._run_ids.get(trial.trial_id)
        if rid is None:
            run = self._mlflow.start_run(run_name=trial.trial_id,
                                         tags=self.tags)
            rid = getattr(getattr(run, "info", None), "run_id",
                          trial.trial_id)
            self._run_ids[trial.trial_id] = rid
            if trial.config:
                self._mlflow.log_params(dict(trial.config), run_id=rid)
        return rid

    def on_trial_result(self, trial, result: Dict[str, Any]):
        rid = self._run_id(trial)
        metrics = {k: float(v) for k, v in result.items()
                   if isinstance(v, numbers.Number)
                   and not isinstance(v, bool)}
        self._mlflow.log_metrics(
            metrics, step=int(result.get("training_iteration") or 0),
            run_id=rid)

    def on_trial_complete(self, trial):
        rid = self._run_ids.pop(trial.trial_id, None)
        if rid is not None:
            self._mlflow.end_run(run_id=rid)

    on_trial_error = on_trial_complete
