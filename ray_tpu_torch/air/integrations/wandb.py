"""Weights & Biases logging callback (reference:
python/ray/air/integrations/wandb.py:453 WandbLoggerCallback — one wandb
run per trial, config logged once, metrics streamed per result).
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.tune_controller import Callback


def _resolve_wandb(injected):
    if injected is not None:
        return injected
    try:
        import wandb  # type: ignore

        return wandb
    except ImportError:
        raise ImportError(
            "WandbLoggerCallback needs the wandb library (not bundled in "
            "this environment) or an injected wandb-shaped object: "
            "WandbLoggerCallback(project=..., wandb=fake)") from None


class WandbLoggerCallback(Callback):
    """reference: air/integrations/wandb.py:453.

    `wandb` injects a module-shaped object with init(...)->run (run has
    .log/.finish) — the exact surface the real library exposes — so
    tests (and air-gapped clusters with a local relay) run without the
    dependency.
    """

    def __init__(self, project: Optional[str] = None,
                 group: Optional[str] = None, *, wandb=None,
                 excludes: Optional[list] = None, log_config: bool = True,
                 **init_kwargs):
        self._wandb = _resolve_wandb(wandb)
        self.project = project
        self.group = group
        self.excludes = set(excludes or ())
        self.log_config = log_config
        self.init_kwargs = init_kwargs
        self._runs: Dict[str, Any] = {}

    def _run(self, trial):
        run = self._runs.get(trial.trial_id)
        if run is None:
            # reinit="create_new" (wandb >= 0.19): each trial gets an
            # INDEPENDENT run handle — TuneController interleaves trial
            # results in one process, and legacy reinit=True would
            # finish trial A's active run when trial B starts.  All
            # logging below goes through the returned handle, never the
            # module-level fluent API, for the same reason.
            run = self._wandb.init(
                project=self.project, group=self.group,
                name=trial.trial_id, reinit="create_new",
                config=(dict(trial.config) if self.log_config else None),
                **self.init_kwargs)
            self._runs[trial.trial_id] = run
        return run

    def on_trial_result(self, trial, result: Dict[str, Any]):
        payload = {k: v for k, v in result.items()
                   if k not in self.excludes
                   and isinstance(v, numbers.Number)
                   and not isinstance(v, bool)}
        self._run(trial).log(payload,
                             step=result.get("training_iteration"))

    def on_trial_complete(self, trial):
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.finish()

    on_trial_error = on_trial_complete
