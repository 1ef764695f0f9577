"""TensorBoard logging callback (reference:
python/ray/tune/logger/tensorboardx.py TBXLoggerCallback — one
SummaryWriter per trial, scalars per result, flushed on complete).
"""

from __future__ import annotations

import json
import numbers
import os
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.tune_controller import Callback


class _FileSummaryWriter:
    """Dependency-free SummaryWriter stand-in: one JSONL event file per
    trial.  Not the TF event format, but the same information — and the
    fallback keeps the callback usable (and testable) in hermetic
    environments without tensorboardX."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "events.ray_tpu_torch.jsonl"), "a")

    def add_scalar(self, tag: str, value, global_step: Optional[int] = None):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": global_step}) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def _resolve_writer_cls():
    try:
        from tensorboardX import SummaryWriter  # type: ignore

        return SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            return SummaryWriter
        except ImportError:
            return _FileSummaryWriter


class TBXLoggerCallback(Callback):
    """Logs every numeric result field as a scalar, stepped by
    training_iteration (reference: tensorboardx.py:71 log_trial_result).

    `summary_writer_cls` overrides writer resolution (tests inject a
    recording fake; default tries tensorboardX, then torch's copy, then
    the JSONL stand-in).
    """

    def __init__(self, summary_writer_cls=None):
        self._writer_cls = summary_writer_cls or _resolve_writer_cls()
        self._writers: Dict[str, Any] = {}

    def _writer(self, trial):
        w = self._writers.get(trial.trial_id)
        if w is None:
            logdir = trial.trial_dir
            if "://" in (logdir or ""):
                # remote trial dirs: write locally under ~/.ray_tpu_tbx
                # (tbx writers need a real filesystem)
                logdir = os.path.expanduser(
                    os.path.join("~/.ray_tpu_tbx", trial.trial_id))
            w = self._writers[trial.trial_id] = self._writer_cls(logdir)
        return w

    def on_trial_result(self, trial, result: Dict[str, Any]):
        w = self._writer(trial)
        step = result.get("training_iteration")
        for k, v in result.items():
            if isinstance(v, numbers.Number) and not isinstance(v, bool):
                w.add_scalar(f"ray/tune/{k}", v, step)
        w.flush()

    def on_trial_complete(self, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()

    on_trial_error = on_trial_complete
