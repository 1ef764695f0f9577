"""Experiment-tracking logger callbacks (reference:
python/ray/air/integrations/wandb.py:453, mlflow.py,
python/ray/tune/logger/tensorboardx.py) — attached via
RunConfig(callbacks=[...]), artifacts asserted on disk; the W&B/MLflow
callbacks run against injected library-shaped fakes (the real libraries
are not bundled).  The cases of ``tests/test_air_integrations.py`` against
``ray_tpu_torch.air`` on the port's own cluster (one per module)."""

import json
import os

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.air.integrations import (MLflowLoggerCallback,
                                            TBXLoggerCallback,
                                            WandbLoggerCallback)
from ray_tpu_torch.train import RunConfig

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _trainable(config):
    for i in range(3):
        tune.report({"score": config["x"] * (i + 1)})


# ---------------------------------------------------------------------------
# fakes (module/client-shaped, recording)
# ---------------------------------------------------------------------------

class _FakeWandbRun:
    def __init__(self, store, name):
        self.store, self.name = store, name

    def log(self, payload, step=None):
        self.store.setdefault(self.name, []).append((step, dict(payload)))

    def finish(self):
        self.store.setdefault("_finished", []).append(self.name)


class _FakeWandb:
    def __init__(self):
        self.store = {}
        self.inits = []

    def init(self, project=None, group=None, name=None, reinit=None,
             config=None, **kw):
        self.inits.append({"project": project, "name": name,
                           "config": config})
        return _FakeWandbRun(self.store, name)


class _FakeMlflow:
    """run_id-explicit surface (the adapter contract — every call is
    targeted, so concurrent trials can't cross-log)."""

    def __init__(self):
        self.calls = []
        self._n = 0

    def set_tracking_uri(self, uri):
        self.calls.append(("set_tracking_uri", uri))

    def set_experiment(self, name):
        self.calls.append(("set_experiment", name))

    def start_run(self, run_name=None, tags=None):
        self._n += 1
        rid = f"run-{self._n}"
        self.calls.append(("start_run", run_name, rid))
        info = type("I", (), {"run_id": rid})()
        return type("R", (), {"info": info})()

    def log_params(self, params, run_id=None):
        self.calls.append(("log_params", dict(params), run_id))

    def log_metrics(self, metrics, step=0, run_id=None):
        self.calls.append(("log_metrics", dict(metrics), step, run_id))

    def end_run(self, run_id=None):
        self.calls.append(("end_run", run_id))


class _FakeWriter:
    instances = []

    def __init__(self, logdir):
        self.logdir = logdir
        self.scalars = []
        self.closed = False
        _FakeWriter.instances.append(self)

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, float(value), global_step))

    def flush(self):
        pass

    def close(self):
        self.closed = True


# ---------------------------------------------------------------------------
# attach via RunConfig(callbacks=[...]) through a real Tuner run
# ---------------------------------------------------------------------------

def test_tbx_callback_through_tuner(cluster, tmp_path):
    from ray_tpu_torch.air.integrations.tbx import _FileSummaryWriter

    # pin the JSONL stand-in (this env has torch's SummaryWriter, whose
    # binary event files we can't assert against)
    cb = TBXLoggerCallback(summary_writer_cls=_FileSummaryWriter)
    tuner = tune.Tuner(
        _trainable, param_space={"x": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="tbx_exp", storage_path=str(tmp_path),
                             callbacks=[cb]))
    results = tuner.fit()
    assert results.num_errors == 0
    event_files = []
    for root, _, files in os.walk(tmp_path):
        event_files += [os.path.join(root, f) for f in files
                        if f == "events.ray_tpu_torch.jsonl"]
    assert len(event_files) == 2          # one per trial
    rows = [json.loads(ln) for ln in open(event_files[0])]
    assert any(r["tag"] == "ray/tune/score" for r in rows)
    assert {r["step"] for r in rows if r["step"]} == {1, 2, 3}


def test_wandb_callback_through_tuner(cluster, tmp_path):
    fake = _FakeWandb()
    tuner = tune.Tuner(
        _trainable, param_space={"x": tune.grid_search([3.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="wandb_exp", storage_path=str(tmp_path),
                             callbacks=[WandbLoggerCallback(
                                 project="proj", wandb=fake)]))
    assert tuner.fit().num_errors == 0
    assert fake.inits and fake.inits[0]["project"] == "proj"
    assert fake.inits[0]["config"] == {"x": 3.0}
    runs = [k for k in fake.store if not k.startswith("_")]
    assert len(runs) == 1
    logged = fake.store[runs[0]]
    assert [s for s, _ in logged] == [1, 2, 3]
    assert logged[-1][1]["score"] == 9.0
    assert fake.store["_finished"] == runs   # finished on complete


def test_mlflow_callback_through_tuner(cluster, tmp_path):
    fake = _FakeMlflow()
    cb = MLflowLoggerCallback(tracking_uri="fake://uri",
                              experiment_name="exp", mlflow=fake)
    tuner = tune.Tuner(
        _trainable, param_space={"x": tune.grid_search([2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="mlflow_exp", storage_path=str(tmp_path),
                             callbacks=[cb]))
    assert tuner.fit().num_errors == 0
    kinds = [c[0] for c in fake.calls]
    assert kinds[:2] == ["set_tracking_uri", "set_experiment"]
    assert kinds.count("log_metrics") == 3
    assert kinds[-1] == "end_run"
    rid = next(c[2] for c in fake.calls if c[0] == "start_run")
    params = next(c for c in fake.calls if c[0] == "log_params")
    assert params[1] == {"x": 2.0} and params[2] == rid
    metrics = next(c for c in fake.calls if c[0] == "log_metrics")
    assert metrics[1]["score"] == 2.0 and metrics[2] == 1
    # every targeted call carried the run id — the concurrency contract
    assert metrics[3] == rid
    assert fake.calls[-1] == ("end_run", rid)


# ---------------------------------------------------------------------------
# standalone trainer.fit() path + unit details
# ---------------------------------------------------------------------------

def test_callbacks_fire_on_standalone_trainer_fit(cluster, tmp_path):
    from ray_tpu_torch.train import JaxTrainer, ScalingConfig

    def loop(config):
        from ray_tpu_torch import train as t

        for i in range(2):
            t.report({"loss": 1.0 / (i + 1), "training_iteration": i + 1})

    fake = _FakeWandb()
    trainer = JaxTrainer(
        train_loop_per_worker=loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="fit_cb", storage_path=str(tmp_path),
                             callbacks=[WandbLoggerCallback(
                                 project="p", wandb=fake)]))
    trainer.fit()
    runs = [k for k in fake.store if not k.startswith("_")]
    assert runs and len(fake.store[runs[0]]) == 2
    assert fake.store["_finished"] == runs


def test_tbx_injected_writer_and_nonnumeric_skip():
    cb = TBXLoggerCallback(summary_writer_cls=_FakeWriter)
    trial = type("T", (), {"trial_id": "t1", "trial_dir": "/tmp/t1",
                           "config": {}})()
    cb.on_trial_result(trial, {"score": 1.5, "name": "str", "flag": True,
                               "training_iteration": 7})
    w = _FakeWriter.instances[-1]
    assert ("ray/tune/score", 1.5, 7) in w.scalars
    assert all(not t.endswith("name") and not t.endswith("flag")
               for t, _, _ in w.scalars)
    cb.on_trial_complete(trial)
    assert w.closed


def test_wandb_requires_library_or_injection():
    with pytest.raises(ImportError, match="wandb"):
        WandbLoggerCallback(project="p")
