"""SearcherWrapper on the port: the cases of
``tests/test_tune_searcher_wrapper.py`` against ``ray_tpu_torch.tune``
(reference: python/ray/tune/search/'s per-library integrations all reduce
to ask/tell; one duck-typed shim covers the surface without bundling any
library).  One cluster of the port's own per module."""

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune import SearcherWrapper

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


class _SkoptLike:
    """ask() -> config dict; tell(config, value); minimizes."""

    def __init__(self, grid):
        self.grid = list(grid)
        self.told = []

    def ask(self):
        return self.grid.pop(0) if self.grid else None

    def tell(self, token, value):
        self.told.append((token, value))


class _OptunaLike:
    """ask() -> trial-like with .params; tell(trial, value)."""

    class T:
        def __init__(self, params):
            self.params = params

    def __init__(self, grid):
        self.grid = [self.T(g) for g in grid]
        self.told = []

    def ask(self):
        return self.grid.pop(0) if self.grid else None

    def tell(self, trial, value):
        self.told.append((trial, value))


def test_requires_ask_tell():
    with pytest.raises(TypeError, match="ask"):
        SearcherWrapper(object(), metric="score")


def test_dict_ask_and_mode_negation():
    opt = _SkoptLike([{"x": 1.0}, {"x": 2.0}])
    s = SearcherWrapper(opt, metric="score", mode="max")
    c1 = s.suggest("t1")
    assert c1 == {"x": 1.0}
    s.on_trial_complete("t1", {"score": 5.0})
    # maximizing over a minimizer: value negated
    assert opt.told == [({"x": 1.0}, -5.0)]
    assert s.suggest("t2") == {"x": 2.0}
    assert s.suggest("t3") is None      # exhausted


def test_trial_like_token_and_error_skips_tell():
    opt = _OptunaLike([{"lr": 0.1}])
    s = SearcherWrapper(opt, metric="loss", mode="min")
    cfg = s.suggest("t1")
    assert cfg == {"lr": 0.1}
    s.on_trial_complete("t1", error=True)
    assert opt.told == []               # failures are not fake values


def test_to_config_extractor():
    class Weird:
        def __init__(self, kv):
            self.kv = kv

    class Opt:
        def ask(self):
            return Weird({"a": 3})

        def tell(self, token, value):
            pass

    s = SearcherWrapper(Opt(), metric="m", to_config=lambda t: t.kv)
    assert s.suggest("t") == {"a": 3}


def test_searcher_state_resumes_remaining_budget(cluster, tmp_path):
    """An interrupted run's restore() continues the ORIGINAL searcher
    from its pickled state (reference: Searcher.save/restore) — the
    not-yet-suggested budget is not lost and the optimizer keeps what
    it was told."""
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.tune.trial import TERMINATED
    from ray_tpu_torch.tune.tune_controller import TuneController

    opt = _SkoptLike([{"x": float(i)} for i in range(6)])
    exp = str(tmp_path / "exp")

    def obj(config):
        tune.report({"score": config["x"]})

    controller = TuneController(
        obj, searcher=SearcherWrapper(opt, metric="score", mode="max"),
        scheduler=None, experiment_dir=exp, experiment_name="exp",
        max_concurrent=1)
    for _ in range(60):
        done = sum(1 for t in controller.trials
                   if t.status == TERMINATED)
        if done >= 2 or not controller.step():
            break
    controller.save_state()
    controller.cleanup()           # "interrupted" here
    assert 0 < sum(1 for t in controller.trials
                   if t.status == TERMINATED) < 6

    grid = Tuner.restore(
        exp, obj,
        tune_config=TuneConfig(metric="score", mode="max")).fit()
    done = [r for r in grid if r.error is None and r.metrics]
    xs = sorted(r.metrics["score"] for r in done)
    assert xs == [float(i) for i in range(6)], xs   # full budget ran
    # (the restored run drives a pickled COPY of opt; only the
    # pre-interrupt tells are observable on this instance)
    assert len(opt.told) >= 1


def test_end_to_end_through_tuner(cluster, tmp_path):
    opt = _SkoptLike([{"x": 1.0}, {"x": 3.0}, {"x": 2.0}])

    def obj(config):
        tune.report({"score": config["x"] * 10})

    from ray_tpu_torch.train import RunConfig

    tuner = tune.Tuner(
        obj,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=3,
            search_alg=SearcherWrapper(opt, metric="score", mode="max")),
        run_config=RunConfig(name="wrap", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert grid.num_errors == 0
    best = grid.get_best_result()
    assert best.metrics["score"] == 30.0
    # every completed trial was told back, negated for the minimizer
    assert sorted(v for _, v in opt.told) == [-30.0, -20.0, -10.0]
