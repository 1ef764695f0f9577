"""The extended tune surface on the port: the cases of
``tests/test_tune_extended.py`` (HyperBand, PB2, TPE, ConcurrencyLimiter,
Repeater, BayesOpt; reference: tune/tests/test_trial_scheduler.py,
test_searchers.py) against ``ray_tpu_torch.tune``, plus parity with the
reference's searchers and schedulers: fed the same seeds and the same
reported metric sequences, both give the same trial configs and the same
continue/pause/stop decisions, in order.  One cluster of the port's own
per module; the reference's Tune runs here only as plain Python (no
cluster, no JAX program)."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train, tune
from ray_tpu_torch.train import RunConfig
from ray_tpu_torch.tune import (ConcurrencyLimiter, HyperBandScheduler, PB2,
                                Repeater, TPESearch, TuneConfig, Tuner)
from ray_tpu_torch.tune.search import DEFER, BasicVariantGenerator

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _objective(config):
    for i in range(1, 10):
        train.report({"score": config["x"] * i, "training_iteration": i})


# ---------------------------------------------------------------------------
# Searchers (no cluster)
# ---------------------------------------------------------------------------

def test_concurrency_limiter_defers():
    base = BasicVariantGenerator({"x": tune.uniform(0, 1)}, num_samples=5,
                                 metric="score")
    lim = ConcurrencyLimiter(base, max_concurrent=2)
    c1 = lim.suggest("t1")
    c2 = lim.suggest("t2")
    assert isinstance(c1, dict) and isinstance(c2, dict)
    assert lim.suggest("t3") is DEFER
    lim.on_trial_complete("t1", {"score": 1.0})
    assert isinstance(lim.suggest("t3"), dict)


def test_repeater_aggregates():
    seen = {}

    class Rec(BasicVariantGenerator):
        def on_trial_complete(self, tid, result=None, error=False):
            seen[tid] = result

    base = Rec({"x": tune.uniform(0, 1)}, num_samples=2, metric="score")
    rep = Repeater(base, repeat=3, metric="score")
    ids = []
    for i in range(6):
        cfg = rep.suggest(f"t{i}")
        assert isinstance(cfg, dict)
        ids.append(f"t{i}")
    # t0-t2 share config 1; t3-t5 share config 2
    for i, tid in enumerate(ids[:3]):
        rep.on_trial_complete(tid, {"score": float(i)})
    assert seen["t0"]["score"] == pytest.approx(1.0)  # mean(0,1,2)


def test_tpe_improves_over_random():
    """TPE on a smooth 1-d objective: late suggestions should cluster
    near the optimum more than the initial random ones."""
    tpe = TPESearch({"x": tune.uniform(-5, 5)}, metric="score", mode="max",
                    n_initial=8, num_samples=40, seed=0)
    xs = []
    for i in range(40):
        cfg = tpe.suggest(f"t{i}")
        if cfg is None:
            break
        x = cfg["x"]
        xs.append(x)
        tpe.on_trial_complete(f"t{i}", {"score": -(x - 2.0) ** 2})
    early = np.mean([abs(x - 2.0) for x in xs[:8]])
    late = np.mean([abs(x - 2.0) for x in xs[-8:]])
    assert late < early


def test_tpe_categorical_and_int():
    tpe = TPESearch({"c": tune.choice(["a", "b"]),
                     "n": tune.randint(0, 10)},
                    metric="score", mode="max", n_initial=4,
                    num_samples=20, seed=1)
    for i in range(20):
        cfg = tpe.suggest(f"t{i}")
        assert cfg["c"] in ("a", "b")
        assert 0 <= cfg["n"] < 10
        score = (1.0 if cfg["c"] == "b" else 0.0) + cfg["n"] * 0.1
        tpe.on_trial_complete(f"t{i}", {"score": score})
    # the good region (c=b, large n) should dominate late suggestions
    lates = [tpe._obs[i][0] for i in range(-6, 0)]
    assert sum(1 for c in lates if c["c"] == "b") >= 4


# ---------------------------------------------------------------------------
# Schedulers (cluster)
# ---------------------------------------------------------------------------

def test_hyperband_e2e(cluster, tmp_path):
    sched = HyperBandScheduler(metric="score", mode="max", max_t=9, eta=3)
    tuner = Tuner(
        _objective,
        param_space={"x": tune.grid_search([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=sched),
        run_config=RunConfig(name="hb", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 6
    best = grid.get_best_result()
    assert best.metrics["config"]["x"] == 6.0
    # successive halving must have culled some trials before iteration 9
    iters = [r.metrics.get("training_iteration", 0) for r in grid]
    assert min(iters) < 9


def test_pb2_explore_uses_bounds():
    pb2 = PB2(metric="score", mode="max", perturbation_interval=2,
              hyperparam_bounds={"lr": (0.001, 0.1)}, seed=0)
    cfg = pb2._explore({"lr": 0.05})
    assert 0.001 <= cfg["lr"] <= 0.1
    # feed observations, then explore must still respect bounds
    for i in range(8):
        pb2._gp_data.append(([0.001 + 0.01 * i], float(i)))
    cfg = pb2._explore({"lr": 0.05})
    assert 0.001 <= cfg["lr"] <= 0.1


def test_pb2_e2e(cluster, tmp_path):
    def trainable(config):
        import ray_tpu_torch.tune as t

        v = 0.0
        for i in range(1, 13):
            v += config["lr"]
            train.report({"score": v, "training_iteration": i})

    sched = PB2(metric="score", mode="max", perturbation_interval=3,
                hyperparam_bounds={"lr": (0.01, 1.0)}, seed=0)
    tuner = Tuner(
        trainable,
        param_space={"lr": tune.uniform(0.01, 1.0)},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=sched,
                               num_samples=4),
        run_config=RunConfig(name="pb2", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 4
    assert all(np.isfinite(r.metrics["score"]) for r in grid
               if "score" in r.metrics)


def test_bayesopt_search_converges():
    """GP-EI finds the optimum of a smooth 2D bowl better than its own
    random warmup (reference: tune/search/bayesopt tests)."""
    import numpy as np

    from ray_tpu_torch.tune import BayesOptSearch
    from ray_tpu_torch.tune.search import choice, uniform

    sp = {"x": uniform(-2.0, 2.0), "y": uniform(-2.0, 2.0),
          "kind": choice(["a", "b"])}
    s = BayesOptSearch(sp, metric="score", mode="max", n_initial=6,
                       num_samples=40, seed=0)

    def objective(cfg):
        bonus = 0.2 if cfg["kind"] == "a" else 0.0
        return -(cfg["x"] - 0.7) ** 2 - (cfg["y"] + 0.3) ** 2 + bonus

    scores = []
    for i in range(40):
        tid = f"t{i}"
        cfg = s.suggest(tid)
        if cfg is None:
            break
        sc = objective(cfg)
        scores.append(sc)
        s.on_trial_complete(tid, {"score": sc})
    assert len(scores) == 40
    # the modeled phase beats the random warmup phase
    assert max(scores[6:]) > max(scores[:6])
    assert max(scores) > -0.05  # near the optimum (0.2 at x=.7,y=-.3,'a')


def test_bayesopt_in_tuner(cluster):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import BayesOptSearch, TuneConfig, Tuner
    from ray_tpu_torch.tune.search import uniform

    def trainable(config):
        from ray_tpu_torch.train.session import report

        report({"loss": (config["lr"] - 0.3) ** 2})

    searcher = BayesOptSearch({"lr": uniform(0.0, 1.0)}, metric="loss",
                              mode="min", n_initial=4, num_samples=10,
                              seed=1)
    tuner = Tuner(trainable,
                  tune_config=TuneConfig(search_alg=searcher,
                                         metric="loss", mode="min"))
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.metrics["loss"] < 0.05


# ---------------------------------------------------------------------------
# Parity with the reference's searchers and schedulers (no cluster)
# ---------------------------------------------------------------------------

def _both():
    """(reference tune, port tune) modules."""
    from ray_tpu.tune import schedulers as ref_sched, search as ref_search
    from ray_tpu.tune import trial as ref_trial
    from ray_tpu_torch.tune import schedulers, search, trial

    return ((ref_search, ref_sched, ref_trial), (search, schedulers, trial))


def _space(search):
    return {"x": search.uniform(-2.0, 2.0), "n": search.randint(0, 8),
            "c": search.choice(["a", "b", "c"]),
            "g": search.grid_search([0.1, 1.0])}


def _score(cfg):
    """A deterministic objective over every key the spaces use."""
    return (-(cfg.get("x", 0.0) - 0.5) ** 2 + 0.1 * cfg.get("n", 0)
            + {"a": 0.0, "b": 0.3, "c": 0.1}.get(cfg.get("c"), 0.0)
            + cfg.get("g", 0.0))


def _drive_searcher(s, n, complete_every=1, DEFER=None):
    """suggest/complete in a fixed order; -> every suggestion in order."""
    out, live = [], []
    for i in range(n):
        cfg = s.suggest(f"t{i}")
        out.append(cfg if isinstance(cfg, dict) or cfg is None else "DEFER")
        if isinstance(cfg, dict):
            live.append((f"t{i}", cfg))
        if cfg is None:
            break
        if len(live) >= complete_every:
            tid, c = live.pop(0)
            s.on_trial_complete(tid, {"score": _score(c)})
    return out


SEARCHERS = {
    "BasicVariantGenerator": lambda se: se.BasicVariantGenerator(
        _space(se), num_samples=3, seed=7, metric="score", mode="max"),
    "ConcurrencyLimiter": lambda se: se.ConcurrencyLimiter(
        se.BasicVariantGenerator(_space(se), num_samples=3, seed=7,
                                 metric="score"), max_concurrent=2),
    "Repeater": lambda se: se.Repeater(
        se.BasicVariantGenerator(_space(se), num_samples=2, seed=3,
                                 metric="score"),
        repeat=3, metric="score"),
    "TPESearch": lambda se: se.TPESearch(
        {k: v for k, v in _space(se).items() if k != "g"}, metric="score",
        mode="max", n_initial=5, num_samples=20, seed=11),
    "BayesOptSearch": lambda se: se.BayesOptSearch(
        {"x": se.uniform(-2.0, 2.0), "c": se.choice(["a", "b"])},
        metric="score", mode="max", n_initial=4, num_samples=12, seed=5),
}


@pytest.mark.parametrize("name", sorted(SEARCHERS))
def test_searcher_matches_the_reference(name):
    """The same seed and the same reported scores: the reference's and
    the port's searcher suggest the same configs, in the same order (a
    ConcurrencyLimiter's deferrals included)."""
    (ref_se, _, _), (se, _, _) = _both()
    every = 2 if name == "ConcurrencyLimiter" else 1
    want = _drive_searcher(SEARCHERS[name](ref_se), 24, every)
    got = _drive_searcher(SEARCHERS[name](se), 24, every)
    assert len(want) > 3 and any(isinstance(c, dict) for c in want)
    assert got == want


def _metric_seq(n_trials, iters, seed):
    """Each trial's reported scores, iteration by iteration."""
    rs = np.random.RandomState(seed)
    base = rs.uniform(0.0, 1.0, n_trials)
    return [[float(base[t] + 0.05 * rs.standard_normal())
             for i in range(iters)] for t in range(n_trials)]


SCHEDULERS = {
    "AsyncHyperBandScheduler": lambda sc: sc.AsyncHyperBandScheduler(
        metric="score", mode="max", grace_period=1, reduction_factor=2,
        max_t=8),
    "HyperBandScheduler": lambda sc: sc.HyperBandScheduler(
        metric="score", mode="max", max_t=9, eta=3),
    "MedianStoppingRule": lambda sc: sc.MedianStoppingRule(
        metric="score", mode="max", grace_period=2, min_samples_required=2),
    "PopulationBasedTraining": lambda sc: sc.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [1e-4, 1e-3, 1e-2],
                              "wd": [0.0, 0.1]},
        quantile_fraction=0.34, seed=3),
}


def _drive_scheduler(sc, tr, make, n_trials=6, iters=9, seed=0):
    """Round-robin reports of ``_metric_seq`` to a scheduler; a trial
    stops reporting once told STOP or culled.  -> every decision in order,
    with what each one carries (HyperBand's culls, PBT's donors and the
    configs it explores)."""
    s = make(sc)
    trials = [tr.Trial(f"t{i}", {"lr": 1e-3, "wd": 0.1}, "/nonexistent",
                       "exp") for i in range(n_trials)]
    for t in trials:
        s.on_trial_add(t)
    seq = _metric_seq(n_trials, iters, seed)
    live = set(range(n_trials))
    out = []
    for i in range(iters):
        for k in range(n_trials):
            if k not in live:
                continue
            t = trials[k]
            d = s.on_trial_result(t, {"training_iteration": i + 1,
                                      "score": seq[k][i]})
            extra = sorted(s.trials_to_stop())
            ex = getattr(s, "pending_exploits", {}).pop(t.trial_id, None)
            if ex is not None:
                donor = trials[int(ex[0][1:])]
                ex = (ex[0], s.make_exploit_config(donor))
            out.append((t.trial_id, i + 1, d, extra, ex))
            # a paused trial resumes at its next report, as the
            # controller restarts it; a stopped or culled one is done
            for j in [k] * (d == "STOP") + [int(x[1:]) for x in extra]:
                if j in live:
                    live.discard(j)
                    s.on_trial_complete(trials[j])
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_the_reference(name):
    """The same reported metric sequences: the reference's and the
    port's scheduler make the same continue/pause/stop decisions in
    order (and PBT the same exploits from the same seed)."""
    (_, ref_sc, ref_tr), (_, sc, tr) = _both()
    want = _drive_scheduler(ref_sc, ref_tr, SCHEDULERS[name])
    got = _drive_scheduler(sc, tr, SCHEDULERS[name])
    assert {d for _, _, d, _, _ in want} - {"CONTINUE"}, want
    assert got == want
