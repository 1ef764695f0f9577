"""Tune on the port's runtime: the cases of ``tests/test_tune.py`` against
``ray_tpu_torch.tune`` (reference: python/ray/tune/tests/
test_tune_controller.py, test_searchers.py, test_trial_scheduler.py), plus
what the port adds: a trial's resources as the runtime's GPU lease and the
concurrency cap with GPU trials, a ``JaxTrainer.as_trainable()`` trial at
GPT nano on two gloo CPU workers bitwise the trainer run directly with the
merged config, and the mirror of ``tests/test_rl.py::test_tune_integration``
(PPO's ``to_trainable()`` under ``Tuner``).  One cluster of the port's own
per module; no JAX program runs here."""

import json
import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train, tune
from ray_tpu_torch.train import (Checkpoint, JaxConfig, JaxTrainer, RunConfig,
                                 ScalingConfig)
from ray_tpu_torch.tune import (ASHAScheduler, MedianStoppingRule,
                                PopulationBasedTraining, TuneConfig, Tuner)
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP
from ray_tpu_torch.tune.trial import Trial

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


# ---------------------------------------------------------------------------
# Search spaces (no cluster)
# ---------------------------------------------------------------------------

def test_generate_variants_grid_and_samples():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.uniform(0, 1),
        "bs": tune.choice([16, 32]),
        "nested": {"depth": tune.randint(1, 5)},
    }
    variants = list(tune.generate_variants(space, num_samples=3, seed=0))
    assert len(variants) == 6  # 2 grid values x 3 samples
    lrs = {v["lr"] for v in variants}
    assert lrs == {0.1, 0.01}
    for v in variants:
        assert 0 <= v["wd"] <= 1
        assert v["bs"] in (16, 32)
        assert 1 <= v["nested"]["depth"] < 5


def test_loguniform_bounds():
    import random

    vals = [tune.loguniform(1e-4, 1e-1).sample(random.Random(i))
            for i in range(50)]
    assert all(1e-4 <= v <= 1e-1 for v in vals)


# ---------------------------------------------------------------------------
# Scheduler units (no cluster)
# ---------------------------------------------------------------------------

def _trial(tmp_path, i):
    return Trial(f"t{i}", {}, str(tmp_path), "exp")


def test_asha_stops_bad_trials(tmp_path):
    s = ASHAScheduler(metric="score", mode="max", grace_period=1,
                      reduction_factor=2, max_t=10)
    good, bad = _trial(tmp_path, 0), _trial(tmp_path, 1)
    assert s.on_trial_result(good, {"training_iteration": 1,
                                    "score": 0.9}) == CONTINUE
    assert s.on_trial_result(bad, {"training_iteration": 1,
                                   "score": 0.1}) == STOP


def test_asha_max_t(tmp_path):
    s = ASHAScheduler(metric="score", mode="max", max_t=5)
    t = _trial(tmp_path, 0)
    assert s.on_trial_result(t, {"training_iteration": 5,
                                 "score": 1.0}) == STOP


def test_median_stopping(tmp_path):
    s = MedianStoppingRule(metric="score", mode="max", grace_period=1,
                           min_samples_required=2)
    for i in range(3):
        t = _trial(tmp_path, i)
        s.on_trial_result(t, {"training_iteration": 1, "score": 1.0})
    loser = _trial(tmp_path, 9)
    assert s.on_trial_result(loser, {"training_iteration": 2,
                                     "score": 0.0}) == STOP


# ---------------------------------------------------------------------------
# End-to-end experiments (the module's cluster)
# ---------------------------------------------------------------------------

def _objective(config):
    for i in range(3):
        tune.report({"score": config["x"] * (i + 1)})


def test_tuner_random_search(cluster, tmp_path):
    tuner = Tuner(
        _objective,
        param_space={"x": tune.grid_search([1.0, 3.0, 2.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="rs", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 3
    best = grid.get_best_result()
    assert best.metrics["score"] == 9.0
    assert best.metrics["config"]["x"] == 3.0
    state = json.load(open(tmp_path / "rs" / "experiment_state.json"))
    assert len(state["trials"]) == 3
    assert all(t["status"] == "TERMINATED" for t in state["trials"])
    t0 = state["trials"][0]["trial_id"]
    lines = open(tmp_path / "rs" / t0 / "result.json").read().splitlines()
    assert len(lines) == 3


def test_tuner_stop_criteria(cluster, tmp_path):
    grid = tune.run(_objective, config={"x": tune.grid_search([1.0])},
                    metric="score", mode="max",
                    storage_path=str(tmp_path), name="stopc",
                    stop={"training_iteration": 2})
    assert grid[0].metrics["training_iteration"] == 2


def _failing(config):
    if config["x"] == 2.0:
        raise RuntimeError("bad config")
    tune.report({"score": config["x"]})


def test_tuner_trial_error_isolated(cluster, tmp_path):
    tuner = Tuner(
        _failing, param_space={"x": tune.grid_search([1.0, 2.0, 3.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="err", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid.errors) == 1
    assert grid.get_best_result().metrics["score"] == 3.0


def _ckpt_objective(config):
    import tempfile

    restored = tune.get_checkpoint()
    start = 0
    if restored:
        with restored.as_directory() as d:
            start = int(open(os.path.join(d, "it.txt")).read()) + 1
    for i in range(start, 4):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "it.txt"), "w") as f:
                f.write(str(i))
            tune.report({"score": config["x"] * (i + 1), "it": i},
                        checkpoint=Checkpoint(d))


def test_tuner_checkpoints(cluster, tmp_path):
    tuner = Tuner(
        _ckpt_objective, param_space={"x": tune.grid_search([2.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="ck", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    r = grid[0]
    assert r.checkpoint is not None
    with r.checkpoint.as_directory() as d:
        assert open(os.path.join(d, "it.txt")).read() == "3"


def test_tuner_restore_skips_finished(cluster, tmp_path):
    run_config = RunConfig(name="resume", storage_path=str(tmp_path))
    tuner = Tuner(_objective, param_space={"x": tune.grid_search([1.0, 2.0])},
                  tune_config=TuneConfig(metric="score", mode="max"),
                  run_config=run_config)
    grid = tuner.fit()
    assert len(grid) == 2
    restored = Tuner.restore(str(tmp_path / "resume"), _objective,
                             tune_config=TuneConfig(metric="score",
                                                    mode="max"))
    grid2 = restored.fit()
    assert len(grid2) == 2
    assert grid2.get_best_result().metrics["score"] == 6.0


def test_tuner_asha_e2e(cluster, tmp_path):
    def obj(config):
        for i in range(6):
            tune.report({"score": config["x"] + i * 0.01})

    tuner = Tuner(
        obj, param_space={"x": tune.grid_search([10.0, 10.1, 0.0, 0.1])},
        tune_config=TuneConfig(
            metric="score", mode="max", max_concurrent_trials=1,
            scheduler=ASHAScheduler(grace_period=2, reduction_factor=2,
                                    max_t=6)),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 4
    assert grid.get_best_result().metrics["score"] >= 10.0
    iters = [r.metrics.get("training_iteration", 0) for r in grid._results]
    assert min(iters) < 6


def _train_loop_for_tune(config):
    ctx = train.get_context()
    for i in range(config["steps"]):
        train.report({"loss": 1.0 / (config["lr"] * (i + 1)),
                      "ws": ctx.get_world_size()})


def test_trainer_on_tune(cluster, tmp_path):
    trainer = train.JaxTrainer(
        _train_loop_for_tune, train_loop_config={"steps": 2},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="tt", storage_path=str(tmp_path)),
    )
    tuner = Tuner(
        trainer, param_space={"lr": tune.grid_search([0.1, 1.0])},
        tune_config=TuneConfig(metric="loss", mode="min",
                               max_concurrent_trials=1),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    best = grid.get_best_result()
    assert best.metrics["config"]["lr"] == 1.0
    assert best.metrics["ws"] == 2


def test_pbt_e2e(cluster, tmp_path):
    def obj(config):
        import tempfile

        restored = tune.get_checkpoint()
        score, start = 0.0, 0
        if restored:
            with restored.as_directory() as d:
                vals = open(os.path.join(d, "s.txt")).read().split()
                score, start = float(vals[0]), int(vals[1]) + 1
        for i in range(start, 8):
            score += config["delta"]
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "s.txt"), "w") as f:
                    f.write(f"{score} {i}")
                tune.report({"score": score}, checkpoint=Checkpoint(d))

    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"delta": [0.1, 1.0, 2.0]}, seed=0)
    tuner = Tuner(
        obj, param_space={"delta": tune.grid_search([0.1, 2.0])},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=pbt),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    assert not grid.errors
    assert grid.get_best_result().metrics["score"] >= 8 * 2.0 - 4.0


# ---------------------------------------------------------------------------
# Beyond the mirror: GPU trials' resources
# ---------------------------------------------------------------------------

def _opts_of(controller, trial_dir):
    """The runner actor's options ``_start_trial`` asks the runtime for,
    and the resource dict the runtime builds from them (what the raylet
    leases)."""
    from ray_tpu_torch._private.api import _build_resources

    seen = []

    class Runner:
        def options(self, **opts):
            seen.append(opts)
            return self

        def remote(self):
            return self

        class start:
            @staticmethod
            def remote(*a):
                return object()

    controller._runner_cls = Runner()
    trial = Trial("t0", {}, trial_dir, "exp")
    controller._start_trial(trial)
    opts = seen[-1]
    return opts, _build_resources(opts.get("num_cpus"), opts.get("num_gpus"),
                                  opts.get("resources"))


def test_trial_resources_reach_the_raylet_as_a_gpu_lease(tmp_path):
    """A plain trainable's extra resources go to the runner actor as
    ``resources=`` (``tune_controller.py``'s ``_start_trial``): a ``GPU``
    entry there is the same lease ``num_gpus`` asks for.  A trainer
    adapter's trial holds nothing itself: its gang asks for the cards."""
    from ray_tpu_torch.tune.search import BasicVariantGenerator
    from ray_tpu_torch.tune.tune_controller import TuneController

    def plain(config):
        tune.report({"x": 1})

    c = TuneController(plain, searcher=BasicVariantGenerator({}),
                       experiment_dir=str(tmp_path), experiment_name="exp",
                       trial_resources={"CPU": 1, "GPU": 0.5})
    opts, lease = _opts_of(c, str(tmp_path))
    assert opts["resources"] == {"GPU": 0.5}
    assert lease == {"CPU": 1.0, "GPU": 0.5}

    trainer = JaxTrainer(_train_loop_for_tune, train_loop_config={},
                         scaling_config=ScalingConfig(
                             num_workers=1, use_gpu=True,
                             gpus_per_worker=0.5))
    c = TuneController(trainer.as_trainable(),
                       searcher=BasicVariantGenerator({}),
                       experiment_dir=str(tmp_path), experiment_name="exp",
                       trial_resources={"CPU": 1, "GPU": 0.5})
    opts, lease = _opts_of(c, str(tmp_path))
    assert "resources" not in opts and lease == {}
    assert trainer.as_trainable()._scaling_config.gpus_per_worker == 0.5


@pytest.mark.parametrize("kind", ["plain", "adapter"])
def test_cpu_cap_lets_two_gpu_trials_run(tmp_path, monkeypatch, kind):
    """The unlimited concurrency cap divides the cluster's CPUs by a
    trial's: on a host with one CPU and one card, two GPU trials (0.5 of
    the card each) still start together."""
    from ray_tpu_torch.tune import tune_controller as tc
    from ray_tpu_torch.tune.search import BasicVariantGenerator

    monkeypatch.setattr(tc.ray_tpu_torch, "cluster_resources",
                        lambda: {"CPU": 1.0, "GPU": 1.0})
    trainable = _objective
    if kind == "adapter":
        trainable = JaxTrainer(
            _train_loop_for_tune, train_loop_config={},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                         gpus_per_worker=0.5)).as_trainable()
    c = tc.TuneController(trainable, searcher=BasicVariantGenerator({}),
                          experiment_dir=str(tmp_path),
                          experiment_name="exp",
                          trial_resources={"CPU": 1, "GPU": 0.5})
    assert c._effective_max_concurrent() >= 2


# ---------------------------------------------------------------------------
# Beyond the mirror: a trainer as a trial, bitwise the trainer
# ---------------------------------------------------------------------------

NANO_STEPS = 3
NANO_BATCH = (2, 32)


def _nano_trial_loop(config):
    """GPT nano, f32, AdamW at ``config["lr"]`` on the CPU, each step on
    the rank's seeded batch; grads averaged over the gang's gloo group; rank 0 saves
    the losses and the final params."""
    import numpy as np
    import torch

    from ray_tpu_torch import collective
    from ray_tpu_torch.models import gpt, training

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]
    cfg = gpt.GPTConfig.nano(dtype=torch.float32)
    init_state, _ = training.make_train_step(
        cfg, tx=training.adamw(config["lr"], weight_decay=0.1),
        device="cpu")
    state = init_state(seed=0)
    leaves = [t for _, t in training.param_leaves(state["params"])]
    opt = state["opt_state"]
    B, S = NANO_BATCH
    tokens = np.random.RandomState(100 + rank).randint(
        0, cfg.vocab_size, (B, S + 1))
    losses = []
    for step in range(config["steps"]):
        opt.zero_grad(set_to_none=True)
        loss = gpt.loss_fn(state["params"], {"tokens": tokens}, cfg,
                           device="cpu")
        loss.backward()
        flat = torch.cat([t.grad.reshape(-1) for t in leaves])
        mean = collective.allreduce(flat, group, op="mean")
        off = 0
        for t in leaves:
            t.grad = mean[off:off + t.numel()].view_as(t).clone()
            off += t.numel()
        opt.step()
        losses.append(float(loss.detach()))
        train.report({"loss": losses[-1], "step": step + 1})
    if rank == 0:
        np.savez(config["out"], losses=np.array(losses),
                 **{k: t.detach().numpy() for k, t in
                    training.param_leaves(state["params"])})


def _nano_trainer(config, name, storage):
    return JaxTrainer(
        _nano_trial_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="spmd"),
        run_config=RunConfig(name=name, storage_path=storage))


def test_trainer_as_trial_is_bitwise_the_trainer(cluster, tmp_path):
    """A ``Tuner`` over ``JaxTrainer.as_trainable()`` (GPT nano, two gloo
    CPU workers): the trial's reported losses and its final params are
    bitwise those of the same trainer run directly with the config the
    trial merged (``test_trainer_equals_the_same_steps_in_process`` holds
    the trainer itself to the same steps in process)."""
    base = {"steps": NANO_STEPS, "lr": 1e-3,
            "out": str(tmp_path / "unused.npz")}
    trial_out = str(tmp_path / "trial.npz")
    trainer = _nano_trainer(base, "nano-tune", str(tmp_path))
    grid = Tuner(trainer,
                 param_space={"lr": tune.grid_search([3e-3]),
                              "out": tune.grid_search([trial_out])},
                 tune_config=TuneConfig(metric="loss", mode="min")).fit()
    assert not grid.errors, grid.errors
    assert len(grid) == 1
    trial = grid[0]
    assert trial.metrics["config"] == {"lr": 3e-3, "out": trial_out}

    direct_out = str(tmp_path / "direct.npz")
    result = _nano_trainer({**base, "lr": 3e-3, "out": direct_out},
                           "nano-direct", str(tmp_path)).fit()
    assert result.error is None, result.error
    got, want = dict(np.load(trial_out)), dict(np.load(direct_out))
    assert set(got) == set(want) and len(want) > 1
    np.testing.assert_array_equal(got["losses"], want["losses"])
    assert trial.metrics["loss"] == want["losses"][-1]
    assert result.metrics["loss"] == want["losses"][-1]
    for k in sorted(want):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the trial trained: its loss fell on the same batch
    assert want["losses"][-1] < want["losses"][0]


# ---------------------------------------------------------------------------
# Beyond the mirror: tests/test_rl.py::test_tune_integration
# ---------------------------------------------------------------------------

def test_tune_integration(cluster):
    from ray_tpu_torch.rl import PPOConfig

    trainable = (PPOConfig().environment("CartPole-v1")
                 .env_runners(0, num_envs_per_runner=4)
                 .training(rollout_len=16, num_epochs=1, minibatch_size=64)
                 .resources(device="cpu")
                 .to_trainable())
    tuner = Tuner(
        trainable,
        param_space={"lr": 1e-3, "training_iterations": 2},
        tune_config=TuneConfig(metric="episode_return_mean", mode="max",
                               num_samples=2),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    assert not grid.errors
    best = grid.get_best_result()
    assert best.metrics["training_iteration"] == 2

