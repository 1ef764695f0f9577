"""CQL and DreamerV3 on the port: the cases of
tests/test_rl_algorithms2.py (reference: rllib/algorithms/{cql,
dreamerv3}/tests/; its APPO case is in tests/test_torch_rl_algorithms.py),
every entry point with ``device="cpu"``.  Configurations and thresholds
as in the reference's file; the seeds are the configs' default 0, so each
run here is deterministic."""

import numpy as np
import torch

from ray_tpu_torch.rl import CQLConfig, DreamerV3Config, PPOConfig

torch.set_num_threads(1)


def _collect_rollouts(n_iters=4):
    """Sample rollouts with a PPO policy to act as 'logged' data."""
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=8)
           .training(rollout_len=64)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        rollouts = []
        for _ in range(n_iters):
            results = algo.runners.sample(64)
            batch, _ = algo._merge_runner_results(results)
            rollouts.append({k: np.asarray(v) for k, v in batch.items()})
        return rollouts
    finally:
        algo.stop()


def test_cql_offline_training():
    data = _collect_rollouts()
    cfg = (CQLConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=2)
           .training(cql_alpha=1.0, num_epochs=2)
           .offline(data)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        r = None
        for _ in range(3):
            r = algo.train()
        assert np.isfinite(r["loss"])
        # the conservative gap must be penalized: logsumexp Q >= Q(a_data)
        assert r["cql_loss"] >= 0.0
        # dataset actions should not be pushed far below the max
        assert r["mean_q_max"] >= r["mean_q_data"] - 1e-3
    finally:
        algo.stop()


def test_cql_conservative_term_pushes_down_ood_q():
    """With a large cql_alpha, out-of-distribution Q values drop below
    dataset-action Q values after training."""
    data = _collect_rollouts(2)
    cfg = (CQLConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=2)
           .training(cql_alpha=5.0, num_epochs=4)
           .offline(data)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        before = algo.train()
        after = None
        for _ in range(4):
            after = algo.train()
        # the gap (logsumexp - data q) shrinks as OOD actions are pushed down
        assert after["cql_loss"] <= before["cql_loss"] + 1e-3
    finally:
        algo.stop()


def test_dreamerv3_smoke_local():
    cfg = (DreamerV3Config().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=4)
           .training(rollout_len=32, horizon=5, deter=32, classes=8,
                     hidden=(32, 32))
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        r = None
        for _ in range(3):
            r = algo.train()
        for key in ("wm_loss", "recon_loss", "kl", "actor_loss",
                    "critic_loss", "dream_return"):
            assert np.isfinite(r[key]), (key, r)
        # world-model reconstruction improves with training
        r2 = None
        for _ in range(5):
            r2 = algo.train()
        assert r2["recon_loss"] < r["recon_loss"] * 1.5
    finally:
        algo.stop()
