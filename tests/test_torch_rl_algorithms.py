"""The wider algorithm family on the port: the V-trace and IMPALA cases
of tests/test_rl_algorithms.py and the APPO case of
tests/test_rl_algorithms2.py (reference: rllib/algorithms/{impala,appo}/
tests/), every entry point with ``device="cpu"``.  SAC, BC/MARWIL, CQL
and DreamerV3 are ROADMAP A.8b: their names raise ImportError.
Tolerances as in the reference's files."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl import (APPOConfig, BCConfig, ImpalaConfig,
                              MARWILConfig, PPOConfig, SACConfig)

torch.set_num_threads(1)


def test_vtrace_reduces_to_gae_targets_on_policy():
    """With behavior == target policy (rho == 1) and c-bar = rho-bar = 1,
    V-trace vs equals n-step TD(lambda=1)-style returns; compare against a
    naive python recursion."""
    from ray_tpu_torch.rl.algorithms.impala import vtrace

    rng = np.random.RandomState(0)
    T, B, gamma = 6, 3, 0.9
    rewards = rng.randn(T, B).astype(np.float32)
    dones = (rng.rand(T, B) < 0.2)
    values = rng.randn(T, B).astype(np.float32)
    final_v = rng.randn(B).astype(np.float32)
    logp = rng.randn(T, B).astype(np.float32)

    t = torch.from_numpy
    vs, pg_adv = vtrace(t(logp), t(logp), t(rewards), t(dones), t(values),
                        t(final_v), gamma)

    # naive recursion (rho = c = 1): vs_t - v_t = delta_t + g*nt*carry
    vs_ref = np.zeros_like(values)
    carry = np.zeros(B, np.float32)
    next_v = final_v.copy()
    for s in range(T - 1, -1, -1):
        nt = 1.0 - dones[s].astype(np.float32)
        delta = rewards[s] + gamma * next_v * nt - values[s]
        carry = delta + gamma * nt * carry
        vs_ref[s] = carry + values[s]
        next_v = values[s]
    np.testing.assert_allclose(vs.numpy(), vs_ref, rtol=1e-4, atol=1e-4)
    assert pg_adv.shape == (T, B)
    assert not vs.requires_grad and not pg_adv.requires_grad


def test_impala_learns_cartpole_local():
    cfg = (ImpalaConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=16)
           .training(rollout_len=128, entropy_coeff=0.01, lr=5e-3)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        first = algo.train()
        last = None
        for _ in range(11):
            last = algo.train()
        assert np.isfinite(last["loss"])
        assert last["episode_return_mean"] > max(
            30.0, first.get("episode_return_mean", 0.0) * 0.8)
    finally:
        algo.stop()


def test_appo_learns_cartpole_local():
    cfg = (APPOConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=16)
           .training(rollout_len=128, entropy_coeff=0.01, lr=5e-3,
                     target_update_freq=2)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        first = algo.train()
        last = None
        for _ in range(11):
            last = algo.train()
        assert np.isfinite(last["loss"])
        assert last["kl"] >= 0.0
        # target net exists and tracks the policy shape
        w = algo.learner_group.get_weights()
        assert "target_pi" in w
        assert last["episode_return_mean"] > max(
            25.0, first.get("episode_return_mean", 0.0) * 0.7)
    finally:
        algo.stop()


def test_appo_target_is_frozen_between_copies():
    """APPO's target_pi takes no gradient and has no optimizer state; it
    moves only by extra_update's copy every target_update_freq updates."""
    from ray_tpu_torch.rl.algorithms.appo import APPOLearner
    from ray_tpu_torch.rl.core.rl_module import DiscretePolicyModule

    learner = APPOLearner(DiscretePolicyModule(4, 2, (8,), device="cpu"),
                          target_update_freq=2, seed=0)
    assert len(learner.opt_state[-1]["mu"]) == 8     # pi + vf leaves only
    rng = np.random.default_rng(0)
    batch = {"obs": rng.normal(size=(3, 5, 4)).astype(np.float32),
             "action": rng.integers(0, 2, (3, 5)),
             "reward": np.ones((3, 5), np.float32),
             "done": np.zeros((3, 5), bool),
             "logp": np.full((3, 5), np.log(0.5), np.float32),
             "final_vf": np.zeros(3, np.float32)}
    t0 = learner.params["target_pi"][0]["w"].clone()
    learner.update(batch)
    assert torch.equal(learner.params["target_pi"][0]["w"], t0)
    assert not torch.equal(learner.params["pi"][0]["w"], t0)
    learner.update(batch)
    assert torch.equal(learner.params["target_pi"][0]["w"],
                       learner.params["pi"][0]["w"])


def test_sac_continuous_learns_pendulum():
    """Continuous-action SAC (SquashedGaussian + reparameterized twin-Q,
    reference: rllib/algorithms/sac/sac.py:320-322) demonstrably LEARNS
    its canonical domain: Pendulum swing-up from ~-1350 (random) to
    >= -300 mean episode return (the conventional solved band is
    >= -200; -300 keeps the test fast and flake-proof)."""
    cfg = (SACConfig().environment("Pendulum-v1")
           .env_runners(0, num_envs_per_runner=8)
           .training(rollout_len=64, learn_starts=1000,
                     updates_per_iter=48, train_batch_size=256, lr=1e-3)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        best = -np.inf
        for _ in range(220):
            r = algo.train()
            if "episode_return_mean" in r:
                best = max(best, r["episode_return_mean"])
            if best >= -300.0:
                break
        assert best >= -300.0, best
        w = algo.learner_group.get_weights()
        assert {"pi", "q1", "q2", "target_q1", "target_q2",
                "log_alpha"} <= set(w)
    finally:
        algo.stop()


def test_sac_smoke_local():
    cfg = (SACConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=8)
           .training(rollout_len=32, learn_starts=128, updates_per_iter=8,
                     train_batch_size=64)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        r = None
        for _ in range(6):
            r = algo.train()
        assert np.isfinite(r["loss"])
        assert r["alpha"] > 0
        w = algo.learner_group.get_weights()
        assert {"pi", "q1", "q2", "target_q1", "target_q2",
                "log_alpha"} <= set(w)
    finally:
        algo.stop()


def test_marwil_offline_learns_from_expert():
    """Train PPO briefly to get decent rollouts, then MARWIL-clone them
    offline and check the cloned policy beats random."""
    ppo = (PPOConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=16)
           .training(rollout_len=128, num_epochs=4, minibatch_size=512,
                     entropy_coeff=0.01)
           .resources(device="cpu")).build()
    try:
        for _ in range(8):
            ppo.train()
        expert_batches = []
        for _ in range(3):
            results = ppo.runners.sample(128)
            if not isinstance(results, list):
                results = [results]
            for r in results:
                expert_batches.append(r["batch"])
    finally:
        ppo.stop()

    cfg = (MARWILConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=4)
           .training(num_epochs=3, minibatch_size=512, lr=2e-3)
           .offline(expert_batches)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        m = None
        for _ in range(3):
            m = algo.train()
        assert np.isfinite(m["loss"])
        # evaluate the cloned policy: sample with the trained weights
        algo.runners.sync_weights(algo.learner_group.get_weights())
        results = algo.runners.sample(200)
        if not isinstance(results, list):
            results = [results]
        stats = algo._merge_runner_results(results)[1]
        assert stats["episode_return_mean"] > 25.0  # random is ~20
    finally:
        algo.stop()


def test_bc_is_marwil_beta_zero():
    cfg = BCConfig()
    assert cfg.beta == 0.0
    cfg.environment("CartPole-v1").env_runners(0, num_envs_per_runner=4)
    cfg.resources(device="cpu")
    algo = cfg.build()
    try:
        m = algo.train()  # BC smoke mode: clones own rollouts
        assert np.isfinite(m["loss"])
        assert m["mean_weight"] == pytest.approx(1.0)
    finally:
        algo.stop()
