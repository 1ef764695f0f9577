"""RL library tests of the port (ray_tpu_torch.rl): the cases of
tests/test_rl.py (reference: rllib test strategy — unit tests per
component + short learning regressions on CartPole) on the port's own
cluster, every entry point with ``device="cpu"``.  Tune's case waits
for ROADMAP A.10.  Tolerances as in the reference's file."""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rl import (CartPole, DQNConfig, PPOConfig, ReplayBuffer,
                              make_env)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ray_cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_jax_cartpole_matches_gymnasium():
    """Dynamics parity with the reference env family: identical physics
    constants -> identical trajectories given identical start states."""
    import gymnasium as gym

    genv = gym.make("CartPole-v1").unwrapped
    jenv = CartPole()
    state, obs = jenv.reset(0, 1, device="cpu")
    genv.reset(seed=0)
    genv.state = np.asarray(obs[0].numpy(), np.float64)

    actions = [0, 1, 1, 0, 1, 0, 0, 1, 1, 1]
    for a in actions:
        state, obs, reward, done = jenv.step(state, torch.tensor([a]))
        gobs, greward, gterm, gtrunc, _ = genv.step(a)
        if done[0] or gterm:
            break
        np.testing.assert_allclose(obs[0].numpy(), gobs, rtol=1e-4,
                                   atol=1e-5)
        assert float(reward[0]) == greward == 1.0


def test_rollout_shapes_and_autoreset():
    from ray_tpu_torch.rl.env.env_runner import JaxEnvRunner

    runner = JaxEnvRunner("CartPole-v1", {"kind": "policy"}, num_envs=4,
                          seed=0, device="cpu")
    out = runner.sample(50)
    batch = out["batch"]
    assert batch["obs"].shape == (50, 4, 4)
    assert batch["action"].shape == (50, 4)
    assert batch["logp"].shape == (50, 4)
    assert batch["final_vf"].shape == (4,)
    # with a random policy 200 env steps must finish some episodes
    out2 = runner.sample(50)
    total_eps = (out["stats"]["episodes_this_iter"]
                 + out2["stats"]["episodes_this_iter"])
    assert total_eps > 0


def test_gae_matches_naive():
    from ray_tpu_torch.rl.algorithms.ppo import compute_gae

    T, B = 6, 2
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    dones = (rng.random((T, B)) < 0.2)
    values = rng.normal(size=(T, B)).astype(np.float32)
    final_v = rng.normal(size=(B,)).astype(np.float32)
    gamma, lam = 0.95, 0.9

    adv, vtarg = compute_gae(torch.from_numpy(rewards),
                             torch.from_numpy(dones),
                             torch.from_numpy(values),
                             torch.from_numpy(final_v), gamma, lam)

    # naive reference implementation
    expected = np.zeros((T, B), np.float32)
    for b in range(B):
        next_adv, next_val = 0.0, final_v[b]
        for t in reversed(range(T)):
            nonterm = 1.0 - float(dones[t, b])
            delta = rewards[t, b] + gamma * next_val * nonterm - values[t, b]
            next_adv = delta + gamma * lam * nonterm * next_adv
            next_val = values[t, b]
            expected[t, b] = next_adv
    np.testing.assert_allclose(adv.numpy(), expected, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vtarg.numpy(), expected + values,
                               rtol=1e-4, atol=1e-5)


def test_replay_buffer_ring():
    buf = ReplayBuffer(capacity=10)
    buf.add_batch({"x": np.arange(6, dtype=np.float32)})
    assert len(buf) == 6
    buf.add_batch({"x": np.arange(6, 14, dtype=np.float32)})
    assert len(buf) == 10  # wrapped
    s = buf.sample(32)
    assert s["x"].shape == (32,)
    # oldest entries (0..3) were overwritten
    assert s["x"].min() >= 4


def test_ppo_learns_cartpole_local():
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=16)
           .training(rollout_len=128, num_epochs=4, minibatch_size=512,
                     entropy_coeff=0.01)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        first = algo.train()
        last = None
        for _ in range(11):
            last = algo.train()
        assert last["episode_return_mean"] > max(
            40.0, first.get("episode_return_mean", 0.0))
        assert last["env_steps_sampled"] == 12 * 128 * 16
    finally:
        algo.stop()


def test_dqn_smoke_local():
    from ray_tpu_torch.telemetry import device as devtel

    storms = len(devtel.get_ledger().storm_advisories())
    cfg = (DQNConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=8)
           .training(rollout_len=32, learn_starts=256, updates_per_iter=8,
                     epsilon_decay_iters=5)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        for _ in range(6):
            r = algo.train()
        assert r["buffer_size"] > 256
        assert np.isfinite(r["loss"])
        assert r["epsilon"] == pytest.approx(0.05)
        # target net must differ from online net between syncs or match
        # after one: just check both exist
        w = algo.learner_group.get_weights()
        assert "q" in w and "target_q" in w
    finally:
        algo.stop()
    # a new epsilon each train() compiles nothing: no storm advisory
    assert len(devtel.get_ledger().storm_advisories()) == storms


def test_ppo_distributed_runners(ray_cluster):
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(2, num_envs_per_runner=4)
           .training(rollout_len=32, num_epochs=2, minibatch_size=128)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        r = algo.train()
        # 2 runners x 4 envs x 32 steps
        assert r["env_steps_sampled"] == 256
        r = algo.train()
        assert r["training_iteration"] == 2
    finally:
        algo.stop()


def test_ppo_remote_learners_average_weights(ray_cluster):
    """Two learner actors: each takes its shard, the group averages their
    weights on the host, so both hold the same params after an update."""
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=4)
           .learners(2)
           .training(rollout_len=16, num_epochs=1, minibatch_size=64)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        r = algo.train()
        assert np.isfinite(r["loss"])
        w = [rt.get(a.get_weights.remote(), timeout=60)
             for a in algo.learner_group.actors]
        for a, b in zip(w[0]["pi"] + w[0]["vf"], w[1]["pi"] + w[1]["vf"]):
            np.testing.assert_array_equal(a["w"], b["w"])
    finally:
        algo.stop()


def test_algorithm_save_restore(tmp_path):
    from ray_tpu_torch.rl.core.rl_module import to_numpy_params, tree_leaves

    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=4)
           .training(rollout_len=16, num_epochs=1, minibatch_size=64)
           .resources(device="cpu"))
    algo = cfg.build()
    algo.train()
    path = str(tmp_path / "ckpt.pkl")
    algo.save(path)
    w0 = to_numpy_params(algo.learner_group.get_weights())
    algo.stop()

    algo2 = cfg.build()
    algo2.restore(path)
    assert algo2.iteration == 1
    w1 = to_numpy_params(algo2.learner_group.get_weights())
    for a, b in zip(tree_leaves(w0), tree_leaves(w1)):
        np.testing.assert_array_equal(a, b)
    # the optimizer state came back too: the next update is the one the
    # saved algorithm would have made
    assert algo2.learner_group.learner.opt_state[-1]["count"] == \
        algo.learner_group.learner.opt_state[-1]["count"]
    algo2.stop()


def test_to_trainable_reports_each_iteration(monkeypatch):
    """``to_trainable`` reports every train() result through the port's
    ``train.session.report`` (the Tune run itself waits for A.10)."""
    from ray_tpu_torch.train import session

    seen = []
    monkeypatch.setattr(session, "report",
                        lambda metrics, **kw: seen.append(metrics))
    trainable = (PPOConfig().environment("CartPole-v1")
                 .env_runners(0, num_envs_per_runner=4)
                 .training(rollout_len=16, num_epochs=1, minibatch_size=64)
                 .resources(device="cpu")
                 .to_trainable())
    trainable({"lr": 1e-3, "training_iterations": 2})
    assert [m["training_iteration"] for m in seen] == [1, 2]


def test_make_env_and_entry_points_need_a_device():
    assert make_env("CartPole-v1").spec["num_actions"] == 2
    with pytest.raises(KeyError):
        make_env("nope")
    if not torch.cuda.is_available():
        from ray_tpu_torch.rl.env.env_runner import JaxEnvRunner

        with pytest.raises(RuntimeError, match="CUDA"):
            JaxEnvRunner("CartPole-v1", {"kind": "policy"}, num_envs=2)
