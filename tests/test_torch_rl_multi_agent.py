"""Multi-agent RL on the port (reference: rllib/env/multi_agent_env.py:32,
rllib/core/rl_module/multi_rl_module.py, AlgorithmConfig.multi_agent):
the cases of tests/test_rl_multi_agent.py on the port's own cluster,
every entry point with ``device="cpu"``."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import rl
from ray_tpu_torch.rl.env.multi_agent_env import (CooperativeMatchEnv,
                                                  MultiAgentEnvRunner)


@pytest.fixture(scope="module")
def ray_cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _mapping(agent_id: str) -> str:
    return f"policy_{agent_id[-1]}"


def test_env_protocol():
    env = CooperativeMatchEnv(num_agents=2, num_targets=3, episode_len=4)
    obs = env.reset(seed=0)
    assert set(obs) == {"agent_0", "agent_1"}
    assert obs["agent_0"].shape == (3,)
    obs, rew, term, trunc, _ = env.step({"agent_0": 0, "agent_1": 1})
    assert set(rew) == {"agent_0", "agent_1"}
    assert "__all__" in term
    for _ in range(3):
        obs, rew, term, trunc, _ = env.step({"agent_0": 0, "agent_1": 1})
    assert term["__all__"]


def test_multi_agent_runner_per_policy_batches():
    runner = MultiAgentEnvRunner(
        "coop_match", policies=["policy_0", "policy_1"],
        policy_mapping_fn=_mapping, module_spec={"hidden": (16,)},
        num_envs=3, seed=0, device="cpu")
    out = runner.sample(5)
    batches = out["batches"]
    assert set(batches) == {"policy_0", "policy_1"}
    b = batches["policy_0"]
    # [T, B_envs * agents_of_policy, ...]
    assert b["obs"].shape == (5, 3, 4)
    assert b["action"].shape == (5, 3)
    assert b["reward"].shape == (5, 3)
    assert b["logp"].shape == (5, 3)
    assert b["final_vf"].shape == (3,)
    # cooperative reward is SHARED: both policies see identical rewards
    np.testing.assert_array_equal(batches["policy_0"]["reward"],
                                  batches["policy_1"]["reward"])
    # observations are private: distinct per policy (different targets)
    assert not np.array_equal(batches["policy_0"]["obs"],
                              batches["policy_1"]["obs"])


def test_multi_agent_ppo_trains_two_policies(ray_cluster):
    cfg = (rl.MultiAgentPPOConfig()
           .environment("coop_match")
           .env_runners(0, num_envs_per_runner=8)
           .multi_agent(policies=["policy_0", "policy_1"],
                        policy_mapping_fn=_mapping)
           .training(rollout_len=32, num_epochs=4, minibatch_size=64,
                     lr=5e-3, entropy_coeff=0.01)
           .debugging(seed=1)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        first = algo.train()
        # distinct per-policy losses reported
        assert "policy_0/loss" in first and "policy_1/loss" in first
        assert first["policy_0/loss"] != first["policy_1/loss"]
        for _ in range(14):
            result = algo.train()
        # each agent can read its target off its own one-hot obs: a
        # trained pair should collect most of the max 8 reward/episode
        assert result.get("episode_return_mean", 0.0) > 4.0, result
        # weights diverged per policy
        w = algo._weights()
        p0 = w["policy_0"]["pi"][0]["w"]
        p1 = w["policy_1"]["pi"][0]["w"]
        assert not np.allclose(np.asarray(p0), np.asarray(p1))
    finally:
        algo.stop()


def test_multi_agent_ppo_remote_runners(ray_cluster):
    cfg = (rl.MultiAgentPPOConfig()
           .environment("coop_match")
           .env_runners(2, num_envs_per_runner=2)
           .multi_agent(policies=["policy_0", "policy_1"],
                        policy_mapping_fn=_mapping)
           .training(rollout_len=8, num_epochs=1, minibatch_size=32)
           .debugging(seed=0)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        result = algo.train()
        assert result["env_steps_sampled"] == 2 * 2 * 8
        assert "policy_0/loss" in result
    finally:
        algo.stop()


def test_shared_policy_mapping():
    """Several agents may share ONE policy (parameter sharing)."""
    runner = MultiAgentEnvRunner(
        "coop_match", policies=["shared"],
        policy_mapping_fn=lambda a: "shared",
        module_spec={"hidden": (16,)}, num_envs=2, seed=0, device="cpu")
    out = runner.sample(3)
    b = out["batches"]["shared"]
    # both agents' transitions pool into the one policy: B = envs*agents
    assert b["obs"].shape == (3, 4, 4)
