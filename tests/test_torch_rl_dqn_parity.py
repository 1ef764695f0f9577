"""DQN and the replay buffer of the port against the JAX package's
(``ray_tpu.rl.algorithms.dqn``, ``ray_tpu.rl.utils.replay_buffer``) on the
same weights and batches, f32 on the CPU.  Tolerances in
tests/_rl_parity.py."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl.algorithms import dqn as jdqn
from ray_tpu.rl.core import rl_module as jmod
from ray_tpu.rl.utils.replay_buffer import ReplayBuffer as JBuffer
from ray_tpu_torch.rl.algorithms import dqn as tdqn
from ray_tpu_torch.rl.core import rl_module as tmod
from ray_tpu_torch.rl.utils.replay_buffer import ReplayBuffer as TBuffer

from _rl_parity import (carry_params, close_rel, fresh_ledgers,  # noqa: F401
                        loss_and_grads_match, updates_match)

torch.set_num_threads(1)


def _transitions(n=64, obs_dim=4, num_actions=2, seed=0, reward_scale=1.0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "action": rng.integers(0, num_actions, n).astype(np.int32),
            "reward": (reward_scale * rng.normal(size=n)).astype(np.float32),
            "done": rng.random(n) < 0.2}


def _learners(target_update_freq=2, hidden=(32, 32)):
    jl = jdqn.DQNLearner(jmod.QModule(4, 2, hidden), gamma=0.99,
                         target_update_freq=target_update_freq, lr=1e-3,
                         grad_clip=10.0, seed=0)
    tl = tdqn.DQNLearner(tmod.QModule(4, 2, hidden, device="cpu"),
                         gamma=0.99, target_update_freq=target_update_freq,
                         lr=1e-3, grad_clip=10.0, seed=0)
    # a target net away from the online one, so double DQN's two nets
    # differ
    rng = np.random.default_rng(1)
    jl.params = dict(jl.params, target_q=jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.normal(size=x.shape).astype(np.float32),
        jl.params["q"]))
    carry_params(jl, tl)
    return jl, tl


def test_replay_buffer_samples_as_jax():
    """The same seed, adds past the capacity, the same samples."""
    jb, tb = JBuffer(50, seed=3), TBuffer(50, seed=3)
    for i in range(4):
        batch = _transitions(n=20, seed=i)
        jb.add_batch(batch)
        tb.add_batch(batch)
        assert len(jb) == len(tb)
    for _ in range(3):
        js, ts = jb.sample(16), tb.sample(16)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])


def test_huber_matches_jax():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    close_rel(tdqn.optax_huber(torch.from_numpy(x)).numpy(),
              np.asarray(jdqn.optax_huber(x)), what="huber")


@pytest.mark.parametrize("reward_scale", [1.0, 5.0])
def test_dqn_loss_and_gradients_match_jax(reward_scale):
    """Huber's quadratic and linear pieces: rewards of scale 5 put most
    TD errors past delta = 1."""
    jl, tl = _learners()
    loss_and_grads_match(jl, tl, _transitions(reward_scale=reward_scale),
                         jax.random.PRNGKey(0))


def test_three_dqn_updates_match_jax():
    """Three updates with a hard target sync after the second."""
    jl, tl = _learners(target_update_freq=2)
    target0 = tmod.to_numpy_params(tl.params["target_q"])
    updates_match(jl, tl, [_transitions(seed=10 + i, reward_scale=3.0)
                           for i in range(3)])
    assert tl._updates == 3
    assert not np.array_equal(
        tmod.to_numpy_params(tl.params["target_q"])[0]["w"],
        target0[0]["w"])
