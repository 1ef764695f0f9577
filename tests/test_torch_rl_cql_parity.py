"""CQL of the port against the JAX package's (``ray_tpu.rl.algorithms.
cql``) on the same weights and batches, f32 on the CPU: the loss with its
conservative term, its gradients, three updates with the Polyak target
step, and the rollout-to-transitions rule.  Tolerances in
tests/_rl_parity.py."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl.algorithms import cql as jcql
from ray_tpu.rl.core import rl_module as jmod
from ray_tpu_torch.rl.algorithms import cql as tcql
from ray_tpu_torch.rl.core import rl_module as tmod

from _rl_parity import (carry_params, fresh_ledgers,  # noqa: F401
                        loss_and_grads_match, updates_match)

torch.set_num_threads(1)


def _learners(cql_alpha=1.0):
    jl = jcql.CQLLearner(jmod.QModule(4, 3, (32, 32)), cql_alpha=cql_alpha,
                         tau=0.05, seed=0)
    tl = tcql.CQLLearner(tmod.QModule(4, 3, (32, 32), device="cpu"),
                         cql_alpha=cql_alpha, tau=0.05, seed=0)
    rng = np.random.default_rng(1)
    # Q values of O(1) with a spread over actions, so the logsumexp and
    # the double-DQN argmax both matter; a target net of its own
    jl.params = jax.tree_util.tree_map(
        lambda x: x + 0.2 * rng.normal(size=x.shape).astype(np.float32),
        jl.params)
    carry_params(jl, tl)
    return jl, tl


def _transitions(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "done": rng.random(n) < 0.2}


@pytest.mark.parametrize("cql_alpha", [1.0, 5.0])
def test_cql_loss_and_gradients_match_jax(cql_alpha):
    jl, tl = _learners(cql_alpha)
    loss_and_grads_match(jl, tl, _transitions(), jax.random.PRNGKey(0))


def test_three_cql_updates_match_jax():
    jl, tl = _learners()
    updates_match(jl, tl, [_transitions(seed=10 + i) for i in range(3)])


def test_transitions_from_rollout_match_jax():
    rng = np.random.default_rng(2)
    rollout = {"obs": rng.normal(size=(7, 3, 4)).astype(np.float32),
               "action": rng.integers(0, 2, (7, 3)),
               "reward": rng.normal(size=(7, 3)),
               "done": rng.random((7, 3)) < 0.3}
    got = tcql.transitions_from_rollout(rollout)
    want = jcql.transitions_from_rollout(rollout)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
