"""MARWIL and BC of the port against the JAX package's (``ray_tpu.rl.
algorithms.marwil``) on the same weights and batches, f32 on the CPU:
the advantage-weighted loss (beta 1) and behaviour cloning (beta 0),
their gradients, three updates; the reward-to-go rules of MARWIL and of
the offline data path (``rl/offline``), and the offline-data resolution
of an in-memory iterable.  Tolerances in tests/_rl_parity.py."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl.algorithms import marwil as jmarwil
from ray_tpu.rl.core import rl_module as jmod
from ray_tpu.rl.offline import offline_data as joff
from ray_tpu_torch.rl.algorithms import marwil as tmarwil
from ray_tpu_torch.rl.core import rl_module as tmod
from ray_tpu_torch.rl.offline import offline_data as toff

from _rl_parity import (carry_params, fresh_ledgers,  # noqa: F401
                        loss_and_grads_match, updates_match)

torch.set_num_threads(1)


def _learners(beta):
    jl = jmarwil.MarwilLearner(jmod.DiscretePolicyModule(4, 2, (32, 32)),
                               beta=beta, lr=2e-3, seed=0)
    tl = tmarwil.MarwilLearner(
        tmod.DiscretePolicyModule(4, 2, (32, 32), device="cpu"), beta=beta,
        lr=2e-3, seed=0)
    carry_params(jl, tl)
    return jl, tl


def _samples(n=128, seed=0, return_scale=3.0):
    """Returns of a few units and one outlier at row 0, whose advantage
    reaches the weight clip at beta 1 (beta adv / rms > 10: about 11)."""
    rng = np.random.default_rng(seed)
    ret = (return_scale * rng.normal(size=n)).astype(np.float32)
    ret[0] = 200.0
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 2, n).astype(np.int32),
            "return": ret}


def _rollout(T=9, B=4, seed=3):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
            "action": rng.integers(0, 2, (T, B)),
            "reward": rng.normal(size=(T, B)).astype(np.float32),
            "done": rng.random((T, B)) < 0.25}


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_loss_and_gradients_match_jax(beta):
    jl, tl = _learners(beta)
    jv, _ = loss_and_grads_match(jl, tl, _samples(), jax.random.PRNGKey(0))
    assert np.isfinite(jv)
    if beta:
        # the outlier's weight is the clip's exp(10)
        batch = {k: torch.from_numpy(v) for k, v in _samples().items()}
        _, met = tl.compute_loss(tl.params, batch, None)
        assert met["mean_weight"].item() >= np.exp(10.0) / 128


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_three_marwil_updates_match_jax(beta):
    jl, tl = _learners(beta)
    updates_match(jl, tl, [_samples(seed=10 + i) for i in range(3)])


def test_reward_to_go_matches_jax():
    rollout = _rollout()
    got = tmarwil.episodes_to_batch(rollout, 0.97)
    want = jmarwil.episodes_to_batch(rollout, 0.97)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for gamma in (0.97, None):
        got = toff._flatten_rollout(rollout, gamma)
        want = joff._flatten_rollout(rollout, gamma)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_resolve_in_memory_offline_data_matches_jax():
    items = [_rollout(seed=4), _samples(n=16, seed=5)]
    got = toff.resolve_offline_data(items, gamma=0.99, want_return=True)
    want = joff.resolve_offline_data(items, gamma=0.99, want_return=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    no_return = {k: v for k, v in
                 toff._flatten_rollout(_rollout(), None).items()}
    for resolve in (toff.resolve_offline_data, joff.resolve_offline_data):
        with pytest.raises(ValueError, match="return"):
            resolve([no_return], gamma=0.99, want_return=True)
