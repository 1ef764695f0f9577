"""SAC of the port against the JAX package's (``ray_tpu.rl.algorithms.
sac``), discrete and continuous, on the same weights, batches and draws,
f32 on the CPU.  The continuous loss samples twice (the next state's
action, the policy's reparameterised action): the port takes the JAX
learner's standard-normal draws through ``rl_module.draw``; discrete
exploration takes JAX's Gumbel draw.  Tolerances in tests/_rl_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.rl.algorithms import sac as jsac
from ray_tpu_torch.rl.algorithms import sac as tsac
from ray_tpu_torch.rl.core import rl_module as tmod

from _rl_parity import (carry_params, close_rel, fresh_ledgers,  # noqa: F401
                        loss_and_grads_match, np_tree, noise_to_torch,
                        updates_match)

torch.set_num_threads(1)

OBS, ACTIONS, HIDDEN = 3, 2, (32, 32)


def _perturb_targets(jl, scale=0.05, seed=1):
    rng = np.random.default_rng(seed)
    bump = lambda x: x + scale * rng.normal(  # noqa: E731
        size=x.shape).astype(np.float32)
    jl.params = dict(jl.params,
                     target_q1=jax.tree_util.tree_map(bump, jl.params["q1"]),
                     target_q2=jax.tree_util.tree_map(bump, jl.params["q2"]),
                     log_alpha=jnp.asarray(-0.3, jnp.float32))


def _discrete():
    jl = jsac.SACLearner(jsac.SACModule(4, 3, HIDDEN), lr=3e-4, seed=0)
    tl = tsac.SACLearner(tsac.SACModule(4, 3, HIDDEN, device="cpu"),
                         lr=3e-4, seed=0)
    _perturb_targets(jl)
    carry_params(jl, tl)
    return jl, tl


def _continuous():
    jl = jsac.SACContinuousLearner(
        jsac.SACContinuousModule(OBS, ACTIONS, HIDDEN, low=-2.0, high=2.0),
        lr=1e-3, seed=0)
    tl = tsac.SACContinuousLearner(
        tsac.SACContinuousModule(OBS, ACTIONS, HIDDEN, low=-2.0, high=2.0,
                                 device="cpu"), lr=1e-3, seed=0)
    _perturb_targets(jl)
    carry_params(jl, tl)
    return jl, tl


def _discrete_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "done": rng.random(n) < 0.2}


def _continuous_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, OBS)).astype(np.float32),
            "next_obs": rng.normal(size=(n, OBS)).astype(np.float32),
            "action": rng.uniform(-2, 2, (n, ACTIONS)).astype(np.float32),
            "reward": rng.normal(size=n).astype(np.float32),
            "done": rng.random(n) < 0.2}


def _continuous_draws(key, batch):
    """The JAX continuous loss's two draws from its key
    (``next_rng, pi_rng = split(rng)``; ``normal(rng, mu.shape)``)."""
    next_rng, pi_rng = jax.random.split(key)
    shape = (batch["obs"].shape[0], ACTIONS)
    return {"next": jax.random.normal(next_rng, shape),
            "pi": jax.random.normal(pi_rng, shape)}


def test_discrete_exploration_takes_jax_categorical_with_its_draw():
    jm = jsac.SACModule(4, 3, HIDDEN)
    tm = tsac.SACModule(4, 3, HIDDEN, device="cpu")
    jp = jm.init(jax.random.PRNGKey(2))
    tp = tmod.from_jax_params(np_tree(jp), like=tm.init(0), device="cpu")
    obs = np.random.default_rng(3).normal(size=(256, 4)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ja, _ = jm.forward_exploration(jp, jnp.asarray(obs), key)
    gumbel = jax.random.gumbel(key, (256, 3))
    ta, _ = tm.forward_exploration(tp, torch.from_numpy(obs), None,
                                   noise=torch.from_numpy(np.array(gumbel)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert len(np.unique(np.asarray(ja))) == 3


def test_squashed_gaussian_sample_matches_jax_with_its_draw():
    jm = jsac.SACContinuousModule(OBS, ACTIONS, HIDDEN, low=[-2.0, -1.0],
                                  high=[2.0, 3.0])
    tm = tsac.SACContinuousModule(OBS, ACTIONS, HIDDEN, low=[-2.0, -1.0],
                                  high=[2.0, 3.0], device="cpu")
    jp = jm.init(jax.random.PRNGKey(5))
    tp = tmod.from_jax_params(np_tree(jp), like=tm.init(0), device="cpu")
    obs = np.random.default_rng(6).normal(size=(128, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ja, jlogp = jm.sample_and_logp(jp, jnp.asarray(obs), key)
    normal = torch.from_numpy(np.array(jax.random.normal(key, (128, 2))))
    ta, tlogp = tm.sample_and_logp(tp, torch.from_numpy(obs), None, normal)
    close_rel(ta.numpy(), np.asarray(ja), what="action")
    close_rel(tlogp.numpy(), np.asarray(jlogp), what="logp")
    close_rel(tm.forward_inference(tp, torch.from_numpy(obs)).numpy(),
              np.asarray(jm.forward_inference(jp, jnp.asarray(obs))),
              what="inference")
    a = ta.numpy()
    assert (a[:, 0] >= -2).all() and (a[:, 0] <= 2).all()
    assert (a[:, 1] >= -1).all() and (a[:, 1] <= 3).all()


def test_module_registry_dispatches_on_the_action_space():
    cont = tmod.module_for_env({"obs_dim": 3, "action_dim": 1,
                                "action_low": -2.0, "action_high": 2.0},
                               "sac", hidden=(8,), device="cpu")
    disc = tmod.module_for_env({"obs_dim": 4, "num_actions": 2}, "sac",
                               hidden=(8,), device="cpu")
    assert isinstance(cont, tsac.SACContinuousModule)
    assert isinstance(disc, tsac.SACModule)
    assert tmod.MODULE_REGISTRY["sac"] is tsac.SACModule
    assert tmod.MODULE_REGISTRY["sac_continuous"] is tsac.SACContinuousModule


def test_discrete_sac_loss_and_gradients_match_jax():
    jl, tl = _discrete()
    loss_and_grads_match(jl, tl, _discrete_batch(), jax.random.PRNGKey(0))


def test_continuous_sac_loss_and_gradients_match_jax():
    jl, tl = _continuous()
    batch = _continuous_batch()
    key = jax.random.PRNGKey(9)
    loss_and_grads_match(jl, tl, batch, key,
                         noise_to_torch(_continuous_draws(key, batch)))


def test_three_discrete_sac_updates_match_jax():
    """Three updates, each followed by the Polyak target step."""
    jl, tl = _discrete()
    updates_match(jl, tl, [_discrete_batch(seed=10 + i) for i in range(3)])


def test_three_continuous_sac_updates_match_jax():
    """Three updates on the JAX learner's draws of each update's key."""
    jl, tl = _continuous()
    updates_match(jl, tl, [_continuous_batch(seed=20 + i)
                           for i in range(3)], noise_fn=_continuous_draws)


def test_continuous_draws_are_the_generators_by_default():
    """Without injected noise the loss draws from the learner's own
    generator: two learners from one seed make the same update."""
    _, a = _continuous()
    _, b = _continuous()
    batch = _continuous_batch(seed=30)
    ma, mb = a.update(batch), b.update(batch)
    assert ma == mb
    assert tmod.tree_leaves(tmod.to_numpy_params(a.params))[0].tobytes() == \
        tmod.tree_leaves(tmod.to_numpy_params(b.params))[0].tobytes()
