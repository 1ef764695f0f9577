"""DreamerV3 of the port against the JAX package's (``ray_tpu.rl.
algorithms.dreamerv3``) on the same weights, batches and draws, f32 on
the CPU: symlog/symexp, the GRU (gate order r, u, c and the ``[wx | wh]``
layout, so weights cross with ``from_jax_params``), the straight-through
categorical, the loss with its observe and imagine loops, KL balancing
and lambda-returns, its gradients, and three updates.  Every categorical
draw of the JAX learner (``argmax(gumbel(key, logits.shape) + logits)``)
is made here from the key it splits and fed to the port through
``rl_module.draw``.  Tolerances in tests/_rl_parity.py, but for one: each
gradient leaf is held to 1e-5 of the largest entry of its head (encoder,
GRU, actor, ...), not of the leaf itself.  The actor's output bias has a
gradient that is a sum of (one-hot - softmax) terms over the dream, two
entries of opposite sign ~400x smaller than the actor's others (8.6e-5
against 3.3e-2 here): its f32 error, 9e-9, is 1e-4 of itself and 3e-7 of
the head."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.rl.algorithms import dreamerv3 as jdr
from ray_tpu_torch.rl.algorithms import dreamerv3 as tdr
from ray_tpu_torch.rl.core import rl_module as tmod

from _rl_parity import (carry_params, close_rel, fresh_ledgers,  # noqa: F401
                        loss_and_grads_match, noise_to_torch, np_tree,
                        updates_match)

torch.set_num_threads(1)

OBS, ACTIONS, HIDDEN, DETER, CLASSES, HORIZON = 4, 2, (16, 16), 8, 4, 4
B, T = 3, 6


def _learners():
    kw = dict(gamma=0.99, lam=0.95, horizon=HORIZON, lr=3e-4, seed=0)
    jl = jdr.DreamerLearner(jdr.DreamerModule(OBS, ACTIONS, HIDDEN,
                                              deter=DETER, classes=CLASSES),
                            **kw)
    tl = tdr.DreamerLearner(tdr.DreamerModule(OBS, ACTIONS, HIDDEN,
                                              deter=DETER, classes=CLASSES,
                                              device="cpu"), **kw)
    carry_params(jl, tl)
    return jl, tl


def _batch(seed=0):
    """[B, T] sequences, as DreamerV3.training_step hands the learner."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(B, T, OBS)).astype(np.float32),
            "action": rng.integers(0, ACTIONS, (B, T)).astype(np.int32),
            "reward": rng.uniform(0, 2, (B, T)).astype(np.float32),
            "done": rng.random((B, T)) < 0.2}


def _draws(key, batch):
    """The JAX loss's Gumbel draws from its key: ``obs_rng, img_rng =
    split(key)``; observe splits obs_rng into T keys, imagine img_rng into
    H keys, each split again into the action's and the latent's."""
    obs_rng, img_rng = jax.random.split(key)
    n = B * T
    observe = [jax.random.gumbel(k, (B, CLASSES))
               for k in jax.random.split(obs_rng, T)]
    act, lat = [], []
    for k in jax.random.split(img_rng, HORIZON):
        a_rng, z_rng = jax.random.split(k)
        act.append(jax.random.gumbel(a_rng, (n, ACTIONS)))
        lat.append(jax.random.gumbel(z_rng, (n, CLASSES)))
    return {"observe": jnp.stack(observe), "imagine_action": jnp.stack(act),
            "imagine_latent": jnp.stack(lat)}


def test_symlog_symexp_match_jax():
    x = np.linspace(-50, 50, 201).astype(np.float32)
    close_rel(tdr.symlog(torch.from_numpy(x)).numpy(),
              np.asarray(jdr.symlog(x)), what="symlog")
    y = np.linspace(-4, 4, 81).astype(np.float32)
    close_rel(tdr.symexp(torch.from_numpy(y)).numpy(),
              np.asarray(jdr.symexp(y)), what="symexp")
    close_rel(tdr.symexp(tdr.symlog(torch.from_numpy(x))).numpy(), x,
              what="inverse")


def test_gru_matches_jax_on_its_layout():
    jp = jdr._gru_init(jax.random.PRNGKey(1), 6, DETER)
    tp = tmod.from_jax_params(np_tree(jp),
                              like=tdr._gru_init(tmod.make_generator(0, "cpu"),
                                                 6, DETER), device="cpu")
    rng = np.random.default_rng(2)
    h = rng.normal(size=(5, DETER)).astype(np.float32)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    close_rel(tdr._gru(tp, torch.from_numpy(h), torch.from_numpy(x)).numpy(),
              np.asarray(jdr._gru(jp, h, x)), what="gru")


def test_straight_through_categorical_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(64, CLASSES)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jdr._st_categorical(key, jnp.asarray(logits)))
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape)))
    live = torch.from_numpy(logits).requires_grad_(True)
    got = tdr._st_categorical(None, live, noise)
    close_rel(got.detach().numpy(), want, what="sample")
    # one-hot forward, softmax's gradient backward
    np.testing.assert_allclose(got.detach().sum(-1).numpy(), 1.0, atol=1e-6)
    w = rng.normal(size=got.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda lg: jnp.sum(jdr._st_categorical(key, lg) * w))(
        jnp.asarray(logits))
    close_rel(live.grad.numpy(), np.asarray(jg), what="st grad")


def test_exploration_matches_jax_with_its_draw():
    jl, tl = _learners()
    obs = np.random.default_rng(5).normal(size=(32, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ja, jex = jl.module.forward_exploration(jl.params, jnp.asarray(obs), key)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (32, ACTIONS))))
    ta, tex = tl.module.forward_exploration(tl.params, torch.from_numpy(obs),
                                            None, noise)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    close_rel(tex["logp"].numpy(), np.asarray(jex["logp"]), what="logp")
    close_rel(tex["vf"].numpy(), np.asarray(jex["vf"]), what="vf")


def test_dreamer_loss_and_gradients_match_jax():
    jl, tl = _learners()
    batch = _batch()
    key = jax.random.PRNGKey(7)
    loss_and_grads_match(jl, tl, batch, key,
                         noise_to_torch(_draws(key, batch)), per_head=True)


def test_three_dreamer_updates_match_jax():
    jl, tl = _learners()
    updates_match(jl, tl, [_batch(seed=10 + i) for i in range(3)],
                  noise_fn=_draws)


def test_dreamer_update_is_deterministic_from_its_seed():
    """Without injected draws the learner samples from its own
    generator: two learners from one seed make bit-identical updates."""
    _, a = _learners()
    _, b = _learners()
    for seed in (20, 21):
        assert a.update(_batch(seed)) == b.update(_batch(seed))
    for x, y in zip(tmod.tree_leaves(tmod.to_numpy_params(a.params)),
                    tmod.tree_leaves(tmod.to_numpy_params(b.params))):
        assert x.tobytes() == y.tobytes()
