"""The port's RL (``ray_tpu_torch.rl``) against the JAX package's
(``ray_tpu.rl``) on the same inputs.

``jax.random`` and ``torch.Generator`` draw different streams, so sampled
actions and reset states cannot match: every case feeds both packages
the same states, actions, batches and weights, made from seeded numpy
(weights carried across with ``rl_module.from_jax_params``).  All f32 on
the CPU.  Tolerances: env dynamics, the MLP, V-trace and GAE 1e-5
absolute (XLA's and torch's sin/cos/exp/log differ in the last ulp);
losses and gradients 1e-5 relative to the largest entry of each,
metrics 1e-4 relative with an absolute floor of 1e-7 (a metric such as
APPO's KL is a mean of differences of O(1) log-probs, each good to an
f32 ulp, 6e-8); params after Adam updates 1e-5 absolute (three Adam steps of lr
3e-4 move a weight by at most ~1e-3, so this holds the updates to 1%);
``params_digest`` of the same params exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl.algorithms import appo as jappo
from ray_tpu.rl.algorithms import impala as jimpala
from ray_tpu.rl.algorithms import ppo as jppo
from ray_tpu.rl.core import rl_module as jmod
from ray_tpu.rl.env import jax_env as jenv
from ray_tpu.rl import podracer as jpod
from ray_tpu_torch.rl.algorithms import appo as tappo
from ray_tpu_torch.rl.algorithms import impala as timpala
from ray_tpu_torch.rl.algorithms import ppo as tppo
from ray_tpu_torch.rl.core import rl_module as tmod
from ray_tpu_torch.rl.env import jax_env as tenv
from ray_tpu_torch.rl import podracer as tpod

torch.set_num_threads(1)

ATOL = 1e-5
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX package's jitted RL programs go through its process-wide
    compilation ledger; leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule)."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _close_rel(got, want, rel=REL, what="", floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale + floor, (what, err, scale)


def _metric_close(got, want, what):
    _close_rel(got, want, rel=1e-4, what=what, floor=1e-7)


def _tree_close(got, want, atol=ATOL):
    g = tmod.tree_leaves(tmod.to_numpy_params(got))
    w = jax.tree_util.tree_leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# environments
# ---------------------------------------------------------------------------


def _cartpole_states(n, rng):
    x = rng.uniform(-2.5, 2.5, n).astype(np.float32)
    x_dot = rng.uniform(-2, 2, n).astype(np.float32)
    theta = rng.uniform(-0.25, 0.25, n).astype(np.float32)
    theta_dot = rng.uniform(-2, 2, n).astype(np.float32)
    t = rng.integers(0, 500, n).astype(np.int32)
    t[:3] = 499                             # truncation
    return x, x_dot, theta, theta_dot, t


def test_cartpole_step_matches_jax():
    rng = np.random.default_rng(0)
    n = 64
    x, x_dot, theta, theta_dot, t = _cartpole_states(n, rng)
    actions = rng.integers(0, 2, n).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    js = jenv.CartPoleState(jnp.asarray(x), jnp.asarray(x_dot),
                            jnp.asarray(theta), jnp.asarray(theta_dot),
                            jnp.asarray(t), keys)
    _, jobs, jrew, jdone = jax.vmap(jenv.CartPole().step)(
        js, jnp.asarray(actions))
    ts = tenv.CartPoleState(*(torch.from_numpy(a) for a in
                              (x, x_dot, theta, theta_dot, t)),
                            tmod.make_generator(0, "cpu"))
    _, tobs, trew, tdone = tenv.CartPole().step(ts, torch.from_numpy(actions))
    jdone = np.asarray(jdone)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    assert 0 < jdone.sum() < n
    live = ~jdone
    np.testing.assert_allclose(tobs.numpy()[live], np.asarray(jobs)[live],
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    # a done env's next observation is its reset observation
    assert np.all(np.abs(tobs.numpy()[jdone]) <= 0.05)


def test_pendulum_step_matches_jax():
    rng = np.random.default_rng(1)
    n = 64
    th = rng.uniform(-6, 6, n).astype(np.float32)
    thdot = rng.uniform(-8, 8, n).astype(np.float32)
    t = rng.integers(0, 200, n).astype(np.int32)
    t[:3] = 199
    u = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    js = jenv.PendulumState(jnp.asarray(th), jnp.asarray(thdot),
                            jnp.asarray(t), keys)
    _, jobs, jrew, jdone = jax.vmap(jenv.Pendulum().step)(js, jnp.asarray(u))
    ts = tenv.PendulumState(torch.from_numpy(th), torch.from_numpy(thdot),
                            torch.from_numpy(t),
                            tmod.make_generator(1, "cpu"))
    _, tobs, trew, tdone = tenv.Pendulum().step(ts, torch.from_numpy(u))
    jdone = np.asarray(jdone)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    live = ~jdone
    np.testing.assert_allclose(tobs.numpy()[live], np.asarray(jobs)[live],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-6,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


def _modules(obs_dim=4, num_actions=2, hidden=(32, 32), seed=0):
    jm = jmod.DiscretePolicyModule(obs_dim, num_actions, hidden)
    tm = tmod.DiscretePolicyModule(obs_dim, num_actions, hidden,
                                   device="cpu")
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = tmod.from_jax_params(_np(jp), like=tm.init(0), device="cpu")
    return jm, tm, jp, tp


def test_mlp_logits_values_logp_match_jax():
    jm, tm, jp, tp = _modules()
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(16, 4)).astype(np.float32)
    act = rng.integers(0, 2, 16)
    np.testing.assert_allclose(tm.logits(tp, torch.from_numpy(obs)).numpy(),
                               np.asarray(jm.logits(jp, obs)), atol=ATOL)
    np.testing.assert_allclose(tm.value(tp, torch.from_numpy(obs)).numpy(),
                               np.asarray(jm.value(jp, obs)), atol=ATOL)
    jl = jax.nn.log_softmax(jm.logits(jp, obs))
    jlogp = np.take_along_axis(np.asarray(jl), act[:, None], -1)[:, 0]
    tl = torch.log_softmax(tm.logits(tp, torch.from_numpy(obs)), -1)
    tlogp = tmod.take_action_logp(tl, torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(tlogp, jlogp, atol=ATOL)
    # the port's sampled actions carry their own log-prob
    a, ex = tm.forward_exploration(tp, torch.from_numpy(obs),
                                   tmod.make_generator(0, "cpu"))
    np.testing.assert_allclose(
        ex["logp"].numpy(),
        np.take_along_axis(np.asarray(jl), a.numpy()[:, None], -1)[:, 0],
        atol=ATOL)


def test_from_jax_params_rejects_a_wrong_tree():
    jm, tm, jp, _ = _modules()
    like = tm.init(0)
    tree = _np(jp)
    bad = {"pi": tree["pi"]}
    with pytest.raises(ValueError, match="missing"):
        tmod.from_jax_params(bad, like=like, device="cpu")
    extra = dict(tree, target_pi=tree["pi"])
    with pytest.raises(ValueError, match="extra"):
        tmod.from_jax_params(extra, like=like, device="cpu")
    short = dict(tree, vf=tree["vf"][:-1])
    with pytest.raises(ValueError, match="entries"):
        tmod.from_jax_params(short, like=like, device="cpu")
    shaped = {"pi": [dict(p) for p in tree["pi"]], "vf": tree["vf"]}
    shaped["pi"][0]["w"] = shaped["pi"][0]["w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        tmod.from_jax_params(shaped, like=like, device="cpu")
    back = tmod.to_numpy_params(tmod.from_jax_params(tree, like=like,
                                                     device="cpu"))
    for a, b in zip(tmod.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_params_digest_of_converted_params_equals_jax():
    _, tm, jp, tp = _modules(hidden=(16, 8))
    appo_like = dict(jp, target_pi=jp["pi"])
    assert tpod.params_digest(tp) == jpod.params_digest(jp)
    assert tpod.params_digest(tmod.to_numpy_params(tp)) == \
        jpod.params_digest(jp)
    tp_appo = tmod.from_jax_params(_np(appo_like), device="cpu")
    assert tpod.params_digest(tp_appo) == jpod.params_digest(appo_like)


# ---------------------------------------------------------------------------
# V-trace, GAE
# ---------------------------------------------------------------------------


def _tb_arrays(T=9, B=5, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        dones=rng.random((T, B)) < 0.2,
        values=rng.normal(size=(T, B)).astype(np.float32),
        final=rng.normal(size=(B,)).astype(np.float32),
        blogp=(-rng.random((T, B)) * 2).astype(np.float32),
        tlogp=(-rng.random((T, B)) * 2).astype(np.float32))


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_jax(clip):
    a = _tb_arrays()
    jvs, jadv = jimpala.vtrace(
        jnp.asarray(a["blogp"]), jnp.asarray(a["tlogp"]),
        jnp.asarray(a["rewards"]), jnp.asarray(a["dones"]),
        jnp.asarray(a["values"]), jnp.asarray(a["final"]), 0.95, *clip)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tvs, tadv = timpala.vtrace(t["blogp"], t["tlogp"], t["rewards"],
                               t["dones"], t["values"], t["final"], 0.95,
                               *clip)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=ATOL)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=ATOL)


def test_compute_gae_matches_jax():
    a = _tb_arrays(seed=4)
    jadv, jtarg = jppo.compute_gae(
        jnp.asarray(a["rewards"]), jnp.asarray(a["dones"]),
        jnp.asarray(a["values"]), jnp.asarray(a["final"]), 0.97, 0.9)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tadv, ttarg = tppo.compute_gae(t["rewards"], t["dones"], t["values"],
                                   t["final"], 0.97, 0.9)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=ATOL)
    np.testing.assert_allclose(ttarg.numpy(), np.asarray(jtarg), atol=ATOL)


# ---------------------------------------------------------------------------
# losses, gradients, updates
# ---------------------------------------------------------------------------


def _seq_batch(B=6, T=10, obs_dim=4, seed=5, reward_scale=1.0):
    """A [B, T] batch as IMPALA/APPO consume it."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(B, T, obs_dim)).astype(np.float32),
        "action": rng.integers(0, 2, (B, T)).astype(np.int32),
        "reward": (rng.normal(size=(B, T)) * reward_scale).astype(np.float32),
        "done": rng.random((B, T)) < 0.1,
        "logp": np.log(rng.uniform(0.2, 0.8, (B, T))).astype(np.float32),
        "final_vf": rng.normal(size=(B,)).astype(np.float32),
    }


def _flat_batch(n=64, obs_dim=4, seed=6):
    """A flat minibatch as PPOLearner consumes it."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "action": rng.integers(0, 2, n).astype(np.int32),
        "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "advantage": rng.normal(size=n).astype(np.float32),
        "value_target": rng.normal(size=n).astype(np.float32),
    }


def _learners(kind, grad_clip=0.5, hidden=(32, 32)):
    jm = jmod.DiscretePolicyModule(4, 2, hidden)
    tm = tmod.DiscretePolicyModule(4, 2, hidden, device="cpu")
    kw = dict(grad_clip=grad_clip, seed=0)
    if kind == "impala":
        jl = jimpala.ImpalaLearner(jm, **kw)
        tl = timpala.ImpalaLearner(tm, **kw)
    elif kind == "ppo":
        jl = jppo.PPOLearner(jm, entropy_coeff=0.01, **kw)
        tl = tppo.PPOLearner(tm, entropy_coeff=0.01, **kw)
    else:
        jl = jappo.APPOLearner(jm, target_update_freq=2, **kw)
        tl = tappo.APPOLearner(tm, target_update_freq=2, **kw)
    tl.params = tmod.from_jax_params(_np(jl.params), like=tl.params,
                                     device="cpu")
    return jl, tl


def _batch_for(kind, **kw):
    return _flat_batch(**kw) if kind == "ppo" else _seq_batch(**kw)


@pytest.mark.parametrize("kind", ["impala", "ppo", "appo"])
def test_loss_and_gradients_match_jax(kind):
    jl, tl = _learners(kind)
    if kind == "appo":
        # a target net away from the learner's, so the KL term is live
        rng = np.random.default_rng(7)
        jl.params = dict(jl.params, target_pi=jax.tree_util.tree_map(
            lambda x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32),
            jl.params["pi"]))
        tl.params = tmod.from_jax_params(_np(jl.params), like=tl.params,
                                         device="cpu")
    batch = _batch_for(kind)
    trainable = jl._trainable(jl.params)

    def jloss(tr):
        return jl.compute_loss(jl._merge(jl.params, tr),
                               jax.tree_util.tree_map(jnp.asarray, batch),
                               jax.random.PRNGKey(0))

    (jv, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(trainable)
    from ray_tpu_torch.rl.core.learner import batch_to_device

    leaves, tdef = tmod.tree_flatten(tl._trainable(tl.params))
    live = [x.detach().requires_grad_(True) for x in leaves]
    tv, tmet = tl.compute_loss(tl._merge(tl.params,
                                         tmod.tree_unflatten(tdef, live)),
                               batch_to_device(batch, "cpu"), tl.rng)
    tg = torch.autograd.grad(tv, live)
    _close_rel(tv.item(), float(jv), what="loss")
    assert set(tmet) == set(jmet)
    for k in jmet:
        _metric_close(tmet[k].item(), float(jmet[k]), k)
    for a, b in zip(tg, jax.tree_util.tree_leaves(jg)):
        _close_rel(a.numpy(), np.asarray(b), what="grad")


@pytest.mark.parametrize("kind,grad_clip,clipped", [
    ("impala", 0.5, True), ("impala", 1e6, False), ("appo", 0.5, True)])
def test_three_learner_updates_match_jax(kind, grad_clip, clipped):
    """Three ``Learner.update`` calls from the same params on the same
    batches: optax's clip rule (scale by max_norm / norm only at or past
    the bound) and optax's Adam."""
    jl, tl = _learners(kind, grad_clip=grad_clip)
    for i in range(3):
        batch = _seq_batch(seed=10 + i, reward_scale=5.0)
        jm = jl.update(batch)
        tm = tl.update(batch)
        assert (jm["grad_norm"] >= grad_clip) == clipped
        for k in jm:
            _metric_close(tm[k], jm[k], k)
    _tree_close(tl.params, jl.params)
    jstate = jl.opt_state[-1][0] if grad_clip is not None else None
    mu = tl.opt_state[-1]["mu"]
    for a, b in zip(mu, jax.tree_util.tree_leaves(jstate.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert tl.opt_state[-1]["count"] == int(jstate.count) == 3


def test_ppo_update_on_batch_matches_jax():
    """The whole PPO update: GAE, numpy advantage normalisation, and the
    minibatch permutation from the same numpy seed."""
    from ray_tpu.rl.core.learner import LearnerGroup as JGroup
    from ray_tpu_torch.rl.core.learner import LearnerGroup as TGroup

    jl, tl = _learners("ppo")
    jg = JGroup(lambda: jl)
    tg = TGroup(lambda: tl)
    rng = np.random.default_rng(8)
    T, B = 16, 8
    batch = {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
             "action": rng.integers(0, 2, (T, B)).astype(np.int32),
             "reward": np.ones((T, B), np.float32),
             "done": rng.random((T, B)) < 0.1,
             "logp": np.log(rng.uniform(0.3, 0.7, (T, B))).astype(
                 np.float32),
             "vf": rng.normal(size=(T, B)).astype(np.float32),
             "final_vf": rng.normal(size=(B,)).astype(np.float32)}
    cfg = tppo.PPOConfig().training(num_epochs=2, minibatch_size=32)
    jm = jppo.ppo_update_on_batch(jg, batch, cfg, np.random.default_rng(3))
    tm = tppo.ppo_update_on_batch(tg, batch, cfg, np.random.default_rng(3))
    assert tl.opt_state[-1]["count"] == 8
    for k in jm:
        _metric_close(tm[k], jm[k], k)
    _tree_close(tl.params, jl.params)


def test_anakin_updates_match_jax_update_fn():
    """A few Anakin updates: the port's device rollouts, each batch fed
    through the JAX package's jitted ``_update_fn`` from the same initial
    params; params and losses track the port's."""
    hidden = (16,)
    env = tenv.make_env("CartPole-v1")
    tl = timpala.make_impala_learner(env.spec, hidden=hidden, device="cpu",
                                     seed=0)
    jl = jimpala.make_impala_learner(env.spec, hidden=hidden, seed=0)
    tl.params = tmod.from_jax_params(_np(jl.params), like=tl.params,
                                     device="cpu")
    carry = tenv.init_carry(env, 1, 8, "cpu")
    tp, topt = tl.params, tl.opt_state
    jp, jopt = jl.params, jl.opt_state
    for _ in range(4):
        carry, batch = tenv.rollout(env, tl.module.forward_exploration, tp,
                                    carry, 8)
        upd = {k: batch[k].transpose(0, 1)
               for k in ("obs", "action", "reward", "done", "logp")}
        upd["final_vf"] = tl.module.value(tp, carry[1]).detach()
        tp, topt, tmet = tl._update_fn(tp, topt, upd, tl.rng)
        jupd = {k: jnp.asarray(v.numpy()) for k, v in upd.items()}
        jp, jopt, jmet = jl._update_fn(jp, jopt, jupd,
                                       jax.random.PRNGKey(0))
        _metric_close(tmet["loss"].item(), float(jmet["loss"]), "loss")
    _tree_close(tp, jp)
