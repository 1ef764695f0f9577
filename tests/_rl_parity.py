"""Shared helpers of the A.8b parity files (tests/test_torch_rl_*_parity.py):
the port's RL algorithms against the JAX package's on the same weights,
batches and draws.

Tolerances (those of tests/test_torch_rl_parity.py): losses and
gradients 1e-5 relative to the largest entry of each; metrics 1e-4
relative with an absolute floor of 1e-7; params after three Adam updates
1e-5 absolute.  ``jax.random`` and ``torch.Generator`` draw different
streams, so each loss that samples takes the JAX learner's draws, made
here from the key the JAX learner splits for that update, through the
port's injected-noise seam (``rl_module.draw``, ``Learner.update(batch,
rng=...)``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.rl.core import rl_module as tmod
from ray_tpu_torch.rl.core.learner import batch_to_device

ATOL = 1e-5
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def fresh_ledgers():
    """The JAX package's jitted learners feed its process-wide
    compilation ledger: leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule).  The port's learners are
    eager and must leave no advisory in the port's ledger."""
    from ray_tpu_torch.telemetry import device as tdevtel

    before = len(tdevtel.get_ledger().snapshot()["advisories"])
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()
    assert len(tdevtel.get_ledger().snapshot()["advisories"]) == before


def np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def close_rel(got, want, rel=REL, what="", floor=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale + floor, (what, err, scale)


def metric_close(got, want, what):
    close_rel(got, want, rel=1e-4, what=what, floor=1e-7)


def tree_close(got, want, atol=ATOL):
    g = tmod.tree_leaves(tmod.to_numpy_params(got))
    w = jax.tree_util.tree_leaves(np_tree(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def carry_params(jl, tl):
    """The JAX learner's params into the port learner (checked leaf by
    leaf against the port's own tree)."""
    tl.params = tmod.from_jax_params(np_tree(jl.params), like=tl.params,
                                     device="cpu")


def next_step_key(jl):
    """The key ``jl.update`` will split off for its next update."""
    return jax.random.split(jl.rng)[1]


def noise_to_torch(noise):
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def loss_and_grads_match(jl, tl, batch, jkey, tnoise=None,
                         per_head=False):
    """One loss and its gradients, JAX's with ``jkey``, the port's with
    ``tnoise`` (pre-drawn noise) or the learner's generator; the metrics
    of both.  Each gradient leaf is held relative to its own largest
    entry, or with ``per_head`` to the largest entry of its head (the
    trainable tree's top-level entry it lies in)."""
    trainable = jl._trainable(jl.params)

    def jloss(tr):
        return jl.compute_loss(jl._merge(jl.params, tr),
                               jax.tree_util.tree_map(jnp.asarray, batch),
                               jkey)

    (jv, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(trainable)
    leaves, tdef = tmod.tree_flatten(tl._trainable(tl.params))
    live = [x.detach().requires_grad_(True) for x in leaves]
    tv, tmet = tl.compute_loss(
        tl._merge(tl.params, tmod.tree_unflatten(tdef, live)),
        batch_to_device(batch, "cpu"),
        tnoise if tnoise is not None else tl.rng)
    tg = torch.autograd.grad(tv, live)
    close_rel(tv.item(), float(jv), what="loss")
    assert set(tmet) == set(jmet)
    for k in jmet:
        metric_close(tmet[k].item(), float(jmet[k]), k)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    heads = ([jax.tree_util.tree_leaves(jg[k]) for k in sorted(jg)]
             if per_head else [[x] for x in jleaves])
    i = 0
    for head in heads:
        scale = max(float(np.max(np.abs(np.asarray(x)))) for x in head)
        for b in head:
            err = float(np.max(np.abs(tg[i].numpy() - np.asarray(b))))
            assert err <= REL * max(scale, 1e-30), ("grad", i, err, scale)
            i += 1
    return float(jv), tv.item()


def updates_match(jl, tl, batches, noise_fn=None):
    """``Learner.update`` on each batch in both packages; with
    ``noise_fn(step_key, batch)`` the port's update takes the draws the
    JAX learner makes from its step key.  Metrics after each update, the
    params and Adam's first moments after the last."""
    for batch in batches:
        tnoise = None
        if noise_fn is not None:
            tnoise = noise_to_torch(noise_fn(next_step_key(jl), batch))
        jm = jl.update(batch)
        tm = tl.update(batch, rng=tnoise)
        assert set(tm) == set(jm)
        for k in jm:
            metric_close(tm[k], jm[k], k)
    tree_close(tl.params, jl.params)
    jstate = jl.opt_state[-1][0]
    mu = tl.opt_state[-1]["mu"]
    jmu = jax.tree_util.tree_leaves(jstate.mu)
    assert len(mu) == len(jmu)
    for a, b in zip(mu, jmu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert tl.opt_state[-1]["count"] == int(jstate.count) == len(batches)
