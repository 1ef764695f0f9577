"""The port's SPMD pipeline (GPipe over the mesh's ``pp`` axis) against
the JAX package's, on gloo ranks.

The JAX package's ``make_train_step(cfg, mesh)`` runs GPT nano (f32,
remat "full") on a four-device CPU mesh at {pp: 2, dp: 2} and {pp: 4},
and the rope/rms/swiglu recipe at {pp: 2, dp: 2}; the port's runs on a
module-scoped pool of four spawned gloo ranks (tests/_gloo_pool.py; they
import no JAX) from the same weights (``models/convert.py``) on the same
batches, placed by ``shard_batch``.  Three SGD steps: the losses and the
parameters gathered with ``full_tensor()`` agree within 1e-5
(tests/test_torch_train.py's LOSS_ATOL and PARAM_ATOL), which holds the
gradients of the leaves replicated over pp (the embedding, whose lookup
only pp rank 0 feeds into the pipeline, and the final norm, whole on
every rank) to the JAX package's totals.

Also: ``num_microbatches`` above pp, ``pipeline_apply`` on a pytree of
activations with one pp rank (a map over the microbatches), and
``split_microbatches`` / ``merge_microbatches`` on pytrees against the
JAX package's, with the error that names the offending leaf.
"""

import numpy as np
import pytest
import torch

from _gloo_pool import GlooPool

torch.set_num_threads(1)

LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-5     # tests/test_torch_train.py's
LR = 0.1
B, S, STEPS = 4, 64, 3
BATCHES = [np.random.RandomState(70 + i).randint(0, 256, (B, S + 1))
           for i in range(STEPS)]
GPT2, MODERN = "gpt2", "rope-rms-swiglu"
RECIPES = {GPT2: {}, MODERN: {"pos": "rope", "norm": "rms",
                              "act": "swiglu"}}
CASES = [({"pp": 2, "dp": 2}, GPT2), ({"pp": 4}, GPT2),
         ({"pp": 2, "dp": 2}, MODERN)]


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX package's programs below go through its process-wide
    compilation ledger; leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule)."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(4)
    yield p
    p.close()


def _cfg(recipe, **kw):
    from ray_tpu_torch.models import gpt

    return gpt.GPTConfig.nano(dtype=torch.float32, **RECIPES[recipe], **kw)


def _sgd(leaves):
    return torch.optim.SGD(list(leaves), lr=LR)


# -- rank-side bodies (module level: the ranks import them by name) ------


def _port_sgd(axes, recipe, np_params, microbatches=None, devices=None):
    """The SGD steps' losses and the final params, gathered whole (None
    on a rank outside ``devices``, which only takes part in making the
    mesh)."""
    import torch.distributed as dist

    from ray_tpu_torch.models import convert, training
    from ray_tpu_torch.parallel import make_mesh

    cfg = _cfg(recipe, num_microbatches=microbatches)
    mesh = make_mesh(device_type="cpu", devices=devices, **axes)
    if devices is not None and dist.get_rank() not in devices:
        return None
    init, step = training.make_train_step(cfg, mesh, tx=_sgd)
    state = init(params=convert.from_jax_params(np_params, cfg,
                                                device="cpu"))
    losses = []
    for b in BATCHES:
        state, m = step(state, training.shard_batch({"tokens": b}, mesh))
        losses.append(float(m["loss"]))
    return losses, convert.to_numpy_params(state["params"])


# -- the JAX package's sharded step -----------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """(axes, recipe) -> (losses, final params as numpy), and each
    recipe's initial params."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtraining
    from ray_tpu.parallel import make_mesh

    inits, out = {}, {}
    for axes, recipe in CASES:
        jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32, **RECIPES[recipe])
        inits.setdefault(recipe, jax.tree.map(
            np.asarray, jgpt.init(jax.random.PRNGKey(0), jcfg)))
        mesh = make_mesh(devices=jax.devices()[:4], **axes)
        init, step = jtraining.make_train_step(jcfg, mesh,
                                               tx=optax.sgd(LR))
        state = init(jax.random.PRNGKey(0))
        losses = []
        for b in BATCHES:
            state, m = step(state, {"tokens": jnp.asarray(b, jnp.int32)})
            losses.append(float(m["loss"]))
        out[tuple(sorted(axes.items())), recipe] = (
            losses, jax.tree.map(np.asarray, state["params"]))
    return inits, out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _assert_params(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("axes,recipe", CASES,
                         ids=["pp2-dp2", "pp4", "pp2-dp2-swiglu"])
def test_pp_step_matches_jax(pool, jax_runs, axes, recipe):
    inits, runs = jax_runs
    want_losses, want_params = runs[tuple(sorted(axes.items())), recipe]
    res = pool.run(_port_sgd, axes, recipe, inits[recipe])
    losses, params = res[0]
    assert all(r[0] == losses for r in res)        # the global loss
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params(params, want_params)


def test_more_microbatches_than_stages(pool, jax_runs):
    """``num_microbatches`` 4 at pp 2 (the pool's first two ranks, the
    batch's 4 rows one per microbatch) is the step of the JAX package's
    pp-4 mesh: microbatching moves no sum beyond rounding."""
    inits, runs = jax_runs
    want_losses, want_params = runs[(("pp", 4),), GPT2]
    losses, params = pool.run(_port_sgd, {"pp": 2}, GPT2, inits[GPT2],
                              4, [0, 1])[0]
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params(params, want_params)


# -- one pp rank, and the microbatch helpers ---------------------------------


def test_pipeline_apply_one_rank_maps_a_pytree():
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 8, generator=g)
    x = torch.randn(3, 2, 8, generator=g)
    aux = torch.zeros(3, 2)

    def stage_fn(p, xs):
        h, a = xs
        y = torch.tanh(h @ p)
        return y, a + y.square().mean(-1)

    y, a = pipeline_apply(stage_fn, w, (x, aux), None)
    for i in range(3):
        want_y, want_a = stage_fn(w, (x[i], aux[i]))
        torch.testing.assert_close(y[i], want_y, rtol=0, atol=0)
        torch.testing.assert_close(a[i], want_a, rtol=0, atol=0)


def test_split_merge_pytree_matches_jax():
    import jax

    from ray_tpu.parallel import pipeline as jpipeline
    from ray_tpu_torch.parallel.pipeline import (merge_microbatches,
                                                 split_microbatches)

    tree = {"inputs": np.arange(48).reshape(8, 6),
            "aux": {"w": np.arange(48, dtype=np.float32).reshape(8, 2, 3)}}
    want = jax.tree.map(np.asarray, jpipeline.split_microbatches(tree, 4))
    got = split_microbatches({k: (torch.from_numpy(v) if k == "inputs"
                                  else {"w": torch.from_numpy(v["w"])})
                              for k, v in tree.items()}, 4)
    assert got["inputs"].shape == (4, 2, 6)
    assert got["aux"]["w"].shape == (4, 2, 2, 3)
    np.testing.assert_array_equal(got["inputs"].numpy(), want["inputs"])
    np.testing.assert_array_equal(got["aux"]["w"].numpy(),
                                  want["aux"]["w"])
    merged = merge_microbatches(got)
    np.testing.assert_array_equal(merged["inputs"].numpy(), tree["inputs"])
    np.testing.assert_array_equal(merged["aux"]["w"].numpy(),
                                  tree["aux"]["w"])
    # numpy leaves and tuples pass too
    t = split_microbatches((np.zeros((6, 2)), np.ones(6)), 3)
    assert isinstance(t, tuple) and t[0].shape == (3, 2, 2) \
        and t[1].shape == (3, 2)


def test_split_error_names_the_leaf_as_jax_does():
    from ray_tpu.parallel import pipeline as jpipeline
    from ray_tpu_torch.parallel.pipeline import split_microbatches

    tree = {"ok": np.zeros((8, 2)), "bad": np.zeros((7, 2))}
    with pytest.raises(ValueError) as jei:
        jpipeline.split_microbatches(tree, 4)
    with pytest.raises(ValueError) as ei:
        split_microbatches({k: torch.from_numpy(v) for k, v in tree.items()},
                           4)
    assert str(ei.value) == str(jei.value)
    with pytest.raises(ValueError, match="<scalar>"):
        split_microbatches({"s": torch.tensor(1.0)}, 2)
