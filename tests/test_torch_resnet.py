"""The port's ResNet (``ray_tpu_torch/models/resnet.py``) against the JAX
package's (``ray_tpu/models/resnet.py``).

The cases of tests/test_models.py's ``test_resnet_*`` run on the port
(ResNet-tiny's forward and five SGD steps whose loss falls; ResNet-50's
parameter count, here equal to the JAX package's leaf for leaf).  Then,
from the same seeded numpy images and weights carried over by
``models/convert.py``, in f32:

  * ``apply`` in eval and training mode and ``loss_fn``: logits, loss
    and accuracy, the new batch-norm state and every leaf's gradient,
    on images whose stride-2 layers meet odd and even sides (33 x 30:
    the stem makes 17 x 15, the pool 9 x 8, the stride-2 block 5 x 4)
    and on 32 x 32.  Logits, loss and state within 1e-5, gradients
    within 2e-5 (reassociated f32 sums of the convolutions);
  * XLA's "SAME" padding, asymmetric (``lax.padtype_to_pads``): the
    224 stem (2, 3), every 3 x 3 stride-2 window (0, 1);
  * {dp 2} on two spawned gloo ranks (tests/_gloo_pool.py) against the
    JAX package's loss_fn jitted on a two-device CPU mesh with the batch
    split over dp: batch norm synchronised over the global batch, the
    same loss, state and gradients within the same tolerances; and
    {fsdp 2}, the params placed by ``logical_axes`` (the conv kernels'
    output channels split over fsdp, gathered on use), against the same.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ATOL, GRAD_ATOL = 1e-5, 2e-5
SIZES = [(33, 30), (32, 32)]


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX package's programs below go through its process-wide
    compilation ledger; leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule)."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


def _batch(h, w, n=8, seed=0):
    images = np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)
    labels = np.random.RandomState(seed + 1).randint(0, 10, (n,))
    return images, labels


def _items(tree, prefix=""):
    """(dotted path, leaf) of a nested dict, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _flat(tree):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v, np.float32) for k, v in _items(tree)}


def _leaves(tree):
    return [v for _, v in _items(tree)]


def _assert_trees(got, want, atol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)


# -- the cases of tests/test_models.py ----------------------------------------


def test_resnet_forward_and_train():
    from ray_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig.tiny(dtype=torch.float32)
    params, state = resnet.init(cfg, seed=0, device="cpu")
    images, labels = _batch(32, 32)
    logits, _ = resnet.apply(params, state, images, cfg, training=False,
                             device="cpu")
    assert logits.shape == (8, 10)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_()
    opt = torch.optim.SGD(leaves, lr=0.05)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss, (state, metrics) = resnet.loss_fn(
            params, state, {"image": images, "label": labels}, cfg,
            device="cpu")
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]


def test_resnet50_param_count():
    import jax

    from ray_tpu.models import resnet as jr
    from ray_tpu_torch.models import resnet

    shapes = resnet.param_shapes(resnet.ResNetConfig.resnet50())
    n = sum(int(np.prod(s)) for s in _leaves(shapes))
    assert 24e6 < n < 27e6, n  # ResNet-50 ~25.6M
    want = jax.eval_shape(lambda: jr.init(jax.random.PRNGKey(0),
                                          jr.ResNetConfig.resnet50()))
    for got_tree, want_tree in zip(
            (shapes, resnet.state_shapes(resnet.ResNetConfig.resnet50())),
            want):
        assert {k: tuple(v) for k, v in _items(got_tree)} == {
            k: tuple(v.shape) for k, v in _items(want_tree)}


# -- against the JAX package --------------------------------------------------


@pytest.fixture(scope="module")
def jax_tiny():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import resnet as jr

    jcfg = jr.ResNetConfig.tiny(dtype=jnp.float32)
    params, state = jr.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, state


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("h,w", SIZES, ids=["33x30", "32x32"])
def test_resnet_tiny_matches_jax(jax_tiny, h, w):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import resnet as jr
    from ray_tpu_torch.models import convert, resnet

    jcfg, jparams, jstate = jax_tiny
    cfg = resnet.ResNetConfig.tiny(dtype=torch.float32)
    params = convert.from_jax_params(_np(jparams), cfg, device="cpu")
    state = convert.from_jax_state(_np(jstate), cfg, device="cpu")
    images, labels = _batch(h, w)
    for training in (False, True):
        want, want_state = jr.apply(jparams, jstate, jnp.asarray(images),
                                    jcfg, training=training)
        got, got_state = resnet.apply(params, state, images, cfg,
                                      training=training, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        _assert_trees(got_state, _np(want_state), ATOL)
    batch = {"image": images, "label": labels}
    (w_loss, (w_state, w_m)), w_grads = jax.jit(jax.value_and_grad(
        lambda p: jr.loss_fn(p, jstate, batch, jcfg), has_aux=True))(jparams)
    for t in _leaves(params):
        t.requires_grad_()
    loss, (new_state, m) = resnet.loss_fn(params, state, batch, cfg,
                                          device="cpu")
    loss.backward()
    assert abs(loss.item() - float(w_loss)) <= ATOL
    assert m["accuracy"].item() == float(w_m["accuracy"])
    _assert_trees(new_state, _np(w_state), ATOL)
    grads = {k: v.grad for k, v in _items(params)}
    want_g = _flat(_np(w_grads))
    assert grads.keys() == want_g.keys()
    for k in want_g:
        np.testing.assert_allclose(grads[k].numpy(), want_g[k],
                                   atol=GRAD_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (112, 3, 2), (56, 3, 2),
                                   (33, 3, 2), (17, 3, 2), (30, 1, 2),
                                   (9, 3, 1)])
def test_same_padding_is_xla_s(n, k, s):
    from jax import lax

    from ray_tpu_torch.models.resnet import _same_pads

    (want,) = lax.padtype_to_pads((n,), (k,), (s,), "SAME")
    assert _same_pads(n, k, s) == tuple(want)
    if (n, k, s) == (224, 7, 2):
        assert want == (2, 3)


# -- {dp 2}: batch norm over the global batch ---------------------------------


@pytest.fixture(scope="module")
def pool():
    from _gloo_pool import GlooPool

    p = GlooPool(2)
    yield p
    p.close()


def _port_dp_step(np_params, np_state, images, labels, axes):
    """loss, accuracy, new state and gathered grads of one loss_fn on a
    two-rank mesh, the batch placed by shard_batch.  At {dp: 2} the
    params are the global tensors on every rank; at {fsdp: 2} DTensors
    placed by ``logical_axes`` (the conv kernels' output channels split
    over fsdp, gathered on use)."""
    from ray_tpu_torch.models import convert, resnet, training
    from ray_tpu_torch.parallel import make_mesh, shard_tree

    cfg = resnet.ResNetConfig.tiny(dtype=torch.float32)
    mesh = make_mesh(device_type="cpu", **axes)
    params = convert.from_jax_params(np_params, cfg, device="cpu")
    if "fsdp" in axes:
        params = shard_tree(params, resnet.logical_axes(cfg), mesh)
    state = convert.from_jax_state(np_state, cfg, device="cpu")
    for t in _leaves(params):
        t.requires_grad_()
    batch = training.shard_batch({"image": images, "label": labels}, mesh)
    loss, (new_state, m) = resnet.loss_fn(params, state, batch, cfg,
                                          mesh=mesh)
    loss.backward()
    logits, _ = resnet.apply(params, state, batch["image"], cfg,
                             training=True, mesh=mesh)
    return {"loss": loss.item(), "accuracy": m["accuracy"].item(),
            "state": _flat(new_state),
            "grads": {k: (v.grad.full_tensor() if "fsdp" in axes
                          else v.grad).numpy() for k, v in _items(params)},
            "logits": logits.full_tensor().detach().numpy()}


@pytest.mark.parametrize("axes", [{"dp": 2}, {"fsdp": 2}],
                         ids=["dp2", "fsdp2"])
def test_resnet_dp2_sync_bn_matches_jax(pool, jax_tiny, axes):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import resnet as jr
    from ray_tpu.parallel import make_mesh

    jcfg, jparams, jstate = jax_tiny
    images, labels = _batch(*SIZES[0])
    mesh = make_mesh(devices=jax.devices()[:2], dp=2)
    sh = NamedSharding(mesh, P("dp"))
    batch = {"image": jax.device_put(jnp.asarray(images), sh),
             "label": jax.device_put(jnp.asarray(labels), sh)}

    def run(p, b):
        (loss, (st, m)), g = jax.value_and_grad(
            lambda q: jr.loss_fn(q, jstate, b, jcfg), has_aux=True)(p)
        logits, _ = jr.apply(p, jstate, b["image"], jcfg, training=True)
        return loss, st, m, g, logits

    loss, st, m, g, logits = jax.jit(run)(jparams, batch)
    res = pool.run(_port_dp_step, _np(jparams), _np(jstate), images, labels,
                   axes)
    for r in res:       # every rank holds the global values
        assert abs(r["loss"] - float(loss)) <= ATOL
        assert r["accuracy"] == float(m["accuracy"])
        want_state = _flat(_np(st))
        for k in want_state:
            np.testing.assert_allclose(r["state"][k], want_state[k],
                                       atol=ATOL, rtol=0, err_msg=k)
        want_g = _flat(_np(g))
        for k in want_g:
            np.testing.assert_allclose(r["grads"][k], want_g[k],
                                       atol=GRAD_ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(r["logits"], np.asarray(logits),
                                   atol=ATOL, rtol=0)
