"""The port's MoE routing, expert feed-forward and model on one process,
against the JAX package (``ray_tpu/ops/moe.py``, ``ray_tpu/models/moe.py``).

The cases of tests/test_moe.py that need no mesh, run on the port
(route_topk's shapes and capacity, overflow drops, moe_ffn against each
token's expert, the model's forward and gradient), and parity with the
JAX package on the same seeded numpy inputs and weights carried over by
``models/convert.py``:

  * ``route_topk``: the dispatch and combine tensors equal the JAX
    package's exactly (0/1 entries and the renormalised gates, which
    both compute in f32 from the same probabilities up to rounding:
    1e-6), the aux and z losses within 1e-6, with drops, and with tied
    logits (``[10, 0, 0, 0]`` at k = 2: the lower index first among the
    equal zeros, as ``jax.lax.top_k`` orders them);
  * ``moe_ffn``: outputs within 1e-5 and the aux and z losses within
    1e-6 relative (an f32 ulp of z ~ 50), k 1 and 2, with drops;
  * mixtral-nano in f32: ``apply``'s logits within 2e-5 and its aux and
    z within 1e-5, ``loss_fn`` within 1e-5, and the gradient of every
    leaf, the router's among them, within 1e-5.

The mesh cases (tests/test_moe.py's sharded ones and
tests/test_moe_pp.py's) are in tests/test_torch_moe_parity.py; the
card's, in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EXACT_ATOL, FFN_ATOL, LOSS_ATOL, LOGIT_ATOL, GRAD_ATOL = (1e-6, 1e-5, 1e-5,
                                                          2e-5, 1e-5)


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX package's programs below go through its process-wide
    compilation ledger; leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule)."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the cases of tests/test_moe.py ------------------------------------------


def test_route_topk_shapes_and_capacity():
    from ray_tpu_torch.ops.moe import route_topk

    T, E, k, C = 32, 4, 2, 16
    logits = _t(np.random.RandomState(0).randn(T, E).astype(np.float32))
    r = route_topk(logits, k, C)
    assert r.dispatch.shape == (T, E, C)
    # each token occupies at most k slots, each with weight exactly 1
    assert (r.dispatch.sum(dim=(1, 2)) <= k + 1e-6).all()
    # each (expert, slot) holds at most one token
    assert (r.dispatch.sum(dim=0) <= 1 + 1e-6).all()
    # combine weights are a convex-ish mixture: <= 1 per token
    assert (r.combine.sum(dim=(1, 2)) <= 1 + 1e-5).all()
    assert np.isfinite(float(r.aux_loss)) and float(r.aux_loss) > 0


def test_route_topk_drops_overflow():
    from ray_tpu_torch.ops.moe import record_drops, route_topk

    # all tokens pick expert 0 -> only `capacity` of them may land
    T, E, C = 16, 4, 8
    logits = torch.tensor([[10.0, 0.0, 0.0, 0.0]]).repeat(T, 1)
    with record_drops() as drops:
        r = route_topk(logits, k=1, capacity=C)
    assert float(r.dispatch[:, 0].sum()) == C
    assert drops[0][0] == T and int(drops[0][1]) == T - C


def test_moe_ffn_matches_per_token_expert():
    """k=1, generous capacity: the output equals each token through its
    argmax expert (its renormalised gate is 1)."""
    from ray_tpu_torch.ops.moe import gelu, moe_ffn

    T, D, F, E = 16, 8, 16, 4
    rs = np.random.RandomState(1)
    x = _t(rs.randn(T, D).astype(np.float32))
    router = _t(rs.randn(D, E).astype(np.float32))
    w_in = _t((rs.randn(E, D, F) * 0.1).astype(np.float32))
    w_out = _t((rs.randn(E, F, D) * 0.1).astype(np.float32))
    out, aux, z = moe_ffn(x, router, w_in, w_out, k=1, capacity=T)
    sel = (x @ router).argmax(-1)
    expect = torch.stack([gelu(x[t] @ w_in[e]) @ w_out[e]
                          for t, e in enumerate(sel.tolist())])
    torch.testing.assert_close(out, expect, rtol=2e-4, atol=2e-5)


def test_moe_model_forward_and_grad():
    from ray_tpu_torch.models import moe, training

    cfg = moe.MoEConfig.mixtral_nano()
    params = moe.init(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 33)))
    with torch.no_grad():
        logits, extras = moe.apply(params, tokens[:, :-1], cfg,
                                   device="cpu")
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert np.isfinite(float(extras["aux"]))
    for _, t in training.param_leaves(params):
        t.requires_grad_()
    loss = moe.loss_fn(params, {"tokens": tokens}, cfg, device="cpu")
    loss.backward()
    assert np.isfinite(loss.item())
    grads = {k: t.grad for k, t in training.param_leaves(params)}
    assert all(torch.isfinite(g).all() for g in grads.values())
    # the router receives gradient through the combine weights
    assert grads["layers.router"].abs().max() > 0


# -- against the JAX package --------------------------------------------------


def _jax_route(logits, k, cap):
    import jax.numpy as jnp

    from ray_tpu.ops.moe import route_topk as jroute

    r = jroute(jnp.asarray(logits), k, cap)
    return [np.asarray(a) for a in r]


@pytest.mark.parametrize("k,cap", [(1, 8), (2, 8), (2, 24)],
                         ids=["k1-drops", "k2-drops", "k2"])
def test_route_topk_matches_jax(k, cap):
    from ray_tpu_torch.ops.moe import record_drops, route_topk

    logits = (np.random.RandomState(3).randn(48, 4) * 2).astype(np.float32)
    want = _jax_route(logits, k, cap)
    with record_drops() as drops:
        got = route_topk(_t(logits), k, cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=EXACT_ATOL, rtol=0)
    np.testing.assert_array_equal(got.dispatch.numpy(), want[0])
    if cap == 8:
        assert int(drops[0][1]) > 0


def test_route_topk_tied_logits_lower_index_first():
    """Rows [10, 0, 0, 0] at k = 2: the second choice among three equal
    probabilities is expert 1, as ``jax.lax.top_k`` orders them; the
    queue positions of expert 1 fill in token order."""
    from ray_tpu_torch.ops.moe import route_topk

    T, E, C = 12, 4, 16
    logits = np.tile(np.array([[10.0, 0.0, 0.0, 0.0]], np.float32), (T, 1))
    logits[::3, 2] = 10.0        # every third row ties experts 0 and 2
    want = _jax_route(logits, 2, C)
    got = route_topk(_t(logits), 2, C)
    np.testing.assert_array_equal(got.dispatch.numpy(), want[0])
    np.testing.assert_allclose(got.combine.numpy(), want[1],
                               atol=EXACT_ATOL, rtol=0)
    chosen = got.dispatch.sum(dim=2)            # [T, E] 0/1
    assert chosen[1].tolist() == [1, 1, 0, 0]
    assert chosen[0].tolist() == [1, 0, 1, 0]


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_jax(k):
    import jax.numpy as jnp

    from ray_tpu.ops.moe import moe_ffn as jffn
    from ray_tpu_torch.ops.moe import moe_ffn

    T, D, F, E = 40, 8, 16, 4
    rs = np.random.RandomState(4 + k)
    arrs = [rs.randn(T, D), rs.randn(D, E) * 2, rs.randn(E, D, F) * 0.1,
            rs.randn(E, F, D) * 0.1]
    arrs = [a.astype(np.float32) for a in arrs]
    want = jffn(*(jnp.asarray(a) for a in arrs), k=k, capacity_factor=1.0)
    got = moe_ffn(*(_t(a) for a in arrs), k=k, capacity_factor=1.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=FFN_ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):     # aux, z: 1e-6 relative
        assert abs(float(g) - float(w)) <= EXACT_ATOL * abs(float(w))


def test_mixtral_nano_matches_jax():
    """apply's logits and router losses, loss_fn and every leaf's
    gradient against the JAX package's, f32, remat on."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe
    from ray_tpu_torch.models import convert, moe, training

    jcfg = jmoe.MoEConfig.mixtral_nano(dtype=jnp.float32)
    cfg = moe.MoEConfig.mixtral_nano(dtype=torch.float32)
    jparams = jmoe.init(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.RandomState(1).randint(0, 256, (2, 33))

    def run(p, t):
        loss, grads = jax.value_and_grad(
            lambda q: jmoe.loss_fn(q, {"tokens": t}, jcfg))(p)
        return loss, grads, jmoe.apply(p, t[:, :-1], jcfg)

    w_loss, w_grads, (w_logits, w_extras) = jax.jit(run)(
        jparams, jnp.asarray(tokens))
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    with torch.no_grad():
        logits, extras = moe.apply(params, _t(tokens[:, :-1]), cfg,
                                   device="cpu")
    np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits),
                               atol=LOGIT_ATOL, rtol=0)
    for key in ("aux", "z"):
        assert abs(float(extras[key]) - float(w_extras[key])) <= LOSS_ATOL
    for _, t in training.param_leaves(params):
        t.requires_grad_()
    loss = moe.loss_fn(params, {"tokens": _t(tokens)}, cfg, device="cpu")
    loss.backward()
    assert abs(float(loss) - float(w_loss)) <= LOSS_ATOL
    want = dict(training.param_leaves(jax.tree.map(np.asarray, w_grads)))
    got = {k: t.grad.numpy() for k, t in training.param_leaves(params)}
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=GRAD_ATOL,
                                   rtol=0, err_msg=key)
    assert np.abs(got["layers.router"]).max() > 0


def test_num_params_and_configs_match_jax():
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe
    from ray_tpu_torch.models import MoEConfig, moe

    assert moe.num_params(MoEConfig.small()) == jmoe.num_params(
        jmoe.MoEConfig.small()) == 369_027_840
    for name in ("small", "mixtral_nano"):
        got = getattr(MoEConfig, name)()
        want = getattr(jmoe.MoEConfig, name)(dtype=jnp.bfloat16)
        for f in ("n_layers", "d_model", "n_heads", "d_head", "d_ff",
                  "vocab_size", "n_experts", "expert_top_k",
                  "capacity_factor", "aux_loss_weight", "router_z_weight",
                  "norm", "pos", "tie_embeddings"):
            assert getattr(got, f) == getattr(want, f), (name, f)
    with pytest.raises(ValueError, match="attn_bias"):
        MoEConfig.mixtral_nano(attn_bias=True)


def test_convert_takes_the_moe_tree_and_refuses_a_bad_leaf():
    import jax

    from ray_tpu.models import moe as jmoe
    from ray_tpu_torch.models import convert, moe

    cfg = moe.MoEConfig.mixtral_nano()
    tree = jax.tree.map(np.asarray, jmoe.init(
        jax.random.PRNGKey(0), jmoe.MoEConfig.mixtral_nano()))
    params = convert.from_jax_params(tree, cfg, device="cpu")
    back = convert.to_numpy_params(params)
    np.testing.assert_array_equal(back["layers"]["w_in"],
                                  tree["layers"]["w_in"])
    bad = dict(tree, layers=dict(tree["layers"]))
    del bad["layers"]["router"]
    with pytest.raises(ValueError, match="keys"):
        convert.from_jax_params(bad, cfg, device="cpu")
    bad["layers"]["router"] = tree["layers"]["router"][:, :, :2]
    with pytest.raises(ValueError, match="router"):
        convert.from_jax_params(bad, cfg, device="cpu")
