"""The port's MoE model over a mesh against the JAX package's, on gloo
ranks.

The JAX package's ``moe.loss_fn`` (its value and gradient) and
``moe.apply`` (logits and the router losses) run jitted on a CPU mesh;
the port's run on a module-scoped pool of four spawned gloo ranks
(tests/_gloo_pool.py; they import no JAX) from the same weights
(``models/convert.py``) on the same batch, placed by ``shard_batch``;
the port's gradient comes from one step of ``make_train_step`` (SGD),
gathered whole with ``full_tensor()``.  Mixtral-nano in f32:

  * {dp 2} and {ep 2, dp 2} at capacity factor 1.25, where tokens drop:
    the routing group (the whole batch at {dp 2}; each contiguous half of
    the batch's tokens at {ep 2, dp 2}, which the ranks of one ep line
    hold) decides which tokens drop and the aux loss's means.  Each case
    also asserts that tokens were dropped, and that routing each rank's
    rows alone (capacity from its own tokens, its own means) moves the
    logits by far more than the tolerance;
  * {ep 2, tp 2}: the experts split over ep, their mlp dim over tp;
  * {pp 2, ep 2} at factor 8 (the reference's pp test's: nothing drops),
    the (x, aux, z) carry through GPipe, each microbatch the reference's
    global microbatch;
  * {fsdp 2, ep 2} at factor 1.25, its gradient taken by ``loss_fn`` on
    DTensor leaves whose fsdp shards are gathered per layer along dims
    other than 0 (the backward of such a gather once hung on gloo).

Tolerances (f32): loss and router losses 1e-5, logits 2e-5, gradients
1e-5 absolute (rounding of reassociated sums only).  Also
``moe_ffn_sharded`` on four ranks against the JAX package's inside its
``shard_map`` and the port's dense path per rank (k 1 and 2), and the
mesh cases of tests/test_moe.py and tests/test_moe_pp.py on the port:
the model at {ep 4} within 5% of its unsharded loss, {pp 2, ep 2}'s
logits == {dp 4}'s at factor 8, a {pp 2, dp 2} step's loss and gradient
finite.
"""

import numpy as np
import pytest
import torch

from _gloo_pool import GlooPool

torch.set_num_threads(1)

LOSS_ATOL, LOGIT_ATOL, GRAD_ATOL = 1e-5, 2e-5, 1e-5
B, S = 8, 32
TOKENS = np.random.RandomState(11).randint(0, 256, (B, S + 1))
# (mesh axes, capacity factor)
CASES = [({"dp": 2}, 1.25), ({"ep": 2, "dp": 2}, 1.25),
         ({"ep": 2, "tp": 2}, 1.25), ({"pp": 2, "ep": 2}, 8.0),
         ({"fsdp": 2, "ep": 2}, 1.25)]
IDS = ["dp2-cf1.25", "ep2-dp2-cf1.25", "ep2-tp2", "pp2-ep2-cf8",
       "fsdp2-ep2-cf1.25"]
# the cases whose drops the routing group decides
DROPPING = ("dp2-cf1.25", "ep2-dp2-cf1.25")
# the case whose gradient reaches DTensor leaves through loss_fn (the
# others' through make_train_step's local shards)
VIA_DTENSORS = ("fsdp2-ep2-cf1.25",)


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


def _size(axes):
    n = 1
    for v in axes.values():
        n *= v
    return n


def _cfg(cf):
    from ray_tpu_torch.models import moe

    return moe.MoEConfig.mixtral_nano(dtype=torch.float32,
                                      capacity_factor=cf)


# -- rank-side bodies (module level: the ranks import them by name) ------


def _port_moe(axes, cf, np_params, via_dtensors=False):
    """(loss, gathered grads, gathered logits, aux, z, (assignments,
    dropped) of the loss's routings, logits when each rank routes its
    own rows alone) on the pool's first ranks; None on the others.  The
    gradient comes from one step of make_train_step, or with
    ``via_dtensors`` from ``loss_fn`` on DTensor leaves (their fsdp
    shards gathered along dims other than 0: the embedding's, the
    router's and the experts')."""
    from unittest import mock

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import convert, moe, training
    from ray_tpu_torch.ops.moe import record_drops
    from ray_tpu_torch.parallel import make_mesh, spmd

    n = _size(axes)
    cfg = _cfg(cf)
    mesh = make_mesh(device_type="cpu", devices=list(range(n)), **axes)
    if dist.get_rank() >= n:
        return None
    placed = convert.shard_jax_params(np_params, cfg, mesh)
    batch = training.shard_batch({"tokens": TOKENS}, mesh)
    if via_dtensors:
        leaves = training.param_leaves(placed)
        for _, t in leaves:
            t.requires_grad_()
        with record_drops() as drops:
            loss = moe.loss_fn(placed, batch, cfg, mesh=mesh)
        loss.backward()
        loss = float(loss)
        grads = {k: t.grad.full_tensor().numpy() for k, t in leaves}
        for _, t in leaves:
            t.requires_grad_(False)
    else:
        init, step = training.make_train_step(
            cfg, mesh, tx=lambda ls: torch.optim.SGD(list(ls), lr=0.0))
        state = init(params=convert.from_jax_params(np_params, cfg,
                                                    device="cpu"))
        with record_drops() as drops:
            loss = float(step(state, batch)[1]["loss"])
        grads = {k: DTensor.from_local(
            t.grad, p.device_mesh, p.placements, run_check=False,
            shape=p.shape, stride=p.stride()).full_tensor().numpy()
            for (k, t), (_, p) in zip(
                training.param_leaves(state["shards"]),
                training.param_leaves(state["params"]))}
    assigned = sum(a for a, _ in drops)
    dropped = int(sum(int(d) for _, d in drops))
    inputs = training.shard_batch({"t": TOKENS[:, :-1]}, mesh)["t"]
    with torch.no_grad():
        logits, extras = moe.apply(placed, inputs, cfg, mesh=mesh)
        # each rank's rows routed alone: the fault the group guards against
        plane = moe._TokenPlane
        with mock.patch.object(moe, "_TokenPlane", lambda ctx, b, s, g:
                               plane(spmd.MeshCtx.of(None), b, s, 1)):
            alone, _ = moe.apply(placed, inputs, cfg, mesh=mesh)
    return {"loss": loss, "grads": grads,
            "logits": logits.full_tensor().numpy(),
            "aux": float(extras["aux"]), "z": float(extras["z"]),
            "assigned": assigned, "dropped": dropped,
            "alone": alone.full_tensor().numpy()}


def _port_apply(axes, cf, tokens, remat=True):
    """logits (gathered), aux and z of the port's seed-0 params over a
    mesh of the whole pool."""
    from ray_tpu_torch.models import moe, training
    from ray_tpu_torch.parallel import make_mesh

    cfg = moe.MoEConfig.mixtral_nano(dtype=torch.float32,
                                     capacity_factor=cf, remat=remat)
    mesh = make_mesh(device_type="cpu", **axes)
    params = training.init_sharded(0, cfg, mesh)
    inputs = training.shard_batch({"t": tokens}, mesh)["t"]
    with torch.no_grad():
        logits, extras = moe.apply(params, inputs, cfg, mesh=mesh)
    return (logits.full_tensor().numpy(), float(extras["aux"]),
            float(extras["z"]))


def _port_loss_grads(axes, tokens, remat=True, cf=1.25):
    """The port's loss and its grads' global norm (seed-1 params) over a
    mesh of the whole pool, or unsharded (axes None) on every rank."""
    from ray_tpu_torch.models import moe, training
    from ray_tpu_torch.parallel import make_mesh

    cfg = moe.MoEConfig.mixtral_nano(dtype=torch.float32, remat=remat,
                                     capacity_factor=cf)
    mesh = None if axes is None else make_mesh(device_type="cpu", **axes)
    init, step = training.make_train_step(
        cfg, mesh, tx=lambda ls: torch.optim.SGD(list(ls), lr=0.0),
        device="cpu" if mesh is None else None)
    state = init(seed=1)
    _, m = step(state, {"tokens": tokens})
    return float(m["loss"]), float(m["grad_norm"])


def _port_ffn_sharded(x, router, w_in, w_out, k, cap):
    import torch.distributed as dist

    from ray_tpu_torch.ops.moe import moe_ffn_sharded

    from ray_tpu_torch.ops.moe import moe_ffn

    n, r = dist.get_world_size(), dist.get_rank()
    T, El = x.shape[0] // n, w_in.shape[0] // n
    xs = torch.from_numpy(x[r * T:(r + 1) * T])
    out, aux, z = moe_ffn_sharded(
        xs, torch.from_numpy(router),
        torch.from_numpy(w_in[r * El:(r + 1) * El]),
        torch.from_numpy(w_out[r * El:(r + 1) * El]), k=k, capacity=cap)
    # the port's dense path on this rank's tokens, all experts here
    dense = moe_ffn(xs, torch.from_numpy(router), torch.from_numpy(w_in),
                    torch.from_numpy(w_out), k=k, capacity=cap)[0]
    return out.numpy(), float(aux), float(z), dense.numpy()


# -- the JAX package's runs ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """The initial params (numpy) and, per case, the JAX package's loss,
    grads, logits, aux and z on its CPU mesh."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jmoe
    from ray_tpu.models.training import _use_mesh
    from ray_tpu.parallel import make_mesh

    base = jmoe.MoEConfig.mixtral_nano(dtype=jnp.float32)
    params = jmoe.init(jax.random.PRNGKey(0), base)
    toks = jnp.asarray(TOKENS, jnp.int32)
    out = {}
    for (axes, cf), name in zip(CASES, IDS):
        jcfg = jmoe.MoEConfig.mixtral_nano(dtype=jnp.float32,
                                           capacity_factor=cf)
        mesh = make_mesh(devices=jax.devices()[:_size(axes)], **axes)

        def run(p, t, jcfg=jcfg, mesh=mesh):
            loss, grads = jax.value_and_grad(
                lambda q: jmoe.loss_fn(q, {"tokens": t}, jcfg, mesh))(p)
            logits, extras = jmoe.apply(p, t[:, :-1], jcfg, mesh)
            return loss, grads, logits, extras

        with _use_mesh(mesh):
            loss, grads, logits, extras = jax.jit(run)(params, toks)
        out[name] = {"loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads),
                     "logits": np.asarray(logits),
                     "aux": float(extras["aux"]), "z": float(extras["z"])}
    return jax.tree.map(np.asarray, params), out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_moe_mesh_matches_jax(pool, jax_runs, case):
    (axes, cf), name = CASES[case], IDS[case]
    np_params, runs = jax_runs
    want = runs[name]
    res = pool.run(_port_moe, axes, cf, np_params, name in VIA_DTENSORS,
                   timeout=300)
    got = res[0]
    n = _size(axes)
    assert all(r["loss"] == got["loss"] for r in res[:n])
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL
    assert abs(got["aux"] - want["aux"]) <= LOSS_ATOL
    assert abs(got["z"] - want["z"]) <= LOSS_ATOL
    np.testing.assert_allclose(got["logits"], want["logits"],
                               atol=LOGIT_ATOL, rtol=0)
    g, w = _flat(got["grads"]), _flat(want["grads"])
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)
    if name in DROPPING:
        # tokens drop here, and the group decides which: routing each
        # rank's rows alone gives other logits
        assert got["dropped"] > 0, got["dropped"]
        assert np.abs(got["alone"] - want["logits"]).max() > 100 * LOGIT_ATOL
    if cf >= 8:
        assert got["dropped"] == 0


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_sharded_matches_jax(pool, k):
    """The rank-local body over an ep group of four ranks == the JAX
    package's ``moe_ffn_sharded`` in its ``shard_map`` (drops allowed:
    both route each rank's tokens as a group)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu._private.jax_compat import shard_map
    from ray_tpu.ops.moe import expert_capacity, moe_ffn_sharded

    n, T, D, F, E = 4, 32, 8, 16, 4
    rs = np.random.RandomState(20 + k)
    x = rs.randn(T, D).astype(np.float32)
    router = rs.randn(D, E).astype(np.float32)
    w_in = (rs.randn(E, D, F) * 0.1).astype(np.float32)
    w_out = (rs.randn(E, F, D) * 0.1).astype(np.float32)
    cap = expert_capacity(T // n, E, k, 1.0)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("ep",))
    fn = shard_map(
        lambda xt, wr, wi, wo: moe_ffn_sharded(xt, wr, wi, wo, k=k,
                                               capacity=cap),
        mesh=mesh, check_vma=False,
        in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=(P("ep"), P(), P()))
    w_o, w_a, w_z = fn(*(jnp.asarray(a) for a in (x, router, w_in, w_out)))
    res = pool.run(_port_ffn_sharded, x, router, w_in, w_out, k, cap)
    got = np.concatenate([r[0] for r in res])
    np.testing.assert_allclose(got, np.asarray(w_o), atol=1e-5, rtol=0)
    for _, aux, z, _ in res:
        assert abs(aux - float(w_a)) <= 1e-5 and abs(z - float(w_z)) <= 1e-5
    # tests/test_moe.py's test_moe_sharded_matches_dense: the all_to_all
    # path == the dense path, each rank's tokens routed as their group
    np.testing.assert_allclose(got, np.concatenate([r[3] for r in res]),
                               rtol=2e-4, atol=2e-5)


def test_moe_model_on_ep_mesh(pool):
    """tests/test_moe.py's: the model on a mesh with a real ep axis (each
    rank's 2 rows a routing group) within 5% of the unsharded loss."""
    tokens = np.random.RandomState(1).randint(0, 256, (8, 33))
    (loss_mesh, _), = {r for r in pool.run(_port_loss_grads, {"ep": 4},
                                           tokens)}
    loss_ref, _ = pool.run(_port_loss_grads, None, tokens)[0]
    assert abs(loss_mesh - loss_ref) / loss_ref < 0.05


def test_moe_pp_matches_no_pp(pool):
    """tests/test_moe_pp.py's: at capacity factor 8 (no token drops, so
    regrouping by microbatch moves nothing) the pp mesh's logits equal
    the flat mesh's, and the router losses leave the pipeline."""
    tokens = np.random.RandomState(0).randint(0, 256, (8, 16))
    flat = pool.run(_port_apply, {"dp": 4}, 8.0, tokens, False)[0]
    piped = pool.run(_port_apply, {"pp": 2, "ep": 2}, 8.0, tokens, False)[0]
    assert np.all(np.isfinite(piped[0]))
    np.testing.assert_allclose(piped[0], flat[0], rtol=2e-4, atol=2e-4)
    assert np.isfinite(piped[1]) and piped[1] > 0


def test_moe_pp_grads_finite(pool):
    """tests/test_moe_pp.py's: a pp step's loss and gradient norm are
    finite and the norm positive."""
    tokens = np.random.RandomState(1).randint(0, 256, (8, 17))
    (loss, gnorm), = {r for r in pool.run(_port_loss_grads,
                                          {"pp": 2, "dp": 2}, tokens,
                                          False, 8.0)}
    assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
