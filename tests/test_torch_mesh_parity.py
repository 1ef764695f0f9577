"""The port's sharded train step against the JAX package's, on gloo ranks.

The JAX package's ``make_train_step(cfg, mesh)`` runs GPT nano (f32,
remat "full", ``sp_mode="ring"``) on a four-device CPU mesh; the port's
runs on a module-scoped pool of four spawned gloo ranks
(tests/_gloo_pool.py; they import no JAX) from the same weights
(``models/convert.py``) on the same batches, placed by ``shard_batch``.
Three SGD steps at {fsdp: 2, tp: 2}, {dp: 2, sp: 2} and {sp: 4}, and at
{sp: 4} with ``sp_mode="none"`` (K/V gathered over sp; the JAX package's
partitioner gathers them for its step): the
losses and the parameters gathered with ``full_tensor()`` agree within
tests/test_torch_train.py's LOSS_ATOL and PARAM_ATOL (1e-5), and the
sharded eval step on the final params within LOSS_ATOL of the unsharded
loss of the JAX package's final params.  The
cross-package oracle steps with SGD: AdamW turns the packages' ulp
differences in a gradient that cancels to ~1e-9 into a good part of a
step (ROADMAP §C, Train).

Port against port:
  * AdamW sharded against AdamW unsharded: the losses within 1e-6 each
    step, and the sharded params bitwise those of an unsharded AdamW fed
    the sharded step's gathered gradients (the moments live on each
    rank's shards and must update as the whole would);
  * ``remat_policy="dots"`` bitwise ``"full"``, on one rank and at
    {fsdp: 2, tp: 2};
  * ``JaxConfig(mode="spmd", mesh_shape={"dp": 2})`` through the trainer
    on two gloo workers, bitwise the same loop on two ranks in process;
  * ``iter_jax_batches(sharding=batch_sharding(mesh))``: each rank's
    block is its slice of the host batch; with no sharding and a default
    mesh over several processes, batches go whole to the device (the
    reference's rule for a mesh a process does not wholly address);
  * a tensor with a spec through the object plane's serializer,
    re-placed on the receiver's default mesh;
  * a pp axis > 1 runs GPipe over the ranks (ROADMAP A.6b): at
    {pp: 2, dp: 2} the sharded step's losses equal the unsharded step's
    within 1e-6 (tests/test_torch_pipeline_parity.py holds it to the JAX
    package's pp step).

A world-1 mesh's steps on the card, bitwise the unsharded step's, are in
tests/test_torch_kernels.py (a file that imports no JAX).
"""

import numpy as np
import pytest
import torch

from _gloo_pool import GlooPool

torch.set_num_threads(1)

LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-5     # tests/test_torch_train.py's
ADAMW_LOSS_ATOL = 1e-6
LR = 0.1
B, S, STEPS = 4, 64, 3
BATCHES = [np.random.RandomState(50 + i).randint(0, 256, (B, S + 1))
           for i in range(STEPS)]
SHAPES = [{"fsdp": 2, "tp": 2}, {"dp": 2, "sp": 2}, {"sp": 4}]
# (axes, sp_mode) of the cross-package cases
CASES = [(axes, "ring") for axes in SHAPES] + [({"sp": 4}, "none")]


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


def _cfg(**kw):
    from ray_tpu_torch.models import gpt

    return gpt.GPTConfig.nano(dtype=torch.float32, **kw)


def _sgd(leaves):
    return torch.optim.SGD(list(leaves), lr=LR)


# -- rank-side bodies (module level: the ranks import them by name) ------


def _steps(mesh, cfg, tx, params=None, batches=BATCHES, grads=False):
    """(losses, grad norms, gathered params, gathered grads per step)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import convert, training

    init, step = training.make_train_step(cfg, mesh, tx=tx)
    state = init(seed=0, params=params)
    losses, norms, gs = [], [], []
    for b in batches:
        state, m = step(state, training.shard_batch({"tokens": b}, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads:
            gs.append({k: DTensor.from_local(
                t.grad, p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride()).full_tensor().numpy()
                for (k, t), (_, p) in zip(
                    training.param_leaves(state["shards"]),
                    training.param_leaves(state["params"]))})
    return losses, norms, convert.to_numpy_params(state["params"]), gs


def _port_sgd(axes, np_params, sp_mode="ring"):
    """The SGD steps, and the eval step's loss on the first batch with
    the final params."""
    from ray_tpu_torch.models import convert, training
    from ray_tpu_torch.parallel import make_mesh

    cfg = _cfg(sp_mode=sp_mode)
    mesh = make_mesh(device_type="cpu", **axes)
    params = convert.from_jax_params(np_params, cfg, device="cpu")
    losses, norms, final, _ = _steps(mesh, cfg, _sgd, params)
    placed = convert.shard_jax_params(final, cfg, mesh)
    ev = training.make_eval_step(cfg, mesh)(
        placed, training.shard_batch({"tokens": BATCHES[0]}, mesh))
    return losses, norms, final, float(ev)


def _port_adamw(axes):
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device_type="cpu", **axes)
    return _steps(mesh, _cfg(), None, grads=True)


def _port_remat(axes):
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device_type="cpu", **axes)
    return [_steps(mesh, _cfg(remat_policy=p), _sgd)[:3]
            for p in ("full", "dots")]


def _mesh_loop_losses(mesh):
    from ray_tpu_torch.models import training

    init, step = training.make_train_step(_cfg(), mesh, tx=_sgd)
    state = init(seed=0)
    return [float(step(state, {"tokens": b})[1]["loss"]) for b in BATCHES]


def _in_process_dp2():
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh

    # the pool's first two ranks; the others take part in making the mesh
    mesh = make_mesh(dp=2, devices=[0, 1], device_type="cpu")
    if dist.get_rank() > 1:
        return None
    return _mesh_loop_losses(mesh)


def _loop_mesh(config):
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import axis_sizes, get_default_mesh

    torch.set_num_threads(1)
    mesh = get_default_mesh()
    train.report({"losses": _mesh_loop_losses(mesh),
                  "mesh": axis_sizes(mesh)})


def _sharded_batches(host):
    from ray_tpu_torch.data.iterator import iter_jax_batches
    from ray_tpu_torch.parallel import (axis_index, batch_sharding,
                                        default_mesh, make_mesh, spec_of)

    mesh = make_mesh(dp=2, sp=2, device_type="cpu")
    out = []
    for b in iter_jax_batches(iter([{"ids": x} for x in host]),
                              sharding=batch_sharding(mesh), device="cpu"):
        t = b["ids"]
        out.append((tuple(t.shape), tuple(spec_of(t)),
                    t.to_local().numpy()))
    with default_mesh(make_mesh(dp=4, device_type="cpu")):
        plain = [b["ids"] for b in iter_jax_batches(
            iter([{"ids": x} for x in host]), device="cpu")]
    return (axis_index(mesh, "dp"), axis_index(mesh, "sp"), out,
            [(type(t).__name__, tuple(t.shape)) for t in plain])


def _replaced(blob):
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.parallel import (axis_index, default_mesh, make_mesh,
                                        spec_of)

    bare = serialization.loads_inline(blob)
    mesh = make_mesh(dp=4, device_type="cpu")
    with default_mesh(mesh):
        t = serialization.loads_inline(blob)
    return (type(bare).__name__, axis_index(mesh, "dp"),
            tuple(spec_of(t)), tuple(t.shape), t.to_local().numpy())


def _pp_runs():
    from ray_tpu_torch.parallel import make_mesh

    return _mesh_loop_losses(make_mesh(pp=2, dp=2, device_type="cpu"))


# -- the JAX package's sharded step -----------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """(axes, sp_mode) -> (losses, final params as numpy), and the
    initial params."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtraining
    from ray_tpu.parallel import make_mesh

    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32)
    init_np = jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0),
                                                 jcfg))
    out = {}
    for axes, sp_mode in CASES:
        jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32, sp_mode=sp_mode)
        mesh = make_mesh(devices=jax.devices()[:4], **axes)
        init, step = jtraining.make_train_step(jcfg, mesh,
                                               tx=optax.sgd(LR))
        state = init(jax.random.PRNGKey(0))
        losses = []
        for b in BATCHES:
            state, m = step(state, {"tokens": jnp.asarray(b, jnp.int32)})
            losses.append(float(m["loss"]))
        out[tuple(sorted(axes.items())), sp_mode] = (
            losses, jax.tree.map(np.asarray, state["params"]))
    return init_np, out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("axes,sp_mode", CASES,
                         ids=["fsdp2-tp2", "dp2-sp2", "sp4", "sp4-none"])
def test_sharded_step_matches_jax(pool, jax_runs, axes, sp_mode):
    init_np, runs = jax_runs
    want_losses, want_params = runs[tuple(sorted(axes.items())), sp_mode]
    res = pool.run(_port_sgd, axes, init_np, sp_mode)
    losses, _, params, ev = res[0]
    assert all(r[0] == losses and r[3] == ev for r in res)  # global
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    # the eval step over the mesh == the unsharded loss of JAX's params
    from ray_tpu_torch.models import convert, gpt

    cfg = _cfg()
    want_ev = gpt.loss_fn(convert.from_jax_params(want_params, cfg,
                                                  device="cpu"),
                          {"tokens": BATCHES[0]}, cfg, device="cpu")
    assert abs(ev - float(want_ev)) <= LOSS_ATOL
    got, want = _flat(params), _flat(want_params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


def test_sharded_adamw_matches_unsharded(pool):
    from ray_tpu_torch.models import gpt, training

    losses, _, params, grads = pool.run(_port_adamw,
                                        {"fsdp": 2, "tp": 2})[0]
    cfg = _cfg()
    init, step = training.make_train_step(cfg, device="cpu")
    state = init(seed=0)
    ref = []
    for b in BATCHES:
        state, m = step(state, {"tokens": b})
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref, atol=ADAMW_LOSS_ATOL, rtol=0)
    # an unsharded AdamW fed the sharded step's gradients
    leaves = training.param_leaves(gpt.init(cfg, seed=0, device="cpu"))
    ts = [t.requires_grad_() for _, t in leaves]
    opt = training.adamw(3e-4, weight_decay=0.1)(ts)
    for g in grads:
        for (k, _), t in zip(leaves, ts):
            t.grad = torch.from_numpy(g[k])
        opt.step()
    got = _flat(params)
    for (k, _), t in zip(leaves, ts):
        np.testing.assert_array_equal(got[k], t.detach().numpy(), err_msg=k)


def test_remat_dots_is_bitwise_full(pool):
    from ray_tpu_torch.models import training

    def one_rank(policy):
        init, step = training.make_train_step(_cfg(remat_policy=policy),
                                              device="cpu")
        state = init(seed=0)
        losses = [float(step(state, {"tokens": b})[1]["loss"])
                  for b in BATCHES]
        return losses, _flat({k: t.detach() for k, t in
                              training.param_leaves(state["params"])})

    (lf, pf), (ld, pd) = one_rank("full"), one_rank("dots")
    assert lf == ld
    for k in pf:
        np.testing.assert_array_equal(pf[k], pd[k], err_msg=k)
    full, dots = pool.run(_port_remat, {"fsdp": 2, "tp": 2})[0]
    assert full[0] == dots[0] and full[1] == dots[1]
    for k, v in _flat(full[2]).items():
        np.testing.assert_array_equal(v, _flat(dots[2])[k], err_msg=k)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_trainer_mesh_shape_is_the_in_process_mesh(pool, cluster, tmp_path):
    from ray_tpu_torch._private.protocol import free_port
    from ray_tpu_torch.train import (JaxConfig, JaxTrainer, RunConfig,
                                     ScalingConfig)

    result = JaxTrainer(
        _loop_mesh,
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="spmd", mesh_shape={"dp": 2},
                                 coordinator_port=free_port()),
        run_config=RunConfig(name="mesh-dp2", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["mesh"] == {"pp": 1, "dp": 2, "fsdp": 1, "ep": 1,
                                      "sp": 1, "tp": 1}
    want = pool.run(_in_process_dp2)[0]
    assert result.metrics["losses"] == want


def test_iter_jax_batches_places_each_ranks_block(pool):
    host = [np.arange(128, dtype=np.int64).reshape(8, 16) + 1000 * i
            for i in range(3)]
    for dp, sp, out, plain in pool.run(_sharded_batches, host):
        assert len(out) == 3
        for i, (shape, spec, local) in enumerate(out):
            assert shape == (8, 16)
            assert spec == (("dp", "fsdp", "ep"), "sp") or \
                spec == ("dp", "sp")
            np.testing.assert_array_equal(
                local, host[i][dp * 4:(dp + 1) * 4, sp * 8:(sp + 1) * 8])
        assert plain == [("Tensor", (8, 16))] * 3


def test_object_plane_replaces_a_spec_on_the_receivers_mesh(pool):
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.parallel import (NamedSharding, PartitionSpec as P,
                                        distribute, make_mesh)

    world1 = make_mesh(device_type="cpu")
    x = torch.arange(32.0).reshape(8, 4)
    blob = serialization.dumps_inline(
        distribute(x, NamedSharding(world1, P("dp"))))
    for bare, dp, spec, shape, local in pool.run(_replaced, blob):
        assert bare == "Tensor"                 # no default mesh
        assert spec == ("dp",) and shape == (8, 4)
        np.testing.assert_array_equal(local, x.numpy()[2 * dp:2 * dp + 2])


def test_pp_axis_raises_naming_its_item(pool):
    """A pp axis > 1 no longer raises (it named A.6b): the GPipe step over
    {pp: 2, dp: 2} is the unsharded step."""
    from ray_tpu_torch.models import training

    got = pool.run(_pp_runs)
    init, step = training.make_train_step(_cfg(), tx=_sgd, device="cpu")
    state = init(seed=0)
    want = [float(step(state, {"tokens": b})[1]["loss"]) for b in BATCHES]
    assert all(r == got[0] for r in got)
    np.testing.assert_allclose(got[0], want, atol=ADAMW_LOSS_ATOL, rtol=0)
