"""The port's training slice against the JAX reference: the nano GPT in
f32, the same weights (``convert.from_jax_params``) on the same token
batches, with the reference on ``attention_impl="pallas_interpret"`` so
its Pallas kernels K1-K3 run.

  * ``gpt.loss_fn`` and every leaf's grad == ``jax.value_and_grad`` of
    the reference's, dense, masked and chunked (``loss_chunk``);
  * three ``make_train_step`` steps == the reference's train step on a
    1-device mesh (AdamW(3e-4, weight_decay=0.1)): losses, grad norms
    and params after each step;
  * a step resumed from the reference's state after two steps
    (``from_optax_adamw_state``) == the reference's third;
  * remat on and off give the same grads.

Tolerances: the loss within 1e-5; grads within 1e-5 + 1e-4*max|g| per
leaf (sums in another order through 4 layers); grad norms within 1e-5
relative; params within 1e-5 after three steps (the AdamW updates are
at most ~lr = 3e-4 per step, so this is ~3% of a step).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtraining
from ray_tpu.parallel import make_mesh
from ray_tpu_torch.models import convert, gpt, training
from ray_tpu_torch.ops import _kernels

torch.set_num_threads(1)

B, S = 2, 64
LOSS_ATOL, GRAD_ATOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-4, 1e-5
BATCHES = [np.random.RandomState(30 + i).randint(0, 256, (B, S + 1))
           for i in range(3)]
MASK = (np.random.RandomState(40).rand(B, S) < 0.7).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _tcfg(**kw):
    return gpt.GPTConfig.nano(dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32,
                               attention_impl="pallas_interpret")
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _port_params(np_params, cfg):
    params = convert.from_jax_params(np_params, cfg, device="cpu")
    for _, t in training.param_leaves(params):
        t.requires_grad_()
    return params


def _port_loss_and_grads(np_params, batch, cfg):
    params = _port_params(np_params, cfg)
    loss = gpt.loss_fn(params, batch, cfg, device="cpu")
    loss.backward()
    return float(loss.detach()), {k: t.grad.numpy()
                                  for k, t in training.param_leaves(params)}


def _grads_close(got, want):
    assert set(got) == set(want)
    for key, g in want.items():
        tol = GRAD_ATOL + GRAD_RTOL * np.abs(g).max()
        np.testing.assert_allclose(got[key], g, atol=tol, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("variant", ["dense", "mask", "chunk"])
def test_loss_and_grads_match_jax(ref, variant):
    jcfg, jparams, np_params = ref
    batch = {"tokens": BATCHES[0]}
    if variant == "mask":
        batch["mask"] = MASK
    kw = {"loss_chunk": 16} if variant == "chunk" else {}
    jcfg = dataclasses.replace(jcfg, **kw)
    want, jgrads = jax.value_and_grad(jgpt.loss_fn)(
        jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    loss, grads = _port_loss_and_grads(np_params, batch, _tcfg(**kw))
    assert abs(loss - float(want)) <= LOSS_ATOL
    _grads_close(grads, _flat(jgrads))


@pytest.fixture(scope="module")
def ref_steps(ref):
    """The reference's train step (one compile), three steps from
    init's params: the state before the first step and after each."""
    jcfg = ref[0]
    init_fn, step_fn = jtraining.make_train_step(
        jcfg, make_mesh(devices=jax.devices()[:1]))
    state = init_fn(jax.random.PRNGKey(0))
    snaps = [{"params": jax.tree.map(np.asarray, state["params"])}]
    for b in BATCHES:
        state, m = step_fn(state, {"tokens": b})
        snaps.append({"params": jax.tree.map(np.asarray, state["params"]),
                      "adam": jax.tree.map(np.asarray, state["opt_state"][0]),
                      "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    return snaps


def _step_matches(state, metrics, snap):
    assert metrics["loss"].dtype == torch.float32
    assert abs(float(metrics["loss"]) - snap["loss"]) <= LOSS_ATOL
    assert float(metrics["grad_norm"]) == pytest.approx(snap["grad_norm"],
                                                        rel=1e-5)
    got = _flat(convert.to_numpy_params(state["params"]))
    for key, want in _flat(snap["params"]).items():
        np.testing.assert_allclose(got[key], want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)


def test_three_train_steps_match_jax(ref_steps):
    cfg = _tcfg()
    init_state, step = training.make_train_step(cfg, device="cpu")
    state = init_state(params=convert.from_jax_params(
        ref_steps[0]["params"], cfg, device="cpu"))
    for i, b in enumerate(BATCHES):
        state, metrics = step(state, {"tokens": b})
        _step_matches(state, metrics, ref_steps[i + 1])
    assert int(state["step"]) == 3


def test_step_resumed_from_jax_state_matches(ref_steps):
    cfg = _tcfg()
    init_state, step = training.make_train_step(cfg, device="cpu")
    state = init_state(params=convert.from_jax_params(
        ref_steps[2]["params"], cfg, device="cpu"))
    state["opt_state"] = convert.from_optax_adamw_state(
        ref_steps[2]["adam"], state["params"], cfg)
    state, metrics = step(state, {"tokens": BATCHES[2]})
    _step_matches(state, metrics, ref_steps[3])


def test_remat_does_not_change_grads(ref):
    np_params = ref[2]
    batch = {"tokens": BATCHES[1]}
    on = _port_loss_and_grads(np_params, batch, _tcfg(remat=True))
    off = _port_loss_and_grads(np_params, batch, _tcfg(remat=False))
    assert on[0] == off[0]
    for key in on[1]:
        np.testing.assert_allclose(on[1][key], off[1][key], atol=1e-7,
                                   rtol=0, err_msg=key)


def test_remat_recomputes_the_forward_attention(ref):
    """Under remat each block's forward runs again in the backward: the
    attention forward is called twice per layer, once without."""
    calls = []
    real = gpt.attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    for remat, want in ((True, 8), (False, 4)):
        calls.clear()
        with mock.patch.object(gpt, "attention", counting):
            _port_loss_and_grads(ref[2], {"tokens": BATCHES[0]},
                                 _tcfg(remat=remat))
        assert len(calls) == want


def test_eval_step_matches_loss_fn(ref):
    cfg = _tcfg()
    params = convert.from_jax_params(ref[2], cfg, device="cpu")
    batch = {"tokens": BATCHES[0]}
    loss = training.make_eval_step(cfg, device="cpu")(params, batch)
    assert not loss.requires_grad
    assert float(loss) == float(gpt.loss_fn(params, batch, cfg,
                                            device="cpu"))


def test_cpu_training_never_reaches_the_kernels(ref):
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    cfg = _tcfg()
    init_state, step = training.make_train_step(cfg, device="cpu")
    state = init_state(seed=0)
    _kernels.reset_launch_counts()
    with mock.patch.multiple(_kernels, flash_fwd=refuse, flash_bwd=refuse,
                             flash_bwd_dkv=refuse, flash_bwd_dq=refuse):
        state, m = step(state, {"tokens": BATCHES[0]})
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert set(_kernels.launch_counts().values()) == {0}


def test_unported_options_and_missing_device_raise():
    """``remat_policy="dots"`` runs (the same loss as "full"); an unknown
    policy and a mesh that is not a DeviceMesh raise."""
    cfg = _tcfg()
    params = gpt.init(cfg, seed=0, device="cpu")
    batch = {"tokens": BATCHES[0]}
    dots = gpt.loss_fn(params, batch, _tcfg(remat_policy="dots"),
                       device="cpu")
    assert torch.equal(dots, gpt.loss_fn(params, batch, cfg, device="cpu"))
    with pytest.raises(ValueError, match="remat_policy"):
        with torch.enable_grad():
            gpt.loss_fn(params, batch, _tcfg(remat_policy="some"),
                        device="cpu")
    for call in (lambda: gpt.loss_fn(params, batch, cfg, device="cpu",
                                     mesh=object()),
                 lambda: training.make_train_step(cfg, mesh=object()),
                 lambda: training.make_eval_step(cfg, mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            training.make_train_step(cfg)
