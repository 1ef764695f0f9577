"""The port's GPT-2 checkpoint interop (``ray_tpu_torch/models/hf.py``)
against the JAX package's converter and HF's own model.

The cases of tests/test_models_hf.py on the port: a randomly built
``transformers`` GPT-2 (2 layers, width 64, vocab 160, offline) converted
by ``from_hf_gpt2`` gives HF's logits within that file's 2e-3 (f32),
its greedy ``generate`` continues from HF's argmax, the converted
weights serve through the port's Serve (``params_loader`` returning the
(cfg, params) pair, on the CPU) and train (a finite loss and gradient).
Beyond them: the port's tree equals the JAX converter's leaf for leaf,
bitwise, and its config field for field; a state dict with the HF
config's fields as a mapping (with or without the ``transformer.``
prefix) gives the same tree; the reference's refusals stand (a non-tanh
activation, ``scale_attn_by_inverse_layer_idx``,
``reorder_and_upcast_attn``, an epsilon other than 1e-5), and a model
name is refused: it would download weights.
"""

import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")

HF_ATOL = 2e-3   # tests/test_models_hf.py's
HF_KW = dict(n_layer=2, n_head=4, n_embd=64, n_positions=96, vocab_size=160,
             n_inner=None, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX package's programs below go through its process-wide
    compilation ledger; leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule)."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


def _hf_model():
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(
        transformers.GPT2Config(**HF_KW)).eval()


@pytest.fixture(scope="module")
def hf_pair():
    from ray_tpu_torch.models.hf import from_hf_gpt2

    model = _hf_model()
    cfg, params = from_hf_gpt2(model, dtype=torch.float32, device="cpu")
    return model, cfg, params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


# -- the cases of tests/test_models_hf.py -------------------------------------


def test_hf_conversion_logit_parity(hf_pair):
    from ray_tpu_torch.models import gpt

    model, cfg, params = hf_pair
    assert cfg.n_layers == 2 and cfg.attn_bias and cfg.tie_embeddings
    toks = np.random.RandomState(0).randint(0, 160, (3, 17))
    with torch.no_grad():
        want = model(torch.tensor(toks)).logits.numpy()
        got = gpt.apply(params, toks, cfg, device="cpu").numpy()
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=HF_ATOL), \
        f"max err {np.abs(got - want).max()}"


def test_hf_conversion_decode_and_generate(hf_pair):
    """The converted model rides the port's decode path: greedy generate
    continues from HF's argmax logits."""
    from ray_tpu_torch.models import gpt

    model, cfg, params = hf_pair
    prompt = np.random.RandomState(1).randint(0, 160, (2, 9))
    out = gpt.generate(params, cfg, torch.tensor(prompt), 5, max_seq=32,
                       device="cpu")
    assert tuple(out.shape) == (2, 14)
    with torch.no_grad():
        want_next = model(torch.tensor(prompt)).logits[:, -1].argmax(-1)
    assert torch.equal(out[:, 9].cpu(), want_next)


def _loader_of(hf_kw):
    """A params_loader that runs on the replica (pickled by value: the
    replica cannot import this file): it builds the HF model there and
    converts it."""
    def load():
        import torch as t
        import transformers as tf

        from ray_tpu_torch.models.hf import from_hf_gpt2

        t.manual_seed(0)
        model = tf.GPT2LMHeadModel(tf.GPT2Config(**hf_kw)).eval()
        return from_hf_gpt2(model, dtype=t.float32, device="cpu")

    return load


def test_hf_model_serves(hf_pair):
    """HF checkpoint -> the port's LLMServer in one line: the
    params_loader returns from_hf_gpt2's (cfg, params) pair."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve.llm import LLMServer

    _, cfg, params = hf_pair
    rt.init(num_cpus=2)
    try:
        h = serve.run(LLMServer().bind(params_loader=_loader_of(HF_KW),
                                       device="cpu"),
                      name="hf_llm", route_prefix=None)
        got = h.remote({"tokens": [5, 9, 2, 7],
                        "max_new_tokens": 4}).result(timeout_s=180)
        want = gpt.generate(params, cfg, torch.tensor([[5, 9, 2, 7]]), 4,
                            max_seq=16, device="cpu")[0, 4:].tolist()
        assert got["completion"] == want
    finally:
        serve.shutdown()
        rt.shutdown()


def test_hf_conversion_trains(hf_pair):
    """Converted params are ordinary params: the loss and every leaf's
    gradient are finite."""
    from ray_tpu_torch.models import gpt, training

    _, cfg, params = hf_pair
    tree = copy.deepcopy(params)
    leaves = training.param_leaves(tree)
    for _, t in leaves:
        t.requires_grad_()
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 160,
                                                             (4, 33)))
    loss = gpt.loss_fn(tree, {"tokens": toks}, cfg, device="cpu")
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(t.grad).all() for _, t in leaves)


# -- against the JAX package's converter --------------------------------------


def test_tree_equals_the_jax_converter(hf_pair):
    import jax.numpy as jnp

    from ray_tpu.models.hf import from_hf_gpt2 as jconvert

    model, cfg, params = hf_pair
    jcfg, jparams = jconvert(model, dtype=jnp.float32)
    got, want = _flat(params), _flat(jparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for f in ("n_layers", "d_model", "n_heads", "d_head", "d_ff",
              "vocab_size", "max_seq", "norm", "act", "pos",
              "tie_embeddings", "attn_bias"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("prefixed", [True, False])
def test_state_dict_with_config_mapping(hf_pair, prefixed):
    from ray_tpu_torch.models.hf import from_hf_gpt2

    model, cfg, params = hf_pair
    sd = model.state_dict() if prefixed else \
        model.transformer.state_dict()
    sd = {k: v.numpy() for k, v in sd.items()}
    got_cfg, got = from_hf_gpt2(sd, config=model.config.to_dict(),
                                dtype=torch.float32, device="cpu")
    assert got_cfg == cfg
    a, b = _flat(got), _flat(params)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="config"):
        from_hf_gpt2(sd, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("activation_function", "relu"),
    ("scale_attn_by_inverse_layer_idx", True),
    ("reorder_and_upcast_attn", True),
    ("layer_norm_epsilon", 1e-6)])
def test_refusals_match_the_reference(hf_pair, field, value):
    from ray_tpu.models.hf import from_hf_gpt2 as jconvert
    from ray_tpu_torch.models.hf import from_hf_gpt2

    model = hf_pair[0]
    conf = dict(model.config.to_dict(), **{field: value})
    with pytest.raises(NotImplementedError):
        from_hf_gpt2(model.state_dict(), config=conf, device="cpu")

    class Shim:           # the reference's converter reads model.config
        config = transformers.GPT2Config(**conf)

        @staticmethod
        def state_dict():
            return model.state_dict()

    with pytest.raises(NotImplementedError):
        jconvert(Shim())


def test_a_model_name_is_refused():
    from ray_tpu_torch.models.hf import from_hf_gpt2

    with pytest.raises(TypeError, match="download"):
        from_hf_gpt2("gpt2", device="cpu")
