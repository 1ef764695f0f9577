"""PyTorch port of the GPT model against the JAX reference: the same
weights (carried by models/convert.py) give the same forward logits and
the same greedy generation, on both recipes (GPT-2: learned positions,
LayerNorm, GELU — the decode fast path; modern: RoPE, RMSNorm, SwiGLU —
the generic decode path).  nano size, f32: logits at atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt

torch.set_num_threads(1)

RECIPES = {
    "learned-ln-gelu": dict(pos="learned", norm="ln", act="gelu"),
    "rope-rms-swiglu": dict(pos="rope", norm="rms", act="swiglu"),
    "gpt2-bias-untied": dict(pos="learned", norm="ln", act="gelu",
                             attn_bias=True, tie_embeddings=False),
}
TOKENS = np.random.RandomState(0).randint(0, 256, (2, 48))


def _pair(recipe):
    kw = RECIPES[recipe]
    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32, **kw)
    tcfg = gpt.GPTConfig.nano(dtype=torch.float32, **kw)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    if kw.get("attn_bias"):
        # the reference inits biases at zero: make them count
        rng = np.random.RandomState(1)
        jparams["layers"] = {
            k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.1)
                if k.endswith("_b") else v)
            for k, v in jparams["layers"].items()}
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=list(RECIPES))
def pair(request):
    return _pair(request.param)


def test_apply_matches_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    ref = np.asarray(jgpt.apply(jparams, jnp.asarray(TOKENS), jcfg))
    out = gpt.apply(tparams, TOKENS, tcfg, device="cpu")
    assert out.shape == (2, 48, 256) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_generate_greedy_token_exact(pair):
    jcfg, jparams, tcfg, tparams = pair
    prompt = TOKENS[:2, :8]
    ref = np.asarray(jgpt.generate(jparams, jcfg, jnp.asarray(prompt), 16))
    out = gpt.generate(tparams, tcfg, prompt, 16, device="cpu")
    assert out.shape == (2, 24)
    assert np.array_equal(out.numpy(), ref)


def test_decode_step_matches_apply(pair):
    """Per-position KV-cache decode logits == the forward's logits."""
    _, _, tcfg, tparams = pair
    toks = torch.from_numpy(TOKENS[:2, :12])
    full = gpt.apply(tparams, toks, tcfg, device="cpu")
    cache = gpt.init_cache(tcfg, 2, 12, device="cpu")
    with torch.no_grad():
        for p in range(12):
            logits, cache = gpt.decode_step(tparams, cache, toks[:, p], tcfg)
            np.testing.assert_allclose(logits.numpy(), full[:, p].numpy(),
                                       atol=1e-4, rtol=0)
    assert cache["pos"] == 12


def test_slot_and_paged_prefill_match_apply():
    """One slot prefilled through the contiguous and the paged caches:
    last-position logits equal the forward's, and the two caches hold
    the same K/V for the prompt."""
    _, _, tcfg, tparams = _pair("learned-ln-gelu")
    prompt = torch.from_numpy(TOKENS[0, :11])
    full = gpt.apply(tparams, prompt[None], tcfg, device="cpu")[0, -1]
    with torch.no_grad():
        slot = gpt.init_slot_cache(tcfg, 2, 32, device="cpu")
        lg_s, slot = gpt.slot_prefill(tparams, slot, prompt, 0, 1, tcfg)
        paged = gpt.init_paged_cache(tcfg, 6, 8, device="cpu")
        ptab_row = torch.tensor([3, 5, 0, 0])
        lg_p, paged = gpt.paged_prefill(tparams, paged, prompt, ptab_row, 0,
                                        tcfg)
    np.testing.assert_allclose(lg_s.numpy(), full.numpy(), atol=1e-4, rtol=0)
    assert torch.equal(lg_s, lg_p)
    kv = paged["k"][:, [3, 5]].permute(0, 2, 1, 3, 4).reshape(
        tcfg.n_layers, tcfg.n_heads, 16, tcfg.d_head)
    assert torch.equal(kv[:, :, :11], slot["k"][:, 1, :, :11])
    assert not paged["k"][:, 0].any()      # null page untouched


def test_copy_page():
    _, _, tcfg, _ = _pair("learned-ln-gelu")
    cache = gpt.init_paged_cache(tcfg, 4, 8, device="cpu")
    cache["k"][:, 2] = 1.5
    cache["v"][:, 2] = -2.0
    gpt.copy_page(cache, 3, 2)
    assert torch.equal(cache["k"][:, 3], cache["k"][:, 2])
    assert torch.equal(cache["v"][:, 3], cache["v"][:, 2])


def test_num_params_and_init_shapes():
    for kw in RECIPES.values():
        jcfg = jgpt.GPTConfig.nano(**kw)
        tcfg = gpt.GPTConfig.nano(**kw)
        assert gpt.num_params(tcfg) == jgpt.num_params(jcfg)
        jshapes = jax.tree.map(lambda a: tuple(a.shape),
                               jgpt.init(jax.random.PRNGKey(0), jcfg))
        tparams = gpt.init(tcfg, seed=0, device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), tparams) == jshapes
    small = gpt.GPTConfig.gpt2_small()
    assert gpt.num_params(small) == jgpt.num_params(
        jgpt.GPTConfig.gpt2_small())


def test_init_is_seeded():
    cfg = gpt.GPTConfig.nano()
    a = gpt.init(cfg, seed=3, device="cpu")
    b = gpt.init(cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    c = gpt.init(cfg, seed=4, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert a["embed"].dtype == torch.float32


def test_convert_rejects_mismatched_tree():
    cfg = gpt.GPTConfig.nano()
    tree = jax.tree.map(np.asarray,
                        jgpt.init(jax.random.PRNGKey(0),
                                  jgpt.GPTConfig.nano()))
    bad = dict(tree, extra=np.zeros(3))
    with pytest.raises(ValueError, match="keys"):
        convert.from_jax_params(bad, cfg, device="cpu")
    bad = dict(tree, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_params(bad, cfg, device="cpu")


def test_bf16_forward_close_to_f32():
    cfg32 = gpt.GPTConfig.nano(dtype=torch.float32)
    cfg16 = gpt.GPTConfig.nano()
    params = gpt.init(cfg32, seed=0, device="cpu")
    a = gpt.apply(params, TOKENS[:1, :32], cfg32, device="cpu")
    b = gpt.apply(params, TOKENS[:1, :32], cfg16, device="cpu")
    assert b.dtype == torch.bfloat16
    assert (a - b.float()).abs().max() < 0.05


def test_sample_logits_recipe():
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(3, 50).astype(np.float32))
    greedy = gpt.sample_logits(logits, None, 0.0)
    assert torch.equal(greedy, logits.argmax(-1))
    a = gpt.sample_logits(logits, 11, 0.7, top_k=4)
    b = gpt.sample_logits(logits, 11, 0.7, top_k=4)
    assert torch.equal(a, b)
    top4 = logits.topk(4, dim=-1).indices
    assert all(a[i] in top4[i] for i in range(3))
    # a row sampled alone draws what row 0 of a batch draws
    rows = gpt.sample_rows(logits[:1], [0.7], [4], [11])
    assert rows[0] == a[0]
    assert gpt.token_key(5, 2) == gpt.token_key(5, 2)
    assert gpt.token_key(5, 2) != gpt.token_key(5, 3)


def test_mesh_and_missing_device_raise():
    """A mesh that is not a DeviceMesh raises; on a world-1 mesh the
    forward is the unsharded one, as a DTensor (the sharded meshes:
    tests/test_torch_mesh_parity.py)."""
    from ray_tpu_torch.parallel import make_mesh, shard_tree

    cfg = gpt.GPTConfig.nano()
    params = gpt.init(cfg, seed=0, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        gpt.apply(params, TOKENS[:1, :8], cfg, device="cpu", mesh=object())
    mesh = make_mesh(device_type="cpu")
    placed = shard_tree(params, gpt.logical_axes(cfg), mesh)
    got = gpt.apply(placed, TOKENS[:1, :8], cfg, mesh=mesh)
    assert torch.equal(got.full_tensor(),
                       gpt.apply(params, TOKENS[:1, :8], cfg, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gpt.apply(params, TOKENS[:1, :8], cfg)
