"""PyTorch port ops against the JAX reference: attention (the flash
kernel's plain version vs the Pallas kernel in interpret mode, the
blockwise and naive paths, the dispatcher) and layer math.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f32 at atol 1e-5 (summation order only); bf16 compared in
f32 at atol 2e-2 (a bf16 ulp of the outputs, which round differently
in the two frameworks' matmuls).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu import ops as jops
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import _kernels

torch.set_num_threads(1)

F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _qkv(seed=0, b=1, h=2, sq=128, sk=None, d=32):
    rng = np.random.RandomState(seed)
    sk = sq if sk is None else sk
    return (rng.randn(b, h, sq, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32))


def _t(*arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _j(*arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def _close(a, b, atol):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# flash attention: plain version vs the Pallas kernel (interpret mode)


FLASH_CASES = [
    # (causal, sq, sk, q_offset)
    (False, 128, 128, 0),
    (True, 128, 128, 0),
    (False, 64, 192, 0),
    (True, 64, 192, 128),     # rectangular causal, bottom-right anchor
]


@pytest.mark.parametrize("causal,sq,sk,q_offset", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret_f32(causal, sq, sk, q_offset):
    q, k, v = _qkv(sq=sq, sk=sk)
    ref_o, ref_l = jops.flash_attention_with_lse(
        *_j(q, k, v), causal, None, 64, 64, True, q_offset)
    out, lse = tops.flash_attention_plain(*_t(q, k, v), causal=causal,
                                          q_offset=q_offset, with_lse=True)
    assert lse.shape == (1, 2, sq) and lse.dtype == torch.float32
    _close(out, ref_o, F32_ATOL)
    _close(lse, ref_l, F32_ATOL)
    # the dispatcher takes the plain version for CPU tensors
    out2, lse2 = tops.flash_attention_with_lse(*_t(q, k, v), causal=causal,
                                               q_offset=q_offset)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_pallas_interpret_bf16(causal):
    q, k, v = _qkv(seed=1)
    ref = jops.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), causal,
                               None, 64, 64, True)
    out = tops.flash_attention_plain(*_t(q, k, v, dtype=torch.bfloat16),
                                     causal=causal)
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(ref.astype(jnp.float32)), BF16_ATOL)


def test_flash_plain_ragged_length_matches_reference():
    # any length: the kernel (and its plain version) mask the ragged
    # edge where the TPU path needs 128-multiples
    q, k, v = _qkv(seed=2, sq=100, d=16)
    ref = jops.mha_reference(*_j(q, k, v), causal=True)
    out = tops.flash_attention(*_t(q, k, v), causal=True)
    _close(out, ref, F32_ATOL)


def test_flash_causal_rectangular_needs_offset():
    q, k, v = _qkv(sq=64, sk=128)
    with pytest.raises(ValueError, match="q_offset"):
        tops.flash_attention(*_t(q, k, v), causal=True)
    with pytest.raises(ValueError, match="q_offset"):
        tops.flash_attention(*_t(q, k, v), causal=True, q_offset=-1)


def test_cpu_tensors_never_reach_the_kernel():
    _kernels.reset_launch_counts()
    q, k, v = _t(*_qkv(sq=64))
    tops.attention(q, k, v, causal=True)
    assert _kernels.FLASH_FWD.launches == 0
    with pytest.raises(ValueError, match="cuda"):
        _kernels.flash_fwd(q, k, v, causal=True, scale=0.25)


# ---------------------------------------------------------------------------
# naive + blockwise + dispatcher


@pytest.mark.parametrize("causal,sq,sk", [(False, 64, 64), (True, 64, 64),
                                          (True, 32, 96), (False, 32, 96)])
def test_mha_reference_matches_jax(causal, sq, sk):
    q, k, v = _qkv(seed=3, sq=sq, sk=sk)
    ref = jops.mha_reference(*_j(q, k, v), causal=causal)
    _close(tops.mha_reference(*_t(q, k, v), causal=causal), ref, F32_ATOL)


@pytest.mark.parametrize("causal,sq,sk,block,q_offset", [
    (False, 128, 128, 32, 0), (True, 128, 128, 32, 0),
    (True, 96, 96, 40, 0), (True, 32, 96, 32, 64)])
def test_blockwise_matches_jax(causal, sq, sk, block, q_offset):
    q, k, v = _qkv(seed=4, sq=sq, sk=sk)
    ref = jops.blockwise_attention(*_j(q, k, v), causal=causal,
                                   block_k=block, q_offset=q_offset)
    out = tops.blockwise_attention(*_t(q, k, v), causal=causal,
                                   block_k=block, q_offset=q_offset)
    _close(out, ref, F32_ATOL)


def test_blockwise_bf16_matches_jax():
    q, k, v = _qkv(seed=5)
    ref = jops.blockwise_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                                   causal=True, block_k=32)
    out = tops.blockwise_attention(*_t(q, k, v, dtype=torch.bfloat16),
                                   causal=True, block_k=32)
    _close(out, np.asarray(ref.astype(jnp.float32)), BF16_ATOL)


@pytest.mark.parametrize("causal,sq,sk", [(True, 128, 128),
                                          (True, 64, 128),
                                          (False, 64, 128)])
def test_attention_dispatcher_matches_jax(causal, sq, sk):
    q, k, v = _qkv(seed=6, sq=sq, sk=sk)
    ref = jops.attention(*_j(q, k, v), causal=causal,
                         impl="pallas_interpret", block_q=64, block_k=64)
    _close(tops.attention(*_t(q, k, v), causal=causal), ref, F32_ATOL)


def test_attention_causal_sq_gt_sk_raises():
    q, k, v = _qkv(sq=128, sk=64)
    with pytest.raises(ValueError, match="sq"):
        tops.attention(*_t(q, k, v), causal=True)


# ---------------------------------------------------------------------------
# layers


def _x(seed=7, shape=(2, 5, 64), scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def test_rms_norm_matches_jax():
    x, w = _x(), _x(8, (64,))
    _close(tops.rms_norm(*_t(x, w)), jops.rms_norm(*_j(x, w)), F32_ATOL)


def test_layer_norm_population_variance():
    # a large mean and few features make the unbiased variance visibly
    # different from the population variance the reference uses
    x = _x(shape=(3, 4), scale=2.0, shift=5.0)
    w, b = _x(9, (4,)), _x(10, (4,))
    ref = jops.layer_norm(*_j(x, w, b))
    out = tops.layer_norm(*_t(x, w, b))
    _close(out, ref, F32_ATOL)
    x32 = torch.from_numpy(x)
    biased = ((x32 - x32.mean(-1, keepdim=True))
              * torch.rsqrt(x32.var(-1, keepdim=True) + 1e-5)
              * torch.from_numpy(w) + torch.from_numpy(b))
    assert (biased - out).abs().max() > 1e-2


def test_layer_norm_bf16_matches_jax():
    x, w, b = _x(), _x(8, (64,)), _x(9, (64,))
    ref = jops.layer_norm(jnp.asarray(x, jnp.bfloat16), *_j(w, b))
    out = tops.layer_norm(torch.from_numpy(x).bfloat16(), *_t(w, b))
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(ref.astype(jnp.float32)), BF16_ATOL)


def test_rope_matches_jax():
    cos_j, sin_j = jops.rope_table(32, 16)
    cos_t, sin_t = tops.rope_table(32, 16)
    _close(cos_t, cos_j, F32_ATOL)
    _close(sin_t, sin_j, F32_ATOL)
    x = _x(shape=(2, 3, 8, 16))
    _close(tops.apply_rope(torch.from_numpy(x), cos_t, sin_t),
           jops.apply_rope(jnp.asarray(x), cos_j, sin_j), F32_ATOL)
    pos = np.array([3, 9, 17, 31, 0, 1, 2, 5])
    _close(tops.apply_rope(torch.from_numpy(x), cos_t, sin_t,
                           positions=torch.from_numpy(pos)),
           jops.apply_rope(jnp.asarray(x), cos_j, sin_j,
                           positions=jnp.asarray(pos)), F32_ATOL)


def test_gelu_mlp_is_tanh_gelu():
    x = _x(shape=(2, 5, 16))
    w_in, b_in = _x(11, (16, 32)), _x(12, (32,))
    w_out, b_out = _x(13, (32, 16)), _x(14, (16,))
    from ray_tpu.ops.layers import gelu_mlp as jgelu_mlp

    ref = jgelu_mlp(*_j(x, w_in, b_in, w_out, b_out))
    out = tops.gelu_mlp(*_t(x, w_in, b_in, w_out, b_out))
    _close(out, ref, 1e-4)
    xt, wi, bi, wo, bo = _t(x, w_in, b_in, w_out, b_out)
    erf = torch.nn.functional.gelu(xt @ wi + bi) @ wo + bo
    assert (erf - out).abs().max() > 1e-4


def test_swiglu_matches_jax():
    x = _x(shape=(2, 5, 16))
    wg, wu, wd = _x(15, (16, 32)), _x(16, (16, 32)), _x(17, (32, 16))
    _close(tops.swiglu(*_t(x, wg, wu, wd)), jops.swiglu(*_j(x, wg, wu, wd)),
           1e-4)
