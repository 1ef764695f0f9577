"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without an NVIDIA GPU every test skips.  This
file imports no JAX, so it also runs where only PyTorch is installed:

    RAY_TPU_TEST_REAL_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda -n 0

(the variable keeps tests/conftest.py from pinning JAX to the CPU).
Tolerances: bf16 outputs within one bf16 ulp (4e-3 + 2^-7*|ref|), f32
outputs and lse at 1e-4 (summation order).
"""

import concurrent.futures

import pytest
import torch

from ray_tpu_torch.ops import _kernels, flash_attention_plain

torch.set_num_threads(1)

BF16_TOL = (4e-3, 2.0 ** -7)

KERNEL_CASES = [
    # (dtype, causal, sq, sk, d, with_lse)
    (torch.bfloat16, True, 256, 256, 64, True),
    (torch.bfloat16, False, 200, 200, 64, False),
    (torch.bfloat16, True, 64, 256, 128, True),
    (torch.bfloat16, True, 1, 300, 16, True),
    (torch.float32, True, 130, 130, 32, True),
    (torch.float32, False, 70, 33, 96, True),
]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,sq,sk,d,with_lse", KERNEL_CASES)
def test_flash_kernel_matches_plain(gpu, dtype, causal, sq, sk, d,
                                    with_lse):
    g = torch.Generator(device=gpu).manual_seed(0)
    q = torch.randn(2, 3, sq, d, generator=g, device=gpu).to(dtype)
    k = torch.randn(2, 3, sk, d, generator=g, device=gpu).to(dtype)
    v = torch.randn(2, 3, sk, d, generator=g, device=gpu).to(dtype)
    qoff = sk - sq if causal else 0
    before = _kernels.FLASH_FWD.launches
    out, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5,
                                  q_offset=qoff, with_lse=with_lse)
    assert _kernels.FLASH_FWD.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=qoff, with_lse=True)
    torch.cuda.synchronize()
    atol, rtol = BF16_TOL if dtype == torch.bfloat16 else (1e-4, 1e-5)
    err = (out.float() - ref.float()).abs()
    assert (err <= atol + rtol * ref.float().abs()).all(), err.max()
    if with_lse:
        assert (lse - ref_lse).abs().max().item() <= 1e-4
    else:
        assert lse is None


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(gpu):
    q = torch.randn(1, 1, 8, 64, device=gpu, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        h = q[..., :40].contiguous()
        _kernels.flash_fwd(h, h, h,
                           causal=False, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3)
        _kernels.flash_fwd(t, t, t, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.flash_fwd(q.half(), q.half(), q.half(), causal=False,
                           scale=1.0)
    with pytest.raises(NotImplementedError, match="forward-only"):
        w = q.float().requires_grad_()
        _kernels.flash_fwd(w, w, w, causal=False, scale=1.0)


@pytest.mark.cuda
def test_flash_kernel_launches_on_the_inputs_device(gpu):
    """The wrapper launches on the inputs' device, whichever device the
    calling thread has current: a fresh thread (as the engine's is),
    with another card current where there is more than one."""
    n = torch.cuda.device_count()
    for i in range(n):
        dev = torch.device("cuda", i)
        g = torch.Generator(device=dev).manual_seed(i)
        q, k, v = (torch.randn(1, 2, 100, 64, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))

        def run():
            torch.cuda.set_device((i + 1) % n)
            return _kernels.flash_fwd(q, k, v, causal=True, scale=64 ** -0.5)

        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            out, _ = ex.submit(run).result()
        ref = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize(dev)
        assert out.device == dev
        atol, rtol = BF16_TOL
        err = (out.float() - ref.float()).abs()
        assert (err <= atol + rtol * ref.float().abs()).all(), err.max()
