"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without an NVIDIA GPU every test skips.  This
file imports no JAX, so it also runs where only PyTorch is installed:

    RAY_TPU_TEST_REAL_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda -n 0

(the variable keeps tests/conftest.py from pinning JAX to the CPU).
Tolerances: bf16 outputs within one bf16 ulp (4e-3 + 2^-7*|ref|), f32
outputs and lse at 1e-4 (summation order).  The backward kernels' dq,
dk, dv are held to the same limits against their plain version.
"""

import concurrent.futures

import pytest
import torch

from ray_tpu_torch.ops import (_kernels, flash_attention,
                               flash_attention_bwd_plain,
                               flash_attention_plain, flash_bwd_di)

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
    # inputs that require grad are taken (the autograd Function hands
    # them over); the kernel records no graph
    w = q.float().requires_grad_()
    out, _ = _kernels.flash_fwd(w, w, w, causal=False, scale=1.0)
    assert not out.requires_grad


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


BWD_CASES = [
    # (dtype, causal, sq, sk, d, q_offset, with_dlse)
    (torch.bfloat16, True, 256, 256, 64, 0, False),
    (torch.bfloat16, False, 200, 200, 64, 0, False),
    (torch.bfloat16, True, 64, 256, 128, 192, False),
    (torch.bfloat16, True, 1, 300, 16, 299, False),
    (torch.bfloat16, True, 64, 256, 64, 64, False),   # keys no row sees
    (torch.bfloat16, True, 100, 100, 64, 0, True),
    (torch.float32, True, 130, 130, 32, 0, False),
    (torch.float32, False, 70, 33, 96, 0, True),
]


def _bwd_inputs(gpu, dtype, causal, sq, sk, d, q_offset, with_dlse):
    g = torch.Generator(device=gpu).manual_seed(1)
    q, do = (torch.randn(2, 3, sq, d, generator=g, device=gpu).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 3, sk, d, generator=g, device=gpu).to(dtype)
            for _ in range(2))
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5,
                                q_offset=q_offset, with_lse=True)
    dlse = (torch.randn(2, 3, sq, generator=g, device=gpu) if with_dlse
            else None)
    return q, k, v, o, lse, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,sq,sk,d,q_offset,with_dlse",
                         BWD_CASES)
def test_flash_bwd_kernels_match_plain(gpu, dtype, causal, sq, sk, d,
                                       q_offset, with_dlse):
    q, k, v, o, lse, do, dlse = _bwd_inputs(gpu, dtype, causal, sq, sk, d,
                                            q_offset, with_dlse)
    before = (_kernels.FLASH_BWD_DKV.launches, _kernels.FLASH_BWD_DQ.launches)
    got = _kernels.flash_bwd(q, k, v, do, lse, flash_bwd_di(o, do, dlse),
                             causal=causal, scale=d ** -0.5,
                             q_offset=q_offset)
    assert (_kernels.FLASH_BWD_DKV.launches,
            _kernels.FLASH_BWD_DQ.launches) == (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, dlse,
                                     causal=causal, scale=d ** -0.5,
                                     q_offset=q_offset)
    torch.cuda.synchronize()
    atol, rtol = BF16_TOL if dtype == torch.bfloat16 else (1e-4, 1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs()
        assert (err <= atol + rtol * b.float().abs()).all(), (name, err.max())
    if causal and q_offset + sq < sk:
        # keys past the last row's position get no gradient
        assert not got[1][:, :, q_offset + sq:].any()
        assert not got[2][:, :, q_offset + sq:].any()


@pytest.mark.cuda
def test_flash_attention_grad_runs_the_kernels(gpu):
    """Through the autograd Function: K1 once, K2 and K3 once each, and
    the grads are the kernels' own (a transposed do is made
    contiguous)."""
    q, k, v, o, lse, do, _ = _bwd_inputs(gpu, torch.bfloat16, True, 128,
                                         128, 64, 0, False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _kernels.reset_launch_counts()
    out = flash_attention(*leaves, causal=True)
    out.transpose(1, 2).backward(do.transpose(1, 2))
    assert _kernels.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 1,
                                        "flash_bwd_dq": 1}
    want = _kernels.flash_bwd(q, k, v, do, lse, flash_bwd_di(o, do),
                              causal=True, scale=64 ** -0.5)
    for a, b in zip(leaves, want):
        assert torch.equal(a.grad, b)


@pytest.mark.cuda
def test_flash_bwd_rejects_what_it_does_not_take(gpu):
    q, k, v, o, lse, do, _ = _bwd_inputs(gpu, torch.bfloat16, True, 64, 64,
                                         64, 0, False)
    di = flash_bwd_di(o, do)
    kw = dict(causal=True, scale=0.125)
    with pytest.raises(ValueError, match="lse"):
        _kernels.flash_bwd(q, k, v, do, lse.bfloat16(), di, **kw)
    with pytest.raises(ValueError, match="di"):
        _kernels.flash_bwd(q, k, v, do, lse, di[..., :32].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.flash_bwd(q, k, v, do.transpose(2, 3), lse, di, **kw)
    with pytest.raises(ValueError, match="disagree"):
        _kernels.flash_bwd(q, k, v, do[:, :, :32].contiguous(), lse, di,
                           **kw)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.flash_bwd(q, k, v, do.float(), lse, di, **kw)
    with pytest.raises(ValueError, match="head dim"):
        h = q[..., :40].contiguous()
        _kernels.flash_bwd(h, h, h, h, lse, di, **kw)
    with pytest.raises(ValueError, match="cuda"):
        _kernels.flash_bwd(q.cpu(), k, v, do, lse, di, **kw)
