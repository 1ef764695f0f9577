"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without an NVIDIA GPU every test skips.  This
file imports no JAX, so it also runs where only PyTorch is installed:

    RAY_TPU_TEST_REAL_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda -n 0

(the variable keeps tests/conftest.py from pinning JAX to the CPU).
Tolerances: bf16 outputs within one bf16 ulp (4e-3 + 2^-7*|ref|), f32
outputs and lse at 1e-4 (summation order).  The backward kernels' dq,
dk, dv are held to the same limits against their plain version.  In
bf16, K1, K2 and K3 run on the tensor cores (mma.sync, which sums in
another order than the plain version's f32 matmuls: the same per-output
limits hold, K2 and K3 forming their large p and ds in the plain
version's order, which peaked-softmax cases drive); the cases cover
every head dim's tile loop (D = 16 to 128,
including 48, 80 and 112) and sequence lengths that are multiples of
neither 16 nor 64 (77, 1).  A bf16 input that is not 16-byte aligned
raises; ptxas reports no spill for the bf16 D = 64 instances, and their
SASS holds HMMA (tensor-core) instructions while no bf16 instance of the
f32 CUDA-core kernels is built.  The
quantize kernels K4-K6 are held to their plain versions bitwise: int8
values, scales and f32 sums all equal, K5 and K6 also at the edges of
their 16-wide vector body (ragged tails, blocks 16 to 4096, and the
inputs it does not take: a block of 24, q one byte into its buffer,
which run the per-element body in the same launch), K4 at every block
its warp tile takes (16 to 512) and at blocks it does not (48, 100,
4096), f32 and bf16, both scale rules, deterministic and stochastic, x at
an unaligned offset, row-strided chunks whose tiles cross rows, and a NaN
and an inf block side by side in one tile; and so is K7, the fused
reduce-scatter, in its one-card loopback launch (every rank of a group in
one cooperative launch) against its plain version and the staged K4 ->
K6 path, at blocks 256/128/32/100 with sub a whole number of tiles or
not (the per-element tail).
"""

import concurrent.futures

import pytest
import torch

from ray_tpu_torch.ops import (_kernels, flash_attention,
                               flash_attention_bwd_plain,
                               flash_attention_plain, flash_bwd_di)
from ray_tpu_torch.ops import quantize as qz

torch.set_num_threads(1)

BF16_TOL = (4e-3, 2.0 ** -7)

KERNEL_CASES = [
    # (dtype, causal, sq, sk, d, with_lse)
    (torch.bfloat16, True, 256, 256, 64, True),
    (torch.bfloat16, False, 200, 200, 64, False),
    (torch.bfloat16, True, 64, 256, 128, True),
    (torch.bfloat16, True, 1, 300, 16, True),
    (torch.bfloat16, True, 77, 77, 48, True),
    (torch.bfloat16, False, 77, 1, 80, True),
    (torch.bfloat16, True, 1, 77, 112, True),
    (torch.bfloat16, False, 130, 77, 112, False),
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
    (torch.bfloat16, True, 77, 77, 48, 0, False),
    (torch.bfloat16, False, 77, 1, 80, 0, True),
    (torch.bfloat16, True, 1, 77, 112, 76, False),
    (torch.bfloat16, True, 77, 200, 112, 50, True),   # keys no row sees
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
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dkv_large_p_and_ds_match_plain(gpu, causal):
    """Peaked attention (softmax scale 0.5 on unit-variance q and k) with
    a unit-variance dO gives many entries whose p or ds is large enough
    that a bf16 rounding flip would move dK or dV by more than an output
    ulp; K2 forms those in the plain version's order, so the per-output
    limits hold there too."""
    from ray_tpu_torch.ops.attention import flash_attention_bwd_dkv_plain

    g = torch.Generator(device=gpu).manual_seed(3)
    q, k, v, do = (torch.randn(2, 3, 192, 64, generator=g, device=gpu)
                   .bfloat16() for _ in range(4))
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=0.5,
                                with_lse=True)
    di = flash_bwd_di(o, do)
    got = _kernels.flash_bwd_dkv(q, k, v, do, lse, di, causal=causal,
                                 scale=0.5)
    want = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal, 0.5)
    torch.cuda.synchronize()
    atol, rtol = BF16_TOL
    for name, a, b in zip(("dk", "dv"), got, want):
        err = (a.float() - b.float()).abs()
        assert (err <= atol + rtol * b.float().abs()).all(), (name, err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dq_large_p_and_ds_match_plain(gpu, causal):
    """The same peaked attention through K3: one ulp of a large ds times
    |k| can move dQ by more than an output ulp, so K3 forms those entries
    in the plain version's order too and dQ holds the per-output
    limits."""
    from ray_tpu_torch.ops.attention import flash_attention_bwd_dq_plain

    g = torch.Generator(device=gpu).manual_seed(3)
    q, k, v, do = (torch.randn(2, 3, 192, 64, generator=g, device=gpu)
                   .bfloat16() for _ in range(4))
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=0.5,
                                with_lse=True)
    di = flash_bwd_di(o, do)
    got = _kernels.flash_bwd_dq(q, k, v, do, lse, di, causal=causal,
                                scale=0.5)
    want = flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal, 0.5)
    torch.cuda.synchronize()
    atol, rtol = BF16_TOL
    err = (got.float() - want.float()).abs()
    assert (err <= atol + rtol * want.float().abs()).all(), err.max()


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
    assert _kernels.launch_counts() == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1, "quantize": 0,
        "dequantize": 0, "dequantize_accumulate": 0,
        "fused_reduce_scatter": 0}
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


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["flash_fwd", "flash_bwd_dkv",
                                   "flash_bwd_dq"])
def test_flash_kernels_reject_unaligned_bf16(gpu, entry):
    """A contiguous bf16 view at an odd element offset is not 16-byte
    aligned: the wrapper raises rather than copy it."""
    shape = (1, 2, 64, 64)
    buf = torch.randn(2 * 64 * 64 + 1, device=gpu).to(torch.bfloat16)
    odd = buf[1:].view(shape)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    ok = torch.randn(shape, device=gpu).to(torch.bfloat16)
    rows = torch.zeros(1, 2, 64, device=gpu)
    kernel = getattr(_kernels, entry.upper())
    before = kernel.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        if entry == "flash_fwd":
            _kernels.flash_fwd(ok, odd, ok, causal=True, scale=0.125)
        else:
            getattr(_kernels, entry)(ok, ok, ok, odd, rows, rows,
                                     causal=True, scale=0.125)
    assert kernel.launches == before


@pytest.mark.cuda
def test_flash_bf16_kernels_run_on_the_tensor_cores(gpu):
    """ptxas reports no spill for the bf16 D = 64 instances of K1, K2 and
    K3 (the main path's head dim); every bf16 instance holds HMMA
    instructions; the f32 CUDA-core kernels have no bf16 instance."""
    for kernel, fn, old in (
            (_kernels.FLASH_FWD, "flash_fwd_mma_kernel", "flash_fwd_kernel"),
            (_kernels.FLASH_BWD_DKV, "flash_bwd_dkv_mma_kernel",
             "flash_bwd_dkv_kernel"),
            (_kernels.FLASH_BWD_DQ, "flash_bwd_dq_mma_kernel",
             "flash_bwd_dq_kernel")):
        _kernels.build([kernel])
        entries = _kernels.ptxas_entries(kernel)
        d64 = [e for name, e in entries.items() if f"{fn}ILi64E" in name]
        assert len(d64) == 1, entries
        assert d64[0]["spill_bytes"] == 0, d64
        hmma = _kernels.sass_opcode_counts(kernel, "HMMA")
        mine = {n: c for n, c in hmma.items() if fn in n}
        assert len(mine) == 8 and all(c > 0 for c in mine.values()), hmma
        assert not [n for n in hmma if f"{old}I13__nv_bfloat16" in n], hmma


QUANT_CASES = [
    # (dtype, shape, block)
    (torch.float32, (1 << 20,), 256),       # a 4 MiB gradient bucket
    (torch.float32, (1 << 20,), 32),        # its requantize block
    (torch.float32, (10, 100), 256),        # tail not a block multiple
    (torch.float32, (5000,), 100),
    (torch.float32, (4097,), 4096),
    (torch.float32, (7,), 1),
    (torch.bfloat16, (5000,), 256),
    (torch.bfloat16, (3, 1000), 16),
] + [
    # K4's warp tile (512 f32 or 1024 bf16 elements) at every block it
    # takes, the per-element body at blocks it does not (48, 100, 4096);
    # 70,001 elements are not a whole number of tiles (the tail)
    (dtype, (70_001,), block) for dtype in (torch.float32, torch.bfloat16)
    for block in (16, 32, 64, 128, 256, 512, 48, 100, 4096)
]


def _quant_input(gpu, dtype, shape, seed=2):
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=gpu)
    # blocks of very different magnitudes, and an all-zero block
    x = x * torch.logspace(-3, 3, x.numel(), device=gpu).view(shape)
    x.view(-1)[:min(64, x.numel())] = 0
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["divide", "reciprocal"])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype,shape,block", QUANT_CASES)
def test_quantize_kernel_matches_plain(gpu, dtype, shape, block, stochastic,
                                       rule):
    x = _quant_input(gpu, dtype, shape)
    kw = dict(stochastic=stochastic, seed=11,
              reciprocal_scale=rule == "reciprocal")
    before = _kernels.QUANTIZE.launches
    vector = _kernels.QUANTIZE.vector_launches
    q, s = qz.quantize_blockwise(x, block, **kw)
    assert _kernels.QUANTIZE.launches == before + 1
    assert _kernels.QUANTIZE.vector_launches == vector + (
        block in _kernels.QUANTIZE_VECTOR_BLOCKS)
    pq, ps = qz.quantize_blockwise(x, block, impl="plain", **kw)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(s, ps), (s != ps).sum()
    assert torch.equal(q, pq), (q != pq).sum()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernel_at_an_unaligned_offset(gpu, dtype):
    """x 4 (f32) or 2 (bf16) bytes into its buffer: the per-element body,
    the same bits."""
    buf = _quant_input(gpu, dtype, (1 << 16) + 1)
    x = buf[1:]
    assert x.data_ptr() % 16
    vector = _kernels.QUANTIZE.vector_launches
    q, s = qz.quantize_blockwise(x, 256, reciprocal_scale=True)
    assert _kernels.QUANTIZE.vector_launches == vector
    pq, ps = qz.quantize_blockwise(x, 256, impl="plain",
                                   reciprocal_scale=True)
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lo,hi,block", [(512, 1024, 256), (256, 1024, 256),
                                         (32, 1312, 32)])
def test_quantize_kernel_reads_a_row_strided_chunk(gpu, dtype, lo, hi,
                                                   block):
    """The collectives quantize a column slice [world, csz] of [world,
    sub] in place: the same codes as the contiguous copy, with rows of
    whole tiles (512 f32) or not (a tile crossing rows)."""
    x = _quant_input(gpu, dtype, (4, 3 * 512))
    chunk = x[:, lo:hi]
    assert not chunk.is_contiguous()
    before = _kernels.QUANTIZE.launches
    vector = _kernels.QUANTIZE.vector_launches
    q, s = qz.quantize_blockwise(chunk, block, reciprocal_scale=True)
    assert _kernels.QUANTIZE.launches == before + 1
    assert _kernels.QUANTIZE.vector_launches == vector + (
        chunk.data_ptr() % 16 == 0)
    pq, ps = qz.quantize_blockwise(chunk.contiguous(), block, impl="plain",
                                   reciprocal_scale=True)
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_kernel_keeps_nan_and_inf_in_their_blocks(gpu, stochastic):
    """A NaN in one block of 32 and an inf in its neighbour, inside one
    warp tile: the segmented absmax keeps each in its own block (the
    NaN block takes scale 1.0, the inf block inf, the blocks around them
    their own scales)."""
    x = _quant_input(gpu, torch.float32, (4096,))
    x[1024 + 5] = float("nan")
    x[1024 + 32 + 7] = float("inf")
    q, s = qz.quantize_blockwise(x, 32, stochastic=stochastic, seed=3,
                                 reciprocal_scale=True)
    pq, ps = qz.quantize_blockwise(x, 32, impl="plain", stochastic=stochastic,
                                   seed=3, reciprocal_scale=True)
    assert torch.equal(s, ps) and torch.equal(q, pq)
    assert s[32].item() == 1.0 and s[33].item() == float("inf")
    assert torch.isfinite(s[31]) and torch.isfinite(s[34])
    assert s[31].item() != 1.0 and s[34].item() != 1.0


@pytest.mark.cuda
def test_quantize_kernel_nan_and_inf_blocks(gpu):
    """A NaN block fails absmax > 0 and takes scale 1.0, an inf block
    takes scale inf, as the plain version (and the reference)."""
    x = _quant_input(gpu, torch.float32, (1024,))
    x[300] = float("nan")
    x[600] = float("inf")
    q, s = qz.quantize_blockwise(x, 256)
    pq, ps = qz.quantize_blockwise(x, 256, impl="plain")
    assert torch.equal(s, ps)
    assert s[1].item() == 1.0 and s[2].item() == float("inf")
    # a NaN ratio is code 0 (XLA's float -> int8), in both versions
    assert torch.equal(q, pq)
    assert q[300].item() == 0 and q[600].item() == 0


def _at_offset(q, offset):
    """q as a contiguous view ``offset`` bytes into a larger buffer (not
    16-byte aligned for offset 1: the kernels' per-element body)."""
    if not offset:
        return q
    buf = torch.empty(q.numel() + offset, dtype=q.dtype, device=q.device)
    buf[offset:] = q
    return buf[offset:]


# (shape, block, q's storage offset): the vector body at blocks 16 to 4096
# with n not a multiple of 16 (the per-element tail under a 512-output
# tile), and what it does not take (a block of 24, a q one byte into its
# buffer)
DEQUANT_CASES = [((1 << 20,), 256, 0), ((10, 100), 256, 0), ((5000,), 32, 0),
                 ((1_000_003,), 32, 0), ((77,), 16, 0), ((40_000,), 16, 0),
                 ((70_001,), 4096, 0), ((5000,), 24, 0), ((1 << 20,), 256, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block,offset", DEQUANT_CASES)
def test_dequantize_kernel_matches_plain(gpu, dtype, shape, block, offset):
    q, s = qz.quantize_blockwise(_quant_input(gpu, torch.float32, shape),
                                 block, impl="plain")
    q = _at_offset(q, offset)
    before = _kernels.DEQUANTIZE.launches
    vector = _kernels.DEQUANTIZE.vector_launches
    out = qz.dequantize_blockwise(q, s, shape, dtype, block)
    assert _kernels.DEQUANTIZE.launches == before + 1
    assert _kernels.DEQUANTIZE.vector_launches == vector + (
        block % 16 == 0 and not offset)
    want = qz.dequantize_blockwise(q, s, shape, dtype, block, impl="plain")
    assert out.dtype == dtype and out.shape == torch.Size(shape)
    assert torch.equal(out, want)
    err = qz.quantization_error(_quant_input(gpu, dtype, shape), block)
    assert torch.equal(err, qz.quantization_error(
        _quant_input(gpu, dtype, shape), block, impl="plain"))


# (m, block, q's storage offset): the dp step's smallest chunk size, an m
# that is not a whole number of 512-output tiles (the per-element tail),
# blocks 16 to 4096, a block of 24 and a q one byte into its buffer
ACCUM_CASES = [(8192, 256, 0), (1_179_648, 256, 0), (8448, 256, 0),
               (10_240, 16, 0), (8192, 32, 0), (16_384, 4096, 0),
               (12_288, 24, 0), (8192, 256, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("m,block,offset", ACCUM_CASES)
def test_dequantize_accumulate_kernel_matches_plain(gpu, world, mean, m,
                                                    block, offset):
    x = _quant_input(gpu, torch.float32, (world, m))
    q, s = qz.quantize_blockwise(x, block, impl="plain")
    q = _at_offset(q, offset)
    scale = qz.reciprocal(world) if mean else None
    before = _kernels.DEQUANTIZE_ACCUMULATE.launches
    vector = _kernels.DEQUANTIZE_ACCUMULATE.vector_launches
    out = qz.dequantize_accumulate(q, s, world, block, scale=scale)
    assert _kernels.DEQUANTIZE_ACCUMULATE.launches == before + 1
    assert _kernels.DEQUANTIZE_ACCUMULATE.vector_launches == vector + (
        block % 16 == 0 and not offset)
    want = qz.dequantize_accumulate(q, s, world, block, impl="plain",
                                    scale=scale)
    assert out.shape == (m,)
    assert torch.equal(out, want), (out != want).sum()


@pytest.mark.cuda
def test_quantize_kernels_reject_what_they_do_not_take(gpu):
    x = torch.randn(1024, device=gpu)
    with pytest.raises(ValueError, match="block_size"):
        _kernels.quantize(x, 8192)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.quantize(x.half(), 256)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.quantize(x.view(32, 32).t(), 16)
    with pytest.raises(ValueError, match="cuda"):
        _kernels.quantize(x.cpu(), 256)
    q, s = _kernels.quantize(x, 256)
    with pytest.raises(ValueError, match="world"):
        _kernels.dequantize_accumulate(q.repeat(17), s.repeat(17), 17, 256)
    with pytest.raises(ValueError, match="scales"):
        _kernels.dequantize_accumulate(q, s[:2], 1, 256)
    with pytest.raises(ValueError, match="int8"):
        _kernels.dequantize(q.float(), s, 1024, 256, torch.float32)
    with pytest.raises(ValueError, match="JAX package"):
        qz.quantize_blockwise(x, 256, impl="pallas")


# --- K7: the fused reduce-scatter, every rank on one card ------------------


def _fused_inputs(gpu, world, sub, seed=5):
    """[world, world, sub]: rank r's [world, sub] contributions, with a
    NaN block and an inf block."""
    xs = _quant_input(gpu, torch.float32, (world, world, sub), seed)
    xs[0, 0, 7] = float("nan")
    xs[-1, -1, 300] = float("inf")
    return xs


def _staged_loopback(xs, block, scale):
    """Every rank's staged hop on the card: K4 of its rows, the exchange
    as a transpose, K6."""
    world, _, sub = xs.shape
    codes = [qz.quantize_blockwise(xs[r], block, reciprocal_scale=True)
             for r in range(world)]
    out = []
    for d in range(world):
        q = torch.cat([c.view(world, sub)[d] for c, _ in codes])
        s = torch.cat([c.view(world, -1)[d] for _, c in codes])
        out.append(qz.dequantize_accumulate(q, s, world, block, scale=scale))
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("block,sub", [(256, 3 * 2048), (128, 640),
                                       (100, 1000), (32, 4096), (32, 800),
                                       (128, 1536), (256, 1280)])
def test_fused_rs_loopback_matches_plain(gpu, world, mean, block, sub):
    from ray_tpu_torch.collective.peer_memory import PeerBuffers

    xs = _fused_inputs(gpu, world, sub)
    scale = qz.reciprocal(world) if mean else None
    peers = PeerBuffers.loopback(world, gpu)
    try:
        before = _kernels.FUSED_REDUCE_SCATTER.launches
        got = qz.fused_reduce_scatter_loopback(xs, peers, block, scale=scale)
        assert _kernels.FUSED_REDUCE_SCATTER.launches == before + 1
        peers.check()
        want = qz.fused_reduce_scatter_loopback_plain(xs, block, scale=scale)
        staged = _staged_loopback(xs, block, scale)
        assert got.shape == (world, sub)
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), staged.nan_to_num())
    finally:
        peers.close()


@pytest.mark.cuda
def test_fused_rs_reuses_epochs_and_grows(gpu):
    """100 back-to-back calls on one set of buffers (every epoch reuses
    the rows of the one before), with inputs that change each call, then
    a chunk larger than the regions (they grow, the epoch restarts)."""
    from ray_tpu_torch.collective.peer_memory import PeerBuffers

    world, sub = 4, 4096
    peers = PeerBuffers.loopback(world, gpu)
    try:
        xs = _fused_inputs(gpu, world, sub)
        outs, wants = [], []
        for i in range(100):
            x = xs * (1 + i % 7)
            outs.append(qz.fused_reduce_scatter_loopback(x, peers))
            wants.append(_staged_loopback(x, 256, None))
        peers.check()
        assert peers.epoch == 100
        for a, b in zip(outs, wants):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())
        big = _fused_inputs(gpu, world, 1 << 18, seed=9)
        got = qz.fused_reduce_scatter_loopback(big, peers)
        peers.check()
        assert peers.epoch == 1 and peers.data_bytes >= world * (1 << 18)
        assert torch.equal(got.nan_to_num(),
                           _staged_loopback(big, 256, None).nan_to_num())
    finally:
        peers.close()


@pytest.mark.cuda
def test_fused_rs_missing_peer_fails_within_its_bound(gpu):
    """A launch hosting 3 of 4 ranks: rank 3 never arrives, the kernel
    gives up after its timeout and the next call raises."""
    import time

    from ray_tpu_torch.collective.peer_memory import PeerBuffers

    peers = PeerBuffers.loopback(4, gpu, timeout_s=0.5)
    try:
        xs = _fused_inputs(gpu, 4, 1024)[:3]
        t0 = time.perf_counter()
        qz.fused_reduce_scatter_loopback(xs, peers)
        with pytest.raises(RuntimeError, match="did not arrive"):
            peers.check()
        assert time.perf_counter() - t0 < 10
        with pytest.raises(RuntimeError, match="unusable"):
            qz.fused_reduce_scatter_loopback(xs, peers)
    finally:
        peers.close()


@pytest.mark.cuda
def test_fused_rs_rejects_what_it_does_not_take(gpu):
    from ray_tpu_torch.collective.peer_memory import PeerBuffers

    peers = PeerBuffers.loopback(2, gpu)
    try:
        xs = _fused_inputs(gpu, 2, 512)
        with pytest.raises(ValueError, match="float32"):
            _kernels.fused_reduce_scatter(xs.double(), peers, 256)
        with pytest.raises(ValueError, match="multiple"):
            _kernels.fused_reduce_scatter(xs[:, :, :300], peers, 256)
        with pytest.raises(ValueError, match="unit"):
            _kernels.fused_reduce_scatter(xs.transpose(1, 2), peers, 256)
        with pytest.raises(ValueError, match="group of 2"):
            _kernels.fused_reduce_scatter(
                _fused_inputs(gpu, 3, 512), peers, 256)
        with pytest.raises(ValueError, match="world"):
            PeerBuffers.loopback(17, gpu)
    finally:
        peers.close()
    with pytest.raises(RuntimeError, match="peer memory"):
        qz.fused_reduce_scatter(xs[0], None, 256)


@pytest.mark.cuda
def test_fused_rs_builds_with_its_ptxas_report(gpu):
    _kernels.build([_kernels.FUSED_REDUCE_SCATTER])
    log = _kernels.build_log(_kernels.FUSED_REDUCE_SCATTER)
    assert "fused_rs_kernel" in log and "Used" in log, log
    assert "bytes spill" in log


@pytest.mark.cuda
def test_iter_jax_batches_stages_onto_the_card_through_the_copy_stream(gpu):
    """Data's device-fed iterator: 8 host batches (read-only arrays, as
    the shm blocks are) with 2 in flight, through its ring of pinned
    buffers and its copy stream, onto the current card: every batch is
    its host batch bitwise (a torch dtype cast on the host too), and the
    staging counters show all 8 on the copy stream."""
    import numpy as np

    from ray_tpu_torch.data import iterator

    rng = np.random.RandomState(0)
    host = []
    for _ in range(8):
        b = {"tokens": rng.randint(0, 50304, (16, 513)),
             "x": rng.standard_normal((16, 7))}
        for v in b.values():
            v.flags.writeable = False
        host.append(b)
    iterator.reset_staging_counts()
    it = iterator.iter_jax_batches(iter(host), prefetch=2,
                                   dtypes={"x": torch.bfloat16})
    got = list(it)
    assert len(got) == 8
    want_dev = torch.device("cuda", torch.cuda.current_device())
    for h, d in zip(host, got):
        assert d["tokens"].device == want_dev and d["x"].device == want_dev
        assert d["tokens"].dtype == torch.int64
        assert torch.equal(d["tokens"].cpu(), torch.from_numpy(h["tokens"]))
        assert torch.equal(d["x"].cpu(),
                           torch.from_numpy(h["x"]).to(torch.bfloat16))
    per_batch = 16 * 513 * 8 + 16 * 7 * 2
    assert iterator.staging_counts() == {
        "batches": 8, "bytes": 8 * per_batch, "copy_stream_batches": 8}


# -- the flight recorder's CUDA hooks (telemetry/) ----------------------------


@pytest.mark.cuda
def test_fence_waits_for_the_card(gpu):
    """``recorder._fence`` waits for the work queued before it on the
    stream of every card holding a tensor of its argument (a nested
    tree included); a CPU tensor needs no wait."""
    import time

    from ray_tpu_torch.telemetry import recorder

    x = torch.ones(16, device=gpu)
    y = x * 2                                  # load the kernel first
    torch.cuda.synchronize()
    recorder._fence(x)
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1 << 30)                 # ~0.5 s of spinning
    end.record()
    y = x * 2                                  # queued behind the sleep
    t0 = time.perf_counter()
    recorder._fence({"out": [y], "cpu": torch.ones(2), "n": 3})
    waited = time.perf_counter() - t0
    assert end.query() and torch.cuda.current_stream().query()
    assert waited >= 0.5 * start.elapsed_time(end) / 1e3, waited
    t0 = time.perf_counter()
    recorder._fence(torch.ones(4))             # CPU: nothing to wait for
    assert time.perf_counter() - t0 < 0.01


@pytest.mark.cuda
def test_census_counts_a_cuda_tensor_once(gpu):
    """The census walk counts a CUDA storage once, through any number of
    views, attributes it to the largest tensor over it, and reports the
    allocator's counters beside it."""
    import gc

    from ray_tpu_torch.telemetry import device as devtel

    census = devtel.DeviceMemoryCensus()
    gc.collect()
    torch.cuda.synchronize()
    base = census.census()["live"]["total_bytes"]
    t = torch.empty(1 << 20, device=gpu)       # 4 MiB
    views = [t[10:], t.view(1024, 1024), t[::2]]
    live = census.census()["live"]
    assert live["total_bytes"] - base == 4 << 20
    (slot,) = [s for s in live["top_shapes"] if s["shape"] == [1 << 20]]
    assert slot["count"] >= 1 and slot["dtype"] == "float32"
    assert not any(s["shape"] in ([1024, 1024], [(1 << 20) - 10])
                   for s in live["top_shapes"])
    card = live["allocator"][f"cuda:{gpu.index or 0}"]
    assert card["allocated_bytes"] >= 4 << 20
    assert card["reserved_bytes"] >= card["allocated_bytes"]
    del views, t


@pytest.mark.cuda
def test_profiled_allreduce_on_cuda_equals_unprofiled(gpu):
    """``mesh_allreduce(profile=True)`` on the kernels (a one-rank NCCL
    group) gives the unprofiled bits, launches K4 twice and K6 and K5
    once each, and fills the three buckets."""
    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective import nccl_group as ng
    from ray_tpu_torch.telemetry import recorder

    col.init_collective_group(1, 0, backend="nccl", group_name="prof1")
    try:
        pg = col.get_group_handle("prof1").pg
        g = torch.Generator(device="cpu").manual_seed(5)
        x = (torch.randn(1 << 20, generator=g)
             * torch.randn(1 << 20, generator=g).exp()).to(gpu)
        for op in ("sum", "mean"):
            want = ng.mesh_allreduce(x, pg, op=op, compression="int8")
            before = _kernels.launch_counts()
            timer = recorder.StepTimer()
            recorder.set_current_timer(timer)
            try:
                timer.step_start(0)
                got = ng.mesh_allreduce(x, pg, op=op, compression="int8",
                                        profile=True)
                rec = timer.step_end(0, fence=got)
            finally:
                recorder.set_current_timer(None)
            after = _kernels.launch_counts()
            assert torch.equal(got, want)
            assert {k: after[k] - before[k] for k in after} == {
                "flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                "quantize": 2, "dequantize": 1,
                "dequantize_accumulate": 1, "fused_reduce_scatter": 0}
            for stage in ("quantize", "transfer", "dequantize"):
                assert rec["phases"][f"collective.{stage}"] > 0, rec
    finally:
        col.destroy_collective_group("prof1")


# -- meshes and the ring ----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4),
                                        (torch.bfloat16, 2e-2)])
def test_ring_kernel_body_matches_scan_on_the_card(gpu, dtype, atol):
    """Every rank of a four-rank causal ring on one card: the kernel body
    (K1 per unmasked chunk, K2/K3 in its backward) against the same
    ring's scan body, values and grads; n(n+1)/2 = 10 K1 launches
    forward, 10 K2 and 10 K3 backward."""
    from ray_tpu_torch.ops.ring_attention import ring_simulate

    g = torch.Generator(device="cpu").manual_seed(3)
    q, k, v, cot = (torch.randn((2, 4, 512, 64), generator=g).to(gpu, dtype)
                    for _ in range(4))

    def run(impl):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        _kernels.reset_launch_counts()
        out = ring_simulate(*ts, 4, causal=True, impl=impl)
        fwd = dict(_kernels.launch_counts())
        (out.float() * cot.float()).sum().backward()
        return out.float(), [t.grad.float() for t in ts], fwd, \
            dict(_kernels.launch_counts())

    out, grads, fwd, both = run("pallas")
    ref, g_ref, _, none = run("xla")
    assert fwd["flash_fwd"] == 10 and fwd["flash_bwd_dq"] == 0
    assert both["flash_bwd_dkv"] == 10 and both["flash_bwd_dq"] == 10
    assert set(none.values()) == {0}
    assert (out - ref).abs().max().item() <= atol
    for a, b in zip(grads, g_ref):
        assert (a - b).abs().max().item() <= atol * 5


@pytest.mark.cuda
def test_world_one_mesh_step_is_bitwise_the_unsharded_step(gpu):
    """Three AdamW steps of GPT nano (bf16) over a mesh whose every axis
    is 1 are the unsharded step's, bit for bit: no collective runs."""
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import make_mesh

    cfg = gpt.GPTConfig.nano()
    g = torch.Generator(device="cpu").manual_seed(50)
    batches = [torch.randint(0, 256, (4, 65), generator=g).to(gpu)
               for _ in range(3)]

    def run(mesh):
        init, step = (training.make_train_step(cfg) if mesh is None
                      else training.make_train_step(cfg, mesh))
        state = init(seed=0)
        losses = [float(step(state, {"tokens": b})[1]["loss"])
                  for b in batches]
        return losses, {k: (t.to_local() if mesh is not None else t)
                        .detach().cpu() for k, t in
                        training.param_leaves(state["params"])}

    a, pa = run(None)
    b, pb = run(make_mesh())
    assert a == b
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.cuda
def test_remat_dots_is_bitwise_full_on_the_card(gpu):
    """``remat_policy="dots"`` (the weight matmuls' outputs saved, the
    rest, K1 included, recomputed) gives "full"'s steps bit for bit on
    the kernels."""
    import dataclasses

    from ray_tpu_torch.models import gpt, training

    cfg = gpt.GPTConfig.nano()
    g = torch.Generator(device="cpu").manual_seed(51)
    batches = [torch.randint(0, 256, (4, 65), generator=g).to(gpu)
               for _ in range(2)]

    def run(policy):
        init, step = training.make_train_step(
            dataclasses.replace(cfg, remat_policy=policy))
        state = init(seed=0)
        _kernels.reset_launch_counts()
        losses = [float(step(state, {"tokens": b})[1]["loss"])
                  for b in batches]
        return losses, _kernels.launch_counts(), {
            k: t.detach().cpu() for k, t in
            training.param_leaves(state["params"])}

    a, na, pa = run("full")
    b, nb, pb = run("dots")
    assert a == b and na == nb and na["flash_fwd"] == 2 * 2 * cfg.n_layers
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def _pipeline_case(gpu):
    import numpy as np

    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.nano()          # bf16 compute, f32 params, remat
    batch = {"tokens": np.random.RandomState(52).randint(0, 256, (8, 65))}
    return cfg, gpt.init(cfg, seed=0, device=gpu), batch


def _pipeline_run(cfg, params, batch, schedule="1f1b"):
    from ray_tpu_torch.parallel.mpmd import MPMDPipeline, PipelineConfig

    pcfg = PipelineConfig(stages=2, schedule=schedule, microbatches=4)
    with MPMDPipeline(cfg, pcfg, params=params) as pipe:
        res = pipe.step(batch, apply_update=False, return_grads=True)
    return res


def _plain_model_attention(q, k, v, causal=False):
    from ray_tpu_torch.ops.attention import _flash

    sq, sk = q.shape[-2], k.shape[-2]
    return _flash(q, k, v, causal, None, (sk - sq) if causal else 0, False,
                  plain=True)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["1f1b", "zb"])
def test_pipeline_stages_run_k1_k3_against_plain(gpu, schedule):
    """Two MPMD stages on the card: every stage launches K1, K2 and K3
    (K1 again in each backward, which rebuilds the stage forward), and
    the loss and grads agree with the same pipeline over the kernels'
    plain versions."""
    from unittest import mock

    from ray_tpu_torch.models import gpt, training

    cfg, params, batch = _pipeline_case(gpu)
    got = _pipeline_run(cfg, params, batch, schedule)
    with mock.patch.object(gpt, "attention", _plain_model_attention):
        want = _pipeline_run(cfg, params, batch, schedule)
    L, M = cfg.n_layers // 2, 4
    for s, kinds in enumerate(got["launches"]):
        tot = {k: sum(per.get(k, 0) for per in kinds.values())
               for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        halves = 2 if schedule == "zb" and s > 0 else 1
        assert tot == {"flash_fwd": M * L + 2 * M * L * halves,
                       "flash_bwd_dkv": M * L * halves,
                       "flash_bwd_dq": M * L * halves}, (s, kinds)
    assert all(n == 0 for kinds in want["launches"]
               for per in kinds.values() for n in per.values())
    assert abs(got["loss"] - want["loss"]) <= 1e-3 * abs(want["loss"])
    for (k, a), (_, b) in zip(training.param_leaves(got["grads"]),
                              training.param_leaves(want["grads"])):
        cos = torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item()
        assert cos >= 0.999, (k, cos)


@pytest.mark.cuda
def test_bf16_stage_pair_matches_the_unpipelined_step(gpu):
    """A bf16 stage pair (1f1b, M = 4) against loss_fn and its gradients
    on the card: the loss within 1e-3 relative, the global norm within
    1e-2, each leaf's cosine >= 0.999."""
    from ray_tpu_torch.models import gpt, training

    cfg, params, batch = _pipeline_case(gpu)
    got = _pipeline_run(cfg, params, batch)
    leaves = {k: t.detach().clone().requires_grad_()
              for k, t in training.param_leaves(params)}
    tree = {"layers": {k.split(".", 1)[1]: t for k, t in leaves.items()
                       if k.startswith("layers.")},
            **{k: t for k, t in leaves.items() if "." not in k}}
    loss = gpt.loss_fn(tree, batch, cfg)
    loss.backward()
    assert abs(got["loss"] - loss.item()) <= 1e-3 * abs(loss.item())
    g = {k: v.to(gpu) for k, v in training.param_leaves(got["grads"])}
    norm = training.global_norm(list(g.values())).item()
    want = training.global_norm([t.grad for t in leaves.values()]).item()
    assert abs(norm - want) <= 1e-2 * want
    for k, t in leaves.items():
        cos = torch.nn.functional.cosine_similarity(
            g[k].flatten().double(), t.grad.flatten().double(), dim=0).item()
        assert cos >= 0.999, (k, cos)
