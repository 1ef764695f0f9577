"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without an NVIDIA GPU every test skips.  This
file imports no JAX, so it also runs where only PyTorch is installed:

    RAY_TPU_TEST_REAL_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda -n 0

(the variable keeps tests/conftest.py from pinning JAX to the CPU).
Tolerances: bf16 outputs within one bf16 ulp (4e-3 + 2^-7*|ref|), f32
outputs and lse at 1e-4 (summation order).  The backward kernels' dq,
dk, dv are held to the same limits against their plain version.  The
quantize kernels K4-K6 are held to their plain versions bitwise: int8
values, scales and f32 sums all equal, and so is K7, the fused
reduce-scatter, in its one-card loopback launch (every rank of a group in
one cooperative launch) against its plain version and the staged K4 ->
K6 path.
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
    q, s = qz.quantize_blockwise(x, block, **kw)
    assert _kernels.QUANTIZE.launches == before + 1
    pq, ps = qz.quantize_blockwise(x, block, impl="plain", **kw)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(s, ps), (s != ps).sum()
    assert torch.equal(q, pq), (q != pq).sum()


@pytest.mark.cuda
def test_quantize_kernel_reads_a_row_strided_chunk(gpu):
    """The collectives quantize a column slice [world, csz] of [world,
    sub] in place: the same codes as the contiguous copy."""
    x = _quant_input(gpu, torch.float32, (4, 3 * 512))
    chunk = x[:, 512:1024]
    assert not chunk.is_contiguous()
    before = _kernels.QUANTIZE.launches
    q, s = qz.quantize_blockwise(chunk, 256, reciprocal_scale=True)
    assert _kernels.QUANTIZE.launches == before + 1
    pq, ps = qz.quantize_blockwise(chunk.contiguous(), 256, impl="plain",
                                   reciprocal_scale=True)
    assert torch.equal(q, pq) and torch.equal(s, ps)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block", [((1 << 20,), 256), ((10, 100), 256),
                                         ((5000,), 32)])
def test_dequantize_kernel_matches_plain(gpu, dtype, shape, block):
    q, s = qz.quantize_blockwise(_quant_input(gpu, torch.float32, shape),
                                 block, impl="plain")
    before = _kernels.DEQUANTIZE.launches
    out = qz.dequantize_blockwise(q, s, shape, dtype, block)
    assert _kernels.DEQUANTIZE.launches == before + 1
    want = qz.dequantize_blockwise(q, s, shape, dtype, block, impl="plain")
    assert out.dtype == dtype and out.shape == torch.Size(shape)
    assert torch.equal(out, want)
    err = qz.quantization_error(_quant_input(gpu, dtype, shape), block)
    assert torch.equal(err, qz.quantization_error(
        _quant_input(gpu, dtype, shape), block, impl="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("mean", [False, True])
def test_dequantize_accumulate_kernel_matches_plain(gpu, world, mean):
    x = _quant_input(gpu, torch.float32, (world, 8192))
    q, s = qz.quantize_blockwise(x, 256, impl="plain")
    scale = qz.reciprocal(world) if mean else None
    before = _kernels.DEQUANTIZE_ACCUMULATE.launches
    out = qz.dequantize_accumulate(q, s, world, 256, scale=scale)
    assert _kernels.DEQUANTIZE_ACCUMULATE.launches == before + 1
    want = qz.dequantize_accumulate(q, s, world, 256, impl="plain",
                                    scale=scale)
    assert out.shape == (8192,)
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
                                       (100, 1000)])
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
