"""Block-wise int8 quantization: the compressed-collective building block.

Counterpart of ``ray_tpu/ops/quantize.py`` (its public functions and the
layout contract below).  Each function has a plain PyTorch version
(``*_plain``), the counterpart of the reference's ``impl="xla"`` path, and
a hand-written Hopper kernel (``csrc/quantize.cu`` and
``csrc/fused_rs.cu``, bound in ``ops/_kernels.py``):

  * K4 ``quantize_blockwise``     — per-block absmax, scale, round;
  * K5 ``dequantize_blockwise``   — int8 x scale, written in the output
    dtype;
  * K6 ``dequantize_accumulate``  — the sum over peers of their
    dequantized blocks (the accumulate half of the quantized
    reduce-scatter);
  * K7 ``fused_reduce_scatter``   — the whole reduce-scatter hop in one
    kernel: K4 of every row with the reciprocal scale, each row stored
    straight into its peer's receive region over CUDA peer memory
    (``collective/peer_memory.py``), then K6 of the rows that arrive.
    Its plain version exchanges through the group's ``all_to_all``, so
    it is the staged path's arithmetic, bit for bit.

Dispatch follows ``ops.attention``: a CUDA tensor goes to the kernel, a
CPU tensor to the plain version; ``impl="plain"`` forces the plain
version on any device.

Layout contract (shared with the collectives): an array is flattened,
zero-padded to a multiple of ``block_size``, and viewed as
[nblocks, block_size]; block b covers flat elements
[b*block_size, (b+1)*block_size).  scales[b] = absmax(block b)/127 (1.0
for an all-zero block), values are the clipped rounded ratios in int8.
Zero padding quantizes to exact zeros, so the trailing remainder of a
non-multiple array survives a round trip untouched.

The arithmetic is the reference's, operation for operation: ``1 /
scale`` is an IEEE division, ``y = x * (1/scale)`` one rounded product,
half-to-even rounding (``torch.round``), and the accumulate takes the
peers in order 0..world-1, each as one fused multiply-add onto an f32
sum that starts at zero: ``acc = fma(q[p], s[p], acc)``, as XLA compiles
the reference's ``(q * s).sum(0)`` (its eager, op-by-op call rounds the
product and the sum separately; no path of the port or of the
reference's collectives runs that way).  A block holding NaN has a NaN
absmax, which fails ``absmax > 0``, so its scale is 1.0 as in the
reference; a block holding inf has scale inf.

The reference's ``absmax / 127`` takes one of two values, by where it
runs: called eagerly (and in the numpy codec of ``compression.py``) it
is an IEEE division; inside a jitted program — its collectives, and its
Pallas kernel in interpret mode — XLA rewrites a division by a constant
as the product with the constant's f32 reciprocal.  The two differ in
the last bit of some scales.  ``quantize_blockwise`` divides by default
and takes ``reciprocal_scale=True`` for the product; the collectives
pass it, so they match the reference's compiled collectives bit for bit
while ``quantization_error`` (error feedback's residual) matches its
host codec.  A mean's ``/ world`` after the accumulate is compiled the
same way: ``dequantize_accumulate(scale=reciprocal(world))``.

Stochastic rounding is ``floor(y + u)`` with ``u = (bits >> 8) * 2^-24``
and ``bits`` a counter-based 32-bit hash of (seed, flat element index):
the kernel and the plain version draw the same bits for the same seed.
They are not the TPU's bits (``pltpu.prng_random_bits``), so the
stochastic path is held port against port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

INT8_MAX = 127.0
_M32 = 0xFFFFFFFF
_IMPLS = ("auto", "plain")


def padded_len(n: int, block_size: int) -> int:
    """Smallest multiple of block_size >= n."""
    return n + (-n) % block_size


def num_blocks(n: int, block_size: int) -> int:
    return padded_len(n, block_size) // block_size


# ---------------------------------------------------------------------------
# Stochastic bits: a counter-based hash, the same in the kernel
# ---------------------------------------------------------------------------


def _mix32(x):
    """A 32-bit integer finaliser (``x ^= x >> 16; x *= 0x21f0aaad;
    x ^= x >> 15; x *= 0x735a2d97; x ^= x >> 15`` on uint32), on a Python
    int or an int64 tensor of values in [0, 2^32).  Both multipliers are
    below 2^31, so an int64 product never overflows before the mask."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def stochastic_key(seed: int) -> int:
    """The per-call 32-bit key the bits hash with (``mix32(seed mod
    2^32)``); the wrapper passes it to the kernel."""
    return _mix32(int(seed) & _M32)


def stochastic_bits(index: torch.Tensor, seed: int) -> torch.Tensor:
    """``mix32(mix32(i) ^ key(seed))`` for each flat element index i, as
    int64 in [0, 2^32): the plain version of the kernel's draw."""
    return _mix32(_mix32(index) ^ stochastic_key(seed))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the reference's impl="xla" arithmetic)
# ---------------------------------------------------------------------------


def reciprocal(d: float) -> float:
    """f32(1) / f32(d), rounded once: the constant XLA multiplies by
    where the reference divides by the constant d inside a jitted
    program."""
    return float(np.float32(1.0) / np.float32(d))


def _times(x: torch.Tensor, c: float) -> torch.Tensor:
    """x * c, the f32 constant held in a 0-dim tensor on x's device."""
    return x * torch.full((), c, dtype=x.dtype, device=x.device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fma(a, b, c), rounded once, for a holding int8 values.  a*b
    is exact in f64 (8 + 24 significant bits); the sum is taken in f64
    and rounded to odd (an inexact result with an even last bit steps
    one ulp toward the exact value) before the rounding to f32, which
    makes the two roundings one (53 >= 24 + 2 bits)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)       # exact: s + err == p + c
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(fix, torch.nextafter(s, toward), s).to(torch.float32)


def _as_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flatten + zero-pad to [nblocks, block_size] f32."""
    flat = x.reshape(-1).to(torch.float32)
    pad = padded_len(flat.numel(), block_size) - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, block_size)


def quantize_blockwise_plain(x: torch.Tensor, block_size: int = 256, *,
                             stochastic: bool = False, seed: int = 0,
                             reciprocal_scale: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: (values int8 [npad], scales f32 [nblocks])."""
    blocks = _as_blocks(x, block_size)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scaled = (_times(absmax, reciprocal(INT8_MAX)) if reciprocal_scale
              else _ieee_div(absmax, INT8_MAX))
    scales = torch.where(absmax > 0, scaled, torch.ones_like(absmax))
    # reciprocal-multiply, as the reference: 1/scale is one IEEE
    # division (tensor by tensor, on the CPU and on the card alike)
    y = blocks * (torch.ones_like(scales) / scales)
    if stochastic:
        idx = torch.arange(y.numel(), dtype=torch.int64, device=y.device)
        bits = stochastic_bits(idx, seed).view(y.shape)
        u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
        q = torch.floor(y + u)
    else:
        q = torch.round(y)   # half-to-even, as jnp.round
    # a NaN y (a NaN element, or an inf one in its inf-scaled block) is
    # code 0, as XLA converts float to int8; torch's cast leaves it to
    # the device
    q = torch.nan_to_num(torch.clamp(q, -INT8_MAX, INT8_MAX), nan=0.0)
    return q.to(torch.int8).reshape(-1), scales[:, 0]


def dequantize_blockwise_plain(q: torch.Tensor, scales: torch.Tensor,
                               shape: Sequence[int], dtype: torch.dtype,
                               block_size: int = 256) -> torch.Tensor:
    """Plain version of K5: back to ``shape``/``dtype``, dropping the zero
    padding."""
    out = q.reshape(-1, block_size).to(torch.float32) * scales[:, None]
    n = 1
    for d in shape:
        n *= d
    return out.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def dequantize_accumulate_plain(q: torch.Tensor, scales: torch.Tensor,
                                world: int, block_size: int = 256,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Plain version of K6: f32 [n], ``acc = fma(q[p], s[p], acc)`` over
    peers 0..world-1 in order from acc = 0; then times the f32 ``scale``
    if one is given (the mean's ``reciprocal(world)``)."""
    qf = q.reshape(world, -1, block_size).to(torch.float32)
    sf = scales.reshape(world, -1)[:, :, None].to(torch.float32)
    acc = torch.zeros(qf.shape[1:], dtype=torch.float32, device=q.device)
    for p in range(world):
        acc = _fma(qf[p], sf[p], acc)
    acc = acc.reshape(-1)
    return acc if scale is None else _times(acc, scale)


def _ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division.  Divided by a Python number, a CUDA
    tensor is multiplied by the reciprocal instead (not the same bits
    unless d is a power of two), so the divisor is a tensor on x's
    device."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Dispatch: kernel for CUDA tensors, plain version for CPU tensors
# ---------------------------------------------------------------------------


def _use_kernel(t: torch.Tensor, impl: str) -> bool:
    if impl in ("pallas", "pallas_interpret", "fused", "xla"):
        raise ValueError(
            f"quantize impl {impl!r} is the JAX package's; the port has "
            f"'auto' (the Hopper kernel for a CUDA tensor, the plain "
            f"version for a CPU tensor) and 'plain'")
    if impl not in _IMPLS:
        raise ValueError(f"unknown quantize impl {impl!r} (known: {_IMPLS})")
    if impl == "plain" or t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {t.device}")
    return True


def _check_block(block_size: int) -> None:
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")


def quantize_blockwise(x: torch.Tensor, block_size: int = 256, *,
                       stochastic: bool = False, seed: int = 0,
                       impl: str = "auto", reciprocal_scale: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize any-shape float tensor to (values int8 [npad], scales f32
    [nblocks]) under the module's block layout.

    stochastic: unbiased stochastic rounding, its bits drawn from
    ``seed`` (an int; the reference's pallas path takes an int seed too,
    its XLA path a JAX key).  reciprocal_scale: scale = absmax *
    f32(1/127), the reference's compiled arithmetic, instead of the IEEE
    absmax / 127 (see the module docstring).  A 2-D row-strided view
    whose rows are whole blocks (a column slice of a contiguous
    [rows, cols] tensor, as the collectives' chunks are) reaches the
    kernel without a copy."""
    _check_block(block_size)
    if not _use_kernel(x, impl):
        return quantize_blockwise_plain(x, block_size, stochastic=stochastic,
                                        seed=seed,
                                        reciprocal_scale=reciprocal_scale)
    from ray_tpu_torch.ops import _kernels

    if not _kernels.row_strided(x, block_size):
        x = x.reshape(-1)
    return _kernels.quantize(x, block_size, stochastic=stochastic,
                             key=stochastic_key(seed),
                             reciprocal_scale=reciprocal_scale)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         shape: Sequence[int], dtype: torch.dtype,
                         block_size: int = 256,
                         impl: str = "auto") -> torch.Tensor:
    """Inverse of quantize_blockwise: back to ``shape``/``dtype``,
    dropping the zero padding.  The kernel writes ``dtype`` directly (the
    values of f32 followed by a cast)."""
    _check_block(block_size)
    if not _use_kernel(q, impl):
        return dequantize_blockwise_plain(q, scales, shape, dtype,
                                          block_size)
    from ray_tpu_torch.ops import _kernels

    n = 1
    for d in shape:
        n *= d
    return _kernels.dequantize(q, scales, n, block_size, dtype).reshape(
        tuple(shape))


def dequantize_accumulate(q: torch.Tensor, scales: torch.Tensor, world: int,
                          block_size: int = 256, impl: str = "auto", *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Fused dequantize-and-reduce of ``world`` peers' quantized blocks.

    q is int8 [world * n] (n a block multiple), scales f32
    [world * n/block_size]; returns f32 [n] = sum over peers of their
    dequantized contribution — the accumulate half of the quantized
    reduce-scatter — times the f32 ``scale`` when one is given, so a
    mean (``scale=reciprocal(world)``) takes no second pass."""
    _check_block(block_size)
    if not _use_kernel(q, impl):
        return dequantize_accumulate_plain(q, scales, world, block_size,
                                           scale)
    from ray_tpu_torch.ops import _kernels

    return _kernels.dequantize_accumulate(
        q, scales, world, block_size,
        post_scale=1.0 if scale is None else scale)


# ---------------------------------------------------------------------------
# K7: the fused quantize -> peer exchange -> accumulate hop
# ---------------------------------------------------------------------------


def fused_rs_vmem_bytes(world: int, sub: int) -> int:
    """The reference's VMEM footprint estimate of its fused kernel (input +
    output + scratch, ``ray_tpu/ops/quantize.py:409``): the collectives'
    auto rule keeps chunks above its cap on the staged path, as the
    reference does."""
    nblk_bytes = (sub // 256 + 1) * 128 * 4
    return world * (sub * 4 + 2 * sub + 2 * nblk_bytes) + sub * 4


def _check_fused(x2d: torch.Tensor, block_size: int) -> None:
    _check_block(block_size)
    if x2d.dim() != 2 or x2d.shape[1] < block_size or (
            x2d.shape[1] % block_size):
        raise ValueError(f"fused_reduce_scatter needs [world, sub] with sub "
                         f"a positive multiple of block_size ({block_size}), "
                         f"got shape {tuple(x2d.shape)}")


def fused_reduce_scatter_plain(x2d: torch.Tensor, group=None,
                               block_size: int = 256, *,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K7 for this rank: the plain K4 of its [world, sub]
    rows with the reciprocal scale, the exchange (rank p receives row p of
    every peer, in peer order: ``all_to_all`` over ``group``, a process
    group of ``world`` ranks), then the plain K6, times ``scale``."""
    _check_fused(x2d, block_size)
    world = x2d.shape[0]
    q, s = quantize_blockwise_plain(x2d, block_size, reciprocal_scale=True)
    if world > 1:
        import torch.distributed as dist

        if dist.get_world_size(group) != world:
            raise ValueError(f"fused_reduce_scatter: {world} rows for a "
                             f"group of {dist.get_world_size(group)}")
        qx, sx = torch.empty_like(q), torch.empty_like(s)
        dist.all_to_all_single(qx, q, group=group)
        dist.all_to_all_single(sx, s, group=group)
        q, s = qx, sx
    return dequantize_accumulate_plain(q, s, world, block_size, scale)


def fused_reduce_scatter_loopback_plain(xs: torch.Tensor,
                                        block_size: int = 256, *,
                                        scale: Optional[float] = None
                                        ) -> torch.Tensor:
    """Plain version of K7 for every rank of a group at once, on one
    device: xs is the ranks' inputs [world, world, sub]; returns each
    rank's result [world, sub] (the exchange is a transpose)."""
    world = xs.shape[0]
    if xs.dim() != 3 or xs.shape[1] != world:
        raise ValueError(f"loopback K7 takes [world, world, sub], got "
                         f"{tuple(xs.shape)}")
    _check_fused(xs[0], block_size)
    sub = xs.shape[2]
    codes = [quantize_blockwise_plain(xs[r], block_size,
                                      reciprocal_scale=True)
             for r in range(world)]
    out = []
    for d in range(world):
        qx = torch.cat([q.view(world, sub)[d] for q, _ in codes])
        sx = torch.cat([s.view(world, -1)[d] for _, s in codes])
        out.append(dequantize_accumulate_plain(qx, sx, world, block_size,
                                               scale))
    return torch.stack(out)


def fused_reduce_scatter(x2d: torch.Tensor, group=None,
                         block_size: int = 256, *,
                         scale: Optional[float] = None,
                         impl: str = "auto") -> torch.Tensor:
    """One-kernel quantized reduce-scatter hop (the reference's
    ``fused_reduce_scatter``).  x2d is this rank's [world, sub] f32
    contributions (sub a multiple of block_size; a column slice of a
    contiguous tensor is read in place); returns f32 [sub]: the sum over
    all ranks, in rank order, of their once-quantized row for this rank,
    times ``scale`` when one is given (a mean's ``reciprocal(world)``).
    Deterministic rounding only, as the reference's.

    A CUDA tensor launches K7 over the peer memory of ``group`` (a
    process group set up by ``collective.init_collective_group``; raises
    if it has none); a CPU tensor, or ``impl="plain"``, takes the plain
    version, which exchanges through the group's ``all_to_all``."""
    _check_fused(x2d, block_size)
    if not _use_kernel(x2d, impl):
        return fused_reduce_scatter_plain(x2d, group, block_size,
                                          scale=scale)
    from ray_tpu_torch.collective import peer_memory
    from ray_tpu_torch.ops import _kernels

    return _kernels.fused_reduce_scatter(
        x2d, peer_memory.require(group), block_size,
        post_scale=1.0 if scale is None else scale)


def fused_reduce_scatter_loopback(xs: torch.Tensor, peers,
                                  block_size: int = 256, *,
                                  scale: Optional[float] = None,
                                  impl: str = "auto") -> torch.Tensor:
    """K7 hosting every rank of a group in one launch on one card (a test
    of the exchange protocol, not a path users take): xs [world, world,
    sub] on the card of ``peers`` (``PeerBuffers.loopback``) -> [world,
    sub].  A CPU tensor or ``impl="plain"`` takes the plain version."""
    if not _use_kernel(xs, impl):
        return fused_reduce_scatter_loopback_plain(xs, block_size,
                                                   scale=scale)
    from ray_tpu_torch.ops import _kernels

    return _kernels.fused_reduce_scatter(
        xs, peers, block_size, post_scale=1.0 if scale is None else scale)


def quantization_error(x: torch.Tensor, block_size: int = 256,
                       impl: str = "auto") -> torch.Tensor:
    """x - deq(quant(x)): the per-call compression error (what error
    feedback accumulates).  Deterministic rounding only — the stochastic
    path's error depends on the drawn bits.  On the card: K4 then K5."""
    q, s = quantize_blockwise(x, block_size, impl=impl)
    return x - dequantize_blockwise(q, s, x.shape, x.dtype, block_size,
                                    impl=impl)
