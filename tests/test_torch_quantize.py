"""The port's block-wise int8 quantization (``ops/quantize.py``, the plain
versions of K4-K6) and its copy of ``collective/compression.py`` against
the JAX package, on the CPU, from numpy-seeded inputs.

The reference computes ``absmax / 127`` as an IEEE division when it runs
eagerly and as the product with f32(1/127) inside a jitted program (XLA
rewrites a division by a constant), and its accumulate ``(q * s).sum(0)``
as separate roundings eagerly and as fused multiply-adds when jitted.
So:

  * ``quantize_blockwise`` / ``dequantize_blockwise`` (the port's default,
    dividing) == the reference's eager ``impl="xla"``, bitwise, f32 and
    bf16 inputs, blocks 16/32/100/256/1024, 1-D and 2-D;
  * ``quantize_blockwise(reciprocal_scale=True)`` == ``jax.jit`` of the
    same, and == ``impl="pallas_interpret"`` (K4/K5 in interpret mode) at
    block 256, bitwise;
  * ``dequantize_accumulate`` == ``jax.jit`` of ``impl="xla"`` bitwise at
    world 2/4/8, and == ``pallas_interpret`` (K6, which sums in another
    order) within 2e-6 * max|out|;
  * ``quantization_error`` == the reference's (eager) and == the port's
    ``compression_residual`` (numpy), bitwise;
  * stochastic rounding: unbiased with the reference test's thresholds,
    reproducible per seed (the bits are the port's own).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.collective import collective as ref_collective
from ray_tpu.collective import compression as ref_compression
from ray_tpu.ops import quantize as jq
from ray_tpu_torch.collective import collective as port_collective
from ray_tpu_torch.collective import compression as port_compression
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)

BLOCKS = (16, 32, 100, 256, 1024)
SHAPES = ((1000,), (5000,), (10, 100), (50, 100))
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _x(shape, seed=0):
    """Magnitudes over six decades, and an all-zero leading block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x = x * np.exp(rng.uniform(-7, 7, shape)).astype(np.float32)
    x.reshape(-1)[:16] = 0
    return x


def _pair(shape, dtype, seed=0):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(_x(shape, seed)).to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


def _eq(got: torch.Tensor, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)
                      if jnp.asarray(want).dtype == jnp.bfloat16 else want)
    np.testing.assert_array_equal(got.float().numpy()
                                  if got.is_floating_point() else got.numpy(),
                                  want.astype(np.float32)
                                  if got.is_floating_point() else want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_dequantize_match_jax(dtype, block, shape):
    t, j = _pair(shape, dtype)
    q, s = tq.quantize_blockwise(t, block)
    jqv, js = jq.quantize_blockwise(j, block, impl="xla")
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    _eq(q, jqv)
    _eq(s, js)
    back = tq.dequantize_blockwise(q, s, t.shape, t.dtype, block)
    jback = jq.dequantize_blockwise(jqv, js, j.shape, j.dtype, block,
                                    impl="xla")
    assert back.dtype == t.dtype and back.shape == t.shape
    _eq(back, jback)


@pytest.mark.parametrize("shape", [(5000,), (10, 100)])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reciprocal_scale_matches_jitted_jax(dtype, block, shape):
    t, j = _pair(shape, dtype, seed=1)
    q, s = tq.quantize_blockwise(t, block, reciprocal_scale=True)
    jqv, js = jax.jit(lambda a: jq.quantize_blockwise(a, block,
                                                      impl="xla"))(j)
    _eq(q, jqv)
    _eq(s, js)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matches_pallas_interpret(dtype, shape):
    """K4 and K5 as the reference's Pallas kernels in interpret mode."""
    t, j = _pair(shape, dtype, seed=2)
    q, s = tq.quantize_blockwise(t, 256, reciprocal_scale=True)
    pq, ps = jq.quantize_blockwise(j, 256, impl="pallas_interpret")
    _eq(q, pq)
    _eq(s, ps)
    back = tq.dequantize_blockwise(q, s, t.shape, torch.float32, 256)
    _eq(back, jq.dequantize_blockwise(pq, ps, j.shape, jnp.float32, 256,
                                      impl="pallas_interpret"))


@pytest.mark.parametrize("world", [2, 4, 8])
def test_dequantize_accumulate_matches_jax(world):
    x = _x((world, 4096), seed=3)
    jqv, js = jq.quantize_blockwise(jnp.asarray(x), 256, impl="xla")
    q, s = (torch.from_numpy(np.array(a)) for a in (jqv, js))
    got = tq.dequantize_accumulate(q, s, world, 256)
    want = jax.jit(lambda a, b: jq.dequantize_accumulate(
        a, b, world, 256, impl="xla"))(jqv, js)
    _eq(got, want)
    mean = tq.dequantize_accumulate(q, s, world, 256,
                                    scale=tq.reciprocal(world))
    _eq(mean, jax.jit(lambda a, b: jq.dequantize_accumulate(
        a, b, world, 256, impl="xla") / world)(jqv, js))
    interp = np.asarray(jq.dequantize_accumulate(jqv, js, world, 256,
                                                 impl="pallas_interpret"))
    np.testing.assert_allclose(got.numpy(), interp, rtol=0,
                               atol=2e-6 * np.abs(interp).max())


@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("shape", [(5000,), (10, 100)])
def test_quantization_error_matches_jax_and_host_codec(shape, block):
    x = _x(shape, seed=4)
    got = tq.quantization_error(torch.from_numpy(x), block)
    _eq(got, jq.quantization_error(jnp.asarray(x), block))
    cc = port_compression.CompressionConfig(block_size=block, min_size=0)
    _eq(got, port_compression.compression_residual(x, cc))
    _eq(got, ref_compression.compression_residual(x, cc))


def test_stochastic_rounding_is_unbiased():
    """The reference's thresholds (test_collective_compression.py:84-98):
    each draw within 2e-2 of x, the mean of 32 draws within 2e-3."""
    x = np.linspace(-1.0, 1.0, 2048, dtype=np.float32)
    t = torch.from_numpy(x)

    def rel(a):
        return np.linalg.norm(a - x) / np.linalg.norm(x)

    outs = []
    for seed in range(32):
        q, s = tq.quantize_blockwise(t, 256, stochastic=True, seed=seed)
        outs.append(tq.dequantize_blockwise(q, s, t.shape, torch.float32,
                                            256).numpy())
        assert rel(outs[-1]) < 2e-2
    assert rel(np.mean(outs, axis=0)) < 2e-3


def test_stochastic_seed_reproducible():
    t = torch.from_numpy(_x((4096,), seed=5))
    a = tq.quantize_blockwise(t, 256, stochastic=True, seed=7)
    b = tq.quantize_blockwise(t, 256, stochastic=True, seed=7)
    c = tq.quantize_blockwise(t, 256, stochastic=True, seed=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert torch.equal(a[1], c[1])          # scales do not depend on bits
    # the plain hash on tensors == the same hash on Python ints (the
    # kernel's uint32 arithmetic)
    idx = torch.tensor([0, 1, 12345, 2 ** 31 - 1], dtype=torch.int64)
    want = [tq._mix32(tq._mix32(int(i)) ^ tq.stochastic_key(7))
            for i in idx]
    assert tq.stochastic_bits(idx, 7).tolist() == want
    assert all(0 <= w < 2 ** 32 for w in want)


def test_impls_and_cpu_dispatch():
    t = torch.from_numpy(_x((1000,)))
    for impl in ("pallas", "pallas_interpret", "fused", "xla"):
        with pytest.raises(ValueError, match="JAX package"):
            tq.quantize_blockwise(t, 256, impl=impl)
    with pytest.raises(ValueError, match="unknown"):
        tq.quantize_blockwise(t, 256, impl="triton")

    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel wrapper")

    _kernels.reset_launch_counts()
    with mock.patch.multiple(_kernels, quantize=refuse, dequantize=refuse,
                             dequantize_accumulate=refuse):
        q, s = tq.quantize_blockwise(t, 256)
        tq.dequantize_blockwise(q, s, t.shape, torch.float32, 256)
        tq.dequantize_accumulate(q, s, 1, 256)
        tq.quantization_error(t, 256)
    assert set(_kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the compression.py copy, held to the reference's own asserts
# ---------------------------------------------------------------------------

MODULES = {"reference": ref_compression, "port": port_compression}


@pytest.mark.parametrize("which", sorted(MODULES))
def test_compression_spec_roundtrip_and_errors(which):
    m = MODULES[which]
    cc = m.parse_compression("int8:block=512,stochastic=1,ef=0,min=64")
    assert cc == m.CompressionConfig(block_size=512, stochastic=True,
                                     error_feedback=False, min_size=64)
    assert m.parse_compression(cc.to_spec()) == cc
    assert m.parse_compression("int8") == m.CompressionConfig()
    assert m.parse_compression("") is None
    assert m.parse_compression("off") is None
    assert m.parse_compression(None) is None
    with pytest.raises(ValueError, match="dtype"):
        m.parse_compression("int4")
    with pytest.raises(ValueError, match="unknown compression spec key"):
        m.parse_compression("int8:bogus=1")
    spec = "int8:block=128,chunks=3,bucket=65536"
    assert (dataclasses.asdict(port_compression.parse_compression(spec))
            == dataclasses.asdict(ref_compression.parse_compression(spec)))


@pytest.mark.parametrize("which", sorted(MODULES))
def test_compression_wire_ratio_and_codec(which):
    m = MODULES[which]
    cc = m.CompressionConfig(min_size=0)
    x = np.random.default_rng(4).standard_normal(1 << 16).astype(np.float32)
    payload = m.compress_array(x, cc)
    assert m.wire_bytes(payload) / x.nbytes <= 0.27
    assert m.wire_ratio(x.size, cc) <= 0.27
    rcc = m.CompressionConfig(block_size=m.result_block_size(cc.block_size),
                              min_size=0)
    assert (m.wire_ratio(x.size, cc) + m.wire_ratio(x.size, rcc)) / 2 <= 0.3
    other = MODULES["reference" if which == "port" else "port"]
    theirs = other.compress_array(x, other.CompressionConfig(min_size=0))
    for key in ("v", "s"):
        np.testing.assert_array_equal(payload[key], theirs[key])
    np.testing.assert_array_equal(m.decompress_array(payload),
                                  other.decompress_array(theirs))


@pytest.mark.parametrize("which", sorted(MODULES))
def test_compression_chunk_layout(which):
    m = MODULES[which]
    assert m.chunk_layout(7, 2) == (4, 3)
    assert m.chunk_layout(10, 5) == (2, 2, 2, 2, 2)
    assert m.chunk_layout(3, 8) == (1, 1, 1)
    with pytest.raises(ValueError, match="pipeline chunk count"):
        m.chunk_layout(4, 0)
    with pytest.raises(ValueError, match="n_blocks"):
        m.chunk_layout(0, 2)
    with pytest.raises(ValueError, match="block_size=256"):
        m.validate_chunk_elems(300, 256)
    m.validate_chunk_elems(512, 256)
    assert m.auto_pipeline_chunks(1 << 30, 4, "cpu") == 1
    assert m.auto_pipeline_chunks(1 << 20, 4, "gpu") == 1
    assert m.auto_pipeline_chunks(124_000_000, 4, "gpu") == 8
    assert m.auto_pipeline_chunks(5 << 20, 4, "tpu") == 5
    for n in (1, 1000, 1 << 22, 1 << 27):
        for backend in ("cpu", "gpu", "tpu"):
            assert (m.auto_pipeline_chunks(n, 4, backend)
                    == MODULES["reference"].auto_pipeline_chunks(n, 4,
                                                                 backend))


@pytest.mark.parametrize("which", ["reference", "port"])
def test_compression_resolution_precedence(which, monkeypatch):
    """The reference test's asserts (test_collective_compression.py:155),
    through each package's ``_resolve_op_compression``, plus the
    RAY_TPU_COLLECTIVE_COMPRESSION flag under both defaults."""
    m = MODULES[which]
    col = ref_collective if which == "reference" else port_collective

    def arr(n, dtype=np.float32):
        x = np.zeros(n, dtype)
        return x if which == "reference" else torch.from_numpy(x)

    x = arr(4096)
    with pytest.raises(ValueError, match="sum"):
        col._resolve_op_compression(x, "max", "int8")
    monkeypatch.delenv("RAY_TPU_COLLECTIVE_COMPRESSION", raising=False)
    assert col._resolve_op_compression(x, "sum", None) is None
    monkeypatch.setenv("RAY_TPU_COLLECTIVE_COMPRESSION", "int8:block=64")
    assert col._resolve_op_compression(x, "sum", None).block_size == 64
    try:
        m.set_group_compression("int8:block=128")
        assert col._resolve_op_compression(x, "max", None) is None
        got = col._resolve_op_compression(x, "sum", None)
        assert got is not None and got.block_size == 128
        assert col._resolve_op_compression(x, "sum", "off") is None
        assert col._resolve_op_compression(arr(8), "sum", None) is None
        assert col._resolve_op_compression(arr(4096, np.int64), "sum",
                                           None) is None
    finally:
        m.set_group_compression(None)
