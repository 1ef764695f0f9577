"""Compression config + host wire codec for compressed collectives.

The port's own copy of ``ray_tpu/collective/compression.py`` (which
imports no JAX; the port imports nothing of ``ray_tpu``), unchanged but
for where the process-wide flag is read: ``resolve_compression`` reads
``RAY_TPU_COLLECTIVE_COMPRESSION`` straight from the environment instead
of through the reference's runtime config.

Consumers in the port:

  * ``collective/nccl_group.py`` and ``parallel/sharding.py`` take
    ``CompressionConfig`` (and its spec-string round trip) to parameterize
    the quantized collectives over ``ops/quantize.py``'s kernels.
  * The numpy codec (``compress_array`` …) is the host-side statement of
    the same arithmetic: ``ops.quantize.quantization_error`` on the card
    is held to ``compression_residual`` bit for bit, which is what lets
    error feedback keep its residuals on the device.

The numerics here mirror ``ops/quantize.py`` bit-for-bit for
deterministic rounding (same absmax/127 scale, numpy's round
half-to-even matches torch.round).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np

INT8_MAX = 127.0

_TRUE = ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """How a collective compresses payloads.

    dtype: quantized wire dtype — only "int8" today.
    block_size: elements per scale block; smaller = lower error, more
        scale overhead (wire ratio ~= 1/4 + 1/block_size at int8).
    stochastic: unbiased stochastic rounding instead of round-to-even.
        Useful without error feedback; with EF, deterministic rounding
        lets the residual be recomputed exactly.
    error_feedback: accumulate the per-parameter compression residual
        and re-inject it next step (keeps compressed SGD convergent).
        Consumed by `parallel/sharding.GradientSynchronizer`, not by the
        one-shot collective calls.
    min_size: arrays with fewer elements ship uncompressed (scale
        overhead would beat the savings).
    pipeline_chunks: split large tensors into this many block-aligned
        chunks inside the quantized allreduce and double-buffer them —
        quantize of chunk k+1 overlaps transfer of chunk k.  0 = auto
        (tuned from tensor size and backend; see auto_pipeline_chunks).
        1 = monolithic.  Chunked and monolithic results are bit-identical
        for deterministic rounding (chunk boundaries are block-aligned so
        every per-block scale is unchanged).
    bucket_bytes: GradientSynchronizer coalesces per-parameter gradients
        into flat buckets of about this many (f32) bytes, so many small
        leaves ride one pipelined collective instead of one blocking
        call each.
    """

    dtype: str = "int8"
    block_size: int = 256
    stochastic: bool = False
    error_feedback: bool = True
    min_size: int = 1024
    pipeline_chunks: int = 0
    bucket_bytes: int = 4 << 20

    def __post_init__(self):
        if self.dtype != "int8":
            raise ValueError(
                f"unsupported compression dtype {self.dtype!r}; only 'int8'")
        if self.block_size <= 0:
            raise ValueError(
                f"block_size must be positive, got {self.block_size}")
        if self.pipeline_chunks < 0:
            raise ValueError(
                f"pipeline_chunks must be >= 0 (0 = auto), got "
                f"{self.pipeline_chunks}")
        if self.bucket_bytes <= 0:
            raise ValueError(
                f"bucket_bytes must be positive, got {self.bucket_bytes}")

    def to_spec(self) -> str:
        """Inverse of parse_compression — env-var/CLI-safe string."""
        return (f"{self.dtype}:block={self.block_size}"
                f",stochastic={int(self.stochastic)}"
                f",ef={int(self.error_feedback)}"
                f",min={self.min_size}"
                f",chunks={self.pipeline_chunks}"
                f",bucket={self.bucket_bytes}")


def result_block_size(block_size: int) -> int:
    """Block size for the second (result) quantization of a two-phase
    allreduce.  The reduced value is quantized exactly once on its way
    back, so finer per-block scales there buy error margin almost for
    free: at block=256 contributions, a block/8 result stage moves
    ~0.27x the baseline wire bytes total while cutting the result-stage
    error by ~35% (two equal int8 stages sit right AT the 1e-2 line;
    this keeps the end-to-end error near 0.009 with margin)."""
    return max(16, block_size // 8)


# Per-chunk payload the auto-tuner aims for.  Small enough that a few
# chunks fit in flight (quantize of k+1 behind transfer of k), large
# enough that per-chunk collective launch overhead stays negligible.
CHUNK_TARGET_BYTES = 4 << 20
MAX_PIPELINE_CHUNKS = 8


def auto_pipeline_chunks(n_elements: int, itemsize: int = 4,
                         backend: str = "") -> int:
    """Pick a pipeline chunk count for an n-element tensor.

    Pure math; callers pass the device backend string ("gpu" for CUDA
    tensors in the port, "cpu" for the gloo backend's CPU tensors).
    On hosts where the "interconnect" is shared memory (the cpu backend —
    incl. XLA_FLAGS-forced multi-device CPU meshes) transfer is a memcpy
    that cannot be hidden behind compute, and every extra chunk adds a
    collective rendezvous, so auto always picks 1 there.  On real
    accelerator fabrics, chunk so each piece is ~CHUNK_TARGET_BYTES."""
    if backend not in ("tpu", "gpu"):
        return 1
    total = int(n_elements) * int(itemsize)
    if total < 2 * CHUNK_TARGET_BYTES:
        return 1
    return min(MAX_PIPELINE_CHUNKS, total // CHUNK_TARGET_BYTES)


def chunk_layout(n_blocks: int, chunks: int) -> Tuple[int, ...]:
    """Split n_blocks quantization blocks into `chunks` contiguous runs.

    Chunk boundaries land ON block boundaries by construction — that is
    what keeps the chunked allreduce bit-identical to the monolithic one
    (every per-block absmax/scale sees exactly the same elements).  The
    remainder is spread over the leading chunks, so uneven splits (say 7
    blocks into 2 chunks -> (4, 3)) stay valid.  Requesting more chunks
    than blocks clamps; empty chunks are never returned.
    """
    if chunks <= 0:
        raise ValueError(
            f"pipeline chunk count must be >= 1, got {chunks} — use "
            f"pipeline_chunks=0 on CompressionConfig for auto-tuning or 1 "
            f"to disable chunking")
    if n_blocks <= 0:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    chunks = min(chunks, n_blocks)
    base, extra = divmod(n_blocks, chunks)
    return tuple(base + (1 if c < extra else 0) for c in range(chunks))


def validate_chunk_elems(chunk_elems: int, block_size: int) -> None:
    """Guard for callers that slice their own chunks (rather than going
    through chunk_layout, which can only produce aligned chunks): a chunk
    whose size is not a block multiple would shift every later block
    boundary, silently changing per-block scales and breaking both the
    chunked==monolithic guarantee and host-codec residual recomputation."""
    if chunk_elems % block_size:
        raise ValueError(
            f"pipeline chunk of {chunk_elems} elements is not a multiple "
            f"of block_size={block_size}: chunk boundaries must land on "
            f"quantization-block boundaries or the per-block scales (and "
            f"the bit-exact host-codec contract) change.  Pick a chunk "
            f"count that divides the tensor into block-aligned pieces "
            f"(compression.chunk_layout does this), or pad the tensor to "
            f"a multiple of block_size first")


def parse_compression(
    spec: Union[None, str, CompressionConfig]) -> Optional[CompressionConfig]:
    """Parse "int8" / "int8:block=512,stochastic=1,ef=0,min=0,chunks=4,
    bucket=4194304" (or pass through a config / None).  Empty string
    means off."""
    if spec is None or isinstance(spec, CompressionConfig):
        return spec
    spec = spec.strip()
    if not spec or spec.lower() in ("none", "off", "0", "false"):
        return None
    dtype, _, rest = spec.partition(":")
    kw: Dict[str, object] = {"dtype": dtype.strip()}
    if rest:
        for item in rest.split(","):
            k, sep, v = item.partition("=")
            if not sep:
                raise ValueError(f"bad compression spec item {item!r} "
                                 f"in {spec!r} (want key=value)")
            k, v = k.strip(), v.strip()
            if k == "block":
                kw["block_size"] = int(v)
            elif k == "stochastic":
                kw["stochastic"] = v.lower() in _TRUE
            elif k == "ef":
                kw["error_feedback"] = v.lower() in _TRUE
            elif k == "min":
                kw["min_size"] = int(v)
            elif k == "chunks":
                kw["pipeline_chunks"] = int(v)
            elif k == "bucket":
                kw["bucket_bytes"] = int(v)
            else:
                raise ValueError(f"unknown compression spec key {k!r} in "
                                 f"{spec!r} (known: block, stochastic, ef, "
                                 f"min, chunks, bucket)")
    return CompressionConfig(**kw)  # type: ignore[arg-type]


# Per-process group default, so workers compress without threading a
# config through every allreduce call.
_group_default: Optional[CompressionConfig] = None


def set_group_compression(
        spec: Union[None, str, CompressionConfig]) -> Optional[CompressionConfig]:
    global _group_default
    _group_default = parse_compression(spec)
    return _group_default


def resolve_compression(
    spec: Union[None, str, CompressionConfig] = None,
    *, use_default: bool = True) -> Optional[CompressionConfig]:
    """Precedence: explicit arg > group default > RAY_TPU_COLLECTIVE_COMPRESSION
    flag.  Explicit "off"/"" disables even when a default is installed."""
    if spec is not None:
        return parse_compression(spec)
    if not use_default:
        return None
    if _group_default is not None:
        return _group_default
    return parse_compression(
        os.environ.get("RAY_TPU_COLLECTIVE_COMPRESSION", ""))


# ---------------------------------------------------------------------------
# Host wire codec (numpy; kv backend + error-feedback residuals)
# ---------------------------------------------------------------------------


def _host_blocks(x: np.ndarray, block_size: int) -> np.ndarray:
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    pad = (-flat.size) % block_size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    return flat.reshape(-1, block_size)


def compress_array(x: np.ndarray, config: CompressionConfig,
                   rng: Optional[np.random.Generator] = None) -> dict:
    """ndarray -> wire payload dict (pickles to ~0.25x the f32 bytes).

    Payload keys: v (int8 [npad]), s (f32 [nblocks]), shape, dtype (str),
    block.  `rng` drives stochastic rounding when config.stochastic.
    """
    x = np.asarray(x)
    blocks = _host_blocks(x, config.block_size)
    absmax = np.max(np.abs(blocks), axis=-1, keepdims=True)
    scales = np.where(absmax > 0, absmax / INT8_MAX, 1.0).astype(np.float32)
    # multiply by the rounded reciprocal instead of dividing: divides are
    # the slowest VPU/host op in the codec, and 1/scale is IEEE-identical
    # between numpy and XLA, so the jit path (ops/quantize.py) makes the
    # same substitution and the bit-exactness contract holds
    y = blocks * (np.float32(1.0) / scales)
    if config.stochastic:
        rng = rng or np.random.default_rng(0)
        y = np.floor(y + rng.random(y.shape, dtype=np.float32))
    else:
        y = np.round(y)  # numpy rounds half-to-even, matching jnp.round
    q = np.clip(y, -INT8_MAX, INT8_MAX).astype(np.int8)
    return {"v": q.reshape(-1), "s": scales[:, 0], "shape": x.shape,
            "dtype": str(x.dtype), "block": config.block_size}


def decompress_array(payload: dict) -> np.ndarray:
    q = payload["v"].reshape(-1, payload["block"]).astype(np.float32)
    out = q * payload["s"][:, None]
    n = int(np.prod(payload["shape"])) if payload["shape"] else 1
    return out.reshape(-1)[:n].reshape(payload["shape"]).astype(
        payload["dtype"])


def compression_residual(x: np.ndarray, config: CompressionConfig) -> np.ndarray:
    """x - decompress(compress(x)) with deterministic rounding — the error
    that error feedback carries to the next step."""
    det = dataclasses.replace(config, stochastic=False)
    return np.asarray(x, np.float32) - decompress_array(
        compress_array(x, det)).astype(np.float32)


def wire_bytes(payload: dict) -> int:
    return payload["v"].nbytes + payload["s"].nbytes


def wire_ratio(n_elements: int, config: CompressionConfig,
               baseline_itemsize: int = 4) -> float:
    """Compressed wire bytes / uncompressed, for n f32 elements."""
    block = config.block_size
    npad = n_elements + (-n_elements) % block
    compressed = npad * 1 + (npad // block) * 4
    return compressed / float(n_elements * baseline_itemsize)
