"""Explicit data-parallel gradient sync with compressed collectives.

Counterpart of ``GradientSynchronizer`` in ``ray_tpu/parallel/sharding.py``
(:129-296).  The logical-axis rules, ``shard_tree`` and the other mesh
helpers of that module come with the meshes slice (ROADMAP A.6).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from ray_tpu_torch.collective import collective
from ray_tpu_torch.collective.compression import (CompressionConfig,
                                                  auto_pipeline_chunks,
                                                  chunk_layout,
                                                  resolve_compression,
                                                  result_block_size)
from ray_tpu_torch.collective.nccl_group import _resolve_rs_impl
from ray_tpu_torch.ops.quantize import padded_len, quantization_error


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List], Any]]:
    """Leaves of a nested dict / list / tuple of tensors, in order, and
    the function that rebuilds the structure from new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"gradient trees hold tensors in dicts, lists and "
                        f"tuples; got {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new: List):
        out, off = [], 0
        for (_, build), n in zip(parts, sizes):
            out.append(build(new[off:off + n]))
            off += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def bucket_sizes(sizes: Sequence[int], cap: int) -> List[int]:
    """The f32 elements of each bucket ``GradientSynchronizer`` issues for
    float leaves of ``sizes`` elements, pushed in order: a bucket goes
    once the f32 bytes pending reach ``cap`` (``push``), the rest at
    ``finish``."""
    out, cur = [], 0
    for n in sizes:
        cur += n
        if 4 * cur >= cap:
            out.append(cur)
            cur = 0
    if cur:
        out.append(cur)
    return out


SYNC_KERNELS = ("quantize", "dequantize", "dequantize_accumulate",
                "fused_reduce_scatter")


class KernelLaunch(NamedTuple):
    """One quantize-kernel launch of a sync: the kernel (its name in
    ``ops._kernels``), the elements it takes (K6 and K7: of each of
    ``world`` peers), and its block."""
    kernel: str
    n: int
    block: int
    world: int = 1


def sync_plan(sizes: Sequence[int], cc: CompressionConfig, world: int,
              peers: bool = True,
              fused: Optional[bool] = None) -> List[KernelLaunch]:
    """Every K4-K7 launch of one ``GradientSynchronizer`` sync of float
    leaves of ``sizes`` elements on a CUDA group of ``world`` ranks,
    bucket by bucket.  Per compressed bucket, phase 1 runs once per
    pipeline chunk (``chunk_layout`` at auto chunks): K7 where the
    reference's rule picks the fused hop (``_resolve_rs_impl``: world > 1,
    a block multiple of 128, deterministic rounding, the chunk under the
    8 MiB VMEM cap, ``peers`` — the group has peer memory), else K4 and
    K6; phase 2 requantizes at the result block and dequantizes once per
    chunk (or once, when chunks cannot pipeline it); error feedback
    quantizes and dequantizes the bucket once more.  ``fused=True`` plans
    a run that forces the fused hop on every chunk."""
    plan: List[KernelLaunch] = []
    block, rblock = cc.block_size, result_block_size(cc.block_size)
    for n in bucket_sizes(sizes, cc.bucket_bytes):
        if n < cc.min_size:
            continue
        sub = padded_len(n, world * block) // world
        chunks = [nb * block for nb in chunk_layout(
            sub // block,
            cc.pipeline_chunks or auto_pipeline_chunks(n, 4, "gpu"))]
        fused_here = (_resolve_rs_impl("auto", world, block, cc.stochastic,
                                       max(chunks), peers) == "fused"
                      if fused is None else fused)
        for c in chunks:
            plan += ([KernelLaunch("fused_reduce_scatter", c, block, world)]
                     if fused_here else
                     [KernelLaunch("quantize", world * c, block),
                      KernelLaunch("dequantize_accumulate", c, block, world)])
        for c in (chunks if len(chunks) > 1 and block % rblock == 0
                  else [sub]):
            plan += [KernelLaunch("quantize", c, rblock),
                     KernelLaunch("dequantize", world * padded_len(c, rblock),
                                  rblock)]
        if cc.error_feedback:
            plan += [KernelLaunch("quantize", n, block),
                     KernelLaunch("dequantize", n, block)]
    return plan


def sync_launch_counts(plan: Sequence[KernelLaunch]) -> Dict[str, int]:
    """Launches of each of K4-K7 in a ``sync_plan``."""
    counts = dict.fromkeys(SYNC_KERNELS, 0)
    for launch in plan:
        counts[launch.kernel] += 1
    return counts


class GradientSynchronizer:
    """Cross-process gradient sync with optional compressed collectives.

    Each rank computes its local grads, then ``sync(grads)`` allreduces
    every leaf (op="mean" by default) through the group, compressed per
    ``compression`` / the group default / the RAY_TPU_COLLECTIVE_COMPRESSION
    flag.

    Float gradients are COALESCED into f32 buckets of ~``bucket_bytes``
    (CompressionConfig.bucket_bytes unless overridden here) and each
    bucket is issued through ``collective.allreduce_async`` the moment it
    fills, so with the incremental ``begin()/push()/finish()`` API the
    first buckets are in flight while the rest are still being pushed.
    A bucket below the config's ``min_size`` goes uncompressed.

    With ``error_feedback`` on (the CompressionConfig default), the
    compression residual e_t = g_t - deq(quant(g_t)) is kept in the
    PARAMETER dtype and re-injected into the next step's gradient (the
    EF-SGD construction).  Buckets and residuals stay on the gradients'
    device: the residual of each bucket is
    ``ops.quantize.quantization_error`` at the bucket's block size (K4
    then K5 on the card), bit for bit the host codec the reference
    recomputes it with (``compression_residual``).  Push order must
    match across ranks: it is the collective issue order.  A pushed
    tensor must not change before ``finish()``."""

    def __init__(self, group_name: str = "default", op: str = "mean",
                 compression=None, bucket_bytes: Optional[int] = None):
        self.group_name = group_name
        self.op = op
        self.compression = compression
        self.bucket_bytes = bucket_bytes
        self._residuals: Optional[Dict[int, torch.Tensor]] = None
        self._stream: Optional[dict] = None

    def reset(self):
        """Drop accumulated error-feedback residuals (e.g. after a
        checkpoint restore on different parameters)."""
        self._residuals = None

    @property
    def residuals(self) -> Dict[int, torch.Tensor]:
        """The error-feedback residual of each slot, in the parameter
        dtype (empty before the first sync or without error feedback)."""
        return dict(self._residuals or {})

    # -- incremental streaming API ---------------------------------------

    def begin(self):
        """Start a sync stream; feed leaves with push(), collect with
        finish()."""
        cc = resolve_compression(self.compression)
        cap = self.bucket_bytes
        if cap is None:
            cap = cc.bucket_bytes if cc is not None else 4 << 20
        if self._residuals is None:
            self._residuals = {}
        self._stream = {
            "cc": cc,
            "use_ef": cc is not None and cc.error_feedback,
            "cap": max(1, int(cap)),
            "pending": [],        # (slot, tensor) awaiting bucket flush
            "pending_bytes": 0,
            "buckets": [],        # flushed: (handle, corrected, segments)
            "singles": {},        # slot -> handle (non-bucketed leaves)
            "meta": {},           # slot -> (shape, dtype)
            "nslots": 0,
        }
        return self

    def push(self, g: torch.Tensor) -> int:
        """Enqueue one gradient leaf; returns its slot id.  Issues the
        current bucket's allreduce as soon as it crosses bucket_bytes."""
        st = self._stream
        if st is None:
            raise RuntimeError("push() outside begin()/finish() — call "
                               "begin() first (or use __call__)")
        slot = st["nslots"]
        st["nslots"] += 1
        st["meta"][slot] = (g.shape, g.dtype)
        if st["cc"] is not None and g.is_floating_point():
            st["pending"].append((slot, g))
            st["pending_bytes"] += g.numel() * 4     # bucket carries f32
            if st["pending_bytes"] >= st["cap"]:
                self._flush_bucket()
        else:
            st["singles"][slot] = collective.allreduce_async(
                g, self.group_name, op=self.op, compression=st["cc"])
        return slot

    def _flush_bucket(self):
        st = self._stream
        if not st["pending"]:
            return
        parts, segments, off = [], [], 0
        for slot, g in st["pending"]:
            flat = g.reshape(-1).to(torch.float32)
            res = self._residuals.get(slot) if st["use_ef"] else None
            if res is not None:
                flat = flat + res.reshape(-1).to(torch.float32)
            parts.append(flat)
            segments.append((slot, off, off + flat.numel()))
            off += flat.numel()
        st["pending"] = []
        st["pending_bytes"] = 0
        corrected = parts[0] if len(parts) == 1 else torch.cat(parts)
        handle = collective.allreduce_async(corrected, self.group_name,
                                            op=self.op, compression=st["cc"])
        st["buckets"].append((handle, corrected, segments))

    def finish(self) -> List[torch.Tensor]:
        """Flush the tail bucket, await every in-flight reduce, update
        residuals, and return the synced leaves in push order."""
        st = self._stream
        if st is None:
            raise RuntimeError("finish() without begin()")
        self._flush_bucket()
        cc = st["cc"]
        out: List[Optional[torch.Tensor]] = [None] * st["nslots"]
        for handle, corrected, segments in st["buckets"]:
            reduced = handle.result()
            # did the wire actually compress this bucket?  (mirrors
            # collective._resolve_op_compression: small buckets go exact)
            compressed = cc is not None and corrected.numel() >= cc.min_size
            resid = (quantization_error(corrected, cc.block_size)
                     if compressed and st["use_ef"] else None)
            for slot, a, b in segments:
                shape, dtype = st["meta"][slot]
                out[slot] = reduced[a:b].reshape(shape).to(dtype)
                if resid is not None:
                    # parameter dtype on purpose: bf16 params keep bf16
                    # residuals (the re-injection upcasts to f32)
                    self._residuals[slot] = resid[a:b].reshape(shape).to(
                        dtype)
                elif st["use_ef"]:
                    # an exact (uncompressed) sync consumed whatever
                    # residual was injected
                    self._residuals[slot] = torch.zeros(
                        shape, dtype=dtype, device=corrected.device)
        for slot, handle in st["singles"].items():
            out[slot] = handle.result()
        self._stream = None
        return out

    def __call__(self, grads):
        """Sync a tree (nested dicts, lists, tuples) of gradient tensors;
        returns the same structure of synced tensors."""
        leaves, rebuild = _flatten(grads)
        self.begin()
        for g in leaves:
            self.push(g)
        return rebuild(self.finish())
