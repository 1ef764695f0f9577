"""Collectives over a ``torch.distributed`` process group: NCCL for CUDA
tensors, gloo for CPU tensors.

Counterpart of ``ray_tpu/collective/xla_group.py`` (the reference Ray
calls this layer ``nccl_collective_group.py``).  The reference compiles
each collective as a ``shard_map`` program over a mesh, driven by one
controller that passes ONE global array; here every rank is its own
process and the contract is rank-local: each rank passes its own shard
and gets its own result (the shard the reference's ``out_specs`` would
give that device).  ``group`` is a process group (None: the default
one); its size is the reference's mesh axis size and the rank in it the
``axis_index``.  Every ``mesh_*`` function also takes the reference's
form, a ``DeviceMesh`` (``parallel/mesh.py``) and an axis name in place
of the group — ``mesh_allreduce(x, mesh, "dp")``,
``mesh_ppermute(x, mesh, perm, "sp")`` — and then runs over
``mesh.get_group(axis_name)``, still on this rank's shard.
``mesh_ppermute`` and ``mesh_all_to_all`` are differentiable (ring and
Ulysses attention train through them): the gradient of a permutation is
the inverse permutation, that of an all-to-all the all-to-all with
``split_axis`` and ``concat_axis`` swapped.  So are the collectives of
a sharded step's rank-local region (``gather_dim``: all-gather,
reduce-scatter backward; ``sum_partials`` / ``sum_grads``: Megatron's
"g" and "f"; ``reduce_values``), which ``parallel/spmd.py`` runs over
mesh axes: every collective of the mesh path is one of this module's.

The quantized (EQuARX-style) paths move int8 blocks and f32 per-block
scales (``ops/quantize.py``'s layout) and run the reference's compiled
arithmetic step for step (the scale's and the mean's divisions by
constants as products with f32 reciprocals, as XLA compiles them), so
with deterministic rounding they give its results bit for bit: quantize (K4) -> ``all_to_all`` -> dequantize-accumulate (K6)
-> requantize at the finer result block (K4) -> ``all_gather`` ->
dequantize (K5).  Stochastic draws keep the reference's seed arithmetic
(``seed * world + rank + chunk``, ``+ 1`` for the requantize), so they
reproduce from run to run; the bits themselves are the port's own.

Phase 1 of a chunk may instead run as ONE kernel, K7
(``ops.quantize.fused_reduce_scatter``: quantize, store each peer its row
over CUDA peer memory, accumulate), chosen per call by
``_resolve_rs_impl`` with the reference's rule (``xla_group.py:103``):
``impl="auto"`` takes K7 for deterministic rounding, a block that is a
multiple of 128, world > 1 and a chunk under the reference's 8 MiB VMEM
cap, when the group has peer memory on CUDA; ``RAY_TPU_FUSED_RS=0``
turns it off.  ``impl="fused"`` asks for K7 at any world and chunk size
and raises where the group has no peer memory (gloo, or cards that cannot
map each other's memory); ``impl="fused_plain"`` runs K7's plain version
(its exchange through ``all_to_all``), as the reference's
``fused_interpret`` runs its kernel through the interpreter.  Both phase-1
paths give the same bits.

Every public collective reports its dispatch time and its payload and
wire bytes to the flight recorder (``_record_mesh_op``; no fence, as in
the reference: waiting here would serialize the very overlap the
pipeline buys), and the bodies run through the program ledger
(``telemetry/device.py``) as the reference's compiled programs do.
``mesh_allreduce(profile=True)`` runs the quantized path as six fenced
stages instead — K4 quantize, ``all_to_all``, K6 dequantize-accumulate,
K4 requantize, ``all_gather``, K5 stitch — and charges them to the
``quantize``, ``transfer`` and ``dequantize`` sub-phases of the current
step's ``collective`` phase (``_q_allreduce_profiled``).
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.collective.compression import (CompressionConfig,
                                                  auto_pipeline_chunks,
                                                  chunk_layout,
                                                  parse_compression,
                                                  result_block_size,
                                                  wire_ratio)
from ray_tpu_torch.collective import peer_memory
from ray_tpu_torch.ops.quantize import (dequantize_accumulate,
                                        dequantize_blockwise,
                                        fused_reduce_scatter,
                                        fused_rs_vmem_bytes, padded_len,
                                        quantize_blockwise, reciprocal)
from ray_tpu_torch.telemetry import device as _devtel
from ray_tpu_torch.telemetry.recorder import _fence
from ray_tpu_torch.util import tracing

Group = Optional[dist.ProcessGroup]
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _record_mesh_op(op: str, t0: float, x: torch.Tensor,
                    cc: Optional[CompressionConfig],
                    breakdown: Optional[dict] = None) -> None:
    """Report dispatch time + byte counters to the flight recorder
    (reference: ``xla_group.py:40-60``).  Dispatch-side only — no forced
    fence here: the card's time lands in the step's fenced total
    instead.  ``breakdown`` carries measured quantize/transfer/
    dequantize sub-phase seconds when the caller ran the staged
    (fenced) profiling path."""
    try:
        from ray_tpu_torch.telemetry import recorder as _rec

        nbytes = float(x.numel() * x.element_size())
        wire = None
        if nbytes and cc is not None:
            wire = nbytes * wire_ratio(x.numel(), cc,
                                       baseline_itemsize=x.element_size())
        _rec.record_collective(op, time.perf_counter() - t0, nbytes, wire,
                               breakdown=breakdown)
    except Exception:
        pass


def _world_rank(group: Group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _global_rank(group: Group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _backend(x: torch.Tensor) -> str:
    """auto_pipeline_chunks's backend string for where x lies."""
    return "gpu" if x.device.type == "cuda" else "cpu"


def _mean(x: torch.Tensor, world: int) -> torch.Tensor:
    """A sum over ``world`` ranks made a mean as the reference's compiled
    ``pmean`` makes it: times the f32 reciprocal of world."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return x * torch.full((), reciprocal(world), dtype=x.dtype,
                          device=x.device)


_IMPLS = ("auto", "plain", "fused", "fused_plain")
# the reference's cap on the fused kernel's VMEM footprint per chunk
# (xla_group.py:100), kept so auto picks what the reference picks
_FUSED_RS_VMEM_CAP = 8 << 20


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(
            f"unknown impl {impl!r} (the port has 'auto': the Hopper "
            f"kernels for CUDA tensors, K7 where the reference's rule picks "
            f"its fused kernel; 'plain'; 'fused': K7 forced; 'fused_plain': "
            f"K7's plain version)")


def has_peer_memory(x: torch.Tensor, group: Group) -> bool:
    """Whether K7 can run x's reduce-scatter hop: a CUDA tensor, and a
    group with peer memory (``collective/peer_memory.py``)."""
    return x.device.type == "cuda" and peer_memory.lookup(group) is not None


def _resolve_rs_impl(impl: str, world: int, block: int, stochastic: bool,
                     max_chunk_elems: int, peers: bool) -> str:
    """How phase 1 (the reduce-scatter hop) runs: "fused" (K7), "staged"
    (K4 -> all_to_all -> K6) or "fused_plain" (K7's plain version).  The
    reference's rule (``xla_group.py:103-120``) with "the group has peer
    memory on CUDA" (``peers``) in place of "the backend is a TPU"."""
    if impl in ("fused", "fused_plain"):
        return impl
    if impl != "auto":
        return "staged"
    if os.environ.get("RAY_TPU_FUSED_RS", "1") in ("0", "false", "off"):
        return "staged"
    if (peers and not stochastic and block % 128 == 0 and world > 1
            and fused_rs_vmem_bytes(world, max_chunk_elems)
            <= _FUSED_RS_VMEM_CAP):
        return "fused"
    return "staged"


def resolve_chunks(cc: CompressionConfig, x: torch.Tensor) -> int:
    """The pipeline chunk count the quantized allreduce takes for x: the
    config's, or auto (by payload bytes on the card, 1 on the CPU)."""
    if cc.pipeline_chunks:
        return cc.pipeline_chunks
    return auto_pipeline_chunks(x.numel(), x.element_size(), _backend(x))


def mesh_allreduce(x: torch.Tensor, group: Group = None, op: str = "sum",
                   compression: Union[None, str, CompressionConfig] = None,
                   seed: int = 0, impl: str = "auto",
                   profile: bool = False) -> torch.Tensor:
    """Allreduce this rank's tensor with its peers'; returns a new tensor
    of x's shape and dtype (reference API: collective.py:258 allreduce).
    ``mesh_allreduce(x, mesh, axis_name, op=...)`` runs over the line of
    ``mesh`` along ``axis_name``.

    compression: a CompressionConfig / spec string ("int8",
    "int8:block=512") switches to the two-phase quantized path (sum/mean
    only), chunked per ``CompressionConfig.pipeline_chunks`` (0 = auto):
    the quantize of chunk k+1 runs on the compute stream while chunk k's
    ``all_to_all`` is in flight.  Chunked and monolithic results are
    bit-identical for deterministic rounding.  ``impl="plain"`` runs the
    kernels' plain versions on any device; ``"fused"`` forces K7 for the
    reduce-scatter hop (raising where the group has no peer memory),
    ``"fused_plain"`` its plain version; "auto" picks K7 where the
    reference's rule does.  ``seed`` feeds stochastic rounding.

    profile=True runs the same numerics as six fenced stages and
    reports measured quantize/transfer/dequantize sub-phase seconds to
    the flight recorder — attribution mode for bench/debug; the
    pipelined path stays the default because the fences serialize the
    very overlap the pipeline buys."""
    t0 = time.perf_counter()
    cc = parse_compression(compression)
    with tracing.span("collective.mesh_allreduce",
                      world=dist.get_world_size(group),
                      op=op, compressed=cc is not None):
        out, breakdown = _mesh_allreduce(x, group, op, cc, seed, impl,
                                         profile)
    _record_mesh_op("mesh_allreduce", t0, x, cc, breakdown)
    return out


def _mesh_allreduce(x: torch.Tensor, group: Group, op: str,
                    cc: Optional[CompressionConfig], seed: int, impl: str,
                    profile: bool = False):
    """mesh_allreduce without its flight-recorder report (the group API,
    ``collective.allreduce``, reports its own): (result, breakdown)."""
    _check_impl(impl)
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    if cc is None:
        return _allreduce(x, group, op), None
    if op not in ("sum", "mean"):
        raise ValueError(f"compressed allreduce supports op in "
                         f"('sum', 'mean'), got {op!r}")
    if profile:
        return _q_allreduce_profiled(x, int(seed), group, op, cc)
    return _q_allreduce(x, int(seed), group, op, cc.block_size,
                        cc.stochastic, resolve_chunks(cc, x), impl), None


def _allreduce(x: torch.Tensor, group: Group, op: str,
               async_op: bool = False):
    """Full-precision allreduce into a copy of x; with async_op, returns
    (out, finish) where finish() waits and applies the mean."""
    world, _ = _world_rank(group)
    out = x.clone(memory_format=torch.contiguous_format)
    work = dist.all_reduce(out, op=_REDUCE_OPS[op], group=group,
                           async_op=async_op)

    def finish():
        if work is not None:
            work.wait()
        return _mean(out, world) if op == "mean" else out

    return (out, finish) if async_op else finish()


def _exchange(q: torch.Tensor, s: torch.Tensor, group: Group):
    """Start the reduce-scatter hop: rank p receives row p of every
    peer's [world, ...] codes, in peer order (``lax.all_to_all`` tiled on
    axis 0)."""
    qx, sx = torch.empty_like(q), torch.empty_like(s)
    works = (dist.all_to_all_single(qx, q, group=group, async_op=True),
             dist.all_to_all_single(sx, s, group=group, async_op=True))
    return qx, sx, works


def _gather(q: torch.Tensor, s: torch.Tensor, world: int, group: Group):
    """Start the all-gather of every rank's codes, in rank order."""
    qg = q.new_empty(world * q.numel())
    sg = s.new_empty(world * s.numel())
    works = (dist.all_gather_into_tensor(qg, q, group=group, async_op=True),
             dist.all_gather_into_tensor(sg, s, group=group, async_op=True))
    return qg, sg, works


def _wait(works) -> None:
    for w in works:
        w.wait()


def _q_allreduce(x: torch.Tensor, seed: int, group: Group, op: str,
                 block: int, stochastic: bool, chunks: int,
                 impl: str) -> torch.Tensor:
    """Chunked, software-pipelined two-phase quantized allreduce (the
    reference's ``_q_allreduce_impl``).

    The flat payload is padded to a world*block multiple, viewed as
    [world, sub], and split column-wise into block-aligned chunks
    (``chunk_layout``).  Per chunk: quantize (K4, reading the column
    slice in place) -> ``all_to_all`` -> dequantize-accumulate (K6, the
    mean's 1/world fused) -> requantize at the finer result block (K4)
    -> ``all_gather`` -> dequantize (K5); where ``_resolve_rs_impl``
    says "fused", one K7 launch per chunk does the first three (the
    reference's ``xla_group.py:275-280``).  Chunk boundaries land on block
    and result-block boundaries, so every per-block scale and the
    accumulation order over peers are those of ``chunks=1``."""
    world, idx = _world_rank(group)
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    total = padded_len(n, world * block)
    if total != n:
        flat = torch.cat([flat, flat.new_zeros(total - n)])
    sub = total // world
    layout = chunk_layout(sub // block, chunks)
    csizes = [nb * block for nb in layout]
    offs = [sum(csizes[:c]) for c in range(len(csizes))]
    C = len(csizes)
    x2d = flat.view(world, sub)
    rblock = result_block_size(block)
    # phase 2 pipelines per chunk only when chunk boundaries are also
    # result-block boundaries; otherwise the reduced chunks are
    # restitched and phase 2 runs once — bit-identical either way
    p2_chunked = C > 1 and block % rblock == 0
    mean_scale = reciprocal(world) if op == "mean" else None
    peers = has_peer_memory(x, group)
    rs = _resolve_rs_impl(impl, world, block, stochastic, max(csizes), peers)
    if rs == "fused" and not peers:
        raise RuntimeError(
            f"impl='fused' needs CUDA peer memory, and this {x.device.type} "
            f"tensor's group has none (an NCCL group made by "
            f"collective.init_collective_group on cards that can map each "
            f"other's memory has it); the staged path is impl='auto'")
    if rs != "staged" and stochastic:
        raise ValueError("the fused reduce-scatter rounds deterministically "
                         "only (stochastic rounding takes the staged path)")
    if impl in ("fused", "fused_plain"):
        impl = "plain" if impl == "fused_plain" else "auto"

    def quantize_chunk(c):
        return quantize_blockwise(x2d[:, offs[c]:offs[c] + csizes[c]], block,
                                  stochastic=stochastic,
                                  seed=seed * world + idx + c, impl=impl,
                                  reciprocal_scale=True)

    def requant_chunk(c, red_c):
        return quantize_blockwise(red_c, rblock, stochastic=stochastic,
                                  seed=seed * world + idx + c + 1, impl=impl,
                                  reciprocal_scale=True)

    def stitch(qg, sg, csz):
        # every rank's piece may carry rblock padding: dequantize all of
        # it row-wise and strip the padding
        out = dequantize_blockwise(qg, sg, (qg.numel(),), torch.float32,
                                   rblock, impl=impl)
        return out.view(world, -1)[:, :csz]

    reds = [None] * C
    if rs != "staged":
        # phase 1 as one K7 launch per chunk (the mean's 1/world fused)
        for c in range(C):
            reds[c] = fused_reduce_scatter(
                x2d[:, offs[c]:offs[c] + csizes[c]], group, block,
                scale=mean_scale, impl=impl)
    else:
        # phase 1: exchange chunk c while quantizing chunk c+1
        q, s = quantize_chunk(0)
        for c in range(C):
            qx, sx, works = _exchange(q, s, group)
            if c + 1 < C:
                q, s = quantize_chunk(c + 1)
            _wait(works)
            reds[c] = dequantize_accumulate(qx, sx, world, block, impl=impl,
                                            scale=mean_scale)

    # phase 2: gather chunk c while requantizing chunk c+1
    if p2_chunked:
        out2d = torch.empty((world, sub), dtype=torch.float32,
                            device=x.device)
        q2, s2 = requant_chunk(0, reds[0])
        for c in range(C):
            qg, sg, works = _gather(q2, s2, world, group)
            if c + 1 < C:
                q2, s2 = requant_chunk(c + 1, reds[c + 1])
            _wait(works)
            out2d[:, offs[c]:offs[c] + csizes[c]] = stitch(qg, sg, csizes[c])
    else:
        red = reds[0] if C == 1 else torch.cat(reds)
        q2, s2 = requant_chunk(0, red)
        qg, sg, works = _gather(q2, s2, world, group)
        _wait(works)
        out2d = stitch(qg, sg, sub)
    return out2d.reshape(-1)[:n].reshape(shape).to(dtype)


def _q_allreduce_profiled(x: torch.Tensor, seed: int, group: Group, op: str,
                          cc: CompressionConfig):
    """Run the quantized allreduce as six fenced stages and return
    (result, {"quantize", "transfer", "dequantize"} seconds) (reference:
    ``xla_group.py:441-484``).  Bit-identical to ``_q_allreduce`` at one
    chunk with the staged phase 1 for deterministic rounding, hence to
    every unprofiled call; ``impl`` plays no part — attribution always
    runs the staged kernels (K7 fuses three stages into one launch and
    cannot be split for timing)."""
    block, stochastic = cc.block_size, cc.stochastic
    world, idx = _world_rank(group)
    rblock = result_block_size(block)
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    total = padded_len(n, world * block)
    if total != n:
        flat = torch.cat([flat, flat.new_zeros(total - n)])
    sub = total // world
    mean_scale = reciprocal(world) if op == "mean" else None
    times = {"quantize": 0.0, "transfer": 0.0, "dequantize": 0.0}

    def run(bucket, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        _fence(out)
        times[bucket] += time.perf_counter() - t
        return out

    def exchange(q, s):
        qx, sx, works = _exchange(q, s, group)
        _wait(works)
        return qx, sx

    def gather(q, s):
        qg, sg, works = _gather(q, s, world, group)
        _wait(works)
        return qg, sg

    _fence(flat)
    q, s = run("quantize", quantize_blockwise, flat.view(world, sub), block,
               stochastic=stochastic, seed=seed * world + idx,
               reciprocal_scale=True)
    qx, sx = run("transfer", exchange, q, s)
    red = run("dequantize", dequantize_accumulate, qx, sx, world, block,
              scale=mean_scale)
    q2, s2 = run("quantize", quantize_blockwise, red, rblock,
                 stochastic=stochastic, seed=seed * world + idx + 1,
                 reciprocal_scale=True)
    qg, sg = run("transfer", gather, q2, s2)
    out = run("dequantize", dequantize_blockwise, qg, sg, (qg.numel(),),
              torch.float32, rblock)
    out = out.view(world, -1)[:, :sub].reshape(-1)[:n].reshape(shape)
    return out.to(dtype), times


def mesh_reducescatter(x: torch.Tensor, group: Group = None,
                       compression: Union[None, str,
                                          CompressionConfig] = None,
                       seed: int = 0) -> torch.Tensor:
    """Reduce across the group, leave each rank its chunk (reference API:
    collective.py:472 reducescatter).  x is this rank's contribution of N
    elements ([1, N] as the reference's shard, or [N]); returns rank r's
    reduced chunk, elements [r*N/world, (r+1)*N/world), shaped like x with
    its last dim N/world.  With ``compression``, contributions travel as
    int8 blocks + scales (sum semantics, lossy).  The mesh form:
    ``mesh_reducescatter(x, mesh, axis_name)``."""
    t0 = time.perf_counter()
    cc = parse_compression(compression)
    with tracing.span("collective.mesh_reducescatter",
                      world=dist.get_world_size(group),
                      compressed=cc is not None):
        out = _reducescatter(x, group, cc, seed)
    _record_mesh_op("mesh_reducescatter", t0, x, cc)
    return out


def _reducescatter(x: torch.Tensor, group: Group,
                   cc: Optional[CompressionConfig], seed: int
                   ) -> torch.Tensor:
    world, idx = _world_rank(group)
    row = x.reshape(-1)
    if row.numel() % world:
        raise ValueError(f"reducescatter needs the payload ({row.numel()} "
                         f"elements) divisible by the group size ({world})")
    sub = row.numel() // world
    out_shape = tuple(x.shape[:-1]) + (sub,)
    if cc is None:
        out = row.new_empty(sub)
        dist.reduce_scatter_tensor(out, row.contiguous(), op=dist.ReduceOp.SUM,
                                   group=group)
        return out.reshape(out_shape)
    block = cc.block_size
    sub_pad = padded_len(sub, block)
    chunks = row.to(torch.float32).view(world, sub)
    if sub_pad != sub:
        chunks = torch.nn.functional.pad(chunks, (0, sub_pad - sub))
    q, s = quantize_blockwise(chunks, block, stochastic=cc.stochastic,
                              seed=seed * world + idx, reciprocal_scale=True)
    qx, sx, works = _exchange(q, s, group)
    _wait(works)
    red = dequantize_accumulate(qx, sx, world, block)
    return red[:sub].reshape(out_shape).to(x.dtype)


def mesh_allgather(x: torch.Tensor, group: Group = None,
                   compression: Union[None, str, CompressionConfig] = None,
                   seed: int = 0) -> torch.Tensor:
    """Each rank contributes its shard; all get the concatenation along
    dim 0, in rank order (reference API: collective.py:423 allgather).
    With ``compression``, shards travel as int8 blocks + scales and are
    dequantized on arrival (lossy; see compression.py).  The mesh form:
    ``mesh_allgather(x, mesh, axis_name)``."""
    t0 = time.perf_counter()
    cc = parse_compression(compression)
    with tracing.span("collective.mesh_allgather",
                      world=dist.get_world_size(group),
                      compressed=cc is not None):
        out = _allgather(x, group, cc, seed)
    _record_mesh_op("mesh_allgather", t0, x, cc)
    return out


def _allgather(x: torch.Tensor, group: Group,
               cc: Optional[CompressionConfig], seed: int) -> torch.Tensor:
    """mesh_allgather without its flight-recorder report."""
    world, idx = _world_rank(group)
    out_shape = (world * x.shape[0],) + tuple(x.shape[1:])
    if cc is None:
        out = x.new_empty(out_shape)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    block = cc.block_size
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    npad = padded_len(n, block)
    q, s = quantize_blockwise(flat, block, stochastic=cc.stochastic,
                              seed=seed * world + idx, reciprocal_scale=True)
    qg, sg, works = _gather(q, s, world, group)
    _wait(works)
    out = dequantize_blockwise(qg, sg, (world * npad,), torch.float32, block)
    return out.view(world, npad)[:, :n].reshape(out_shape).to(x.dtype)


def _broadcast(x: torch.Tensor, group: Group = None,
               root: int = 0) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=_global_rank(group, int(root)), group=group)
    return out


def _ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
              group: Group = None) -> torch.Tensor:
    """Point-to-point shard rotation (reference API: collective.py:531/:594
    send/recv, ``lax.ppermute``): for each (src, dst) in ``perm``, rank
    dst receives rank src's shard; a rank no pair sends to gets zeros."""
    world, idx = _world_rank(group)
    perm = [(int(a), int(b)) for a, b in perm]
    srcs, dsts = [a for a, _ in perm], [b for _, b in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= r < world for r in srcs + dsts)):
        raise ValueError(f"perm {perm} is not a partial permutation of "
                         f"ranks 0..{world - 1}")
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    src = x.contiguous()
    ops: List[dist.P2POp] = []
    for a, b in perm:
        if a == idx and b == idx:
            out.copy_(src)
        elif a == idx:
            ops.append(dist.P2POp(dist.isend, src, _global_rank(group, b),
                                  group))
        elif b == idx:
            ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, a),
                                  group))
    if ops:
        _wait(dist.batch_isend_irecv(ops))
    return out


def _all_to_all(x: torch.Tensor, group: Group = None, split_axis: int = 1,
                concat_axis: int = 0) -> torch.Tensor:
    """All-to-all reshard — the Ulysses/MoE-dispatch primitive (reference:
    ``lax.all_to_all`` tiled).  This rank's shard is split along
    ``split_axis`` into ``world`` pieces, piece j goes to rank j, and the
    pieces received are concatenated along ``concat_axis`` in source
    order."""
    world, _ = _world_rank(group)
    split_axis %= x.dim()
    if x.shape[split_axis] % world:
        raise ValueError(f"split axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not divide into "
                         f"{world} pieces")
    send = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    pieces = recv.view((world, -1) + tuple(send.shape[1:]))
    return torch.cat([p.movedim(0, split_axis) for p in pieces.unbind(0)],
                     dim=concat_axis)


# -- differentiable collectives ------------------------------------------
# What a sharded step, the ring and Ulysses run inside their rank-local
# regions (``parallel/spmd.py`` names mesh axes for them).  Each call, in
# the forward and in the backward, is traced and reported to the flight
# recorder under its ``mesh_*`` name like the public collectives, and its
# body runs through the program ledger.


def _traced(op: str, x: torch.Tensor, group: Group, body, *args):
    t0 = time.perf_counter()
    with tracing.span("collective." + op, world=dist.get_world_size(group)):
        out = body(*args)
    _record_mesh_op(op, t0, x, None)
    return out


def _gather_along(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    x0 = x.movedim(dim, 0).contiguous()
    out = _traced("mesh_allgather", x0, group, _allgather, x0, group, None,
                  0)
    return out.movedim(0, dim)


def _scatter_along(g: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    g0 = g.movedim(dim, 0).contiguous()
    out = _traced("mesh_reducescatter", g0, group, _reducescatter,
                  g0.reshape(-1), group, None, 0)
    world = dist.get_world_size(group)
    # contiguous: a DTensor leaf's to_local() backward hangs on gloo
    # given a strided gradient (a shard gathered along a dim other than 0)
    return out.view((g0.shape[0] // world,)
                    + tuple(g0.shape[1:])).movedim(0, dim).contiguous()


def _sum_over(x: torch.Tensor, groups: Sequence[Group],
              op: str = "sum") -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        out = _traced("mesh_allreduce", out, g, _allreduce, out, g, op)
    return out


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_along(g, ctx.dim, ctx.group), None, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _sum_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.groups), None


class _PPermuteFn(torch.autograd.Function):
    """ppermute whose gradient is the inverse permutation."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _traced("mesh_ppermute", x, group, _ppermute_prog, x, perm,
                       group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(b, a) for a, b in ctx.perm]
        g = g.contiguous()
        return (_traced("mesh_ppermute", g, ctx.group, _ppermute_prog, g,
                        inverse, ctx.group), None, None)


class _AllToAllFn(torch.autograd.Function):
    """all_to_all whose gradient is the all_to_all with the split and
    concat axes swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group = group
        ctx.split_axis, ctx.concat_axis = split_axis % x.dim(), \
            concat_axis % x.dim()
        return _traced("mesh_all_to_all", x, group, _all_to_all_prog, x,
                       group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_traced("mesh_all_to_all", g, ctx.group, _all_to_all_prog,
                        g, ctx.group, ctx.concat_axis, ctx.split_axis),
                None, None, None)


def gather_dim(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's ``x``, in rank
    order; its gradient is reduce-scattered back along ``dim``."""
    return _GatherDim.apply(x, dim, group)


def sum_partials(x: torch.Tensor, groups: Sequence[Group]) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over each group in turn; its
    gradient passes as it is (the same on every rank)."""
    return _SumPartials.apply(x, tuple(groups))


def sum_grads(x: torch.Tensor, groups: Sequence[Group]) -> torch.Tensor:
    """``x`` as it is; its gradient summed over each group in turn."""
    return _SumGrads.apply(x, tuple(groups))


def reduce_values(x: torch.Tensor, groups: Sequence[Group],
                  op: str = "sum") -> torch.Tensor:
    """A copy of ``x`` reduced by ``op`` over each group in turn,
    recording no gradient (counts, maxima, norms)."""
    return _sum_over(x.detach(), groups, op)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _is_mesh(obj) -> bool:
    return obj is not None and hasattr(obj, "mesh_dim_names") \
        and hasattr(obj, "get_group")


def _axis(mesh, axis_name: Optional[str]) -> str:
    """The reference's rule (``xla_group.py:63``): a one-axis mesh needs
    no name."""
    if axis_name is None:
        names = tuple(mesh.mesh_dim_names)
        if len(names) != 1:
            raise ValueError(f"specify axis_name for multi-axis mesh "
                             f"{names}")
        return names[0]
    if axis_name not in tuple(mesh.mesh_dim_names):
        raise ValueError(f"axis {axis_name!r} is not in the mesh (axes: "
                         f"{tuple(mesh.mesh_dim_names)})")
    return axis_name


def _mesh_group(mesh, axis_name: Optional[str]) -> Group:
    return mesh.get_group(_axis(mesh, axis_name))


def _group_from(args: tuple, kwargs: dict, group_key: str = "group"):
    """(group, rest of the positional args): the group form passes the
    group itself; the mesh form ``(mesh, axis_name, ...)`` a mesh and an
    axis name, whose line's group is taken."""
    if args and _is_mesh(args[0]):
        mesh, args = args[0], args[1:]
        axis_name = kwargs.pop("axis_name", None)
        if axis_name is None and args:
            axis_name, args = args[0], args[1:]
        return _mesh_group(mesh, axis_name), args
    if group_key in kwargs:
        return kwargs.pop(group_key), args
    if args:
        return args[0], args[1:]
    return None, args


def mesh_broadcast(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """Every rank receives root's shard (reference API: collective.py:373):
    ``mesh_broadcast(x, group=None, root=0)`` or
    ``mesh_broadcast(x, mesh, axis_name, root=0)``.  Every rank passes a
    tensor of root's shape and dtype; ``root`` is a rank of the group (a
    position on the axis)."""
    group, args = _group_from(args, kwargs)
    return _broadcast_prog(x, group, *args, **kwargs)


def mesh_ppermute(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """Point-to-point shard rotation, differentiable:
    ``mesh_ppermute(x, perm, group=None)`` or the reference's
    ``mesh_ppermute(x, mesh, perm, axis_name)``.  For each (src, dst) in
    ``perm``, rank dst receives rank src's shard; a rank no pair sends to
    gets zeros.  On a line of one rank the only permutation is the
    identity."""
    if args and _is_mesh(args[0]):
        mesh, perm = args[0], args[1]
        axis = _axis(mesh, args[2] if len(args) > 2
                     else kwargs.pop("axis_name", None))
        from ray_tpu_torch.parallel.mesh import axis_group

        group = axis_group(mesh, axis)
        if group is None:
            _check_identity_perm(perm)
            return x
    else:
        perm = args[0] if args else kwargs.pop("perm")
        group = args[1] if len(args) > 1 else kwargs.pop("group", None)
    perm = [(int(a), int(b)) for a, b in perm]
    if _needs_grad(x):
        return _PPermuteFn.apply(x, perm, group)
    return _traced("mesh_ppermute", x, group, _ppermute_prog, x, perm, group)


def _check_identity_perm(perm) -> None:
    if [tuple(map(int, p)) for p in perm] not in ([], [(0, 0)]):
        raise ValueError(f"perm {list(perm)} is not a partial permutation "
                         f"of ranks 0..0")


def mesh_all_to_all(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """All-to-all reshard, differentiable:
    ``mesh_all_to_all(x, group=None, split_axis=1, concat_axis=0)`` or
    ``mesh_all_to_all(x, mesh, axis_name, split_axis=1, concat_axis=0)``.
    This rank's shard is split along ``split_axis`` into ``world`` pieces,
    piece j goes to rank j, and the pieces received are concatenated
    along ``concat_axis`` in source order."""
    if args and _is_mesh(args[0]):
        mesh, args = args[0], args[1:]
        axis_name = kwargs.pop("axis_name", None)
        if axis_name is None and args:
            axis_name, args = args[0], args[1:]
        from ray_tpu_torch.parallel.mesh import axis_group

        group = axis_group(mesh, _axis(mesh, axis_name))
        if group is None:           # one rank: the pieces stay here
            return x
    else:
        group, args = _group_from(args, kwargs)
    split_axis = args[0] if args else kwargs.pop("split_axis", 1)
    concat_axis = args[1] if len(args) > 1 else kwargs.pop("concat_axis", 0)
    if _needs_grad(x):
        return _AllToAllFn.apply(x, group, split_axis, concat_axis)
    return _traced("mesh_all_to_all", x, group, _all_to_all_prog, x, group,
                   split_axis, concat_axis)


# -- program-ledger hookup (telemetry/device.py) -------------------------
# The bodies route through the process ledger, as the reference's
# compiled collectives do (xla_group.py:678-700): a collective meeting new
# shapes every few steps shows up as a storm with a cause diff instead of
# silent step-time jitter.  The stochastic-rounding seed is an input, not
# part of the signature (the reference traces it).

_allreduce = _devtel.instrument(_allreduce, name="collective.allreduce")
_q_allreduce = _devtel.instrument(_q_allreduce, name="collective.q_allreduce",
                                  dynamic_argnames=("seed",))
_q_allreduce_profiled = _devtel.instrument(
    _q_allreduce_profiled, name="collective.q_allreduce_profiled",
    dynamic_argnames=("seed",))
_reducescatter = _devtel.instrument(
    _reducescatter, name="collective.reducescatter",
    dynamic_argnames=("seed",))
_allgather = _devtel.instrument(_allgather, name="collective.allgather",
                                dynamic_argnames=("seed",))
_broadcast_prog = _devtel.instrument(_broadcast,
                                     name="collective.broadcast")
_ppermute_prog = _devtel.instrument(_ppermute, name="collective.ppermute")
_all_to_all_prog = _devtel.instrument(_all_to_all,
                                      name="collective.all_to_all")


def _with_mesh_form(fn):
    """``fn(x, group, ...)`` that also takes ``fn(x, mesh, axis_name,
    ...)``: the group of this rank's line along the axis."""
    @functools.wraps(fn)
    def call(x, *args, **kwargs):
        group, args = _group_from(args, kwargs)
        return fn(x, group, *args, **kwargs)

    return call


mesh_allreduce = _with_mesh_form(mesh_allreduce)
mesh_reducescatter = _with_mesh_form(mesh_reducescatter)
mesh_allgather = _with_mesh_form(mesh_allgather)
