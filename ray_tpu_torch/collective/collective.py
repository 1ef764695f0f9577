"""Cross-process collective API over ``torch.distributed``.

Counterpart of ``ray_tpu/collective/collective.py`` (reference Ray:
python/ray/util/collective/collective.py — init_collective_group :120,
allreduce :258, barrier :298, broadcast :373, allgather :423,
reducescatter :472, send :531, recv :594).

Backends:

  * "nccl" — CUDA tensors, one card per member process (rank r takes card
    r mod the local card count; every rank must see every card, since the
    group also maps its peers' memory for the fused reduce-scatter K7,
    ``collective/peer_memory.py``).  The reference's "xla" backend, whose
    members sit in one SPMD runtime, maps here: the collectives are
    ``collective/nccl_group.py``'s.
  * "gloo" — CPU tensors over the same code path (the CPU tests run the
    quantized collectives this way).
  * "kv" — the reference's control-plane mailbox backend.  It needs the
    task/actor runtime's KV store, which is not ported yet (ROADMAP A.4):
    asking for it raises.

Rendezvous is a ``torch.distributed`` store, not the control-plane KV:
``init_method`` is "file:///shared/path" or "tcp://localhost:PORT" (any
free port), as ``torch.distributed.init_process_group`` takes it.  A
group of one member needs none: it gets a FileStore in a fresh temporary
directory, removed when the group is destroyed.

The first group a process initializes becomes ``torch.distributed``'s
default group; a later one over the same members is a subgroup of it.
Tensors stay on the group's device: every call returns new tensors there
(the reference returns numpy arrays), and the flight-recorder hooks
(``_record_op``) wait for the tracing slice (ROADMAP A.5).
"""

from __future__ import annotations

import dataclasses
import datetime
import shutil
import tempfile
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.collective import nccl_group, peer_memory
from ray_tpu_torch.collective.compression import (CompressionConfig,
                                                  resolve_compression)

BACKENDS = ("nccl", "gloo")
# how long a member waits for the others, at rendezvous and in each op
# (the reference's rendezvous deadline)
_TIMEOUT = datetime.timedelta(seconds=120)
# send/recv's header: dtype code, ndim, then the dims (at most 8)
_HEADER_LEN = 10
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
           torch.bool)


@dataclasses.dataclass
class GroupHandle:
    """A member's view of one collective group: its size, its rank, the
    process group and device it runs on, and the count of ops issued (the
    epoch that seeds stochastic rounding, as in the reference)."""
    name: str
    world_size: int
    rank: int
    backend: str
    pg: dist.ProcessGroup
    device: torch.device
    owns_default: bool
    store_dir: Optional[str] = None
    op_idx: int = 0
    peers: Optional[peer_memory.PeerBuffers] = None


_groups: Dict[str, GroupHandle] = {}


def init_collective_group(world_size: int, rank: int, backend: str = "nccl",
                          group_name: str = "default",
                          init_method: Optional[str] = None) -> GroupHandle:
    """Register this process as ``rank`` of ``group_name`` and rendezvous
    with the other members (reference: collective.py:120)."""
    if backend == "kv":
        raise NotImplementedError(
            "the kv backend moves tensors through the control-plane KV of "
            "the task/actor runtime, which is not ported yet (ROADMAP A.4); "
            "use backend='nccl' (CUDA tensors) or 'gloo' (CPU tensors)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (known: {BACKENDS})")
    if group_name in _groups:
        raise ValueError(f"collective group {group_name!r} is already "
                         f"initialized in this process")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world size {world_size}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend 'nccl' needs a CUDA device and none is available; "
                "use backend='gloo' for CPU tensors")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    store_dir = None
    if not dist.is_initialized():
        if init_method is None:
            if world_size != 1:
                raise ValueError(
                    "init_method is needed for more than one member: "
                    "'file:///a/path/every/member/sees' or "
                    "'tcp://localhost:PORT'")
            store_dir = tempfile.mkdtemp(prefix="rtt-collective-")
            init_method = f"file://{store_dir}/store"
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=_TIMEOUT, **kw)
        pg, owns_default = dist.group.WORLD, True
    else:
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise ValueError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()} in torch.distributed's default "
                f"group; a second collective group must span the same "
                f"members (asked for rank {rank} of {world_size})")
        pg = dist.new_group(ranks=list(range(world_size)), backend=backend)
        owns_default = False
    g = GroupHandle(group_name, world_size, rank, backend, pg, device,
                    owns_default, store_dir)
    if backend == "nccl":
        # K7's receive regions, mapped by every peer (None where a pair of
        # cards cannot map each other's memory: the staged path then)
        g.peers = peer_memory.PeerBuffers.for_group(pg, device)
        if g.peers is not None:
            peer_memory.register(pg, g.peers)
    _groups[group_name] = g
    return g


def get_group_handle(group_name: str = "default") -> GroupHandle:
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} not initialized "
                         f"in this process")
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave the group and free its communicators.  Destroying the group
    that initialized ``torch.distributed``'s default group destroys every
    group of this process.  (The reference's ``timeout`` waits for the KV
    mailbox's fin markers; a store rendezvous leaves nothing to sweep.)"""
    g = _groups.pop(group_name, None)
    if g is None:
        return
    doomed = list(_groups.values()) + [g] if g.owns_default else [g]
    for h in doomed:
        if h.peers is not None:
            peer_memory.unregister(h.pg)
            h.peers.close()
            h.peers = None
    if g.owns_default:
        _groups.clear()
        dist.destroy_process_group()
    else:
        dist.destroy_process_group(g.pg)
    if g.store_dir:
        shutil.rmtree(g.store_dir, ignore_errors=True)


def _on_group(g: GroupHandle, tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"collective ops take torch tensors, got "
                        f"{type(tensor).__name__}")
    if tensor.device.type != g.device.type:
        raise ValueError(f"group {g.name!r} ({g.backend}) runs on "
                         f"{g.device.type} tensors; got one on "
                         f"{tensor.device}")
    return tensor


def barrier(group_name: str = "default") -> None:
    """All members rendezvous (reference: collective.py:298)."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    kw = {"device_ids": [g.device.index]} if g.backend == "nccl" else {}
    dist.barrier(group=g.pg, **kw)


def _resolve_op_compression(x: torch.Tensor, op: str,
                            compression) -> Optional[CompressionConfig]:
    """Per-call compression decision.  Explicit arg wins; otherwise the
    group default / RAY_TPU_COLLECTIVE_COMPRESSION flag applies, but a
    defaulted config silently steps aside for ops it can't express
    (max/min) and payloads not worth compressing (small or non-float) —
    only an explicitly requested incompatible combination errors."""
    explicit = compression is not None
    cc = resolve_compression(compression)
    if cc is None:
        return None
    if op not in ("sum", "mean"):
        if explicit:
            raise ValueError(f"compressed allreduce supports op in "
                             f"('sum', 'mean'), got {op!r}")
        return None
    if x.numel() < cc.min_size or not x.is_floating_point():
        return None
    return cc


def _check_op(op: str) -> None:
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown op {op}")


def allreduce(tensor, group_name: str = "default", op: str = "sum",
              compression: Union[None, str, CompressionConfig] = None
              ) -> torch.Tensor:
    """Allreduce; returns the reduced tensor (reference: collective.py:258).

    compression: "int8" (or a CompressionConfig / spec string like
    "int8:block=512,stochastic=1") moves the payload as block-wise int8
    + per-block scales — ~4x fewer wire bytes for a bounded quantization
    error (sum/mean only).  Defaults to the group's installed config or
    the RAY_TPU_COLLECTIVE_COMPRESSION flag.  The op count seeds
    stochastic rounding."""
    return allreduce_async(tensor, group_name, op, compression).result()


class AllreduceHandle:
    """In-flight allreduce from :func:`allreduce_async`; ``result()``
    waits for (and caches) the reduced tensor.  Issue order IS the op
    order — every member must issue the same sequence of collectives —
    but results may be awaited late, so callers can keep producing bucket
    k+1 while bucket k's reduce is in flight (the GradientSynchronizer
    pipeline)."""

    def __init__(self, finish: Callable[[], torch.Tensor]):
        self._finish: Optional[Callable[[], torch.Tensor]] = finish
        self._value: Optional[torch.Tensor] = None

    def result(self) -> torch.Tensor:
        if self._finish is not None:
            self._value = self._finish()
            self._finish = None
        return self._value


def allreduce_async(tensor, group_name: str = "default", op: str = "sum",
                    compression: Union[None, str, CompressionConfig] = None
                    ) -> AllreduceHandle:
    """Issue an allreduce and return an :class:`AllreduceHandle`.

    The op index (the stochastic seed) is captured at issue.  With NCCL
    the whole quantized path is enqueued on the card's streams at issue
    and nothing on the host waits for it; an uncompressed allreduce is
    issued with ``async_op`` and awaited at ``result()``."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    x = _on_group(g, tensor)
    _check_op(op)
    cc = _resolve_op_compression(x, op, compression)
    if cc is not None:
        out = nccl_group.mesh_allreduce(x, g.pg, op=op, compression=cc,
                                        seed=g.op_idx, impl="auto")
        return AllreduceHandle(lambda: out)
    _, finish = nccl_group._allreduce(x, g.pg, op, async_op=True)
    return AllreduceHandle(finish)


def allgather(tensor, group_name: str = "default",
              compression: Union[None, str, CompressionConfig] = None
              ) -> List[torch.Tensor]:
    """Every member receives every member's tensor, rank-ordered
    (reference: collective.py:423).  With ``compression``, each tensor
    travels as int8 blocks + scales (lossy)."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    x = _on_group(g, tensor)
    cc = (_resolve_op_compression(x, "sum", compression)
          if compression is not None else None)
    full = nccl_group.mesh_allgather(x.reshape((1,) + tuple(x.shape)), g.pg,
                                     compression=cc, seed=g.op_idx)
    return list(full.unbind(0))


def reducescatter(tensor, group_name: str = "default", op: str = "sum",
                  compression: Union[None, str, CompressionConfig] = None
                  ) -> torch.Tensor:
    """Reduce then scatter equal chunks along dim 0; returns this rank's
    chunk (reference: collective.py:472; the chunks split as
    ``np.array_split``).  ``compression`` applies to the underlying
    allreduce (sum/mean only)."""
    g = get_group_handle(group_name)
    full = allreduce(tensor, group_name, op=op, compression=compression)
    return torch.tensor_split(full, g.world_size, dim=0)[g.rank]


def broadcast(tensor, src_rank: int = 0,
              group_name: str = "default") -> torch.Tensor:
    """Root's tensor to everyone (reference: collective.py:373).  Every
    rank passes a tensor of root's shape and dtype (non-root values are
    ignored but size the receive), as the reference's xla backend asks."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    if tensor is None:
        raise TypeError(
            "broadcast is an SPMD op: every rank must pass a tensor of "
            "root's shape and dtype (non-root values are ignored); got "
            "None — pass e.g. torch.empty_like(root's tensor)")
    return nccl_group.mesh_broadcast(_on_group(g, tensor), g.pg,
                                     root=src_rank)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """P2P send (reference: collective.py:531): a header with the dtype
    and shape, then the payload, so ``recv`` needs no buffer."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    x = _on_group(g, tensor).contiguous()
    if x.dtype not in _DTYPES or x.dim() > _HEADER_LEN - 2:
        raise ValueError(f"send takes {_HEADER_LEN - 2} dims at most and "
                         f"dtypes {_DTYPES}; got {x.dtype} {tuple(x.shape)}")
    header = torch.zeros(_HEADER_LEN, dtype=torch.int64)
    header[0], header[1] = _DTYPES.index(x.dtype), x.dim()
    header[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    dst = nccl_group._global_rank(g.pg, dst_rank)
    dist.send(header.to(g.device), dst, group=g.pg)
    dist.send(x, dst, group=g.pg)


def recv(src_rank: int, group_name: str = "default") -> torch.Tensor:
    """P2P recv (reference: collective.py:594).  The sender and receiver
    must issue matching op sequences (same as NCCL send/recv pairing)."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    src = nccl_group._global_rank(g.pg, src_rank)
    header = torch.empty(_HEADER_LEN, dtype=torch.int64, device=g.device)
    dist.recv(header, src, group=g.pg)
    code, ndim, *dims = header.tolist()
    out = torch.empty(dims[:ndim], dtype=_DTYPES[code], device=g.device)
    dist.recv(out, src, group=g.pg)
    return out
