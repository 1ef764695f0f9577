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
  * "kv" — the reference's control-plane mailbox backend (the Gloo
    analog for small control-plane syncs, not bandwidth): CPU tensors
    move through the port's runtime's control-plane KV with the
    reference's epoch-numbered protocol — every op bumps the member's op
    counter, keys are f"{group}/{op_idx}/{op}/{rank}", rank 0 reduces and
    republishes.  Members are tasks or actors of ``ray_tpu_torch``'s
    runtime (or its driver).  The int8-compressed allreduce runs the
    numpy codec of ``collective/compression.py``, bitwise the reference's.

Rendezvous of "nccl"/"gloo" is a ``torch.distributed`` store, not the
control-plane KV: ``init_method`` is "file:///shared/path" or
"tcp://localhost:PORT" (any free port), as
``torch.distributed.init_process_group`` takes it.  A group of one member
needs none: it gets a FileStore in a fresh temporary directory, removed
when the group is destroyed.

The first store group a process initializes becomes
``torch.distributed``'s default group; a later one over the same members
is a subgroup of it.  Tensors stay on the group's device: every call
returns new tensors there (the reference returns numpy arrays; the kv
backend returns CPU tensors).  Every op reports its time and its logical
and wire bytes to the flight recorder (``_record_op``, where the
reference reports); the kv backend's compressed allreduce also times its
codec and mailbox stages as the ``quantize``/``transfer``/``dequantize``
breakdown.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._private.protocol import Backoff
from ray_tpu_torch.collective import nccl_group, peer_memory
from ray_tpu_torch.collective.compression import (CompressionConfig,
                                                  compress_array,
                                                  decompress_array,
                                                  wire_ratio,
                                                  resolve_compression,
                                                  result_block_size)
from ray_tpu_torch.util import tracing

BACKENDS = ("nccl", "gloo", "kv")
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
    pg: Optional[dist.ProcessGroup]
    device: torch.device
    owns_default: bool
    store_dir: Optional[str] = None
    op_idx: int = 0
    peers: Optional[peer_memory.PeerBuffers] = None

    def _key(self, op: str, rank: int) -> str:
        return f"{self.name}/{self.op_idx}/{op}/{rank}"


_groups: Dict[str, GroupHandle] = {}

# -- the kv backend's mailbox (reference: collective.py:68-94) -------------

_NS = "collective"
# how long a kv member waits for the others (the reference's deadline)
_KV_TIMEOUT_S = 120.0


def _record_op(op: str, t0: float, x=None,
               cc: Optional[CompressionConfig] = None,
               breakdown: Optional[Dict[str, float]] = None,
               elapsed: Optional[float] = None):
    """Feed the flight recorder (telemetry.recorder): op latency into the
    current step's "collective" phase + Prometheus series, logical vs
    wire bytes so compression savings are visible in production.
    `breakdown` carries measured quantize/transfer/dequantize sub-phase
    seconds when the caller timed its stages; `elapsed` overrides the
    t0-derived duration (async ops report issue+finish time, not the
    caller's overlap window).  ``x`` is a numpy array or a tensor."""
    try:
        from ray_tpu_torch.telemetry import recorder as _rec

        payload, wire = 0.0, None
        if x is not None:
            n = x.numel() if isinstance(x, torch.Tensor) else x.size
            itemsize = x.element_size() if isinstance(x, torch.Tensor) \
                else x.itemsize
            payload = float(n * itemsize)
            if cc is not None:
                wire = payload * wire_ratio(n, cc,
                                            baseline_itemsize=itemsize)
        dur = elapsed if elapsed is not None else time.perf_counter() - t0
        _rec.record_collective(op, dur, payload, wire, breakdown=breakdown)
    except Exception:
        pass


def _new_breakdown() -> Dict[str, float]:
    return {"quantize": 0.0, "transfer": 0.0, "dequantize": 0.0}


def _kv():
    from ray_tpu_torch._private.core import current_core

    return current_core().control


def _kv_put(key: str, val: bytes):
    _kv().call("kv_put", {"ns": _NS, "key": key, "val": val})


def _kv_get(key: str, timeout: float = _KV_TIMEOUT_S) -> bytes:
    deadline = time.monotonic() + timeout
    # jittered backoff: groups of pollers de-synchronize instead of
    # hammering the control plane in lockstep
    bo = Backoff(base=0.002, cap=0.05)
    while True:
        v = _kv().call("kv_get", {"ns": _NS, "key": key})
        if v is not None:
            return v
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"collective rendezvous timed out on {key}")
        bo.sleep(max_s=remaining)


def _kv_del(key: str):
    _kv().call("kv_del", {"ns": _NS, "key": key})


def _kv_exists(key: str) -> bool:
    return bool(_kv().call("kv_exists", {"ns": _NS, "key": key}))


def _init_kv_group(world_size: int, rank: int,
                   group_name: str) -> GroupHandle:
    """Post this member's init marker and poll until every member's is
    there (reference: collective.py:113)."""
    with tracing.span("collective.init", group=group_name,
                      world_size=world_size, rank=rank, backend="kv"):
        g = GroupHandle(group_name, world_size, rank, "kv", None,
                        torch.device("cpu"), False)
        _kv_put(f"{group_name}/init/{rank}", b"1")
        deadline = time.monotonic() + _KV_TIMEOUT_S
        bo = Backoff(base=0.005, cap=0.1)
        while True:
            n = sum(1 for r in range(world_size)
                    if _kv_exists(f"{group_name}/init/{r}"))
            if n == world_size:
                return g
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"collective group {group_name} init: only "
                    f"{n}/{world_size} arrived")
            bo.sleep(max_s=remaining)


class CollectiveTeardownTimeout(RuntimeError):
    """destroy_collective_group(timeout=...) of a kv group expired before
    every member posted its fin marker; the message names the absent
    ranks."""


def _destroy_kv_group(g: GroupHandle, timeout: Optional[float]) -> None:
    """Post this member's fin marker; the LAST member to arrive sweeps the
    group's KV prefix (reference: collective.py:153).  An early leaver
    returns without sweeping (it must not delete a result key a slower
    rank is still polling); with ``timeout`` it waits that long for every
    fin marker and raises :class:`CollectiveTeardownTimeout` naming the
    ranks that never posted one."""
    with tracing.span("collective.destroy", group=g.name,
                      world_size=g.world_size, rank=g.rank):
        _kv_put(f"{g.name}/fin/{g.rank}", b"1")

        def _missing() -> List[int]:
            return [r for r in range(g.world_size)
                    if not _kv_exists(f"{g.name}/fin/{r}")]

        missing = _missing()
        if missing and timeout is not None:
            deadline = time.monotonic() + timeout
            bo = Backoff(base=0.005, cap=0.1)
            while missing:
                if g.rank in missing:
                    # our own marker is gone: the last member saw every
                    # fin marker and swept (the reference waits on here
                    # and raises although every member arrived)
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CollectiveTeardownTimeout(
                        f"destroy_collective_group({g.name!r}): timed out "
                        f"after {timeout}s waiting for fin markers from "
                        f"ranks {missing} of world {g.world_size} — those "
                        f"members likely died mid-run or never called "
                        f"destroy; their KV debris will be swept by the "
                        f"next same-named group's destroy")
                bo.sleep(max_s=remaining)
                missing = _missing()
        if missing:
            return
        try:
            residual = _kv().call("kv_keys",
                                  {"ns": _NS, "prefix": f"{g.name}/"}) or []
        except Exception:
            residual = []
        for k in set(residual) | {f"{g.name}/init/{g.rank}"}:
            _kv_del(k)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A kv member's payload (a CPU tensor) as the numpy array the
    reference's protocol moves."""
    try:
        return x.detach().contiguous().numpy()
    except TypeError as e:
        raise TypeError(f"the kv backend moves numpy-typed CPU tensors; "
                        f"{x.dtype} has no numpy dtype") from e


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _kv_reduce(op: str, arrays: List[np.ndarray], world: int) -> np.ndarray:
    acc = arrays[0].copy()
    for other in arrays[1:]:
        if op in ("sum", "mean"):
            acc = acc + other
        elif op == "max":
            acc = np.maximum(acc, other)
        else:
            acc = np.minimum(acc, other)
    if op == "mean":
        acc = acc / world
    return acc


def _rng_for(g: GroupHandle, cc: CompressionConfig, rank: int):
    if not cc.stochastic:
        return None
    return np.random.default_rng((g.op_idx * (g.world_size + 1)) + rank + 1)


def _kv_issue(g: GroupHandle, x: np.ndarray, op: str,
              cc: Optional[CompressionConfig], bd: Dict[str, float]
              ) -> Callable[[], torch.Tensor]:
    """Publish this rank's (possibly quantized) contribution now and
    return the reduce/fetch half (reference: collective.py:366-462).
    Keys are pinned to the epoch captured here: an async op finishes
    after later ops have bumped ``g.op_idx``.  Rank 0 reduces; with
    compression it dequantizes every contribution, sums in f32 and
    republishes a requantized result at the finer result block, so every
    rank lands on the same quantized value.  With compression, ``bd``
    collects the codec's (quantize, dequantize) and the mailbox's
    (transfer) seconds, stage by stage, as the reference's
    (collective.py:366-413)."""
    idx = g.op_idx
    tag = "qar" if cc is not None else "ar"

    def key(rank: int) -> str:
        return f"{g.name}/{idx}/{tag}/{rank}"

    def timed(stage: str, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        bd[stage] += time.perf_counter() - t
        return out

    if cc is not None:
        payload = timed("quantize", compress_array, x, cc,
                        _rng_for(g, cc, g.rank))
        timed("transfer", _kv_put, key(g.rank),
              pickle.dumps(payload, protocol=5))
    else:
        _kv_put(key(g.rank), pickle.dumps(x, protocol=5))

    def finish() -> torch.Tensor:
        if g.rank != 0:
            if cc is None:
                return _from_numpy(pickle.loads(_kv_get(key(-1))))
            got = pickle.loads(timed("transfer", _kv_get, key(-1)))
            return _from_numpy(timed("dequantize", decompress_array,
                                     got).astype(x.dtype))
        if cc is None:
            parts = [x] + [pickle.loads(_kv_get(key(r)))
                           for r in range(1, g.world_size)]
            acc = _kv_reduce(op, parts, g.world_size)
            _kv_put(key(-1), pickle.dumps(acc, protocol=5))
            return _from_numpy(acc)
        acc = np.zeros(x.shape, np.float32)
        for r in range(g.world_size):
            raw = timed("transfer", _kv_get, key(r))
            acc += timed("dequantize", decompress_array,
                         pickle.loads(raw)).astype(np.float32)
        if op == "mean":
            acc /= g.world_size
        rcc = dataclasses.replace(cc, block_size=result_block_size(
            cc.block_size))
        result = timed("quantize", compress_array, acc, rcc,
                       _rng_for(g, cc, g.world_size))
        timed("transfer", _kv_put, key(-1),
              pickle.dumps(result, protocol=5))
        return _from_numpy(timed("dequantize", decompress_array,
                                 result).astype(x.dtype))

    return finish


def init_collective_group(world_size: int, rank: int, backend: str = "nccl",
                          group_name: str = "default",
                          init_method: Optional[str] = None,
                          device: Optional[int] = None) -> GroupHandle:
    """Register this process as ``rank`` of ``group_name`` and rendezvous
    with the other members (reference: collective.py:120).  An ``nccl``
    member binds card ``device`` (default: its rank), modulo the cards it
    sees; a caller whose ranks span nodes passes the local rank."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (known: {BACKENDS})")
    if group_name in _groups:
        raise ValueError(f"collective group {group_name!r} is already "
                         f"initialized in this process")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world size {world_size}")
    if backend == "kv":
        _groups[group_name] = _init_kv_group(world_size, rank, group_name)
        return _groups[group_name]
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend 'nccl' needs a CUDA device and none is available; "
                "use backend='gloo' for CPU tensors")
        index = rank if device is None else device
        device = torch.device("cuda", index % torch.cuda.device_count())
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


def destroy_collective_group(group_name: str = "default",
                             timeout: Optional[float] = None) -> None:
    """Leave the group.  A kv group sweeps its KV mailbox when the last
    member leaves; ``timeout`` waits that long for the others and raises
    :class:`CollectiveTeardownTimeout` naming the absent ranks.  A store
    group frees its communicators (a store rendezvous leaves nothing to
    sweep, so ``timeout`` is unused there); destroying the group that
    initialized ``torch.distributed``'s default group destroys every
    store group of this process."""
    g = _groups.pop(group_name, None)
    if g is None:
        return
    if g.backend == "kv":
        _destroy_kv_group(g, timeout)
        return
    doomed = ([h for h in _groups.values() if h.backend != "kv"] + [g]
              if g.owns_default else [g])
    for h in doomed:
        if h.peers is not None:
            peer_memory.unregister(h.pg)
            h.peers.close()
            h.peers = None
    if g.owns_default:
        for h in doomed:
            _groups.pop(h.name, None)
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
    t0 = time.perf_counter()
    try:
        if g.backend == "kv":
            _kv_put(g._key("bar", g.rank), b"1")
            for r in range(g.world_size):
                _kv_get(g._key("bar", r))
            return
        kw = {"device_ids": [g.device.index]} if g.backend == "nccl" else {}
        dist.barrier(group=g.pg, **kw)
    finally:
        _record_op("barrier", t0)


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
    issued with ``async_op`` and awaited at ``result()``.  Telemetry
    records issue + finish time — not the caller's overlap window — with
    the kv backend's stage breakdown."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    _check_op(op)
    x = _on_group(g, tensor)
    cc = _resolve_op_compression(x, op, compression)
    t0 = time.perf_counter()
    bd = None
    if g.backend == "kv":
        bd = _new_breakdown()
        finish = _kv_issue(g, _to_numpy(x), op, cc, bd)
    elif cc is not None:
        out, _ = nccl_group._mesh_allreduce(x, g.pg, op, cc, g.op_idx,
                                            "auto")

        def finish():  # enqueued on the card at issue
            return out
    else:
        _, finish = nccl_group._allreduce(x, g.pg, op, async_op=True)
    issued = time.perf_counter() - t0

    def done() -> torch.Tensor:
        t1 = time.perf_counter()
        res = finish()
        _record_op("allreduce", t0, x, cc, breakdown=bd,
                   elapsed=issued + time.perf_counter() - t1)
        return res

    return AllreduceHandle(done)


def allgather(tensor, group_name: str = "default",
              compression: Union[None, str, CompressionConfig] = None
              ) -> List[torch.Tensor]:
    """Every member receives every member's tensor, rank-ordered
    (reference: collective.py:423).  With ``compression``, each tensor
    travels as int8 blocks + scales (lossy)."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    t = _on_group(g, tensor)
    cc = (_resolve_op_compression(t, "sum", compression)
          if compression is not None else None)
    t0 = time.perf_counter()
    try:
        if g.backend == "kv":
            x = _to_numpy(t)
            if cc is not None:
                payload = compress_array(x, cc, _rng_for(g, cc, g.rank))
                _kv_put(g._key("qag", g.rank),
                        pickle.dumps(payload, protocol=5))
                return [_from_numpy(decompress_array(pickle.loads(
                    _kv_get(g._key("qag", r)))).astype(x.dtype))
                    for r in range(g.world_size)]
            _kv_put(g._key("ag", g.rank), pickle.dumps(x, protocol=5))
            return [_from_numpy(pickle.loads(_kv_get(g._key("ag", r))))
                    for r in range(g.world_size)]
        full = nccl_group._allgather(t.reshape((1,) + tuple(t.shape)),
                                     g.pg, cc, g.op_idx)
        return list(full.unbind(0))
    finally:
        _record_op("allgather", t0, t, cc)


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
    ignored but size the receive), as the reference's xla backend asks;
    the kv backend reads only root's, so other ranks may pass None."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    t0 = time.perf_counter()
    x = None
    try:
        if g.backend == "kv":
            if g.rank == src_rank:
                x = _to_numpy(_on_group(g, tensor))
                _kv_put(g._key("bc", src_rank), pickle.dumps(x, protocol=5))
                return _from_numpy(x.copy())
            x = pickle.loads(_kv_get(g._key("bc", src_rank)))
            return _from_numpy(x)
        if tensor is None:
            raise TypeError(
                "broadcast is an SPMD op: every rank must pass a tensor of "
                "root's shape and dtype (non-root values are ignored); got "
                "None — pass e.g. torch.empty_like(root's tensor)")
        x = _on_group(g, tensor)
        return nccl_group.mesh_broadcast(x, g.pg, root=src_rank)
    finally:
        _record_op("broadcast", t0, x)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """P2P send (reference: collective.py:531): a header with the dtype
    and shape, then the payload, so ``recv`` needs no buffer."""
    g = get_group_handle(group_name)
    g.op_idx += 1
    if g.backend == "kv":
        _kv_put(g._key(f"p2p-{g.rank}-{dst_rank}", g.rank),
                pickle.dumps(_to_numpy(_on_group(g, tensor)), protocol=5))
        return
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
    if g.backend == "kv":
        return _from_numpy(pickle.loads(
            _kv_get(g._key(f"p2p-{src_rank}-{g.rank}", src_rank))))
    src = nccl_group._global_rank(g.pg, src_rank)
    header = torch.empty(_HEADER_LEN, dtype=torch.int64, device=g.device)
    dist.recv(header, src, group=g.pg)
    code, ndim, *dims = header.tolist()
    out = torch.empty(dims[:ndim], dtype=_DTYPES[code], device=g.device)
    dist.recv(out, src, group=g.pg)
    return out
