"""Batch iteration, including device-fed iteration for training.

Reference: python/ray/data/iterator.py (iter_batches, iter_torch_batches).
``iter_jax_batches`` stages host batches onto a CUDA device with prefetch:
the copy of batch N+1 is enqueued while batch N is being consumed, so
input feeding overlaps the device step (the role Ray delegates to torch
DataLoader pinned-memory prefetch).

The port's copy of ``ray_tpu/data/iterator.py``.  Its ``iter_jax_batches``
is the one body that differs: pinned buffers and a copy stream where the
reference calls ``jax.device_put``, a ``device=`` argument, and
``sharding=`` as a ``parallel.NamedSharding`` whose batches come out as
DTensors.  ROADMAP §C lists what differs.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch

from .block import BlockAccessor
from .context import DataContext


def iter_block_batches(block_iter, *, batch_size: Optional[int],
                       batch_format: str, drop_last: bool = False,
                       local_shuffle_buffer_size: Optional[int] = None,
                       seed: Optional[int] = None):
    """Re-batch a stream of blocks into fixed-size batches."""
    if local_shuffle_buffer_size:
        yield from _iter_shuffled_batches(
            block_iter, batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last, buffer_size=local_shuffle_buffer_size,
            seed=seed)
        return
    carry = None  # carry-over arrow table smaller than batch_size

    def emit(table):
        return BlockAccessor(table).to_batch(batch_format)

    for block in block_iter:
        acc = BlockAccessor(block)
        if acc.num_rows() == 0:
            continue
        table = acc.to_arrow()
        if carry is not None:
            table = BlockAccessor.concat([carry, table])
            carry = None
        if batch_size is None:
            yield emit(table)
            continue
        n = table.num_rows
        start = 0
        while n - start >= batch_size:
            yield emit(table.slice(start, batch_size))
            start += batch_size
        if start < n:
            carry = table.slice(start)
    if carry is not None and not drop_last:
        yield emit(carry)


def _iter_shuffled_batches(block_iter, *, batch_size, batch_format,
                           drop_last, buffer_size, seed):
    """Local shuffle: rows pool in a buffer that mixes ACROSS blocks; once
    the pool holds >= buffer_size + batch_size rows it is permuted and
    batches are drawn from it (reference: iterator's
    local_shuffle_buffer_size contract — a bigger buffer means more
    mixing)."""
    rng = np.random.RandomState(seed)
    bs = batch_size or int(buffer_size)
    buf = None

    def emit(table):
        return BlockAccessor(table).to_batch(batch_format)

    def permute(table):
        return BlockAccessor(table).random_permutation(
            int(rng.randint(0, 2**31)))

    for block in block_iter:
        acc = BlockAccessor(block)
        if acc.num_rows() == 0:
            continue
        t = acc.to_arrow()
        buf = t if buf is None else BlockAccessor.concat([buf, t])
        if buf.num_rows >= buffer_size + bs:
            buf = permute(buf)
            while buf.num_rows >= buffer_size + bs:
                yield emit(buf.slice(0, bs))
                buf = buf.slice(bs)
    if buf is not None and buf.num_rows:
        buf = permute(buf)
        start = 0
        while buf.num_rows - start >= bs:
            yield emit(buf.slice(start, bs))
            start += bs
        if start < buf.num_rows and not drop_last:
            yield emit(buf.slice(start))


def prefetch_iter(it: Iterator, depth: int) -> Iterator:
    """Run `it` in a background thread with a bounded queue."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()
    err: List[BaseException] = []

    # propagate task context: the spawning thread may be executing a task
    # (e.g. a Train worker's loop); the prefetcher does that task's
    # blocking get()s, so it must count as the task for the raylet's
    # blocked-CPU lending or a fully-reserved node deadlocks
    from ray_tpu_torch._private.core import adopt_task_context

    def worker():
        adopt_task_context()
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(DONE)

    t = threading.Thread(target=worker, daemon=True, name="data-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            if err:
                raise err[0]
            return
        yield item


# What the device-fed iterator staged, read by chip_smoke and the tests as
# ops/_kernels.py's launch counts are: every staged batch and its bytes,
# and the batches whose copy went through a CUDA copy stream.
_staged = {"batches": 0, "bytes": 0, "copy_stream_batches": 0}


def staging_counts() -> Dict[str, int]:
    return dict(_staged)


def reset_staging_counts() -> None:
    for k in _staged:
        _staged[k] = 0


def iter_jax_batches(batch_iter: Iterator[Dict[str, np.ndarray]], *,
                     sharding=None, dtypes: Optional[Dict[str, Any]] = None,
                     prefetch: int = 2, device=None) -> Iterator:
    """Move numpy batches onto a device as torch tensors, with prefetch.

    "jax" in the name is the reference's API, kept so that code written
    against ``ray_tpu.data`` runs when only its import changes; it is no
    dependency.  Batches come out as dicts of ``torch.Tensor``.

    ``device`` is resolved now, at call time, as the reference captures
    its mesh: None means ``cuda:<torch.cuda.current_device()>`` (in a
    trainer worker, the card ``train.torch.get_device()`` gave once the
    loop called ``torch.cuda.set_device``) and raises with no CUDA device;
    ``device="cpu"`` is the host path, tensors that own their memory.

    On a CUDA device each column goes: host batch -> ``dtypes`` cast on the
    host -> a pinned buffer -> ``.to(device, non_blocking=True)`` on a copy
    stream of the iterator's own.  The pinned buffers form a ring of
    ``max(1, prefetch) + 1`` per column, and a buffer is rewritten only
    after its last copy completed.  Batch N+1's copy is enqueued before
    batch N is yielded, with ``prefetch`` batches in flight; a yielded
    batch's tensors are ready on the consumer's current stream, which
    waits on their copy's event, and are recorded on it for the caching
    allocator.

    ``dtypes`` maps a column to a numpy or torch dtype (or is one dtype
    for a non-dict batch).

    ``sharding`` (a ``parallel.NamedSharding``, e.g. ``batch_sharding(
    mesh)``) lays each batch out over a mesh, as the reference's
    ``jax.device_put(batch, sharding)``: every rank iterates the same
    host batches (the global arrays), stages only its own block of each
    column through the same ring and copy stream onto the mesh's device,
    and gets DTensors of the global shape.  With no sharding and a
    default mesh installed, the reference lays batches over the mesh's
    data axes only when every device of the mesh belongs to the process;
    a process of the port holds one rank of its mesh, so its batches go
    to ``device`` as they do with no mesh (the reference's rule for a
    multi-process mesh, whose processes each iterate their own shard).
    """
    import torch

    from .._device import resolve_device

    if sharding is not None:
        from ..parallel.mesh import mesh_device
        from ..parallel.sharding import NamedSharding

        if not isinstance(sharding, NamedSharding):
            raise TypeError(f"sharding must be a parallel.NamedSharding "
                            f"(e.g. batch_sharding(mesh)), got "
                            f"{type(sharding).__name__}")
        dev = mesh_device(sharding.mesh)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"sharding's mesh computes on {dev}, not "
                             f"{device}")
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stager = _CudaStager(dev, max(1, prefetch) + 1)
    elif dev.type == "cpu":
        stager = _HostStager()
    else:
        raise ValueError(f"iter_jax_batches stages to cuda or cpu, not {dev}")
    if sharding is not None:
        stager = _ShardedStager(stager, sharding)
    return _iter_staged(batch_iter, stager, dtypes, prefetch)


class _ShardedStager:
    """Stages this rank's block of each column and hands out DTensors of
    the global shape (``sharding``'s layout)."""

    def __init__(self, inner, sharding):
        self.inner = inner
        self.sharding = sharding

    def stage(self, cols):
        local = {}
        for k, (x, dtype) in cols.items():
            arr = np.asarray(x)
            local[k] = (arr[self.sharding.local_slices(arr.shape)], dtype)
        return self.inner.stage(local)

    def ready(self, cols):
        from ..parallel.sharding import from_local

        return {k: from_local(t, self.sharding)
                for k, t in self.inner.ready(cols).items()}


def _iter_staged(batch_iter, stager, dtypes, prefetch):
    def put(batch):
        if isinstance(batch, dict):
            return stager.stage({k: (v, dtypes.get(k) if dtypes else None)
                                 for k, v in batch.items()}), True
        one = dtypes if not isinstance(dtypes, dict) else None
        return stager.stage({None: (batch, one)}), False

    def take(staged):
        cols, is_dict = staged
        cols = stager.ready(cols)
        return cols if is_dict else cols[None]

    buf: collections.deque = collections.deque()
    it = iter(batch_iter)
    # fill the pipeline
    try:
        for _ in range(max(1, prefetch)):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    for batch in it:
        nxt = put(batch)  # enqueue transfer for N+1 before yielding N
        yield take(buf.popleft())
        buf.append(nxt)
    while buf:
        yield take(buf.popleft())


def _column_dtypes(arr: np.ndarray, dtype):
    """(numpy dtype of the host cast or None, torch dtype of the tensor).
    A torch dtype is cast by torch (bf16 has no numpy dtype), any other
    by numpy, as the reference's ``astype``."""
    import torch

    if isinstance(dtype, torch.dtype):
        return None, dtype
    np_dtype = arr.dtype if dtype is None else np.dtype(dtype)
    return np_dtype, torch.from_numpy(np.empty(0, np_dtype)).dtype


def _fill(dst, arr: np.ndarray, np_dtype) -> None:
    """Write ``arr``, cast, into the host tensor ``dst`` in one pass."""
    if np_dtype is not None:
        np.copyto(dst.numpy(), arr, casting="unsafe")
        return
    import warnings

    import torch

    with warnings.catch_warnings():
        # blocks are read-only shm views; the tensor over one is only read
        warnings.simplefilter("ignore", UserWarning)
        dst.copy_(torch.from_numpy(arr))


class _HostStager:
    """``device="cpu"``: each column into a tensor of its own memory."""

    def stage(self, cols):
        import torch

        out = {}
        for k, (x, dtype) in cols.items():
            arr = np.asarray(x)
            np_dtype, t_dtype = _column_dtypes(arr, dtype)
            t = torch.empty(arr.shape, dtype=t_dtype)
            _fill(t, arr, np_dtype)
            _staged["bytes"] += arr.size * t_dtype.itemsize
            out[k] = t
        _staged["batches"] += 1
        return out

    def ready(self, out):
        return out


class _CudaStager:
    """Host batches onto one card through a ring of pinned buffers and a
    copy stream (see iter_jax_batches)."""

    def __init__(self, device, ring: int):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        # slot -> {"event": the slot's last copy, "bufs": column -> pinned}
        self.slots = [{"event": None, "bufs": {}} for _ in range(ring)]
        self.next = 0

    def stage(self, cols):
        import torch

        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if slot["event"] is not None:
            slot["event"].synchronize()   # its pinned buffers are free
        out = {}
        total = 0
        for k, (x, dtype) in cols.items():
            arr = np.asarray(x)
            np_dtype, t_dtype = _column_dtypes(arr, dtype)
            nbytes = arr.size * t_dtype.itemsize
            buf = slot["bufs"].get(k)
            if buf is None or buf.numel() < nbytes:
                buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                  pin_memory=True)
                slot["bufs"][k] = buf
            pinned = buf[:nbytes].view(t_dtype).view(arr.shape)
            _fill(pinned, arr, np_dtype)
            with torch.cuda.stream(self.stream):
                out[k] = pinned.to(self.device, non_blocking=True)
            total += nbytes
        ev = torch.cuda.Event()
        ev.record(self.stream)
        slot["event"] = ev
        _staged["batches"] += 1
        _staged["copy_stream_batches"] += 1
        _staged["bytes"] += total
        return out, ev

    def ready(self, staged):
        import torch

        out, ev = staged
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ev)
        for t in out.values():
            t.record_stream(consumer)
        return out


# ---------------------------------------------------------------------------
# DataIterator: a shardable batch-iteration handle (reference:
# python/ray/data/iterator.py DataIterator + _StreamingIterator). Train
# workers receive these — they must serialize into actor tasks.


class DataIterator:
    """Batch iteration over a stream of blocks; see Dataset.iterator()
    and Dataset.streaming_split()."""

    def _block_iter(self):
        raise NotImplementedError

    def iter_rows(self):
        for block in self._block_iter():
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = None,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: Optional[int] = None):
        ctx = DataContext.get_current()
        fmt = batch_format or ctx.default_batch_format
        it = iter_block_batches(
            self._block_iter(), batch_size=batch_size, batch_format=fmt,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            seed=local_shuffle_seed)
        depth = (ctx.prefetch_batches if prefetch_batches is None
                 else prefetch_batches)
        return prefetch_iter(it, depth) if depth else it

    def iter_torch_batches(self, **kw):
        import torch

        for b in self.iter_batches(batch_format="numpy", **kw):
            yield {k: torch.as_tensor(v) for k, v in b.items()}

    def iter_jax_batches(self, **kw):
        sharding = kw.pop("sharding", None)
        dtypes = kw.pop("dtypes", None)
        prefetch = kw.pop("prefetch", 2)
        device = kw.pop("device", None)
        return iter_jax_batches(
            self.iter_batches(batch_format="numpy", **kw),
            sharding=sharding, dtypes=dtypes, prefetch=prefetch,
            device=device)


class _DatasetIterator(DataIterator):
    """Iterator over a full Dataset (Dataset.iterator())."""

    def __init__(self, ds):
        self._ds = ds

    def _block_iter(self):
        for bundle in self._ds.iter_internal_ref_bundles():
            yield ray_tpu_torch.get(bundle.block_ref, timeout=600)


class _SplitCoordinator:
    """Actor executing one Dataset stream per epoch and serving its output
    blocks to n consumers (reference: _internal/execution/streaming_executor
    -> StreamSplitDataIterator coordinator actor).  Iterating a shard again
    is a new epoch: the stream re-executes once EVERY split finished the
    previous epoch (SPMD consumers iterate in lockstep, like the
    reference's split coordinator epoch barrier)."""

    def __init__(self, ds, n: int, equal: bool):
        import asyncio

        self._ds = ds
        self._n = n
        self._equal = equal
        self._epoch = -1      # no epoch started yet
        self._done = set()    # splits finished with the current epoch
        self._gen = None
        self._gen_lock = asyncio.Lock()
        self._start_task = None
        self._static = None   # equal=True: per-split block ref deques
        # pin only a bounded in-flight window of served refs: consumers
        # fetch a block right after receiving its ref, and pinning the
        # whole epoch would hold the entire dataset in the object store
        self._served = collections.deque(maxlen=64)

    PARK_S = 20.0  # max server-side park per call (client just re-calls)

    def _materialize_epoch(self):
        """Runs in a worker thread (to_thread): equal=True materializes
        the whole dataset; streaming just builds the generator."""
        if self._equal:
            splits = self._ds.split(self._n, equal=True)
            return [collections.deque(s.get_internal_block_refs())
                    for s in splits]
        return iter(self._ds.iter_internal_ref_bundles())

    async def next_block_ref(self, split_idx: int, epoch: int):
        """{"ref": r} | {"end": True} | {"wait": True}.  Barrier and
        epoch-start waits park HERE on the actor's event loop (async
        actor: calls interleave at awaits) for up to PARK_S — the client
        re-calls on {"wait"}, so no per-call timeout ever has to cover an
        unboundedly slow peer or a long epoch materialization.  State is
        loop-thread-confined; mutations only between awaits."""
        import asyncio

        loop = asyncio.get_event_loop()
        t0 = loop.time()
        while True:
            if epoch > self._epoch:
                if self._epoch >= 0 and len(self._done) < self._n:
                    # some split is still consuming the previous epoch
                    if loop.time() - t0 > self.PARK_S:
                        return {"wait": True}
                    await asyncio.sleep(0.02)
                    continue
                if self._start_task is None:
                    self._start_task = asyncio.ensure_future(
                        asyncio.to_thread(self._materialize_epoch))
                if not self._start_task.done():
                    if loop.time() - t0 > self.PARK_S:
                        return {"wait": True}
                    await asyncio.sleep(0.02)
                    continue
                task, self._start_task = self._start_task, None
                payload = task.result()  # raises the materialization error
                self._epoch = epoch
                self._done = set()
                self._served = collections.deque(maxlen=64)
                if self._equal:
                    self._static = payload
                else:
                    self._gen = payload
            elif epoch < self._epoch or split_idx in self._done:
                return {"end": True}
            if self._equal:
                q = self._static[split_idx]
                if not q:
                    self._done.add(split_idx)
                    return {"end": True}
                ref = q.popleft()
                self._served.append(ref)
                return {"ref": ref}
            async with self._gen_lock:
                gen = self._gen
                # sentinel form: a raw StopIteration cannot cross an
                # executor Future boundary
                bundle = await asyncio.to_thread(next, gen, None)
            if bundle is None:
                self._done.add(split_idx)
                return {"end": True}
            self._served.append(bundle)
            return {"ref": bundle.block_ref}

    async def finish_epoch(self, split_idx: int, epoch: int):
        """Consumer stopped iterating (exhausted OR abandoned mid-epoch) —
        count it toward the epoch barrier either way."""
        if epoch == self._epoch:
            self._done.add(split_idx)
        return True


class _StreamSplitIterator(DataIterator):
    """One shard of Dataset.streaming_split; safe to ship to an actor.
    Each full iteration is one epoch of the underlying stream."""

    def __init__(self, coordinator, split_idx: int):
        self._coord = coordinator
        self._idx = split_idx
        self._epoch = 0

    def _block_iter(self):
        epoch = self._epoch
        self._epoch += 1
        try:
            while True:
                r = ray_tpu_torch.get(
                    self._coord.next_block_ref.remote(self._idx, epoch),
                    timeout=600)
                if r.get("wait"):
                    continue  # server parked PARK_S; just ask again
                if r.get("end"):
                    return
                yield ray_tpu_torch.get(r["ref"], timeout=600)
        finally:
            try:
                self._coord.finish_epoch.remote(self._idx, epoch)
            except Exception:
                pass
