"""Streaming execution of logical plans over ray_tpu_torch tasks.

Reference: python/ray/data/_internal/execution/ — StreamingExecutor
(streaming_executor.py:48) drives a DAG of PhysicalOperators; MapOperator
(operators/map_operator.py:44) fans block transforms out as tasks with
bounded in-flight budgets and backpressure; all-to-all ops (shuffle/sort/
groupby) run partition+reduce phases.

Notes: blocks are host-side arrow tables moved via the object
plane; device placement happens only at iteration time (iterator.py) where
batches are staged into device memory with prefetch.  The executor itself is
a pure control loop — no data flows through the driver except metadata.

The port's copy of ``ray_tpu/data/execution.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch

from . import logical as L
from .block import Block, BlockAccessor, BlockBuilder, BlockMetadata, \
    batch_to_block, rows_to_block
from .context import DataContext


@dataclass
class RefBundle:
    """A block reference + its metadata (reference:
    _internal/execution/interfaces/ref_bundle.py).

    `order` is the bundle's logical position (lexicographic): assigned
    at sources, carried 1:1 through maps, re-based by Union/AllToAll.
    Tasks complete out of order under load, so any operator whose
    semantics depend on row order (Zip) must sort by it — buffering in
    arrival order silently mispairs rows."""

    block_ref: Any  # ObjectRef[Block]
    metadata: BlockMetadata
    order: Tuple[int, ...] = ()


# ---------------------------------------------------------------------------
# Remote task bodies (run on workers)

def _apply_stage(blocks: List[Block], stage: Dict) -> List[Block]:
    kind = stage["kind"]
    fn = stage["fn"]
    if stage.get("is_class") and isinstance(fn, type):
        # task-pool path never takes class UDFs (dataset.py validates),
        # but a directly-built plan could: instantiate per call
        fn = fn(*(stage.get("fn_constructor_args") or ()),
                **(stage.get("fn_constructor_kwargs") or {}))
    fn_args = stage.get("fn_args") or ()
    fn_kwargs = stage.get("fn_kwargs") or {}
    if kind == "block":
        return [batch_to_block(fn(b, *fn_args, **fn_kwargs)) for b in blocks]
    if kind == "batch":
        batch_size = stage.get("batch_size")
        batch_format = stage.get("batch_format") or "numpy"
        out = []
        for b in blocks:
            acc = BlockAccessor(b)
            n = acc.num_rows()
            if batch_size is None or batch_size >= n:
                slices = [b] if n else []
            else:
                slices = [acc.slice(i, min(i + batch_size, n))
                          for i in range(0, n, batch_size)]
            builder = BlockBuilder()
            for s in slices:
                res = fn(BlockAccessor(s).to_batch(batch_format),
                         *fn_args, **fn_kwargs)
                if hasattr(res, "__next__") or (
                        hasattr(res, "__iter__")
                        and not isinstance(res, (dict, list, tuple))
                        and type(res).__module__.split(".")[0]
                        not in ("numpy", "pandas", "pyarrow")):
                    for r in res:
                        builder.add_block(batch_to_block(r))
                else:
                    builder.add_block(batch_to_block(res))
            out.append(builder.build())
        return out
    # row-wise kinds
    out = []
    for b in blocks:
        builder = BlockBuilder()
        for row in BlockAccessor(b).iter_rows():
            if kind == "row":
                builder.add_row(fn(row, *fn_args, **fn_kwargs))
            elif kind == "filter":
                if fn(row, *fn_args, **fn_kwargs):
                    builder.add_row(row)
            elif kind == "flat":
                for r in fn(row, *fn_args, **fn_kwargs):
                    builder.add_row(r)
            else:
                raise ValueError(f"unknown stage kind {kind}")
        out.append(builder.build())
    return out


def _map_task(chain: List[Dict], *blocks: Block):
    """Apply a fused chain of stages to input block(s); returns
    (block, metadata)."""
    t0 = time.perf_counter()
    out = _apply_stage(list(blocks), chain[0])
    for stage in chain[1:]:
        out = _apply_stage(out, stage)
    block = BlockAccessor.concat(out)
    meta = BlockAccessor(block).get_metadata(
        exec_stats={"wall_s": time.perf_counter() - t0})
    return block, meta


def _read_task(rt, chain: List[Dict]):
    """Run a ReadTask then any fused downstream stages."""
    t0 = time.perf_counter()
    blocks = list(rt())
    for stage in chain:
        blocks = _apply_stage(blocks, stage)
    block = BlockAccessor.concat(blocks)
    meta = BlockAccessor(block).get_metadata(
        input_files=rt.metadata.input_files,
        exec_stats={"wall_s": time.perf_counter() - t0})
    return block, meta


def _read_task_streaming(rt, chain: List[Dict]):
    """Streaming variant of _read_task: each source block flows through
    the fused stages and out of the task as soon as it is produced —
    the task never holds the whole output (reference: the streaming
    executor's generator-based block returns).  Yields block, meta,
    block, meta, ..."""
    for b in rt():
        t0 = time.perf_counter()
        out = [b]
        for stage in chain:
            out = _apply_stage(out, stage)
        for ob in out:
            meta = BlockAccessor(ob).get_metadata(
                input_files=rt.metadata.input_files,
                exec_stats={"wall_s": time.perf_counter() - t0})
            yield ob
            yield meta
            t0 = time.perf_counter()


def _map_task_streaming(chain: List[Dict], *blocks: Block):
    """Streaming variant of _map_task: yields each output block (and its
    metadata) without concatenating the task's whole output."""
    t0 = time.perf_counter()
    out = _apply_stage(list(blocks), chain[0])
    for stage in chain[1:]:
        out = _apply_stage(out, stage)
    for ob in out:
        meta = BlockAccessor(ob).get_metadata(
            exec_stats={"wall_s": time.perf_counter() - t0})
        yield ob
        yield meta
        t0 = time.perf_counter()


def _slice_task(n: int, block: Block):
    acc = BlockAccessor(block)
    out = acc.slice(0, min(n, acc.num_rows()))
    return out, BlockAccessor(out).get_metadata()


def _partition_task(spec: Dict, block: Block):
    """Split one block into spec['n'] parts (hash/random/range)."""
    acc = BlockAccessor(block)
    n = spec["n"]
    how = spec["how"]
    nrows = acc.num_rows()
    if nrows == 0:
        empty = acc.slice(0, 0)
        return tuple(empty for _ in range(n)) if n > 1 else empty
    if how == "random":
        rng = np.random.RandomState(spec.get("seed"))
        assign = rng.randint(0, n, size=nrows)
    elif how == "round_robin":
        assign = np.arange(nrows) % n
    elif how == "contig":
        # contiguous global ranges: row with global index g goes to the
        # output whose [cuts[j], cuts[j+1]) contains g — repartition
        # preserves row order (reference: shuffle=False repartition)
        start = spec["start"]
        cuts = np.asarray(spec["cuts"])  # n+1 absolute boundaries
        assign = np.searchsorted(cuts, start + np.arange(nrows),
                                 side="right") - 1
        assign = np.clip(assign, 0, n - 1)
    elif how == "hash":
        key = spec["key"]
        col = acc.to_numpy([key])[key]
        # stable hash of the key column
        import pandas as pd

        assign = pd.util.hash_array(np.asarray(col)) % n
    elif how == "range":
        key = spec["key"]
        boundaries = spec["boundaries"]
        col = np.asarray(acc.to_numpy([key])[key])
        assign = np.searchsorted(np.asarray(boundaries), col,
                                 side="right")
        if spec.get("descending"):
            assign = (n - 1) - assign
    else:
        raise ValueError(how)
    parts = []
    for i in range(n):
        idx = np.nonzero(assign == i)[0]
        parts.append(acc.take(idx.tolist()))
    return tuple(parts) if n > 1 else parts[0]


def _reduce_task(spec: Dict, *parts: Block):
    """Combine partition pieces into one output block."""
    block = BlockAccessor.concat([p for p in parts if p is not None])
    acc = BlockAccessor(block)
    how = spec["how"]
    if how == "shuffle":
        block = acc.random_permutation(spec.get("seed"))
    elif how == "sort":
        block = acc.sort(spec["key"], spec.get("descending", False))
    elif how == "aggregate":
        block = _aggregate_block(block, spec["key"], spec["aggs"])
    elif how == "map_groups":
        block = _map_groups_block(block, spec["key"], spec["fn"],
                                  spec.get("batch_format") or "numpy")
    elif how == "concat":
        pass
    else:
        raise ValueError(how)
    return block, BlockAccessor(block).get_metadata()


def _iter_groups(block: Block, key: str):
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return
    block = acc.sort(key)
    acc = BlockAccessor(block)
    keys = np.asarray(acc.to_numpy([key])[key])
    # group boundaries in the sorted key column
    change = np.nonzero(keys[1:] != keys[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(keys)]])
    for s, e in zip(starts, ends):
        yield keys[s], acc.slice(int(s), int(e))


def _aggregate_block(block: Block, key: Optional[str], aggs) -> Block:
    rows = []
    if key is None:
        row = {}
        for agg in aggs:
            row[agg.name] = agg.finalize(agg.combine([agg.partial(block)]))
        rows.append(row)
    else:
        for kval, group in _iter_groups(block, key):
            row = {key: kval}
            for agg in aggs:
                row[agg.name] = agg.finalize(
                    agg.combine([agg.partial(group)]))
            rows.append(row)
    return rows_to_block(rows)


def _map_groups_block(block: Block, key: Optional[str], fn,
                      batch_format: str) -> Block:
    builder = BlockBuilder()
    if key is None:
        res = fn(BlockAccessor(block).to_batch(batch_format))
        builder.add_block(batch_to_block(res))
    else:
        for _, group in _iter_groups(block, key):
            res = fn(BlockAccessor(group).to_batch(batch_format))
            builder.add_block(batch_to_block(res))
    return builder.build()


def _sample_task(key, k: int, block: Block):
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return []
    idx = np.linspace(0, n - 1, num=min(k, n), dtype=np.int64)
    sample = BlockAccessor(acc.take(idx.tolist()))
    col = sample.to_numpy([key] if isinstance(key, str) else key)
    return list(np.asarray(col[key if isinstance(key, str) else key[0]]))


def _zip_task(l_off: int, slices: List[Tuple[int, int, int]],
              left: Block, *rights: Block):
    """Zip: align `left` with slices of right-side blocks.
    slices: (right_block_index, start_in_right, length)."""
    import pyarrow as pa

    parts = []
    for (ri, start, length) in slices:
        parts.append(BlockAccessor(rights[ri]).slice(start, start + length))
    right = BlockAccessor.concat(parts)
    lt = BlockAccessor(left).to_arrow()
    rt = BlockAccessor(right).to_arrow()
    cols = {c: lt.column(c) for c in lt.column_names}
    for c in rt.column_names:
        name = c if c not in cols else f"{c}_1"
        cols[name] = rt.column(c)
    out = pa.table(cols)
    return out, BlockAccessor(out).get_metadata()


# ---------------------------------------------------------------------------
# Physical operators

@dataclass
class _TaskRec:
    refs: List[Any]           # return refs; refs[-1] is metadata when paired
    on_done: Callable[["_TaskRec"], None]
    tag: Any = None


@dataclass
class _StreamRec:
    """An in-flight streaming task: its generator yields block, meta,
    block, meta, ...; the executor polls it and emits a bundle per
    pair."""
    gen: Any                  # ObjectRefGenerator
    op: "PhysicalOperator"
    pending: List[Any] = field(default_factory=list)
    base_order: Tuple[int, ...] = ()  # prefix for yielded bundles' order
    item_idx: int = 0


class _OrderStager:
    """Heap of bundles keyed by logical order; releases only those no
    in-flight work can still precede (`bound` = out_min_pending)."""

    def __init__(self):
        self._heap: List[Tuple[Tuple[int, ...], int, RefBundle]] = []
        self._seq = 0

    def push(self, bundle: RefBundle) -> None:
        import heapq

        self._seq += 1
        heapq.heappush(self._heap, (bundle.order, self._seq, bundle))

    def pop_ready(self, bound: Optional[Tuple[int, ...]]
                  ) -> Iterator[RefBundle]:
        import heapq

        while self._heap and (bound is None or self._heap[0][0] < bound):
            yield heapq.heappop(self._heap)[2]

    def orders(self) -> List[Tuple[int, ...]]:
        return [o for o, _, _ in self._heap]

    def clear(self) -> None:
        self._heap.clear()

    def __len__(self) -> int:
        return len(self._heap)


class PhysicalOperator:
    def __init__(self, name: str, num_inputs: int = 1):
        self.name = name
        self.num_inputs = num_inputs
        self.in_queues = [collections.deque() for _ in range(num_inputs)]
        self.in_done = [False] * num_inputs
        self.out_queue: collections.deque = collections.deque()
        self.finished = False
        self.active = 0
        self.stats = {"tasks": 0, "rows_out": 0, "blocks_out": 0,
                      "wall_s": 0.0}
        self.downstream: List[Tuple["PhysicalOperator", int]] = []
        self.upstream: List[Optional["PhysicalOperator"]] = \
            [None] * num_inputs
        # `order` markers of in-flight work whose outputs are not yet in
        # out_queue — the ordered-consumption protocol's lower bound
        self._pending_orders: set = set()

    # -- wiring
    def connect(self, downstream: "PhysicalOperator", index: int = 0):
        self.downstream.append((downstream, index))
        downstream.upstream[index] = self

    # -- ordered consumption (reference: bundles are iterated in block
    # order; tasks complete in any order, so consumers need a lower bound
    # on what can still arrive)
    def out_min_pending(self) -> Optional[Tuple[int, ...]]:
        """Smallest `order` any output this operator has not yet handed
        downstream could carry; None = nothing more will ever come.

        Base implementation is conservative for barrier-style operators
        (AllToAll/Zip): while unfinished they may emit any order."""
        if not self.finished:
            return ()
        if self.out_queue:
            return min(b.order for b in self.out_queue)
        return None

    def _streaming_min_pending(
            self, extra=()) -> Optional[Tuple[int, ...]]:
        """min over queued inputs, in-flight work, upstream's bound and
        undelivered outputs — for operators that preserve input order."""
        cands = list(extra)
        if self.out_queue:
            cands.append(min(b.order for b in self.out_queue))
        cands.extend(self._pending_orders)
        for q in self.in_queues:
            for b in q:
                cands.append(b.order)
        for up in self.upstream:
            if up is not None:
                m = up.out_min_pending()
                if m is not None:
                    cands.append(m)
        return min(cands) if cands else None

    def _emit(self, bundle: RefBundle):
        self.stats["rows_out"] += bundle.metadata.num_rows
        self.stats["blocks_out"] += 1
        if bundle.metadata.exec_stats:
            self.stats["wall_s"] += bundle.metadata.exec_stats.get("wall_s", 0)
        self.out_queue.append(bundle)

    # -- executor interface
    def add_input(self, bundle: RefBundle, index: int = 0):
        self.in_queues[index].append(bundle)

    def notify_input_done(self, index: int = 0):
        self.in_done[index] = True

    def all_inputs_done(self) -> bool:
        return all(self.in_done)

    def has_work(self) -> bool:
        return any(self.in_queues)

    def try_submit(self, submit) -> List[_TaskRec]:
        """Submit up to one task if work is buffered; returns task recs."""
        return []

    def maybe_finish(self):
        if (self.all_inputs_done() and not self.has_work()
                and self.active == 0):
            self.finished = True


class InputOperator(PhysicalOperator):
    """Source of pre-existing bundles (materialized data)."""

    def __init__(self, bundles: List[RefBundle]):
        super().__init__("Input", num_inputs=0)
        for i, b in enumerate(bundles):
            # list position IS the logical order here; re-base every
            # bundle (copies: callers own these objects, and carried
            # keys from a prior execution must not mix with fresh ones)
            self.out_queue.append(replace(b, order=(i,)))
        self.finished = True

    def all_inputs_done(self):
        return True


class ReadOperator(PhysicalOperator):
    def __init__(self, read_tasks, chain: List[Dict], resources=None):
        super().__init__("Read", num_inputs=0)
        self._pending = collections.deque(read_tasks)
        self._chain = chain
        self._resources = resources
        self._next_idx = 0

    def all_inputs_done(self):
        return True

    def has_work(self):
        return bool(self._pending)

    def out_min_pending(self) -> Optional[Tuple[int, ...]]:
        extra = [(self._next_idx,)] if self._pending else []
        return self._streaming_min_pending(extra)

    def try_submit(self, submit) -> List[_TaskRec]:
        if not self._pending:
            return []
        rt = self._pending.popleft()
        task_idx = self._next_idx
        self._next_idx += 1
        self.active += 1
        self.stats["tasks"] += 1
        ctx = DataContext.get_current()
        if ctx.use_streaming_generators:
            gen = submit(_read_task_streaming, (rt, self._chain),
                         num_returns="streaming",
                         resources=self._resources,
                         name=f"data:{self.name}")
            self._pending_orders.add((task_idx, 0))
            return [_StreamRec(gen, self, base_order=(task_idx,))]
        refs = submit(_read_task, (rt, self._chain), num_returns=2,
                      resources=self._resources, name=f"data:{self.name}")
        self._pending_orders.add((task_idx, 0))

        def on_done(rec: _TaskRec):
            self.active -= 1
            meta = ray_tpu_torch.get(rec.refs[1], timeout=300)
            self._emit(RefBundle(rec.refs[0], meta, order=(task_idx, 0)))
            self._pending_orders.discard((task_idx, 0))
            self.maybe_finish()

        return [_TaskRec(refs, on_done)]


class MapOperator(PhysicalOperator):
    """Fused chain of map stages; one task per input block."""

    def __init__(self, name: str, chain: List[Dict], resources=None):
        super().__init__(name)
        self._chain = chain
        self._resources = resources

    def out_min_pending(self) -> Optional[Tuple[int, ...]]:
        return self._streaming_min_pending()

    def try_submit(self, submit) -> List[_TaskRec]:
        if not self.in_queues[0]:
            return []
        bundle: RefBundle = self.in_queues[0].popleft()
        order = bundle.order
        self.active += 1
        self.stats["tasks"] += 1
        ctx = DataContext.get_current()
        if ctx.use_streaming_generators:
            gen = submit(_map_task_streaming,
                         (self._chain, bundle.block_ref),
                         num_returns="streaming",
                         resources=self._resources,
                         name=f"data:{self.name}")
            self._pending_orders.add(order + (0,))
            return [_StreamRec(gen, self, base_order=order)]
        refs = submit(_map_task, (self._chain, bundle.block_ref),
                      num_returns=2, resources=self._resources,
                      name=f"data:{self.name}")
        self._pending_orders.add(order)

        def on_done(rec: _TaskRec):
            self.active -= 1
            meta = ray_tpu_torch.get(rec.refs[1], timeout=300)
            self._emit(RefBundle(rec.refs[0], meta, order=order))
            self._pending_orders.discard(order)
            self.maybe_finish()

        return [_TaskRec(refs, on_done)]


class _MapWorker:
    """Pool worker actor: instantiates class UDFs ONCE at startup and
    applies the fused stage chain to blocks (reference:
    actor_pool_map_operator.py _MapWorker — per-actor warm state is the
    whole point: a model loads / a program compiles once per actor, not
    once per block)."""

    def __init__(self, chain: List[Dict]):
        self._chain = []
        for s in chain:
            s = dict(s)
            if s.get("is_class"):
                s["fn"] = s["fn"](*(s.get("fn_constructor_args") or ()),
                                  **(s.get("fn_constructor_kwargs") or {}))
            self._chain.append(s)

    def apply(self, *blocks: Block):
        return _map_task(self._chain, *blocks)


class ActorPoolMapOperator(PhysicalOperator):
    """Map over an autoscaling pool of `_MapWorker` actors (reference:
    actor_pool_map_operator.py:34 ActorPoolMapOperator).

    Pool behavior: `min_size` actors are created when the operator first
    has work; while every live actor is saturated (max_tasks_in_flight
    each) and input keeps queueing, the pool grows toward `max_size`.
    Blocks route to the least-loaded ready actor.  An actor that dies
    mid-block is replaced and its in-flight blocks are resubmitted —
    tasks are retried, warm state is rebuilt by the replacement's
    __init__."""

    def __init__(self, name: str, chain: List[Dict], strategy,
                 resources=None):
        super().__init__(name)
        self._chain = chain
        self._strategy = strategy
        self._resources = resources
        # actor id -> [handle, inflight_count]
        self._actors: Dict[int, List] = {}
        self._next_actor_id = 0
        self._started = False
        self._shutdown = False
        # consecutive actor deaths with zero completed blocks in between:
        # a UDF that kills every actor it touches (bad import, OOM on
        # init) must surface, not respawn forever
        self._deaths_since_progress = 0

    # -- pool management ----------------------------------------------------

    def _spawn_actor(self):
        cls = ray_tpu_torch.remote(_MapWorker)
        if self._resources:
            cls = cls.options(resources=dict(self._resources))
        handle = cls.remote(self._chain)
        aid = self._next_actor_id
        self._next_actor_id += 1
        self._actors[aid] = [handle, 0]
        return aid

    def _ensure_pool(self):
        if self._started:
            return
        self._started = True
        for _ in range(self._strategy.min_size):
            self._spawn_actor()

    def _pick_actor(self) -> Optional[int]:
        """Least-loaded actor below its in-flight cap; grows the pool when
        all are saturated and room remains."""
        cap = self._strategy.max_tasks_in_flight_per_actor
        candidates = [(cnt, aid) for aid, (h, cnt) in
                      self._actors.items() if cnt < cap]
        if candidates:
            return min(candidates)[1]
        if len(self._actors) < self._strategy.max_size:
            return self._spawn_actor()
        return None

    def _replace_actor(self, aid: int):
        info = self._actors.pop(aid, None)
        if info is None:
            return  # another in-flight task of the same actor got here
        try:
            ray_tpu_torch.kill(info[0], no_restart=True)
        except Exception:
            pass
        if not self._shutdown:
            self._spawn_actor()

    def _maybe_shutdown_pool(self):
        if self._shutdown:
            return
        self._shutdown = True
        for aid, (h, cnt) in list(self._actors.items()):
            try:
                ray_tpu_torch.kill(h, no_restart=True)
            except Exception:
                pass
        self._actors.clear()

    # -- operator interface -------------------------------------------------

    def out_min_pending(self) -> Optional[Tuple[int, ...]]:
        return self._streaming_min_pending()

    def try_submit(self, submit) -> List[_TaskRec]:
        # at most one submission per call: the executor accounts its
        # global budget / per-op caps per try_submit round (MapOperator
        # keeps the same discipline)
        if not self.in_queues[0]:
            return []
        self._ensure_pool()
        aid = self._pick_actor()
        if aid is None:
            return []
        # the queued block first in dataset order, not the first to arrive:
        # reads finish out of order, and a head block queued behind the
        # rest would hold every output of an order-preserving stream until
        # the pool has finished and shut down (ROADMAP §C)
        q = self.in_queues[0]
        bundle: RefBundle = min(q, key=lambda b: b.order)
        q.remove(bundle)
        return [self._submit_to(aid, bundle)]

    def _submit_to(self, aid: int, bundle: RefBundle) -> _TaskRec:
        handle = self._actors[aid][0]
        self._actors[aid][1] += 1
        self.active += 1
        self.stats["tasks"] += 1
        order = bundle.order
        self._pending_orders.add(order)
        refs = handle.apply.options(num_returns=2).remote(bundle.block_ref)

        def on_done(rec: _TaskRec):
            self.active -= 1
            if aid in self._actors:
                self._actors[aid][1] -= 1
            try:
                meta = ray_tpu_torch.get(rec.refs[1], timeout=300)
            except (ray_tpu_torch.ActorDiedError,
                    ray_tpu_torch.WorkerCrashedError) as e:
                self._pending_orders.discard(order)
                self._deaths_since_progress += 1
                if self._deaths_since_progress > \
                        2 * max(2, self._strategy.max_size):
                    raise RuntimeError(
                        f"{self.name}: actor pool is dying faster than it "
                        f"completes work ({self._deaths_since_progress} "
                        f"consecutive deaths) — the UDF or its imports "
                        f"likely crash the worker; last: {e}") from e
                # replace the dead actor, resubmit this block: retried
                # work re-enters the input queue so the normal submit
                # path (with a fresh pool member) picks it up
                self._replace_actor(aid)
                self.in_queues[0].appendleft(bundle)
                return
            self._deaths_since_progress = 0
            self._emit(RefBundle(rec.refs[0], meta, order=order))
            self._pending_orders.discard(order)
            self.maybe_finish()

        return _TaskRec(list(refs), on_done, tag=aid)

    def maybe_finish(self):
        super().maybe_finish()
        if self.finished:
            self._maybe_shutdown_pool()

    # introspection for tests
    def pool_size(self) -> int:
        return len(self._actors)


class LimitOperator(PhysicalOperator):
    """Row-limit in DATASET order: blocks complete out of order, so input
    is staged in an order-heap and consumed only once no earlier block can
    still arrive (upstream.out_min_pending) — limit(5) must keep the first
    5 rows of the dataset, not of whichever task finished first."""

    def __init__(self, limit: int):
        super().__init__(f"Limit({limit})")
        self._remaining = limit
        self._buf = _OrderStager()

    def has_work(self) -> bool:
        return any(self.in_queues) or bool(len(self._buf))

    def out_min_pending(self) -> Optional[Tuple[int, ...]]:
        return self._streaming_min_pending(self._buf.orders())

    def try_submit(self, submit) -> List[_TaskRec]:
        while self.in_queues[0]:
            self._buf.push(self.in_queues[0].popleft())
        up = self.upstream[0]
        upmin = up.out_min_pending() if up is not None else None
        recs = []
        for bundle in self._buf.pop_ready(upmin):
            if self._remaining <= 0:
                break
            n = bundle.metadata.num_rows
            if n <= self._remaining:
                self._remaining -= n
                self._emit(bundle)
                continue
            take = self._remaining
            self._remaining = 0
            order = bundle.order
            refs = submit(_slice_task, (take, bundle.block_ref),
                          num_returns=2, name=f"data:{self.name}")
            self.active += 1
            self.stats["tasks"] += 1
            self._pending_orders.add(order)

            def on_done(rec: _TaskRec):
                self.active -= 1
                meta = ray_tpu_torch.get(rec.refs[1], timeout=300)
                self._emit(RefBundle(rec.refs[0], meta, order=order))
                self._pending_orders.discard(order)
                self.maybe_finish()

            recs.append(_TaskRec(refs, on_done))
        if self._remaining == 0:
            # drop any remaining input; upstream stops via executor check
            for q in self.in_queues:
                q.clear()
            self._buf.clear()
            if self.active == 0:
                self.finished = True
        else:
            self.maybe_finish()
        return recs

    def satisfied(self) -> bool:
        return self._remaining <= 0

    def maybe_finish(self):
        if self.satisfied() and self.active == 0:
            self.finished = True
            return
        super().maybe_finish()


class UnionOperator(PhysicalOperator):
    def __init__(self, n: int):
        super().__init__("Union", num_inputs=n)

    def out_min_pending(self) -> Optional[Tuple[int, ...]]:
        cands = []
        if self.out_queue:
            cands.append(min(b.order for b in self.out_queue))
        for side in range(self.num_inputs):
            side_c = [(side,) + b.order for b in self.in_queues[side]]
            up = self.upstream[side]
            if up is not None:
                m = up.out_min_pending()
                if m is not None:
                    side_c.append((side,) + m)
            cands.extend(side_c)
        return min(cands) if cands else None

    def try_submit(self, submit) -> List[_TaskRec]:
        for side, q in enumerate(self.in_queues):
            while q:
                b = q.popleft()
                # re-base a COPY: side-0 rows precede side-1 rows; the
                # original object may be shared with another consumer
                # (diamond DAG) whose sort keys must not change
                self._emit(replace(b, order=(side,) + b.order))
        self.maybe_finish()
        return []


class ZipOperator(PhysicalOperator):
    """Barrier: buffers both sides, then zips row-aligned slices."""

    def __init__(self):
        super().__init__("Zip", num_inputs=2)
        self._left: List[RefBundle] = []
        self._right: List[RefBundle] = []
        self._planned = False

    def has_work(self) -> bool:
        # buffered-but-unplanned bundles are work: without this the
        # done-propagation sweep sees empty in_queues + active==0 and
        # finishes the op before it ever plans (zip returned 0 rows)
        return super().has_work() or (
            bool(self._left or self._right) and not self._planned)

    def try_submit(self, submit) -> List[_TaskRec]:
        while self.in_queues[0]:
            self._left.append(self.in_queues[0].popleft())
        while self.in_queues[1]:
            self._right.append(self.in_queues[1].popleft())
        if not (self.in_done[0] and self.in_done[1]) or self._planned:
            self.maybe_finish()
            return []
        self._planned = True
        # arrival order is completion order; row alignment needs logical
        # order (the flake: zip under load paired id 5-9 with other 100-104)
        self._left.sort(key=lambda b: b.order)
        self._right.sort(key=lambda b: b.order)
        lrows = sum(b.metadata.num_rows for b in self._left)
        rrows = sum(b.metadata.num_rows for b in self._right)
        if lrows != rrows:
            raise ValueError(
                f"zip(): datasets have different row counts: {lrows} vs "
                f"{rrows}")
        # For each left block, find overlapping right slices.
        r_offsets = []
        off = 0
        for b in self._right:
            r_offsets.append(off)
            off += b.metadata.num_rows
        recs = []
        l_off = 0
        for lb in self._left:
            ln = lb.metadata.num_rows
            slices = []
            need_start, need_end = l_off, l_off + ln
            for ri, rb in enumerate(self._right):
                rs = r_offsets[ri]
                re = rs + rb.metadata.num_rows
                s = max(need_start, rs)
                e = min(need_end, re)
                if s < e:
                    slices.append((ri, s - rs, e - s))
            # compact indices to the refs we pass
            idx_map = {}
            cslices = []
            crefs = []
            for (ri, st, lnn) in slices:
                if ri not in idx_map:
                    idx_map[ri] = len(crefs)
                    crefs.append(self._right[ri].block_ref)
                cslices.append((idx_map[ri], st, lnn))
            refs = submit(_zip_task,
                          (l_off, cslices, lb.block_ref, *crefs),
                          num_returns=2, name="data:Zip")
            self.active += 1
            self.stats["tasks"] += 1

            def on_done(rec: _TaskRec, order=lb.order):
                self.active -= 1
                meta = ray_tpu_torch.get(rec.refs[1], timeout=300)
                self._emit(RefBundle(rec.refs[0], meta, order=order))
                self.maybe_finish()

            recs.append(_TaskRec(refs, on_done))
            l_off += ln
        self.maybe_finish()
        return recs


class AllToAllOperator(PhysicalOperator):
    """Barrier op: partition phase fans each input block into N parts;
    reduce phase combines part i of every block into output block i
    (reference: _internal/planner/exchange/)."""

    def __init__(self, name: str, kind: str, *, num_outputs=None, key=None,
                 descending=False, seed=None, aggs=None, fn=None,
                 batch_format=None, shuffle_blocks=False):
        super().__init__(name)
        self.kind = kind
        self.num_outputs = num_outputs
        self.key = key
        self.descending = descending
        self.seed = seed
        self.aggs = aggs
        self.fn = fn
        self.batch_format = batch_format
        self.shuffle_blocks = shuffle_blocks
        self._bundles: List[RefBundle] = []
        self._phase = "collect"
        self._samples: List[Any] = []
        self._sample_refs: List[Any] = []
        self._boundaries = None
        self._parts: List[List[Any]] = []  # [input][partition] -> ref
        self._n_parts_done = 0

    def _resolved_num_outputs(self) -> int:
        if self.kind in ("groupby", "map_groups") and self.key is None:
            return 1
        if self.num_outputs:
            return self.num_outputs
        ctx = DataContext.get_current()
        if ctx.default_shuffle_partitions:
            return ctx.default_shuffle_partitions
        return max(1, len(self._bundles))

    def try_submit(self, submit) -> List[_TaskRec]:
        while self.in_queues[0]:
            self._bundles.append(self.in_queues[0].popleft())
        if not self.all_inputs_done():
            return []
        if self._phase == "collect":
            # logical order, not arrival order: repartition concatenates
            # part j of every input in _bundles order, so row order must
            # match the upstream's (sort/shuffle are insensitive but
            # repartition-then-zip is not)
            self._bundles.sort(key=lambda b: b.order)
            if self.kind in ("sort", "groupby_sort"):
                self._phase = "sample"
            else:
                self._phase = "partition"
        recs: List[_TaskRec] = []
        if self._phase == "sample":
            self._phase = "sampling"
            for b in self._bundles:
                refs = submit(_sample_task, (self.key, 8, b.block_ref),
                              num_returns=1, name=f"data:{self.name}:sample")
                self.active += 1

                def on_done(rec: _TaskRec):
                    self.active -= 1
                    self._samples.extend(ray_tpu_torch.get(
                        rec.refs[0], timeout=300))
                    if self.active == 0:
                        self._compute_boundaries()
                        self._phase = "partition"

                recs.append(_TaskRec(refs, on_done))
            if not recs:  # no input blocks at all
                self._phase = "partition"
        if self._phase == "partition":
            self._phase = "reduce_wait"
            n = self._resolved_num_outputs()
            if not self._bundles:
                self.finished = True
                return recs
            spec = self._partition_spec(n)
            starts = None
            if spec["how"] == "contig":
                total = sum(b.metadata.num_rows for b in self._bundles)
                spec["cuts"] = [round(total * j / n) for j in range(n + 1)]
                starts, off = [], 0
                for b in self._bundles:
                    starts.append(off)
                    off += b.metadata.num_rows
            self._parts = [None] * len(self._bundles)
            for i, b in enumerate(self._bundles):
                bspec = spec if starts is None else dict(spec,
                                                        start=starts[i])
                refs = submit(_partition_task, (bspec, b.block_ref),
                              num_returns=n, name=f"data:{self.name}:part")
                self.active += 1
                self.stats["tasks"] += 1

                def on_done(rec: _TaskRec, i=i):
                    self.active -= 1
                    self._parts[i] = rec.refs
                    self._n_parts_done += 1
                    if self._n_parts_done == len(self._bundles):
                        self._phase = "reduce"

                recs.append(_TaskRec(refs, on_done))
        if self._phase == "reduce":
            self._phase = "done_wait"
            n = self._resolved_num_outputs()
            rspec = self._reduce_spec()
            order = list(range(n))
            if self.kind == "shuffle" and self.shuffle_blocks:
                rng = np.random.RandomState(self.seed)
                rng.shuffle(order)
            for rank, j in enumerate(order):
                part_refs = [self._parts[i][j]
                             for i in range(len(self._bundles))]
                refs = submit(_reduce_task, (rspec, *part_refs),
                              num_returns=2,
                              name=f"data:{self.name}:reduce")
                self.active += 1
                self.stats["tasks"] += 1

                def on_done(rec: _TaskRec, rank=rank):
                    self.active -= 1
                    meta = ray_tpu_torch.get(rec.refs[1], timeout=300)
                    # rank is the output's logical position (sorted range
                    # j for sort; the shuffled sequence for shuffle)
                    self._emit(RefBundle(rec.refs[0], meta, order=(rank,)))
                    if self.active == 0 and self._phase == "done_wait":
                        self.finished = True

                recs.append(_TaskRec(refs, on_done))
        return recs

    def _compute_boundaries(self):
        n = self._resolved_num_outputs()
        if not self._samples:
            self._boundaries = []
            return
        qs = np.linspace(0, 1, n + 1)[1:-1]
        self._boundaries = list(np.quantile(
            np.asarray(sorted(self._samples)), qs, method="nearest")) \
            if len(qs) else []

    def _partition_spec(self, n: int) -> Dict:
        if self.kind == "shuffle":
            return {"how": "random", "n": n, "seed": self.seed}
        if self.kind == "repartition":
            return {"how": "contig", "n": n}  # cuts/start added at phase
        if self.kind in ("groupby", "map_groups"):
            if self.key is None:
                return {"how": "round_robin", "n": 1}
            return {"how": "hash", "n": n, "key": self.key}
        if self.kind == "sort":
            return {"how": "range", "n": n, "key": self.key,
                    "boundaries": self._boundaries or [],
                    "descending": self.descending}
        raise ValueError(self.kind)

    def _reduce_spec(self) -> Dict:
        if self.kind == "shuffle":
            return {"how": "shuffle", "seed": self.seed}
        if self.kind == "repartition":
            return {"how": "concat"}
        if self.kind == "sort":
            return {"how": "sort", "key": self.key,
                    "descending": self.descending}
        if self.kind == "groupby":
            return {"how": "aggregate", "key": self.key, "aggs": self.aggs}
        if self.kind == "map_groups":
            return {"how": "map_groups", "key": self.key, "fn": self.fn,
                    "batch_format": self.batch_format}
        raise ValueError(self.kind)

    def maybe_finish(self):
        # completion handled by phases
        if (self.all_inputs_done() and not self._bundles
                and self._phase == "collect"):
            self.finished = True


# ---------------------------------------------------------------------------
# Planner: logical DAG -> physical DAG

def _stage_of(op: L.AbstractMap) -> Dict:
    # stage fns travel as task/actor-constructor ARGS (not as the remote
    # function itself), so the by-value registration that ray_tpu_torch.remote
    # applies to its target never sees them — a UDF class defined in a
    # driver-only module would hit ModuleNotFoundError on the worker
    from ray_tpu_torch._private.common import _ensure_picklable_by_value

    _ensure_picklable_by_value(op.fn)
    stage = {"kind": op.fn_kind, "fn": op.fn, "batch_size": op.batch_size,
             "batch_format": op.batch_format, "fn_args": op.fn_args,
             "fn_kwargs": op.fn_kwargs}
    if getattr(op, "is_class_udf", False):
        stage["is_class"] = True
        stage["fn_constructor_args"] = getattr(op, "fn_constructor_args", ())
        stage["fn_constructor_kwargs"] = getattr(op, "fn_constructor_kwargs",
                                                 None)
    return stage


def plan(logical_dag: L.LogicalOp
         ) -> Tuple[PhysicalOperator, List[PhysicalOperator]]:
    """Build the physical DAG, fusing chains of AbstractMap into single
    operators (the reference's OperatorFusionRule).  Returns (sink, ops)."""
    ctx = DataContext.get_current()
    ops: List[PhysicalOperator] = []

    # Count consumers of every logical node: a shared (diamond) subtree must
    # build exactly ONE physical operator (else nondeterministic shared ops
    # like unseeded shuffles diverge per branch), and fusion into a shared
    # upstream is forbidden (it would apply one consumer's stages to all).
    consumers: Dict[int, int] = {}

    def count(op: L.LogicalOp):
        for parent in getattr(op, "inputs", ()):
            consumers[id(parent)] = consumers.get(id(parent), 0) + 1
            if consumers[id(parent)] == 1:
                count(parent)

    count(logical_dag)
    memo: Dict[int, PhysicalOperator] = {}

    def register(phys: PhysicalOperator) -> PhysicalOperator:
        if phys not in ops:
            ops.append(phys)
        return phys

    def build(op: L.LogicalOp) -> PhysicalOperator:
        if id(op) in memo:
            return memo[id(op)]
        phys = register(_build(op))
        memo[id(op)] = phys
        return phys

    def _build(op: L.LogicalOp) -> PhysicalOperator:
        if isinstance(op, L.InputData):
            return InputOperator(op.bundles)
        if isinstance(op, L.Read):
            parallelism = op.parallelism
            if parallelism is None or parallelism < 0:
                parallelism = 200
            tasks = op.datasource.get_read_tasks(parallelism)
            return ReadOperator(tasks, chain=[])
        if isinstance(op, L.AbstractMap):
            upstream = build(op.inputs[0])
            stage = _stage_of(op)
            resources = op.resources or None
            from .compute import ActorPoolStrategy, TaskPoolStrategy

            strategy = op.compute
            wants_actors = isinstance(strategy, ActorPoolStrategy)
            # fuse into upstream Read / Map when compatible — but never
            # into a node other consumers also read (diamond DAGs), and
            # never when the user capped THIS stage's concurrency (fusing
            # would run it at the upstream's parallelism instead)
            capped = isinstance(strategy, TaskPoolStrategy) \
                and strategy.size is not None
            fusable = consumers.get(id(op.inputs[0]), 0) <= 1 \
                and not capped
            if wants_actors:
                # actor compute is its own operator; a later fusable
                # plain-map stage may fuse INTO it (runs on the actors),
                # but an actor stage never fuses into a task upstream
                phys = ActorPoolMapOperator(op.name, [stage], strategy,
                                            resources=resources)
                upstream.connect(phys, 0)
                return phys
            if fusable and isinstance(upstream, ActorPoolMapOperator) \
                    and not resources:
                upstream._chain.append(stage)
                upstream.name = f"{upstream.name}->{op.name}"
                return upstream
            if fusable and isinstance(upstream, ReadOperator) \
                    and not resources:
                upstream._chain.append(stage)
                upstream.name = f"{upstream.name}->{op.name}"
                return upstream
            if fusable and isinstance(upstream, MapOperator) and \
                    upstream._resources == resources:
                upstream._chain.append(stage)
                upstream.name = f"{upstream.name}->{op.name}"
                return upstream
            phys = MapOperator(op.name, [stage], resources=resources)
            if capped:
                phys.task_cap = strategy.size
            upstream.connect(phys, 0)
            return phys
        if isinstance(op, L.Limit):
            upstream = build(op.inputs[0])
            phys = LimitOperator(op.limit)
            upstream.connect(phys, 0)
            return phys
        if isinstance(op, L.Union):
            phys = UnionOperator(len(op.inputs))
            for i, parent in enumerate(op.inputs):
                build(parent).connect(phys, i)
            return phys
        if isinstance(op, L.Zip):
            phys = ZipOperator()
            build(op.inputs[0]).connect(phys, 0)
            build(op.inputs[1]).connect(phys, 1)
            return phys
        if isinstance(op, L.Repartition):
            upstream = build(op.inputs[0])
            phys = AllToAllOperator(
                f"Repartition({op.num_outputs})",
                "shuffle" if op.shuffle else "repartition",
                num_outputs=op.num_outputs)
            upstream.connect(phys, 0)
            return phys
        if isinstance(op, L.RandomShuffle):
            upstream = build(op.inputs[0])
            seed = op.seed if op.seed is not None else ctx.seed
            phys = AllToAllOperator("RandomShuffle", "shuffle",
                                    num_outputs=op.num_outputs, seed=seed,
                                    shuffle_blocks=True)
            upstream.connect(phys, 0)
            return phys
        if isinstance(op, L.Sort):
            upstream = build(op.inputs[0])
            phys = AllToAllOperator(f"Sort({op.key})", "sort",
                                    num_outputs=op.num_outputs, key=op.key,
                                    descending=op.descending)
            upstream.connect(phys, 0)
            return phys
        if isinstance(op, L.GroupByAggregate):
            upstream = build(op.inputs[0])
            phys = AllToAllOperator(f"Aggregate({op.key})", "groupby",
                                    num_outputs=op.num_outputs, key=op.key,
                                    aggs=op.aggs)
            upstream.connect(phys, 0)
            return phys
        if isinstance(op, L.MapGroups):
            upstream = build(op.inputs[0])
            phys = AllToAllOperator(f"MapGroups({op.key})", "map_groups",
                                    num_outputs=op.num_outputs, key=op.key,
                                    fn=op.fn, batch_format=op.batch_format)
            upstream.connect(phys, 0)
            return phys
        raise TypeError(f"unknown logical op {op!r}")

    sink = build(logical_dag)
    return sink, ops


class StreamingExecutor:
    """Pull-based streaming scheduling loop (reference:
    streaming_executor.py:48 + streaming_executor_state.py
    select_operator_to_run)."""

    def __init__(self, sink: PhysicalOperator, all_ops: List[PhysicalOperator]):
        self.sink = sink
        self.ops = all_ops
        self.ctx = DataContext.get_current()
        self._inflight: Dict[str, Tuple[_TaskRec, Any]] = {}
        self._streams: List[_StreamRec] = []
        self._started = time.perf_counter()
        self.wall_s = 0.0

    def _submit(self, fn, args, *, num_returns=1, resources=None, name=""):
        res = dict(self.ctx.task_resources or {})
        if resources:
            res.update(resources)  # per-operator demands win
        opts = dict(num_returns=num_returns, name=name,
                    resources=res or None, num_cpus=1)
        if num_returns == "streaming":
            opts["_generator_backpressure_num_objects"] = \
                self.ctx.generator_backpressure_num_objects
        remote_fn = ray_tpu_torch.remote(fn).options(**opts)
        refs = remote_fn.remote(*args)
        if num_returns == 1:
            refs = [refs]
        return refs  # an ObjectRefGenerator when streaming

    def _track(self, rec, op: PhysicalOperator):
        if isinstance(rec, _StreamRec):
            self._streams.append(rec)
        else:
            self._inflight[rec.refs[0].id] = (rec, op)

    def _poll_streams(self) -> bool:
        from ray_tpu_torch import GetTimeoutError

        progressed = False
        for srec in list(self._streams):
            while True:
                try:
                    ref = srec.gen.next_ready(timeout=0)
                except StopIteration:
                    srec.op.active -= 1
                    srec.op._pending_orders.discard(
                        srec.base_order + (srec.item_idx,))
                    srec.op.maybe_finish()
                    self._streams.remove(srec)
                    progressed = True
                    break
                except GetTimeoutError:
                    break
                srec.pending.append(ref)
                if len(srec.pending) == 2:
                    block_ref, meta_ref = srec.pending
                    srec.pending = []
                    meta = ray_tpu_torch.get(meta_ref, timeout=300)
                    srec.op._emit(RefBundle(
                        block_ref, meta,
                        order=srec.base_order + (srec.item_idx,)))
                    srec.op._pending_orders.discard(
                        srec.base_order + (srec.item_idx,))
                    srec.item_idx += 1
                    srec.op._pending_orders.add(
                        srec.base_order + (srec.item_idx,))
                    progressed = True
        return progressed

    def _route_outputs(self, op: PhysicalOperator):
        while op.out_queue:
            bundle = op.out_queue.popleft()
            if not op.downstream:
                yield bundle
                continue
            for (d, idx) in op.downstream:
                d.add_input(bundle, idx)

    def _propagate_done(self):
        for op in self.ops:
            if op.finished or (op.all_inputs_done() and not op.has_work()
                               and op.active == 0):
                op.maybe_finish()
                if op.finished or isinstance(op, (InputOperator,)):
                    for (d, idx) in op.downstream:
                        if not d.in_done[idx] and not op.out_queue:
                            d.notify_input_done(idx)

    def _limit_reached(self) -> bool:
        return isinstance(self.sink, LimitOperator) and self.sink.satisfied()

    def run(self) -> Iterator[RefBundle]:
        """Generator over output bundles of the sink."""
        try:
            yield from self._run_loop()
        finally:
            self.wall_s = time.perf_counter() - self._started
            # abnormal exit (crash-loop RuntimeError, UDF exception, or
            # the consumer abandoning the generator) must not leak pool
            # actors — including replacements just spawned for dead ones
            for op in self.ops:
                shutdown = getattr(op, "_maybe_shutdown_pool", None)
                if shutdown is not None:
                    try:
                        shutdown()
                    except Exception:
                        pass

    def _run_loop(self) -> Iterator[RefBundle]:
        # preserve_order: outputs stage in an order-heap and yield only
        # when no smaller order can still arrive (sink.out_min_pending)
        ordered = self.ctx.preserve_order
        out_buffer: collections.deque = collections.deque()
        out_heap = _OrderStager()
        while True:
            progressed = False
            # 1. submissions
            budget = (self.ctx.max_concurrent_tasks - len(self._inflight)
                      - len(self._streams))
            # out_heap is NOT counted in plain backpressure: its bundles
            # are held back waiting for a straggler's smaller order —
            # counting them would freeze submissions (including the
            # straggler's) into a deadlock.  But unbounded staging pins
            # every staged block in the object store, so past a cap only
            # operators that can still produce an order <= the blocking
            # one (the straggler's lineage) may submit.
            backpressured = (len(out_buffer)
                            >= self.ctx.max_buffered_output_bundles)
            blocking_order = None
            if ordered and len(out_heap) >= \
                    4 * self.ctx.max_buffered_output_bundles \
                    and out_heap._heap:
                blocking_order = out_heap._heap[0][0]
            if budget > 0 and not backpressured and not self._limit_reached():
                for op in self.ops:
                    if budget <= 0:
                        break
                    if blocking_order is not None:
                        m = op.out_min_pending()
                        if m is None or m > blocking_order:
                            continue
                    percap = self.ctx.max_tasks_per_operator
                    if percap is not None and op.active >= percap:
                        continue
                    opcap = getattr(op, "task_cap", None)
                    if opcap is not None and op.active >= opcap:
                        continue
                    recs = op.try_submit(
                        lambda fn, args, **kw: self._submit(fn, args, **kw))
                    for rec in recs:
                        self._track(rec, op)
                        budget -= 1
                        progressed = True
            else:
                # even without budget, zero-task ops (limit/union) progress
                for op in self.ops:
                    if isinstance(op, (LimitOperator, UnionOperator,
                                       ZipOperator)) and op.has_work():
                        recs = op.try_submit(
                            lambda fn, args, **kw: self._submit(fn, args,
                                                                **kw))
                        for rec in recs:
                            self._track(rec, op)
                            progressed = True
            # 2. completions
            if self._inflight:
                first_refs = [rec.refs[0] for rec, _ in
                              self._inflight.values()]
                ready, _ = ray_tpu_torch.wait(
                    first_refs, num_returns=len(first_refs), timeout=0.05)
                for r in ready:
                    rec, op = self._inflight.pop(r.id)
                    rec.on_done(rec)
                    progressed = True
            # 2b. streamed items: a bundle per (block, meta) pair, as
            # soon as the producer reports them (bounded memory — blocks
            # never buffer inside tasks)
            if self._poll_streams():
                progressed = True
            # 3. route outputs downstream / to the consumer
            for op in self.ops:
                for bundle in self._route_outputs(op):
                    if ordered:
                        out_heap.push(bundle)
                    else:
                        out_buffer.append(bundle)
            while out_buffer:
                progressed = True
                yield out_buffer.popleft()
            if len(out_heap):
                for bundle in out_heap.pop_ready(
                        self.sink.out_min_pending()):
                    progressed = True
                    yield bundle
            # 4. done propagation
            self._propagate_done()
            if self.sink.finished and not self._inflight and \
                    not self._streams and not self.sink.out_queue:
                for op in self.ops:
                    for bundle in self._route_outputs(op):
                        out_heap.push(bundle)
                yield from out_heap.pop_ready(None)
                return
            if self._limit_reached() and not self._inflight:
                self.sink.maybe_finish()
                if self.sink.finished:
                    return
            if not progressed:
                time.sleep(0.002)

    def stats_summary(self) -> str:
        lines = []
        for op in self.ops:
            s = op.stats
            lines.append(
                f"{op.name}: {s['tasks']} tasks, {s['blocks_out']} blocks, "
                f"{s['rows_out']} rows, {s['wall_s']:.3f}s task-time")
        lines.append(f"total wall: {self.wall_s:.3f}s")
        return "\n".join(lines)


def build_executor(logical_dag: L.LogicalOp) -> StreamingExecutor:
    sink, ops = plan(logical_dag)
    return StreamingExecutor(sink, ops)
