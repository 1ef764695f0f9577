"""Dataset: the lazy, distributed data abstraction.

Reference: python/ray/data/dataset.py (Dataset.map_batches :391,
iter_batches :3820, materialize :4768).  A Dataset is a logical plan; all
transforms append logical ops; consumption plans + runs the streaming
executor (execution.py) over ray_tpu_torch tasks.

The port's copy of ``ray_tpu/data/dataset.py``: ``iter_jax_batches``
and ``iter_torch_batches`` stage onto a CUDA device through iterator.py's
one staging path, and ``map_batches`` takes ``num_gpus`` where the
reference takes ``num_tpus``; ROADMAP §C lists what else differs.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

import ray_tpu_torch

from . import aggregate as agg_mod
from . import logical as L
from .block import Block, BlockAccessor, BlockMetadata, batch_to_block
from .context import DataContext
from .datasource import write_block
from .execution import RefBundle, StreamingExecutor, build_executor
from .iterator import iter_block_batches, iter_jax_batches, prefetch_iter


def _slice_block_task(block: Block, start: int, length: int) -> Block:
    return BlockAccessor(block).to_arrow().slice(start, length)


class Dataset:
    def __init__(self, dag: L.LogicalOp):
        self._dag = dag
        self._last_stats: Optional[str] = None

    # ------------------------------------------------------------------
    # transforms (lazy)

    def _with(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(op)

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: Optional[str] = None, fn_args=(),
                    fn_kwargs=None, fn_constructor_args=(),
                    fn_constructor_kwargs=None,
                    compute=None, concurrency=None,
                    zero_copy_batch: bool = False,
                    num_cpus: Optional[float] = None,
                    num_gpus: Optional[float] = None,
                    resources: Optional[Dict[str, float]] = None
                    ) -> "Dataset":
        """Unknown keyword arguments raise TypeError (no silent-ignore
        catch-all): a user porting an unsupported reference kwarg must
        hear about it, not get silently different behavior.

        A callable CLASS `fn` runs on an actor pool: instances are
        constructed once per pool actor (`fn_constructor_args/kwargs`)
        and reused for every batch — pass `concurrency=n` for a fixed
        pool or `(min, max)` for autoscaling (reference: dataset.py
        map_batches `concurrency` + compute.py ActorPoolStrategy).
        `zero_copy_batch` is accepted as a hint (numpy batches here are
        already zero-copy views over shm blocks)."""
        import inspect

        from .compute import ActorPoolStrategy, strategy_from_concurrency

        resources = dict(resources or {})
        if num_cpus:
            resources["CPU"] = num_cpus
        if num_gpus:
            resources["GPU"] = num_gpus
        is_class = inspect.isclass(fn)
        if not is_class and (fn_constructor_args or fn_constructor_kwargs):
            raise ValueError(
                "fn_constructor_args/kwargs are only valid with a "
                "callable-class UDF")
        if compute is None:
            compute = strategy_from_concurrency(concurrency, is_class)
        elif concurrency is not None:
            raise ValueError("pass `compute` or `concurrency`, not both")
        elif is_class and not isinstance(compute, ActorPoolStrategy):
            raise ValueError(
                "a callable-class UDF requires ActorPoolStrategy compute")
        ctx = DataContext.get_current()
        op = L.MapBatches(
            self._dag, fn, batch_size=batch_size,
            batch_format=batch_format or ctx.default_batch_format,
            fn_args=fn_args, fn_kwargs=fn_kwargs, compute=compute,
            resources=resources or None)
        op.is_class_udf = is_class
        op.fn_constructor_args = tuple(fn_constructor_args or ())
        op.fn_constructor_kwargs = fn_constructor_kwargs or {}
        if is_class:
            op.name = f"MapBatches({fn.__name__})"
        return self._with(op)

    def _row_op(self, cls, fn: Callable, concurrency, compute,
                resources) -> "Dataset":
        import inspect

        from .compute import ActorPoolStrategy, strategy_from_concurrency

        is_class = inspect.isclass(fn)
        if compute is None:
            compute = strategy_from_concurrency(concurrency, is_class)
        elif concurrency is not None:
            raise ValueError("pass `compute` or `concurrency`, not both")
        elif is_class and not isinstance(compute, ActorPoolStrategy):
            raise ValueError(
                "a callable-class UDF requires ActorPoolStrategy compute")
        op = cls(self._dag, fn, compute=compute,
                 resources=dict(resources or {}) or None)
        op.is_class_udf = is_class
        return self._with(op)

    def map(self, fn: Callable, *, concurrency=None, compute=None,
            resources=None) -> "Dataset":
        return self._row_op(L.MapRows, fn, concurrency, compute, resources)

    def filter(self, fn: Callable, *, concurrency=None, compute=None,
               resources=None) -> "Dataset":
        return self._row_op(L.Filter, fn, concurrency, compute, resources)

    def flat_map(self, fn: Callable, *, concurrency=None, compute=None,
                 resources=None) -> "Dataset":
        return self._row_op(L.FlatMap, fn, concurrency, compute, resources)

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        def add(batch: Dict[str, np.ndarray], _name=name, _fn=fn):
            batch = dict(batch)
            batch[_name] = np.asarray(_fn(batch))
            return batch

        return self._with(L.MapBatches(self._dag, add, batch_format="numpy",
                                       name=f"AddColumn({name})"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(block: Block, _cols=tuple(cols)):
            return BlockAccessor(block).drop(list(_cols))

        return self._with(L.MapBlocks(self._dag, drop,
                                      name=f"DropColumns({cols})"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(block: Block, _cols=tuple(cols)):
            return BlockAccessor(block).select(list(_cols))

        return self._with(L.MapBlocks(self._dag, select,
                                      name=f"SelectColumns({cols})"))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def rename(block: Block, _m=dict(mapping)):
            return BlockAccessor(block).rename(_m)

        return self._with(L.MapBlocks(self._dag, rename, name="Rename"))

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        def sample(block: Block, _frac=fraction, _seed=seed):
            acc = BlockAccessor(block)
            rng = np.random.RandomState(_seed)
            mask = rng.random_sample(acc.num_rows()) < _frac
            return acc.take(np.nonzero(mask)[0].tolist())

        return self._with(L.MapBlocks(self._dag, sample, name="Sample"))

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(self._dag, n))

    def repartition(self, num_blocks: int, shuffle: bool = False) -> "Dataset":
        return self._with(L.Repartition(self._dag, num_blocks, shuffle))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        return self._with(L.RandomShuffle(self._dag, seed=seed,
                                          num_outputs=num_blocks))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(L.Sort(self._dag, key, descending))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(L.Union([self._dag] + [o._dag for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(L.Zip(self._dag, other._dag))

    def groupby(self, key: Optional[str]) -> "GroupedData":
        from .grouped import GroupedData

        return GroupedData(self, key)

    # ------------------------------------------------------------------
    # execution

    def _execute(self) -> Iterator[RefBundle]:
        executor = build_executor(self._dag)
        try:
            yield from executor.run()
        finally:
            self._last_stats = executor.stats_summary()

    def iter_internal_ref_bundles(self) -> Iterator[RefBundle]:
        return self._execute()

    def materialize(self) -> "MaterializedDataset":
        bundles = list(self._execute())
        return MaterializedDataset(bundles, stats=self._last_stats)

    def stats(self) -> str:
        return self._last_stats or "(not executed)"

    # ------------------------------------------------------------------
    # consumption

    def take(self, limit: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for bundle in self.limit(limit)._execute():
            block = ray_tpu_torch.get(bundle.block_ref, timeout=600)
            for row in BlockAccessor(block).iter_rows():
                out.append(row)
                if len(out) >= limit:
                    return out
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for bundle in self._execute():
            block = ray_tpu_torch.get(bundle.block_ref, timeout=600)
            out.extend(BlockAccessor(block).iter_rows())
        return out

    def count(self) -> int:
        # metadata fast path (reference: Dataset.count's parquet-footer
        # shortcut): a bare Read whose datasource knows its EXACT row
        # count answers without executing a single read task
        if type(self._dag) is L.Read:
            n = self._dag.datasource.plan_row_count()
            if n is not None:
                return n
        return sum(b.metadata.num_rows for b in self._execute())

    def num_blocks(self) -> int:
        """Block count (reference: Dataset.num_blocks — execution-backed
        on a lazy dataset; MaterializedDataset answers from its refs)."""
        return sum(1 for _ in self._execute())

    def schema(self) -> Optional[pa.Schema]:
        for bundle in self.limit(1)._execute():
            if bundle.metadata.schema is not None:
                return bundle.metadata.schema
            block = ray_tpu_torch.get(bundle.block_ref, timeout=600)
            return BlockAccessor(block).schema()
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def to_pandas(self):
        import pandas as pd

        parts = []
        for bundle in self._execute():
            block = ray_tpu_torch.get(bundle.block_ref, timeout=600)
            parts.append(BlockAccessor(block).to_pandas())
        if not parts:
            return pd.DataFrame()
        return pd.concat(parts, ignore_index=True)

    def to_arrow(self) -> pa.Table:
        blocks = [ray_tpu_torch.get(b.block_ref, timeout=600)
                  for b in self._execute()]
        return BlockAccessor.concat(blocks)

    def unique(self, column: str) -> List[Any]:
        vals = set()
        for bundle in self._execute():
            block = ray_tpu_torch.get(bundle.block_ref, timeout=600)
            col = BlockAccessor(block).to_numpy([column])[column]
            vals.update(np.asarray(col).tolist())
        return sorted(vals)

    # global aggregates (no shuffle: distributed partials + driver combine,
    # reference: Dataset.sum/min/max/mean/std)
    def aggregate(self, *aggs: agg_mod.AggregateFn) -> Dict[str, Any]:
        partial_refs = []
        for bundle in self._execute():
            ref = ray_tpu_torch.remote(_partials_task).options(
                name="data:aggregate").remote(list(aggs), bundle.block_ref)
            partial_refs.append(ref)
        partials = ray_tpu_torch.get(partial_refs, timeout=600)
        out = {}
        for i, agg in enumerate(aggs):
            parts = [p[i] for p in partials]
            out[agg.name] = agg.finalize(agg.combine(parts)) if parts \
                else None
        return out

    def sum(self, on: str):
        return self.aggregate(agg_mod.Sum(on))[f"sum({on})"]

    def min(self, on: str):
        return self.aggregate(agg_mod.Min(on))[f"min({on})"]

    def max(self, on: str):
        return self.aggregate(agg_mod.Max(on))[f"max({on})"]

    def mean(self, on: str):
        return self.aggregate(agg_mod.Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(agg_mod.Std(on, ddof))[f"std({on})"]

    # ------------------------------------------------------------------
    # iteration

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for bundle in self._execute():
            block = ray_tpu_torch.get(bundle.block_ref, timeout=600)
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = None,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: Optional[int] = None) -> Iterator:
        # single implementation lives on DataIterator (reference shape:
        # Dataset.iter_batches delegates to Dataset.iterator())
        return self.iterator().iter_batches(
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed,
            prefetch_batches=prefetch_batches)

    def iter_jax_batches(self, *, batch_size: Optional[int] = 256,
                         sharding=None, dtypes=None, drop_last: bool = True,
                         prefetch: int = 2, device=None, **kw) -> Iterator:
        """Iterate device-resident batches (dict of torch.Tensor), staged
        onto `device` (None: the current CUDA device, resolved now) with
        `prefetch` batches in flight; `dtypes` maps column -> target dtype
        cast before transfer (host-side, so e.g. bf16 halves the copy).
        "jax" is the reference's name; see iterator.iter_jax_batches."""
        host = self.iter_batches(batch_size=batch_size, batch_format="numpy",
                                 drop_last=drop_last, **kw)
        return iter_jax_batches(host, sharding=sharding, dtypes=dtypes,
                                prefetch=prefetch, device=device)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device: str = "cpu",
                           drop_last: bool = False, **kw) -> Iterator:
        """Iterate dict-of-torch.Tensor batches (reference:
        data/iterator.py iter_torch_batches) — parity surface for torch
        consumers.  A CUDA `device` takes iter_jax_batches's staging (the
        port's one host-to-device path)."""
        import torch

        if torch.device(device).type != "cpu":
            return iter_jax_batches(
                self.iter_batches(batch_size=batch_size, batch_format="numpy",
                                  drop_last=drop_last, **kw),
                dtypes=dtypes, device=device)
        return self._iter_host_torch_batches(batch_size, dtypes, drop_last,
                                             kw)

    def _iter_host_torch_batches(self, batch_size, dtypes, drop_last, kw):
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last, **kw):
            out = {}
            for k, v in batch.items():
                # blocks are zero-copy views over read-only shm mmaps:
                # torch tensors must own writable memory or in-place ops
                # would fault / corrupt the shared object
                if isinstance(v, np.ndarray) and not v.flags.writeable:
                    v = v.copy()
                t = torch.as_tensor(v)
                if dtypes:
                    want = dtypes.get(k) if isinstance(dtypes, dict) \
                        else dtypes
                    if want is not None:
                        t = t.to(want)
                out[k] = t
            yield out

    # ------------------------------------------------------------------
    # split / writes

    def split(self, n: int, *, equal: bool = False,
              locality_hints=None) -> List["MaterializedDataset"]:
        mat = self.materialize()
        bundles = mat._bundles
        if equal:
            # exact equal-row splits: slice straddling blocks at the
            # per-split row boundaries (extra `total % n` rows dropped,
            # matching the reference's equal=True contract)
            total = sum(b.metadata.num_rows for b in bundles)
            per = total // n
            slicer = ray_tpu_torch.remote(_slice_block_task)
            out: List[List[RefBundle]] = [[] for _ in range(n)]
            bi = 0          # current block index
            boff = 0        # rows of current block already consumed
            for j in range(n):
                need = per
                while need > 0 and bi < len(bundles):
                    b = bundles[bi]
                    avail = b.metadata.num_rows - boff
                    take = min(need, avail)
                    if take == avail and boff == 0:
                        out[j].append(b)  # whole block, no slice task
                    else:
                        ref = slicer.remote(b.block_ref, boff, take)
                        meta = BlockMetadata(num_rows=take, size_bytes=max(
                            1, b.metadata.size_bytes * take
                            // max(1, b.metadata.num_rows)))
                        out[j].append(RefBundle(ref, meta))
                    need -= take
                    boff += take
                    if boff >= b.metadata.num_rows:
                        bi += 1
                        boff = 0
            return [MaterializedDataset(s) for s in out]
        splits: List[List[RefBundle]] = [[] for _ in range(n)]
        # round-robin whole blocks (balanced by count)
        order = sorted(range(len(bundles)),
                       key=lambda i: -bundles[i].metadata.num_rows)
        sizes = [0] * n
        for i in order:
            j = sizes.index(min(sizes))
            splits[j].append(bundles[i])
            sizes[j] += bundles[i].metadata.num_rows
        return [MaterializedDataset(s) for s in splits]

    def split_at_indices(self, indices: List[int]
                         ) -> List["MaterializedDataset"]:
        return self._split_rows_at(self.take_all(), indices)

    def _write(self, path: str, fmt: str, **writer_args) -> List[str]:
        return [p for p, _ in self._write_parts(path, fmt, **writer_args)]

    def _write_parts(self, path: str, fmt: str, **writer_args):
        """Distributed write; one (file path, row count) pair per block."""
        def write(block: Block, _path=path, _fmt=fmt, _wa=writer_args):
            fname = write_block(block, _path, _fmt, **_wa)
            n = block.num_rows if hasattr(block, "num_rows") else len(block)
            return pa.table({"path": [fname], "rows": [n]})

        ds = self._with(L.MapBlocks(self._dag, write, name=f"Write({fmt})"))
        return [(r["path"], r["rows"]) for r in ds.take_all()]

    def write_parquet(self, path: str, **kw) -> List[str]:
        return self._write(path, "parquet", **kw)

    def write_csv(self, path: str, **kw) -> List[str]:
        return self._write(path, "csv", **kw)

    def write_json(self, path: str, **kw) -> List[str]:
        return self._write(path, "json", **kw)

    def write_numpy(self, path: str, **kw) -> List[str]:
        return self._write(path, "npy", **kw)

    def write_avro(self, path: str, **kw) -> List[str]:
        return self._write(path, "avro", **kw)

    def write_tfrecords(self, path: str, **kw) -> List[str]:
        """reference: dataset.py write_tfrecords (tf.train.Example files,
        written with the dependency-free codec in datasource.py)."""
        return self._write(path, "tfrecords", **kw)

    def write_webdataset(self, path: str, **kw) -> List[str]:
        """reference: dataset.py write_webdataset — one tar shard per
        block; rows become key-grouped members (`__key__` or the row
        index), columns encoded by extension (datasource.py
        _wds_encode_field); `encoder=` maps each row dict first."""
        return self._write(path, "tar", **kw)

    def write_delta(self, table_uri: str, *, mode: str = "append",
                    **kw) -> int:
        """Write this dataset as one Delta Lake commit: part files go
        through the normal distributed parquet write, then the driver
        commits them to `_delta_log` atomically (lake.commit_delta_write).
        mode='append'|'overwrite'.  Returns the committed version.
        reference surface: read_api.py's Delta integration is read-only
        (delta-sharing); the writer here makes the round trip testable
        and lets pod jobs publish snapshots consumers can time-travel."""
        from .lake import commit_delta_write

        parts = self._write_parts(table_uri, "parquet", **kw)
        return commit_delta_write(table_uri, parts, mode=mode)

    # -- additional consumption / conversion surface ----------------------

    def take_batch(self, batch_size: int = 20,
                   batch_format: Optional[str] = None) -> Dict[str, Any]:
        """reference: dataset.py take_batch — first `batch_size` rows as
        one batch."""
        from .context import DataContext

        fmt = batch_format or DataContext.get_current().default_batch_format
        for b in self.limit(batch_size).iter_batches(
                batch_size=batch_size, batch_format=fmt):
            return b
        raise ValueError("dataset is empty")

    def _split_rows_at(self, rows: List[Dict[str, Any]],
                       indices: List[int]) -> List["MaterializedDataset"]:
        bounds = [0] + list(indices) + [len(rows)]
        return [from_rows_materialized(rows[s:e])
                for s, e in zip(bounds[:-1], bounds[1:])]

    def train_test_split(self, test_size, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        """reference: dataset.py train_test_split."""
        if isinstance(test_size, float):
            if not 0 < test_size < 1:
                raise ValueError(
                    f"test_size fraction must be in (0, 1), got {test_size}")
        elif not isinstance(test_size, int) or test_size <= 0:
            raise ValueError(
                f"test_size must be a positive int or a fraction in (0, 1), "
                f"got {test_size!r}")
        ds = self.random_shuffle(seed=seed) if shuffle else self
        rows = ds.take_all()  # one execution: count + split share it
        n_test = (int(len(rows) * test_size)
                  if isinstance(test_size, float) else test_size)
        if n_test > len(rows):
            raise ValueError(
                f"test_size {test_size} exceeds dataset size {len(rows)}")
        return tuple(self._split_rows_at(rows, [len(rows) - n_test]))

    def split_proportionately(self, proportions: List[float]
                              ) -> List["MaterializedDataset"]:
        """reference: dataset.py split_proportionately — len(p)+1 splits,
        the last taking the remainder."""
        if not proportions or sum(proportions) >= 1.0 \
                or any(p <= 0 for p in proportions):
            raise ValueError("proportions must be positive and sum to < 1")
        rows = self.take_all()  # one execution
        indices, acc = [], 0
        for p in proportions:
            acc += int(len(rows) * p)
            indices.append(acc)
        return self._split_rows_at(rows, indices)

    def randomize_block_order(self, *, seed: Optional[int] = None
                              ) -> "Dataset":
        """reference: dataset.py randomize_block_order — permute blocks
        without touching rows (cheap approximate shuffle; blocks stay in
        the object store, only their refs are reordered)."""
        import random as _random

        refs = [b.block_ref for b in self._execute()]
        rng = _random.Random(seed)
        rng.shuffle(refs)
        from . import from_arrow_refs

        return from_arrow_refs(refs)

    def size_bytes(self) -> int:
        """reference: dataset.py size_bytes."""
        total = 0
        for b in self._execute():
            n = b.metadata.size_bytes
            if not n:
                blk = ray_tpu_torch.get(b.block_ref, timeout=600)
                n = BlockAccessor(blk).to_arrow().nbytes
            total += n
        return total

    def input_files(self) -> List[str]:
        """reference: dataset.py input_files."""
        files: List[str] = []
        for b in self._execute():
            for f in (b.metadata.input_files or []):
                if f not in files:
                    files.append(f)
        return files

    def to_arrow_refs(self) -> List[Any]:
        """reference: dataset.py to_arrow_refs — blocks ARE arrow tables."""
        return [b.block_ref for b in self._execute()]

    def to_pandas_refs(self) -> List[Any]:
        to_df = ray_tpu_torch.remote(
            lambda b: BlockAccessor(b).to_arrow().to_pandas())
        return [to_df.remote(r) for r in self.to_arrow_refs()]

    def to_numpy_refs(self) -> List[Any]:
        to_np = ray_tpu_torch.remote(lambda b: BlockAccessor(b).to_numpy())
        return [to_np.remote(r) for r in self.to_arrow_refs()]

    def to_torch(self, *, label_column: Optional[str] = None,
                 batch_size: int = 256, drop_last: bool = False):
        """reference: dataset.py to_torch — torch IterableDataset of
        (features, label) (or feature-dict) batches."""
        import torch

        outer = self

        class _TorchIterable(torch.utils.data.IterableDataset):
            def __iter__(self):
                for b in outer.iter_torch_batches(batch_size=batch_size,
                                                  drop_last=drop_last):
                    if label_column is not None:
                        label = b.pop(label_column)
                        feats = (next(iter(b.values()))
                                 if len(b) == 1 else b)
                        yield feats, label
                    else:
                        yield b

        return _TorchIterable()

    def iter_tf_batches(self, *, batch_size: Optional[int] = 256,
                        drop_last: bool = False, prefetch_batches: int = 2):
        """reference: iterator.py iter_tf_batches — dict of tf tensors."""
        import tensorflow as tf

        for b in self.iter_batches(batch_size=batch_size,
                                   batch_format="numpy",
                                   drop_last=drop_last,
                                   prefetch_batches=prefetch_batches):
            yield {k: tf.convert_to_tensor(v) for k, v in b.items()}

    def to_tf(self, feature_columns, label_columns, *,
              batch_size: int = 256, drop_last: bool = False):
        """reference: dataset.py to_tf — tf.data.Dataset of
        (features, labels) tensors."""
        import tensorflow as tf

        f_cols = ([feature_columns] if isinstance(feature_columns, str)
                  else list(feature_columns))
        l_cols = ([label_columns] if isinstance(label_columns, str)
                  else list(label_columns))

        def pick(b, cols):
            if len(cols) == 1:
                return b[cols[0]]
            return {c: b[c] for c in cols}

        first = self.take_batch(1, batch_format="numpy")

        def sig(cols):
            if len(cols) == 1:
                a = np.asarray(first[cols[0]])
                return tf.TensorSpec(shape=(None,) + a.shape[1:],
                                     dtype=tf.as_dtype(a.dtype))
            return {c: tf.TensorSpec(
                shape=(None,) + np.asarray(first[c]).shape[1:],
                dtype=tf.as_dtype(np.asarray(first[c]).dtype))
                for c in cols}

        def gen():
            for b in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
                yield pick(b, f_cols), pick(b, l_cols)

        return tf.data.Dataset.from_generator(
            gen, output_signature=(sig(f_cols), sig(l_cols)))

    def iterator(self) -> "Any":
        """reference: dataset.py iterator() -> DataIterator."""
        from .iterator import _DatasetIterator

        return _DatasetIterator(self)

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List[Any]:
        """reference: dataset.py streaming_split — n DataIterators served
        by one coordinator actor executing the stream once; the iterators
        serialize into Train worker tasks.  equal=True pre-splits into
        exact equal-row shards (SPMD workers must step in lockstep);
        equal=False streams blocks first-come-first-served."""
        from .iterator import _SplitCoordinator, _StreamSplitIterator

        coord = ray_tpu_torch.remote(_SplitCoordinator).remote(self, n, equal)
        return [_StreamSplitIterator(coord, i) for i in range(n)]

    def __repr__(self):
        return f"Dataset(dag={self._dag!r})"


def _partials_task(aggs, block: Block):
    return [agg.partial(BlockAccessor(block).to_arrow()) for agg in aggs]


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are already computed and held by refs
    (reference: MaterializedDataset)."""

    def __init__(self, bundles: List[RefBundle],
                 stats: Optional[str] = None):
        super().__init__(L.InputData(bundles))
        self._bundles = bundles
        self._last_stats = stats

    def num_blocks(self) -> int:
        return len(self._bundles)

    def count(self) -> int:  # no execution needed
        return sum(b.metadata.num_rows for b in self._bundles)

    def get_internal_block_refs(self):
        return [b.block_ref for b in self._bundles]


def from_rows_materialized(rows: List[Dict[str, Any]]) -> MaterializedDataset:
    from .block import rows_to_block

    block = rows_to_block(rows)
    ref = ray_tpu_torch.put(block)
    meta = BlockAccessor(block).get_metadata()
    return MaterializedDataset([RefBundle(ref, meta)])
