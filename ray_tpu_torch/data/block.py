"""Block model: the unit of distributed data.

The canonical block is a ``pyarrow.Table`` (the reference supports Arrow and
pandas blocks — reference: python/ray/data/block.py, BlockAccessor).  A
``BlockAccessor`` unifies operations over whatever a user function returned
(arrow table, pandas DataFrame, dict-of-numpy batch, or list of rows).

The port's copy of ``ray_tpu/data/block.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import pyarrow as pa

Block = pa.Table  # canonical on-wire block type

# Name used for single-column datasets built from raw items/tensors
# (the reference uses the same name, python/ray/data/block.py).
VALUE_COL = "item"


@dataclass
class BlockMetadata:
    """Small, driver-resident description of a block (reference:
    python/ray/data/block.py BlockMetadata)."""

    num_rows: int
    size_bytes: int
    schema: Optional[pa.Schema] = None
    input_files: List[str] = field(default_factory=list)
    exec_stats: Optional[Dict[str, float]] = None


def _is_tensor_like(value: Any) -> bool:
    return isinstance(value, np.ndarray) and value.ndim > 1


class _ArrowTensorMarker:
    """Marks a >1-D numpy column stored row-wise as fixed-shape lists."""


def _np_to_arrow_array(arr: np.ndarray) -> pa.Array:
    if arr.ndim == 1:
        if arr.dtype.kind in "US":
            return pa.array(arr.tolist())
        return pa.array(arr)
    # fixed-shape tensor column: store as FixedShapeTensorType when
    # available so round-trips preserve shape
    try:
        tensor_type = pa.fixed_shape_tensor(pa.from_numpy_dtype(arr.dtype),
                                            arr.shape[1:])
        storage = pa.FixedSizeListArray.from_arrays(
            pa.array(arr.reshape(arr.shape[0], -1).ravel()),
            int(np.prod(arr.shape[1:])))
        return pa.ExtensionArray.from_storage(tensor_type, storage)
    except Exception:
        return pa.array(list(arr))


def _arrow_col_to_np(col: pa.ChunkedArray) -> np.ndarray:
    typ = col.type
    if isinstance(typ, pa.FixedShapeTensorType):
        combined = col.combine_chunks()
        if isinstance(combined, pa.ChunkedArray):
            combined = combined.chunk(0) if combined.num_chunks else \
                pa.array([], typ)
        flat = combined.storage.flatten().to_numpy(zero_copy_only=False)
        shape = (len(col),) + tuple(typ.shape)
        return flat.reshape(shape)
    return col.to_numpy(zero_copy_only=False)


def batch_to_block(batch: Any) -> Block:
    """Convert a user-returned batch to the canonical arrow block."""
    if isinstance(batch, pa.Table):
        return batch
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except ImportError:
        pass
    if isinstance(batch, dict):
        cols, names = [], []
        for k, v in batch.items():
            names.append(k)
            if isinstance(v, np.ndarray):
                cols.append(_np_to_arrow_array(v))
            else:
                cols.append(pa.array(list(v)))
        return pa.Table.from_arrays(cols, names=names)
    if isinstance(batch, np.ndarray):
        return pa.Table.from_arrays([_np_to_arrow_array(batch)],
                                    names=[VALUE_COL])
    if isinstance(batch, list):
        return rows_to_block(batch)
    raise TypeError(
        f"cannot convert batch of type {type(batch).__name__} to a block; "
        f"return pyarrow.Table, pandas.DataFrame, dict of numpy arrays, or "
        f"a list of rows")


def rows_to_block(rows: Sequence[Any]) -> Block:
    """Build a block from python rows (dicts become columns; anything else
    goes into the single `item` column)."""
    if rows and all(isinstance(r, dict) for r in rows):
        names: List[str] = []
        for r in rows:
            for k in r:
                if k not in names:
                    names.append(k)
        cols = []
        for name in names:
            vals = [r.get(name) for r in rows]
            if vals and all(_is_tensor_like(v) or isinstance(v, np.ndarray)
                            for v in vals):
                try:
                    stacked = np.stack(vals)
                    cols.append(_np_to_arrow_array(stacked))
                    continue
                except Exception:
                    pass
            cols.append(pa.array(vals))
        return pa.Table.from_arrays(cols, names=names)
    vals = list(rows)
    if vals and all(isinstance(v, np.ndarray) for v in vals):
        try:
            return pa.Table.from_arrays(
                [_np_to_arrow_array(np.stack(vals))], names=[VALUE_COL])
        except Exception:
            pass
    return pa.Table.from_arrays([pa.array(vals)], names=[VALUE_COL])


class BlockAccessor:
    """Operations over a canonical arrow block (reference:
    python/ray/data/_internal/arrow_block.py ArrowBlockAccessor)."""

    def __init__(self, block: Block):
        if not isinstance(block, pa.Table):
            block = batch_to_block(block)
        self._table = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        return BlockAccessor(block)

    def to_arrow(self) -> pa.Table:
        return self._table

    def num_rows(self) -> int:
        return self._table.num_rows

    def size_bytes(self) -> int:
        return self._table.nbytes

    def schema(self) -> pa.Schema:
        return self._table.schema

    def get_metadata(self, input_files: Optional[List[str]] = None,
                     exec_stats: Optional[Dict[str, float]] = None
                     ) -> BlockMetadata:
        return BlockMetadata(num_rows=self.num_rows(),
                             size_bytes=self.size_bytes(),
                             schema=self.schema(),
                             input_files=input_files or [],
                             exec_stats=exec_stats)

    def to_pandas(self):
        return self._table.to_pandas()

    def to_numpy(self, columns: Optional[List[str]] = None
                 ) -> Dict[str, np.ndarray]:
        cols = columns or self._table.column_names
        return {c: _arrow_col_to_np(self._table.column(c)) for c in cols}

    def to_batch(self, batch_format: str):
        if batch_format in ("pyarrow", "arrow"):
            return self._table
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("numpy", "default", None):
            return self.to_numpy()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for batch in self._table.to_batches():
            cols = {name: _arrow_col_to_np(pa.chunked_array([batch.column(i)]))
                    for i, name in enumerate(batch.schema.names)}
            for i in range(batch.num_rows):
                yield {name: col[i] for name, col in cols.items()}

    def slice(self, start: int, end: int) -> Block:
        return self._table.slice(start, end - start)

    def take(self, indices: Sequence[int]) -> Block:
        return self._table.take(pa.array(indices, type=pa.int64()))

    def select(self, columns: List[str]) -> Block:
        return self._table.select(columns)

    def drop(self, columns: List[str]) -> Block:
        keep = [c for c in self._table.column_names if c not in columns]
        return self._table.select(keep)

    def rename(self, mapping: Dict[str, str]) -> Block:
        names = [mapping.get(c, c) for c in self._table.column_names]
        return self._table.rename_columns(names)

    def random_permutation(self, seed: Optional[int]) -> Block:
        rng = np.random.RandomState(seed)
        idx = rng.permutation(self.num_rows())
        return self.take(idx.tolist())

    def sort(self, key, descending: bool = False) -> Block:
        order = "descending" if descending else "ascending"
        if isinstance(key, str):
            key = [key]
        return self._table.sort_by([(k, order) for k in key])

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if b is not None and b.num_rows >= 0]
        if not blocks:
            return pa.table({})
        nonempty = [b for b in blocks if b.num_rows > 0]
        if not nonempty:
            return blocks[0]
        return pa.concat_tables(nonempty, promote_options="default")


class BlockBuilder:
    """Accumulates rows/batches into bounded-size output blocks (reference:
    python/ray/data/_internal/delegating_block_builder.py)."""

    def __init__(self, target_max_bytes: Optional[int] = None):
        self._rows: List[Any] = []
        self._blocks: List[Block] = []
        self._target = target_max_bytes

    def add_row(self, row: Any) -> None:
        self._rows.append(row)

    def add_block(self, block: Any) -> None:
        self._flush_rows()
        self._blocks.append(batch_to_block(block))

    def _flush_rows(self) -> None:
        if self._rows:
            self._blocks.append(rows_to_block(self._rows))
            self._rows = []

    def build(self) -> Block:
        self._flush_rows()
        return BlockAccessor.concat(self._blocks)
