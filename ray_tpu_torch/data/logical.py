"""Logical plan: lazy operator DAG built by Dataset transforms.

Reference: python/ray/data/_internal/logical/ — logical operators +
LogicalPlan; the optimizer (planner.py here) fuses map chains before
physical planning, mirroring the reference's OperatorFusionRule.

The port's copy of ``ray_tpu/data/logical.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class LogicalOp:
    """A node in the logical DAG; inputs are upstream LogicalOps."""

    name = "Op"

    def __init__(self, inputs: List["LogicalOp"]):
        self.inputs = inputs

    def __repr__(self):
        return self.name


class Read(LogicalOp):
    name = "Read"

    def __init__(self, datasource, parallelism: int = -1):
        super().__init__([])
        self.datasource = datasource
        self.parallelism = parallelism
        self.name = f"Read{datasource.get_name()}"


class InputData(LogicalOp):
    """Already-executed bundles (materialized datasets)."""

    name = "InputData"

    def __init__(self, bundles):
        super().__init__([])
        self.bundles = bundles


# --- row/batch transforms (fusable) ---------------------------------------

class AbstractMap(LogicalOp):
    """Common base for per-block transforms.  ``fn_kind`` distinguishes how
    the user fn consumes data: 'batch', 'row', 'flat', 'filter', 'block'."""

    def __init__(self, input_op: LogicalOp, fn: Callable, fn_kind: str, *,
                 batch_size: Optional[int] = None,
                 batch_format: Optional[str] = None,
                 fn_args: Tuple = (), fn_kwargs: Optional[Dict] = None,
                 compute: Optional[Any] = None,
                 resources: Optional[Dict[str, float]] = None,
                 name: Optional[str] = None):
        super().__init__([input_op])
        self.fn = fn
        self.fn_kind = fn_kind
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.fn_args = fn_args
        self.fn_kwargs = fn_kwargs or {}
        self.compute = compute
        self.resources = resources or {}
        self.name = name or f"Map({getattr(fn, '__name__', 'fn')})"


class MapBatches(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        kw.setdefault("name", f"MapBatches({getattr(fn, '__name__', 'fn')})")
        super().__init__(input_op, fn, "batch", **kw)


class MapRows(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        kw.setdefault("name", f"Map({getattr(fn, '__name__', 'fn')})")
        super().__init__(input_op, fn, "row", **kw)


class Filter(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        kw.setdefault("name", f"Filter({getattr(fn, '__name__', 'fn')})")
        super().__init__(input_op, fn, "filter", **kw)


class FlatMap(AbstractMap):
    def __init__(self, input_op, fn, **kw):
        kw.setdefault("name", f"FlatMap({getattr(fn, '__name__', 'fn')})")
        super().__init__(input_op, fn, "flat", **kw)


class MapBlocks(AbstractMap):
    """Internal: fn(block)->block transform (writes, projections)."""

    def __init__(self, input_op, fn, **kw):
        kw.setdefault("name", f"MapBlocks({getattr(fn, '__name__', 'fn')})")
        super().__init__(input_op, fn, "block", **kw)


# --- all-to-all ops --------------------------------------------------------

class AbstractAllToAll(LogicalOp):
    def __init__(self, input_op: LogicalOp, num_outputs: Optional[int]):
        super().__init__([input_op])
        self.num_outputs = num_outputs


class Repartition(AbstractAllToAll):
    name = "Repartition"

    def __init__(self, input_op, num_blocks: int, shuffle: bool = False):
        super().__init__(input_op, num_blocks)
        self.shuffle = shuffle


class RandomShuffle(AbstractAllToAll):
    name = "RandomShuffle"

    def __init__(self, input_op, seed: Optional[int] = None,
                 num_outputs: Optional[int] = None):
        super().__init__(input_op, num_outputs)
        self.seed = seed


class Sort(AbstractAllToAll):
    name = "Sort"

    def __init__(self, input_op, key, descending: bool = False,
                 num_outputs: Optional[int] = None):
        super().__init__(input_op, num_outputs)
        self.key = key
        self.descending = descending


class GroupByAggregate(AbstractAllToAll):
    name = "Aggregate"

    def __init__(self, input_op, key: Optional[str], aggs: List,
                 num_outputs: Optional[int] = None):
        super().__init__(input_op, num_outputs)
        self.key = key
        self.aggs = aggs


class MapGroups(AbstractAllToAll):
    name = "MapGroups"

    def __init__(self, input_op, key: Optional[str], fn: Callable,
                 batch_format: Optional[str] = None,
                 num_outputs: Optional[int] = None):
        super().__init__(input_op, num_outputs)
        self.key = key
        self.fn = fn
        self.batch_format = batch_format


# --- n-ary / misc ----------------------------------------------------------

class Limit(LogicalOp):
    name = "Limit"

    def __init__(self, input_op, limit: int):
        super().__init__([input_op])
        self.limit = limit


class Union(LogicalOp):
    name = "Union"

    def __init__(self, inputs: List[LogicalOp]):
        super().__init__(inputs)


class Zip(LogicalOp):
    name = "Zip"

    def __init__(self, left: LogicalOp, right: LogicalOp):
        super().__init__([left, right])


@dataclass
class LogicalPlan:
    dag: LogicalOp

    def sources(self) -> List[LogicalOp]:
        out, seen, stack = [], set(), [self.dag]
        while stack:
            op = stack.pop()
            if id(op) in seen:
                continue
            seen.add(id(op))
            if not op.inputs:
                out.append(op)
            stack.extend(op.inputs)
        return out
