"""GroupedData: the result of Dataset.groupby.

Reference: python/ray/data/grouped_data.py — aggregate / count / sum /
min / max / mean / std / map_groups, executed as a hash-partition exchange
followed by per-partition grouped reduction (execution.py AllToAllOperator
kind='groupby').

The port's copy of ``ray_tpu/data/grouped.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

from typing import Callable, Optional

from . import aggregate as agg_mod
from . import logical as L
from .dataset import Dataset


class GroupedData:
    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: agg_mod.AggregateFn) -> Dataset:
        return Dataset(L.GroupByAggregate(self._ds._dag, self._key,
                                          list(aggs)))

    def count(self) -> Dataset:
        return self.aggregate(agg_mod.Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Mean(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        return self.aggregate(agg_mod.Std(on, ddof))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"
                   ) -> Dataset:
        return Dataset(L.MapGroups(self._ds._dag, self._key, fn,
                                   batch_format=batch_format))
