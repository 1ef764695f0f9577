"""Aggregation functions for Dataset.groupby / global aggregates.

Reference: python/ray/data/aggregate.py (AggregateFn, Count/Sum/Min/Max/
Mean/Std).  Implemented over arrow compute; each AggregateFn defines a
per-block partial and a cross-block combine, so aggregation runs as
distributed partials + a small driver-side reduce.

The port's copy of ``ray_tpu/data/aggregate.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

import pyarrow as pa
import pyarrow.compute as pc


class AggregateFn:
    def __init__(self, name: str,
                 partial: Callable[[pa.Table], Any],
                 combine: Callable[[List[Any]], Any],
                 finalize: Optional[Callable[[Any], Any]] = None):
        self.name = name
        self.partial = partial
        self.combine = combine
        self.finalize = finalize or (lambda x: x)


def _scalar(v):
    try:
        return v.as_py()
    except AttributeError:
        return v


class Count(AggregateFn):
    def __init__(self, on: Optional[str] = None, alias_name=None):
        name = alias_name or ("count()" if on is None else f"count({on})")
        if on is None:
            partial = lambda t: t.num_rows  # noqa: E731
        else:
            partial = lambda t: t.num_rows - t.column(on).null_count  # noqa: E731
        super().__init__(name, partial, lambda parts: sum(parts))


class Sum(AggregateFn):
    def __init__(self, on: str, alias_name=None):
        super().__init__(
            alias_name or f"sum({on})",
            lambda t: _scalar(pc.sum(t.column(on))),
            lambda parts: sum(p for p in parts if p is not None))


class Min(AggregateFn):
    def __init__(self, on: str, alias_name=None):
        super().__init__(
            alias_name or f"min({on})",
            lambda t: _scalar(pc.min(t.column(on))),
            lambda parts: min(p for p in parts if p is not None))


class Max(AggregateFn):
    def __init__(self, on: str, alias_name=None):
        super().__init__(
            alias_name or f"max({on})",
            lambda t: _scalar(pc.max(t.column(on))),
            lambda parts: max(p for p in parts if p is not None))


class Mean(AggregateFn):
    def __init__(self, on: str, alias_name=None):
        def partial(t: pa.Table):
            col = t.column(on)
            n = t.num_rows - col.null_count
            s = _scalar(pc.sum(col)) or 0
            return (s, n)

        def combine(parts):
            s = sum(p[0] for p in parts)
            n = sum(p[1] for p in parts)
            return (s, n)

        super().__init__(alias_name or f"mean({on})", partial, combine,
                         lambda sn: (sn[0] / sn[1]) if sn[1] else None)


class Std(AggregateFn):
    """Parallel variance via per-block (n, mean, M2) + Chan combine."""

    def __init__(self, on: str, ddof: int = 1, alias_name=None):
        def partial(t: pa.Table):
            import numpy as np

            col = t.column(on)
            if col.null_count:
                col = pc.drop_null(col)
            vals = col.to_numpy(zero_copy_only=False)
            n = len(vals)
            if n == 0:
                return (0, 0.0, 0.0)
            m = float(np.mean(vals))
            m2 = float(np.sum((vals - m) ** 2))
            return (n, m, m2)

        def combine(parts):
            n, mean, m2 = 0, 0.0, 0.0
            for (nb, mb, m2b) in parts:
                if nb == 0:
                    continue
                delta = mb - mean
                tot = n + nb
                m2 = m2 + m2b + delta * delta * n * nb / tot
                mean = mean + delta * nb / tot
                n = tot
            return (n, mean, m2)

        def finalize(nm):
            n, _, m2 = nm
            if n - ddof <= 0:
                return None
            return math.sqrt(m2 / (n - ddof))

        super().__init__(alias_name or f"std({on})", partial, combine,
                         finalize)
