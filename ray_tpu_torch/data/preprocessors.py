"""Preprocessors: fit/transform feature pipelines over Datasets.

Analog of the reference's ray.data.preprocessors (reference:
python/ray/data/preprocessors/ — scaler.py StandardScaler/MinMaxScaler,
encoder.py OneHotEncoder/LabelEncoder/OrdinalEncoder, imputer.py
SimpleImputer, concatenator.py, batch_mapper.py, chain.py): statistics are
computed with the Dataset's distributed aggregates, transforms run as
map_batches over numpy columns — and compose with iter_jax_batches to feed
device-resident training batches.

The port's copy of ``ray_tpu/data/preprocessors.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .dataset import Dataset


class Preprocessor:
    """Base: subclasses implement _fit(ds) -> stats dict and
    _transform_numpy(batch) using self.stats_."""

    _is_fittable = True

    def __init__(self):
        self.stats_: Optional[Dict[str, Any]] = None

    def fit(self, ds: Dataset) -> "Preprocessor":
        if self._is_fittable:
            self.stats_ = self._fit(ds)
        return self

    def fit_transform(self, ds: Dataset) -> Dataset:
        return self.fit(ds).transform(ds)

    def transform(self, ds: Dataset) -> Dataset:
        if self._is_fittable and self.stats_ is None:
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return ds.map_batches(self._transform_numpy, batch_format="numpy")

    def transform_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        if self._is_fittable and self.stats_ is None:
            raise RuntimeError(f"{type(self).__name__} not fitted")
        return self._transform_numpy(dict(batch))

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        raise NotImplementedError

    def _transform_numpy(self, batch: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str], ddof: int = 0):
        super().__init__()
        self.columns = list(columns)
        self.ddof = ddof

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        from .aggregate import Mean, Std

        # one combined aggregate pass over all columns, not 2k executions
        aggs = [Mean(c) for c in self.columns] + \
            [Std(c, ddof=self.ddof) for c in self.columns]
        stats = dict(ds.aggregate(*aggs))
        for c in self.columns:
            s = stats.get(f"std({c})")
            if not s or s <= 0:
                stats[f"std({c})"] = 1.0
        return stats

    def _transform_numpy(self, batch):
        for c in self.columns:
            mu = self.stats_[f"mean({c})"]
            sd = self.stats_[f"std({c})"]
            batch[c] = (np.asarray(batch[c], np.float64) - mu) / sd
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        from .aggregate import Max, Min

        return dict(ds.aggregate(*[Min(c) for c in self.columns],
                                 *[Max(c) for c in self.columns]))

    def _transform_numpy(self, batch):
        for c in self.columns:
            lo = self.stats_[f"min({c})"]
            hi = self.stats_[f"max({c})"]
            span = (hi - lo) or 1.0
            batch[c] = (np.asarray(batch[c], np.float64) - lo) / span
        return batch


class MaxAbsScaler(Preprocessor):
    """x / max(|x|) per column."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        from .aggregate import Max, Min

        raw = ds.aggregate(*[Min(c) for c in self.columns],
                           *[Max(c) for c in self.columns])
        return {f"abs_max({c})": max(abs(raw[f"min({c})"]),
                                     abs(raw[f"max({c})"])) or 1.0
                for c in self.columns}

    def _transform_numpy(self, batch):
        for c in self.columns:
            batch[c] = (np.asarray(batch[c], np.float64)
                        / self.stats_[f"abs_max({c})"])
        return batch


class LabelEncoder(Preprocessor):
    """Category -> dense int id for one label column."""

    def __init__(self, label_column: str):
        super().__init__()
        self.label_column = label_column

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        vals = sorted(ds.unique(self.label_column), key=str)
        return {"classes": {v: i for i, v in enumerate(vals)}}

    def _transform_numpy(self, batch):
        m = self.stats_["classes"]
        col = batch[self.label_column]
        batch[self.label_column] = np.asarray(
            [m[v] for v in np.asarray(col).tolist()], np.int64)
        return batch

    def inverse_transform_batch(self, batch):
        inv = {i: v for v, i in self.stats_["classes"].items()}
        col = batch[self.label_column]
        batch[self.label_column] = np.asarray(
            [inv[int(v)] for v in np.asarray(col).tolist()])
        return batch


class OrdinalEncoder(Preprocessor):
    """Categories -> dense int ids for several columns."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        return {c: {v: i for i, v in enumerate(
            sorted(ds.unique(c), key=str))} for c in self.columns}

    def _transform_numpy(self, batch):
        for c in self.columns:
            m = self.stats_[c]
            batch[c] = np.asarray(
                [m[v] for v in np.asarray(batch[c]).tolist()], np.int64)
        return batch


class OneHotEncoder(Preprocessor):
    """Category columns -> {col}_{value} indicator columns."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        return {c: sorted(ds.unique(c), key=str) for c in self.columns}

    def _transform_numpy(self, batch):
        for c in self.columns:
            col = np.asarray(batch.pop(c))
            for v in self.stats_[c]:
                batch[f"{c}_{v}"] = (col == v).astype(np.int64)
        return batch


class SimpleImputer(Preprocessor):
    """Fill NaNs with mean / most_frequent / constant."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Any = None):
        super().__init__()
        if strategy not in ("mean", "most_frequent", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' requires fill_value")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value

    def _fit(self, ds: Dataset) -> Dict[str, Any]:
        if self.strategy == "constant":
            return {c: self.fill_value for c in self.columns}
        if self.strategy == "mean":
            # nan-skipping mean (Dataset.mean propagates NaN)
            out = {}
            for c in self.columns:
                total, n = 0.0, 0
                for row in ds.select_columns([c]).iter_rows():
                    v = row[c]
                    if v is not None and v == v:
                        total += float(v)
                        n += 1
                out[c] = total / n if n else 0.0
            return out
        out = {}
        for c in self.columns:
            counts: Dict[Any, int] = {}
            for row in ds.select_columns([c]).iter_rows():
                v = row[c]
                if v is not None and v == v:  # skip None/NaN
                    counts[v] = counts.get(v, 0) + 1
            out[c] = max(counts.items(), key=lambda kv: kv[1])[0] \
                if counts else 0
        return out

    def _transform_numpy(self, batch):
        for c in self.columns:
            col = np.asarray(batch[c], dtype=object if
                             self.strategy == "most_frequent" else None)
            fill = self.stats_[c]
            if col.dtype == object:
                col = np.asarray([fill if v is None or v != v else v
                                  for v in col.tolist()])
            else:
                col = np.where(np.isnan(col.astype(np.float64)), fill, col)
            batch[c] = col
        return batch


class Concatenator(Preprocessor):
    """Merge numeric columns into one float vector column."""

    _is_fittable = False

    def __init__(self, columns: List[str], output_column_name: str = "concat",
                 dtype=np.float32):
        super().__init__()
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _transform_numpy(self, batch):
        parts = []
        for c in self.columns:
            col = np.asarray(batch.pop(c), self.dtype)
            parts.append(col[:, None] if col.ndim == 1 else col)
        batch[self.output_column_name] = np.concatenate(parts, axis=1)
        return batch


class BatchMapper(Preprocessor):
    """Arbitrary stateless batch UDF as a preprocessor."""

    _is_fittable = False

    def __init__(self, fn: Callable[[Dict[str, np.ndarray]],
                                    Dict[str, np.ndarray]]):
        super().__init__()
        self.fn = fn

    def _transform_numpy(self, batch):
        return self.fn(batch)


class Chain(Preprocessor):
    """Sequentially fit+apply preprocessors (reference: chain.py)."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)

    def fit(self, ds: Dataset) -> "Chain":
        for p in self.preprocessors:
            ds = p.fit_transform(ds)
        self.stats_ = {"fitted": True}
        return self

    def transform(self, ds: Dataset) -> Dataset:
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def fit_transform(self, ds: Dataset) -> Dataset:
        self.fit(ds)
        return self.transform(ds)

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch
