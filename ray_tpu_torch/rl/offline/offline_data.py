"""File-backed offline experience for CQL/BC/MARWIL.

The port of ``ray_tpu/rl/offline/offline_data.py``, a copy over the
port's Data (reference: rllib/offline/offline_data.py:22 — wraps ray.data
reads of logged episodes; rllib/offline/offline_env_runner.py writes
rollouts to parquet).  The same two directions ride
``ray_tpu_torch.data``:

  * record_rollouts(...) — [T, B] rollout dicts -> flat transition rows
    -> parquet/json shards (a local dir or any fsspec URI, so every
    host of a cluster can log experience to a shared store).
  * OfflineData(paths) — lazily reads those files back as a
    ``ray_tpu_torch.data`` Dataset and yields flat numpy transition
    batches for learner updates (a learner moves each to its device).

Columns are the flat transition schema {obs, action, reward, done,
next_obs} (+ optionally "return"); multi-dim obs are stored as fixed
shape tensor columns (Data blocks handle ndarray columns natively).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np


def _flatten_rollout(batch: Dict[str, Any],
                     gamma: Optional[float]) -> Dict[str, np.ndarray]:
    """[T, B] rollout arrays -> flat transitions; adds discounted
    reward-to-go as "return" when gamma is given (MARWIL/BC), and
    next_obs (CQL/TD-style) always."""
    obs = np.asarray(batch["obs"])
    rewards = np.asarray(batch["reward"], np.float32)
    dones = np.asarray(batch["done"], bool)
    T = rewards.shape[0]
    flat = lambda a: np.asarray(a)[:T - 1].reshape(  # noqa: E731
        -1, *np.asarray(a).shape[2:])
    out = {
        "obs": flat(obs),
        "next_obs": obs[1:].reshape(-1, *obs.shape[2:]),
        "action": flat(batch["action"]),
        "reward": flat(rewards),
        "done": flat(dones),
    }
    if gamma is not None:
        returns = np.zeros_like(rewards)
        acc = np.zeros(rewards.shape[1], np.float32)
        for t in range(T - 1, -1, -1):
            acc = rewards[t] + gamma * acc * (~dones[t])
            returns[t] = acc
        out["return"] = returns[:T - 1].reshape(-1)
    return out


def record_rollouts(batches: Iterable[Dict[str, Any]], path: str, *,
                    file_format: str = "parquet",
                    gamma: Optional[float] = 0.99) -> List[str]:
    """Write rollout batches (as returned by EnvRunner.sample, [T, B])
    to transition files under `path`; returns the written file paths
    (reference: offline_env_runner.py writing episodes via ray.data).

    Data names a file it writes at random; each is renamed with the
    batch's index in front, so a read of the directory, which takes its
    files in name order, gives the batches in the order they were
    recorded (the reference's order is the random names')."""
    from ... import data as rd
    from ..._private import fileio

    written: List[str] = []
    for i, batch in enumerate(batches):
        flat = batch if "next_obs" in batch else _flatten_rollout(batch,
                                                                  gamma)
        ds = rd.read_datasource(
            rd.BlocksDatasource([_to_block(flat)]))
        writer = getattr(ds, f"write_{file_format}")
        for f in writer(path):
            sep = "/" if fileio.is_uri(f) else os.sep
            head, _, name = f.rpartition(sep)
            ordered = f"{head}{sep}{i:06d}-{name}"
            fileio.move(f, ordered)
            written.append(ordered)
    return written


def _to_block(flat: Dict[str, np.ndarray]):
    from ...data.block import batch_to_block

    return batch_to_block({k: np.asarray(v) for k, v in flat.items()})


class OfflineData:
    """Lazy reader of logged experience (reference:
    rllib/offline/offline_data.py:22 OfflineData).

    `source` is file path(s) (parquet/json — local or fsspec URI), or an
    existing ray_tpu_torch.data.Dataset.
    """

    def __init__(self, source: Union[str, List[str], Any], *,
                 file_format: str = "parquet"):
        self._source = source
        self._format = file_format
        self._ds = None

    @property
    def dataset(self):
        if self._ds is None:
            from ... import data as rd

            src = self._source
            if isinstance(src, (str, list, tuple)):
                reader = getattr(rd, f"read_{self._format}")
                self._ds = reader(src)
            else:
                self._ds = src  # already a Dataset
        return self._ds

    def iter_transition_batches(
            self, batch_size: int = 256, *,
            shuffle_seed: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Flat numpy transition batches for learner updates."""
        kw = {}
        if shuffle_seed is not None:
            kw = {"local_shuffle_buffer_size": 4 * batch_size,
                  "local_shuffle_seed": shuffle_seed}
        for b in self.dataset.iter_batches(batch_size=batch_size,
                                           batch_format="numpy", **kw):
            yield {k: np.asarray(v) for k, v in b.items()}

    def materialize(self, batch_size: int = 256) -> List[Dict[str, np.ndarray]]:
        return list(self.iter_transition_batches(batch_size))


def resolve_offline_data(data: Any, *, gamma: float,
                         batch_size: int = 256,
                         want_return: bool = False
                         ) -> List[Dict[str, np.ndarray]]:
    """Normalize every accepted offline-data shape into a list of flat
    numpy batches: file path(s), OfflineData, a Data Dataset, or
    the legacy in-memory iterable of rollout/transition dicts."""
    if data is None:
        return []
    first = (data[0] if isinstance(data, (list, tuple)) and data else data)
    if isinstance(first, str):
        # sniff the format from the ACTUAL files (a directory of .json
        # shards carries no suffix on the dir path itself)
        from ..._private import fileio

        files = fileio.expand_paths(data)
        fmt = "json" if files[0].endswith((".json", ".jsonl")) \
            else "parquet"
        data = OfflineData(data, file_format=fmt)
    if isinstance(data, OfflineData):
        batches = data.materialize(batch_size)
    elif hasattr(data, "iter_batches"):       # a Dataset
        batches = OfflineData(data).materialize(batch_size)
    else:
        batches = []
        for item in data:
            if "next_obs" not in item and "return" not in item:
                item = _flatten_rollout(item, gamma)
            batches.append({k: np.asarray(v) for k, v in item.items()})
    if want_return:
        for b in batches:
            if "return" not in b:
                raise ValueError(
                    "MARWIL/BC offline data needs a 'return' column; "
                    "record_rollouts(gamma=...) writes it")
    return batches
