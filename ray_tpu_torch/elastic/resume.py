"""Shrink-to-fit math for elastic resume.

Pure functions (unit-testable without a cluster) used by the
BackendExecutor's supervised restart loop: pick the post-shrink width
over data-parallel replicas while preserving tp/sp axes, and split a
constant global batch exactly across the new width.

Width selection is goodput-*predicted*, not greedy: ``choose_width``
ranks every feasible width by the effective round rate predicted from
``IncarnationHistory`` — the recorded rounds-per-wall-second of every
gang incarnation this run has lived through, recovery churn included.
"Largest feasible" is the MLPerf TPU-pod scaling trap (arXiv:1909.09756):
when the widest gang keeps collapsing (a flaky host, repeat preemption),
its *effective* rate — rounds divided by wall time including the
recoveries it caused — falls below a narrower, stable gang's, and the
history says so.  With no history (or history at a single width, where
extrapolation is monotonic) the choice degrades to the classic largest
feasible width.

The port's copy of ``ray_tpu/elastic/resume.py``, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class InsufficientWorkersError(RuntimeError):
    """Fewer survivors than ElasticConfig.min_workers allows."""


def shrink_to_fit(alive: int, min_workers: int,
                  max_workers: Optional[int] = None,
                  workers_per_replica: int = 1) -> int:
    """Largest feasible width <= alive: a multiple of the model-replica
    unit (tp*sp hosts), capped by max_workers, floored by min_workers."""
    unit = max(1, workers_per_replica)
    cap = alive if max_workers is None else min(alive, max_workers)
    n = (cap // unit) * unit
    floor = max(min_workers, unit)
    if n < floor:
        raise InsufficientWorkersError(
            f"only {alive} workers survive; the largest width that keeps "
            f"whole model replicas (unit={unit}, cap={cap}) is {n}, below "
            f"min_workers={min_workers}")
    return n


class IncarnationHistory:
    """Per-incarnation effective-throughput records.

    The BackendExecutor opens a record at ``start_training`` (width,
    rounds counter, wall clock) and closes it when the incarnation ends
    (recovery entry / run end).  A closed record's ``rate`` is rounds
    per wall second — *wall*, not productive time, so a width that kept
    dying carries its recovery churn in its own score.
    """

    def __init__(self):
        self._records: List[Dict[str, Any]] = []
        self._open: Optional[Dict[str, Any]] = None

    def begin(self, incarnation: int, width: int, rounds: int,
              now: float) -> None:
        self.end(rounds, now)  # an unclosed prior record ends here
        self._open = {"incarnation": incarnation, "width": int(width),
                      "rounds0": int(rounds), "t0": float(now)}

    def end(self, rounds: int, now: float) -> None:
        if self._open is None:
            return
        o, self._open = self._open, None
        wall = max(now - o["t0"], 1e-9)
        done = max(int(rounds) - o["rounds0"], 0)
        self._records.append({
            "incarnation": o["incarnation"], "width": o["width"],
            "rounds": done, "wall_s": round(wall, 6),
            "rate": done / wall,
        })

    def records(self) -> List[Dict[str, Any]]:
        return list(self._records)


def predict_rate(width: int,
                 records: List[Dict[str, Any]]) -> Optional[float]:
    """Predicted effective round rate at ``width`` from history.

    Observed widths use their mean recorded rate.  Unobserved widths
    extrapolate linearly from the nearest observed width: with a
    constant global batch, per-replica work shrinks ~1/width, so round
    rate scales ~linearly in width absent degradation — and degradation
    is exactly what the observed rates encode.  Returns None with no
    usable history.
    """
    by_width: Dict[int, List[float]] = {}
    for rec in records:
        if rec.get("rounds", 0) > 0 and rec.get("width", 0) > 0:
            by_width.setdefault(int(rec["width"]), []).append(
                float(rec["rate"]))
    if not by_width:
        return None
    means = {w: sum(rs) / len(rs) for w, rs in by_width.items()}
    if width in means:
        return means[width]
    # nearest observed width; ties prefer the wider anchor
    w0 = min(means, key=lambda w: (abs(w - width), -w))
    return means[w0] * (width / w0)


def choose_width(alive: int, min_workers: int,
                 max_workers: Optional[int] = None,
                 workers_per_replica: int = 1,
                 history: Optional[IncarnationHistory] = None) -> int:
    """Post-shrink gang width by predicted goodput.

    Candidates are every feasible width (multiples of the replica unit
    between the floor and the shrink-to-fit cap); the winner maximizes
    the history-predicted effective rate, ties going to the wider gang.
    Degrades to ``shrink_to_fit`` (largest feasible) when there is no
    history to predict from.
    """
    top = shrink_to_fit(alive, min_workers, max_workers,
                        workers_per_replica)
    records = history.records() if history is not None else []
    unit = max(1, workers_per_replica)
    floor = max(min_workers, unit)
    candidates = list(range(floor, top + 1, unit))
    if len(candidates) <= 1:
        return top
    best, best_rate = top, None
    for w in candidates:
        rate = predict_rate(w, records)
        if rate is None:
            return top  # no usable history: largest feasible
        if best_rate is None or rate > best_rate or \
                (rate == best_rate and w > best):
            best, best_rate = w, rate
    return best


def per_replica_batches(global_batch: int, world: int) -> List[int]:
    """Split a global batch over ``world`` replicas so the sizes sum to
    exactly global_batch (remainder spread over the first ranks): the
    global batch — and thus the gradient — is invariant under width
    changes."""
    if world < 1:
        raise ValueError("world must be >= 1")
    base, rem = divmod(global_batch, world)
    return [base + (1 if i < rem else 0) for i in range(world)]


def batch_offsets(batches: List[int]) -> List[int]:
    """Start offset of each rank's slice within the global batch."""
    offsets, acc = [], 0
    for b in batches:
        offsets.append(acc)
        acc += b
    return offsets
