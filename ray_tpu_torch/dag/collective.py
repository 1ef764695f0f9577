"""Collective operations inside compiled DAGs.

Reference parity: ray.dag collective nodes + experimental.collective
(reference: dag/collective_node.py:19,93; experimental/collective/
allreduce.py:21) — an allreduce bound across several actors' outputs,
executed inside the compiled graph without a driver round-trip.  The
reference moves tensors over NCCL channels; here the participants
exchange contributions over the same shm channel mesh the DAG already
uses, each taking its own contribution by direct handoff and each peer's
over a channel, and reduce on their own card (a CUDA contribution lands
on the reader's card, ``channel.py``).  Device-plane reductions between
ranks belong to ``ray_tpu_torch.collective``.

The port's copy of ``ray_tpu/dag/collective.py``.  ``sum`` and ``prod``
fold in group order, as the reference's do; ``max`` and ``min`` are
``np.maximum.reduce`` / ``np.minimum.reduce`` on numpy inputs (the
reference's results, exactly) and ``torch.maximum`` / ``torch.minimum``
chained in the same order on tensors, which numpy's reductions do not
take on a card.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from .dag_node import ClassMethodNode, CollectiveOutputNode

__all__ = ["allreduce_bind", "REDUCERS"]


def _sum(vals):
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


def _prod(vals):
    out = vals[0]
    for v in vals[1:]:
        out = out * v
    return out


def _is_tensor(v) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(v, torch.Tensor)


def _chained(name: str, np_reduce):
    def reduce(vals):
        if not any(_is_tensor(v) for v in vals):
            return np_reduce(vals)
        fn = getattr(sys.modules["torch"], name)
        out = vals[0]
        for v in vals[1:]:
            out = fn(out, v)
        return out

    return reduce


REDUCERS = {
    "sum": _sum,
    "prod": _prod,
    "max": _chained("maximum", np.maximum.reduce),
    "min": _chained("minimum", np.minimum.reduce),
}


def allreduce_bind(nodes: List[ClassMethodNode], op: str = "sum"
                   ) -> List[CollectiveOutputNode]:
    """Bind an allreduce across actor-method outputs (reference:
    experimental/collective/allreduce.py:21 `allreduce.bind`).

    Each input node must run on a distinct actor; returns one output
    node per participant, each carrying the fully-reduced value on that
    participant's actor (usable by later same-actor nodes or as DAG
    leaves)."""
    if op not in REDUCERS:
        raise ValueError(f"unknown reduce op {op!r}; "
                         f"have {sorted(REDUCERS)}")
    if not nodes:
        raise ValueError("allreduce needs at least one contributor")
    for n in nodes:
        if not isinstance(n, ClassMethodNode):
            raise TypeError(
                f"allreduce contributors must be actor-method nodes, "
                f"got {n!r}")
    actor_ids = [n.handle._actor_id for n in nodes]
    if len(set(actor_ids)) != len(actor_ids):
        raise ValueError(
            "allreduce contributors must be on distinct actors")
    group = list(nodes)
    return [CollectiveOutputNode(n, group, op) for n in group]
