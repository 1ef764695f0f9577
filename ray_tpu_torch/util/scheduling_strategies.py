"""Scheduling strategy objects accepted by @remote(scheduling_strategy=...).

Mirrors the reference (reference: python/ray/util/scheduling_strategies.py —
PlacementGroupSchedulingStrategy :15, NodeAffinitySchedulingStrategy :41,
NodeLabelSchedulingStrategy :135 with In/NotIn/Exists/DoesNotExist label
match operators).  The port's copy of
``ray_tpu/util/scheduling_strategies.py``.
"""

from __future__ import annotations

from typing import Dict, Optional


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class In:
    """Label value is one of the given values."""

    def __init__(self, *values: str):
        self.values = [str(v) for v in values]

    def to_wire(self):
        return ("in", self.values)


class NotIn:
    """Label value is none of the given values."""

    def __init__(self, *values: str):
        self.values = [str(v) for v in values]

    def to_wire(self):
        return ("not_in", self.values)


class Exists:
    """Label key is present on the node."""

    def to_wire(self):
        return ("exists", [])


class DoesNotExist:
    """Label key is absent from the node."""

    def to_wire(self):
        return ("does_not_exist", [])


def _exprs_to_wire(d: Optional[Dict]) -> list:
    out = []
    for key, op in (d or {}).items():
        if isinstance(op, (In, NotIn, Exists, DoesNotExist)):
            kind, values = op.to_wire()
        else:  # bare value sugar: {"zone": "a"} == In("a")
            kind, values = "in", [str(op)]
        out.append((key, kind, values))
    return out


class NodeLabelSchedulingStrategy:
    """Target nodes by label (reference: scheduling_strategies.py:135).
    `hard` requirements must match; among matching nodes, ones that also
    satisfy `soft` are preferred.  Nodes carry labels from their raylet
    registration."""

    def __init__(self, hard: Optional[Dict] = None,
                 soft: Optional[Dict] = None):
        if not hard and not soft:
            raise ValueError(
                "NodeLabelSchedulingStrategy needs hard or soft labels")
        self.hard = hard or {}
        self.soft = soft or {}

    def to_wire(self):
        return {"kind": "node_label",
                "hard": _exprs_to_wire(self.hard),
                "soft": _exprs_to_wire(self.soft)}


__all__ = ["PlacementGroupSchedulingStrategy",
           "NodeAffinitySchedulingStrategy",
           "NodeLabelSchedulingStrategy",
           "In", "NotIn", "Exists", "DoesNotExist"]
