"""Runtime utilities of the port: ``tracing``, placement groups and the
scheduling strategies, the state API (``state``) and client mode
(``client``), the runtime's copies of ``ray_tpu/util/tracing.py``,
``placement_group.py``, ``scheduling_strategies.py``, ``state/`` and
``client/``.  The rest of ``ray_tpu.util`` (actor pools, queues, rpdb,
metrics) comes with the slices that need it (ROADMAP A.4d-ii, A.5)."""

from .placement_group import (PlacementGroup, get_placement_group,
                              placement_group, placement_group_table,
                              remove_placement_group)
from .scheduling_strategies import (NodeAffinitySchedulingStrategy,
                                    NodeLabelSchedulingStrategy,
                                    PlacementGroupSchedulingStrategy)

__all__ = [
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroup",
    "PlacementGroupSchedulingStrategy",
    "get_placement_group",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
]
