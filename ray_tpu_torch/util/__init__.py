"""Runtime utilities of the port, the counterpart of ``ray_tpu.util``
(reference: python/ray/util/): placement groups and the scheduling
strategies, ActorPool, Queue, the state API (``state``), client mode
(``client``), ``tracing``, and the modules imported by name: ``rpdb``,
``multiprocessing``, ``joblib``, ``iter``, ``dask``, ``spark`` and
``metrics`` (Counter / Gauge / Histogram, flushed into the control
plane's KV and served as Prometheus text by the dashboard)."""

from .actor_pool import ActorPool
from .placement_group import (PlacementGroup, get_placement_group,
                              placement_group, placement_group_table,
                              remove_placement_group)
from .queue import Empty, Full, Queue
from .scheduling_strategies import (NodeAffinitySchedulingStrategy,
                                    NodeLabelSchedulingStrategy,
                                    PlacementGroupSchedulingStrategy)

__all__ = [
    "ActorPool",
    "Empty",
    "Full",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroup",
    "PlacementGroupSchedulingStrategy",
    "Queue",
    "get_placement_group",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
]
