"""Autoscaler (reference: python/ray/autoscaler/).  The port's copy of
``ray_tpu/autoscaler``, with GCPGpuNodeProvider where the reference has
GCPTpuNodeProvider (ROADMAP §C)."""

from .autoscaler import (LoadMetrics, Monitor, ResourceDemandScheduler,
                         StandardAutoscaler)
from .node_provider import (GCPGpuNodeProvider, LocalNodeProvider,
                            NodeProvider)
from .v2 import (AutoscalerV2, Instance, InstanceManager, InstanceStorage,
                 Reconciler)

__all__ = [
    "StandardAutoscaler", "Monitor", "LoadMetrics",
    "ResourceDemandScheduler", "NodeProvider", "LocalNodeProvider",
    "GCPGpuNodeProvider",
    "AutoscalerV2", "Instance", "InstanceManager", "InstanceStorage",
    "Reconciler",
]
