"""Meshes, logical-axis sharding, data-parallel gradient sync and
pipelines (SPMD over the ``pp`` axis, MPMD over stage gangs) for the
port (see ray_tpu/parallel)."""

from .mesh import (AXIS_ORDER, MeshSpec, axis_index, axis_sizes,
                   batch_sharding, data_axes, default_mesh,
                   get_default_mesh, local_mesh, make_mesh,
                   make_multislice_mesh, replicated, set_default_mesh,
                   slice_groups)
from .mpmd import (SCHEDULES, MPMDPipeline, PipelineConfig, get_schedule,
                   replay_bubble)
from .sharding import (ACTIVATION_RULES, DEFAULT_RULES, GradientSynchronizer,
                       Logical, NamedSharding, PartitionSpec, distribute,
                       shard_tree, spec_from_logical, spec_of,
                       tree_shardings, with_constraint)

__all__ = [
    "AXIS_ORDER", "MeshSpec", "make_mesh", "make_multislice_mesh",
    "local_mesh", "slice_groups", "batch_sharding",
    "data_axes", "replicated", "axis_sizes", "axis_index",
    "set_default_mesh", "get_default_mesh", "default_mesh",
    "DEFAULT_RULES", "ACTIVATION_RULES", "GradientSynchronizer", "Logical",
    "NamedSharding", "PartitionSpec", "distribute", "spec_from_logical",
    "spec_of", "tree_shardings", "shard_tree", "with_constraint",
    "SCHEDULES", "MPMDPipeline", "PipelineConfig", "get_schedule",
    "replay_bubble",
]
