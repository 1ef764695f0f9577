"""Data-parallel gradient sync for the port (see ray_tpu/parallel).  The
meshes, logical-axis rules and pipelines come with ROADMAP A.6."""

from .sharding import GradientSynchronizer

__all__ = ["GradientSynchronizer"]
