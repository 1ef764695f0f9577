"""The rank-local side of a sharded program: this rank's place on a mesh
and the mesh-axis forms of the collectives that a sharded step runs.

The reference compiles one program over the mesh and lets the
partitioner insert the collectives (``ray_tpu/models/training.py:1-10``).
In the port every rank runs the model on its own shards inside one
rank-local region (``models/gpt.py``), and the collectives are explicit.
Each one here names mesh axes and runs the collective layer's
differentiable form (``collective/nccl_group.py``, where every mesh
collective is traced and reported to the flight recorder) over the
groups of this rank's lines along them:

  * ``gather``      all-gather on use (fsdp's ZeRO-3); backward:
                    reduce-scatter of the gradient;
  * ``reduce_out``  all-reduce of partial results (after a row-parallel
                    matmul over ``tp``, Megatron's "g"); backward: the
                    identity, the gradient being the same on every rank;
  * ``reduce_grad`` the identity (before a column-parallel matmul over
                    ``tp``, Megatron's "f", or on a parameter replicated
                    over data ranks); backward: all-reduce of the
                    gradient;
  * ``all_sum`` / ``all_max``: reductions that record no gradient.

On an axis of size 1 each is the identity and runs no collective, so a
mesh whose every axis is 1, or no mesh (``MeshCtx.of(None)``), computes
exactly the unsharded program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ray_tpu_torch.collective import nccl_group

from .mesh import AXIS_ORDER, axis_group, axis_index, axis_sizes

DATA_AXES = ("dp", "fsdp", "ep")


@dataclasses.dataclass
class MeshCtx:
    """This rank's place on a mesh: each axis's size, this rank's
    coordinate on it, and its line's group (None for size 1)."""

    mesh: object
    sizes: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]

    @classmethod
    def of(cls, mesh) -> "MeshCtx":
        """``mesh``'s; with no mesh, the one rank of an unsharded model
        (every axis 1, no group)."""
        if mesh is None:
            return cls(None, dict.fromkeys(AXIS_ORDER, 1),
                       dict.fromkeys(AXIS_ORDER, 0),
                       dict.fromkeys(AXIS_ORDER))
        sizes = axis_sizes(mesh)
        return cls(mesh, sizes, {a: axis_index(mesh, a) for a in sizes},
                   {a: axis_group(mesh, a) for a in sizes})

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    @property
    def data_size(self) -> int:
        n = 1
        for a in DATA_AXES:
            n *= self.size(a)
        return n

    @property
    def data_index(self) -> int:
        """This rank's block of a batch sharded over the data axes, outer
        to inner."""
        idx = 0
        for a in DATA_AXES:
            idx = idx * self.size(a) + self.coords.get(a, 0)
        return idx


def _groups(ctx: MeshCtx, axes: Sequence[str]):
    return tuple(ctx.groups[a] for a in axes if ctx.size(a) > 1)


def gather(x: torch.Tensor, dim: int, ctx: MeshCtx,
           axis: str = "fsdp") -> torch.Tensor:
    """The whole of ``x`` along ``dim`` from its blocks on ``axis``."""
    if ctx.size(axis) == 1:
        return x
    return nccl_group.gather_dim(x, dim, ctx.groups[axis])


def reduce_out(x: torch.Tensor, ctx: MeshCtx,
               axes: Sequence[str] = ("tp",)) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over ``axes``."""
    groups = _groups(ctx, axes)
    return nccl_group.sum_partials(x, groups) if groups else x


def reduce_grad(x: torch.Tensor, ctx: MeshCtx,
                axes: Sequence[str] = ("tp",)) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``axes``."""
    groups = _groups(ctx, axes)
    return nccl_group.sum_grads(x, groups) if groups else x


def all_sum(x: torch.Tensor, ctx: MeshCtx,
            axes: Sequence[str]) -> torch.Tensor:
    """A sum over ``axes`` that records no gradient (counts, norms)."""
    return nccl_group.reduce_values(x, _groups(ctx, axes), "sum")


def all_max(x: torch.Tensor, ctx: MeshCtx,
            axes: Sequence[str]) -> torch.Tensor:
    return nccl_group.reduce_values(x, _groups(ctx, axes), "max")
