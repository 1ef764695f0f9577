"""Ulysses-style sequence parallelism: all-to-all head<->sequence reshard.

Counterpart of ``ray_tpu/ops/ulysses.py``.  With activations sharded on
the sequence over ``sp``, attention wants the whole sequence per head: an
all-to-all (``mesh_all_to_all``, differentiable) swaps the sharded axis
from the sequence to the heads before attention and back after
(DeepSpeed-Ulysses).  Needs heads % sp == 0.  Every rank passes its own
[B, H, S/n, D] chunks (or DTensors sharded on S, unwrapped in a
``local_map`` region) and gets its own rows of the output; the inner
attention is the port's ``attention`` (K1, and K2/K3 backward, on CUDA
tensors).
"""

from __future__ import annotations

from typing import Callable, Optional


def _seq_to_heads(x, mesh, axis_name: str):
    # local [B, H, S/n, D] -> exchange -> local [B, H/n, S, D]
    from ray_tpu_torch.collective.nccl_group import mesh_all_to_all

    return mesh_all_to_all(x, mesh, axis_name, split_axis=1, concat_axis=2)


def _heads_to_seq(x, mesh, axis_name: str):
    # local [B, H/n, S, D] -> local [B, H, S/n, D]
    from ray_tpu_torch.collective.nccl_group import mesh_all_to_all

    return mesh_all_to_all(x, mesh, axis_name, split_axis=2, concat_axis=1)


def _check(q, mesh, axis_name: str) -> None:
    from ray_tpu_torch.parallel.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    if axis_name not in sizes:
        raise ValueError(f"ulysses_attention: axis {axis_name!r} is not in "
                         f"the mesh (axes: {tuple(mesh.mesh_dim_names)})")
    heads, sp = q.shape[1], sizes[axis_name]
    if heads % sp:
        raise ValueError(
            f"ulysses_attention: the all_to_all reshard splits the head dim "
            f"across the {axis_name!r} axis, so heads ({heads}) must be "
            f"divisible by the axis size ({sp}); pad/regroup heads or "
            f"shrink {axis_name!r}")


def _inner(causal: bool, scale: Optional[float],
           attn_fn: Optional[Callable]):
    if attn_fn is not None:
        return attn_fn
    from .attention import attention

    return lambda a, b, c: attention(a.contiguous(), b.contiguous(),
                                     c.contiguous(), causal=causal,
                                     scale=scale)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = False, scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None):
    """Attention with Ulysses resharding: q, k, v [B, H, S, D] sharded on
    S over ``axis_name`` (DTensors, or this rank's chunks), resharded to
    head-parallel (the whole sequence on each rank), attention by
    ``attn_fn`` (default: the port's ``attention``), then back."""
    from torch.distributed.tensor import DTensor

    _check(q, mesh, axis_name)
    if isinstance(q, DTensor):
        from torch.distributed.tensor.experimental import local_map

        from ray_tpu_torch.parallel.sharding import (NamedSharding,
                                                     PartitionSpec)

        pl = NamedSharding(mesh, PartitionSpec(None, None, axis_name,
                                               None)).placements
        fn = local_map(
            lambda q_, k_, v_: ulysses_attention(
                q_, k_, v_, mesh, axis_name, causal, scale, attn_fn),
            out_placements=list(pl), in_placements=(pl, pl, pl),
            device_mesh=mesh, redistribute_inputs=True)
        return fn(q, k, v)
    inner = _inner(causal, scale, attn_fn)
    qh = _seq_to_heads(q, mesh, axis_name)
    kh = _seq_to_heads(k, mesh, axis_name)
    vh = _seq_to_heads(v, mesh, axis_name)
    return _heads_to_seq(inner(qh, kh, vh), mesh, axis_name)


def ulysses_attention_sharded(q, k, v, axis_name: str = "sp",
                              causal: bool = False,
                              scale: Optional[float] = None,
                              attn_fn: Optional[Callable] = None, *,
                              mesh=None):
    """The per-rank body for use inside a rank-local region (q, k, v are
    this rank's chunks); ``mesh`` defaults to the default mesh."""
    if mesh is None:
        from ray_tpu_torch.parallel.mesh import get_default_mesh

        mesh = get_default_mesh()
        if mesh is None:
            raise ValueError("ulysses_attention_sharded needs a mesh: pass "
                             "mesh= or install a default mesh")
    return ulysses_attention(q, k, v, mesh, axis_name, causal, scale,
                             attn_fn)
