"""SPMD pipeline parallelism: GPipe microbatching over the ``pp`` axis.

The port's copy of ``ray_tpu/parallel/pipeline.py``.  The reference runs
one compiled program in which every pp rank holds one stage's layers and
microbatch activations rotate stage to stage by ``lax.ppermute`` inside
a ``lax.scan``.  Here the same loop runs in the model's rank-local region
(``models/gpt.py``): each pp rank calls ``stage_fn`` on its own stage's
params (its local shard of the stacked layers) for T = M + n - 1 ticks,
and the activations rotate with ``mesh_ppermute``, whose backward sends
the gradients the other way round (``collective/nccl_group.py``), so
autograd pipelines the backward as the reference's transpose does.

Every rank runs the same ops on every tick (stage 0 selects a fresh
microbatch with ``torch.where``, the last stage's results are masked on
the others), so the ranks' autograd graphs are alike and issue their
collectives in the same order.  The bubble is the fill-drain one,
(n-1)/T.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from ray_tpu_torch.collective import nccl_group

from .sharding import _flatten
from .spmd import MeshCtx


def _tree_map(fn, tree):
    """fn(path, leaf) over a pytree's leaves, in the same structure."""
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(path, leaf) for path, leaf in leaves])


def pipeline_apply(stage_fn: Callable, stage_params, x_mb, mesh,
                   axis_name: str = "pp"):
    """Run microbatches through the pipeline.

    stage_fn(stage_params, x) -> x: one stage's computation
    stage_params: this rank's stage (the local shard of the layer stack)
    x_mb: a pytree whose leaves are [M, mb, ...] microbatched inputs,
          the same on every pp rank; a bare tensor is the one-leaf case,
          a tuple lets side outputs ride the rotation with the
          activations
    mesh: the DeviceMesh (or this rank's ``spmd.MeshCtx``)
    returns: the same structure, leaves [M, mb, ...] from the final
             stage, on every pp rank (summed over pp in f32 from the last
             rank's results, as the reference's masked psum does)

    With one pp rank it is a map over the microbatches.
    """
    ctx = mesh if isinstance(mesh, MeshCtx) else MeshCtx.of(mesh)
    n = ctx.size(axis_name)
    leaves, rebuild = _flatten(x_mb)
    xs = [l for _, l in leaves]
    M = xs[0].shape[0]
    if n == 1:
        outs = [stage_fn(stage_params, rebuild([x[i] for x in xs]))
                for i in range(M)]
        return _stack_trees(outs)

    r, group = ctx.coords[axis_name], ctx.groups[axis_name]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    first = torch.tensor(r == 0, device=xs[0].device)
    state = [torch.zeros_like(x[0]) for x in xs]
    banked: List[Any] = []
    for t in range(M + n - 1):
        # stage 0 takes a fresh microbatch while the fill lasts; the
        # others take what the previous stage sent
        fresh = [x[min(t, M - 1)] for x in xs]
        inp = [torch.where(first, f, s) for f, s in zip(fresh, state)]
        out = stage_fn(stage_params, rebuild(inp))
        if t >= n - 1:      # the last stage's result for microbatch t-n+1
            banked.append(out)
        if t < M + n - 2:   # the last tick's rotation would feed nothing
            state = [nccl_group.mesh_ppermute(o, fwd, group)
                     for _, o in _flatten(out)[0]]
    mask = 1.0 if r == n - 1 else 0.0
    return _tree_map(
        lambda _, b: nccl_group.sum_partials(
            b.float() * mask, (group,)).to(b.dtype),
        _stack_trees(banked))


def _stack_trees(trees):
    """A list of like pytrees -> one pytree of leaves stacked on dim 0."""
    rebuild = _flatten(trees[0])[1]
    cols = zip(*[[l for _, l in _flatten(t)[0]] for t in trees])
    return rebuild([torch.stack(list(c)) for c in cols])


def split_microbatches(x, num_microbatches: int):
    """Leaves [B, ...] -> [M, B/M, ...] over any pytree (tensors or numpy
    arrays); a leaf whose batch does not divide raises naming it."""
    M = int(num_microbatches)

    def split_leaf(path, leaf):
        b = leaf.shape[0] if leaf.ndim else 0
        if leaf.ndim == 0 or b % M:
            where = path or "<root>"
            raise ValueError(
                f"batch {b if leaf.ndim else '<scalar>'} at leaf {where} "
                f"(shape {tuple(leaf.shape)}) not divisible by "
                f"microbatches {M}")
        return leaf.reshape(M, b // M, *leaf.shape[1:])

    return _tree_map(split_leaf, x)


def merge_microbatches(x):
    """Leaves [M, mb, ...] -> [B, ...] (inverse of split_microbatches)."""
    return _tree_map(
        lambda _, l: l.reshape(l.shape[0] * l.shape[1], *l.shape[2:]), x)
