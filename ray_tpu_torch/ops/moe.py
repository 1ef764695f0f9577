"""Mixture-of-experts routing and the expert feed-forward, with expert
parallelism (EP).  Counterpart of ``ray_tpu/ops/moe.py``.

The reference's formulation is kept: top-k routing with slot-priority
queue positions (GShard), dense one-hot dispatch and combine tensors
[T, E, C] and einsums over them, a static capacity per expert (tokens
past it are dropped: their combine weight is zero), and the
load-balance and router z losses returned to the caller.  The einsums
run as ``torch.einsum`` on the card, as the reference's are XLA
programs outside any Pallas kernel.

Two things are pinned where the reference's semantics would otherwise
depend on torch's choices:

  * top-k ties: ``jax.lax.top_k`` puts the lower expert index first
    among equal probabilities; ``torch.topk`` promises no order, so the
    top k come from a stable descending sort;
  * the routing group: which tokens share the experts' queues, in what
    order, and how many there are (the capacity's basis and the aux
    losses' means).  ``route_topk`` routes the tokens it is given as one
    group unless a ``RoutingGroup`` says they are this rank's part of a
    larger one (``models/moe.py`` builds one over a mesh's token plane):
    then the queue positions are counted over the whole group's
    assignments, in its order, and the means are taken over its tokens.

Expert parallelism is one ``mesh_all_to_all`` each way over the ``ep``
group (``collective/nccl_group.py``, differentiable): [E, C, D] ->
[E/n, n*C, D] to the experts' owners, and back.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["RouterOut", "RoutingGroup", "expert_capacity", "route_topk",
           "moe_ffn", "moe_ffn_sharded", "expert_ffn", "record_drops",
           "gelu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class RouterOut(NamedTuple):
    dispatch: torch.Tensor   # [T, E, C] 0/1 dispatch tensor
    combine: torch.Tensor    # [T, E, C] gate-weighted combine tensor
    aux_loss: torch.Tensor   # scalar load-balance loss
    z_loss: torch.Tensor     # scalar router z-loss


def expert_capacity(num_tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Static per-expert token budget (a multiple of 8, at least 8)."""
    c = int(math.ceil(k * num_tokens / num_experts * capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


class RoutingGroup:
    """The tokens routed together, when a caller holds only part of them.

    This base class is one caller holding one whole group: the tokens
    it routes.  A subclass over a mesh (``models/moe.py``) spans the
    ranks that share the tokens of a batch, which the reference splits
    into ``n_groups`` contiguous groups of its global token order.

      * ``gather(t)``: [T_local, ...] -> [G, T_group, ...], every token's
        value in each group's order (no gradient);
      * ``mine(t)``: [G, T_group, ...] -> [T_local, ...], this caller's
        tokens' rows;
      * ``sum(t)``: [G, ...] partial sums -> the sums over every caller
        (differentiable; every caller then holds the same values);
      * ``index``: the group this caller's tokens belong to.
    """

    n_groups = 1
    index = 0

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return t[None]

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        return t[0]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t


_WHOLE = RoutingGroup()

# (assignments, dropped) per routing while ``record_drops`` is open
_drops: Optional[List[Tuple[int, torch.Tensor]]] = None


@contextlib.contextmanager
def record_drops():
    """Collect, for each routing inside the block, its group's count of
    top-k assignments (an int) and how many of them fell past capacity
    (a 0-d tensor on the logits' device).  Yields the list they are
    appended to."""
    global _drops
    prev, _drops = _drops, []
    try:
        yield _drops
    finally:
        _drops = prev


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, the lower
    index first among equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _queue_positions(idx: torch.Tensor, num_experts: int):
    """The reference's slot-priority queue positions over whole groups:
    idx [G, T, k] expert choices -> (positions [G, T, k] in f32, each
    token's place in its expert's queue; top-1 counts [G, E]).  Slot j's
    positions follow every token's slots 0..j-1 (the unrolled loop of
    ``ray_tpu/ops/moe.py:route_topk``), in f32 as there."""
    G, T, k = idx.shape
    counts = torch.zeros((G, num_experts, 1), dtype=torch.float32,
                         device=idx.device)
    pos = []
    for j in range(k):
        # [G, E, T]: the scan runs along the innermost dim (exact integers
        # in f32 whatever the order)
        oh = F.one_hot(idx[..., j], num_experts).float().transpose(
            1, 2).contiguous()
        p = torch.cumsum(oh, dim=2) - 1.0 + counts
        counts = counts + oh.sum(dim=2, keepdim=True)
        pos.append(p.gather(1, idx[:, None, :, j])[:, 0])
    top1 = F.one_hot(idx[..., 0], num_experts).float().sum(dim=1)
    return torch.stack(pos, dim=-1), top1


def route_topk(logits: torch.Tensor, k: int, capacity: int,
               group: Optional[RoutingGroup] = None) -> RouterOut:
    """Top-k routing with slot-priority positioning (GShard).

    logits: [T, E] router scores of this caller's tokens.  Returns dense
    dispatch / combine tensors [T, E, capacity] (f32, or f64 for f64
    logits) and the aux losses: the load balance E * sum_e frac_e *
    mean_prob_e over the top-1 assignment (Switch Transformer eq. 4) and
    the mean of logsumexp^2, each over the group's tokens and then
    averaged over its groups.  Tokens past their expert's capacity get
    zero weight."""
    group = _WHOLE if group is None else group
    T, E = logits.shape
    cdt = torch.promote_types(logits.dtype, torch.float32)
    lg = logits.to(cdt)
    probs = torch.softmax(lg, dim=-1)
    gate, idx = _top_k(probs, k)
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)

    with torch.no_grad():
        idx_all = group.gather(idx)                              # [G, Tg, k]
        pos_all, top1 = _queue_positions(idx_all, E)
        pos = group.mine(pos_all)                                # [T, k]
        keep = pos < capacity
        flat = idx * capacity + pos.clamp(0, capacity - 1).long()
        if _drops is not None:
            _drops.append((idx_all.numel(), (pos_all >= capacity).sum()))
    # each token's slots are distinct experts, so every (e, c) entry of a
    # row is written at most once: the reference's 0 + 1 and 0 + gate
    dispatch = torch.zeros((T, E * capacity), dtype=cdt,
                           device=logits.device).scatter_(
        1, flat, keep.to(cdt)).view(T, E, capacity)
    combine = torch.zeros((T, E * capacity), dtype=cdt,
                          device=logits.device).scatter(
        1, flat, gate * keep.to(cdt)).view(T, E, capacity)

    Tg = idx_all.shape[1]
    stats = torch.cat([probs.sum(dim=0),
                       torch.logsumexp(lg, dim=-1).square().sum()[None]])
    rows = F.one_hot(torch.tensor(group.index, device=logits.device),
                     group.n_groups).to(cdt)
    sums = group.sum(rows[:, None] * stats[None])                # [G, E+1]
    frac = top1.to(cdt) / Tg
    mean_prob = sums[:, :E] / Tg
    aux = (E * (frac * mean_prob).sum(dim=-1)).mean()
    z = (sums[:, E] / Tg).mean()
    return RouterOut(dispatch, combine, aux, z)


def expert_ffn(xe: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
               act: Callable = gelu, ep_group=None, tp_sum=None
               ) -> torch.Tensor:
    """The experts on their dispatched slots: xe [E, C, D] -> [E, C, D].

    With an ``ep_group`` the experts are split over its ranks (w_in
    [E/n, D, F], w_out [E/n, F, D] the local ones): one all_to_all sends
    each expert's slots to its owner ([E, C, D] -> [E/n, n*C, D]) and the
    inverse brings the results home.  ``tp_sum`` sums the row-parallel
    product's partials (the experts' mlp dim split over tp)."""
    from ray_tpu_torch.collective import nccl_group

    if ep_group is not None:
        xe = nccl_group.mesh_all_to_all(xe, ep_group, split_axis=0,
                                        concat_axis=1)
    h = act(torch.einsum("ecd,edf->ecf", xe, w_in))
    y = torch.einsum("ecf,efd->ecd", h, w_out)
    if tp_sum is not None:
        y = tp_sum(y)
    if ep_group is not None:
        y = nccl_group.mesh_all_to_all(y, ep_group, split_axis=1,
                                       concat_axis=0)
    return y


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, *, k: int = 2,
            capacity_factor: float = 1.25, act: Callable = gelu,
            capacity: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense MoE feed-forward on one device.

    x: [T, D] tokens; router_w: [D, E]; w_in: [E, D, F]; w_out:
    [E, F, D].  Returns (out [T, D], aux_loss, z_loss)."""
    T = x.shape[0]
    E = router_w.shape[1]
    C = capacity if capacity is not None else expert_capacity(
        T, E, k, capacity_factor)
    r = route_topk(x @ router_w, k, C)
    xe = torch.einsum("td,tec->ecd", x, r.dispatch.to(x.dtype))
    y = expert_ffn(xe, w_in, w_out, act)
    out = torch.einsum("ecd,tec->td", y, r.combine.to(y.dtype))
    return out, r.aux_loss, r.z_loss


def moe_ffn_sharded(x: torch.Tensor, router_w: torch.Tensor,
                    w_in_local: torch.Tensor, w_out_local: torch.Tensor, *,
                    group=None, k: int = 2, capacity_factor: float = 1.25,
                    act: Callable = gelu, capacity: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's MoE body over an ep group (the reference's body inside
    its ``shard_map``): x [T_local, D] this rank's tokens, routed as
    their own group; w_in_local / w_out_local this rank's experts
    ([E/n, D, F], [E/n, F, D]); the router replicated.  ``group`` is
    the ep process group (None: the default world).  The aux losses are
    each rank's means, averaged over the group (``pmean``)."""
    import torch.distributed as dist

    from ray_tpu_torch.collective import nccl_group

    if group is None:
        group = dist.group.WORLD
    n = dist.get_world_size(group)
    E = w_in_local.shape[0] * n
    C = capacity if capacity is not None else expert_capacity(
        x.shape[0], E, k, capacity_factor)
    r = route_topk(x @ router_w, k, C)
    xe = torch.einsum("td,tec->ecd", x, r.dispatch.to(x.dtype))
    y = expert_ffn(xe, w_in_local, w_out_local, act,
                   ep_group=group if n > 1 else None)
    out = torch.einsum("ecd,tec->td", y, r.combine.to(y.dtype))
    if n == 1:
        return out, r.aux_loss, r.z_loss
    aux, z = nccl_group.sum_partials(
        torch.stack([r.aux_loss, r.z_loss]), (group,)).unbind()
    return out, aux / n, z / n
