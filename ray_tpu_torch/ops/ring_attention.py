"""Ring attention: sequence/context parallelism over the ``sp`` mesh axis.

Counterpart of ``ray_tpu/ops/ring_attention.py``.  Q stays on its rank;
the K/V chunks rotate around the ``sp`` ring (``mesh_ppermute``, one
exchange of K and V stacked per step) while each rank folds every chunk
into its output.  Causal masking works on *global* positions: rank r owns
query rows [r*S_loc, (r+1)*S_loc), and at step t it holds the KV chunk of
rank (r - t) mod n.

The reference is one program over global arrays; here every rank calls
the ring with its own [B, H, S_loc, D] chunks (or with DTensors sharded
on S, which ``ring_attention`` unwraps in a ``local_map`` region) and
gets its own rows of the output.

Bodies (``impl``):
  * the kernel body (``_ring_attention_local_pallas`` in the reference):
    since KV rotates in whole chunks, each step is one of three static
    cases — the diagonal (K1 causal), a chunk strictly before (K1 full),
    or a chunk strictly after (masked, no launch) — each chunk's
    (o, lse) merged in log space in f32 (``ring_step``).  A causal ring
    of n ranks launches n(n+1)/2 chunks in all.  The body is one
    autograd function (``_RingFn``) whose backward is the ring's own:
    K2/K3 on each unmasked chunk against the final (o, lse), dQ summed
    in place, dK/dV summed in f32 accumulators that travel with their
    chunk and reach its rank after n rotations.  (Autograd through each
    step would give each rank its own graph — the masked steps differ —
    and a rank whose rotated chunks never reach its output, rank 0 of a
    causal ring, would skip the backward's exchanges its peers wait on;
    JAX's transpose runs every ``ppermute``.)
  * ``"xla"``: the reference's scan body in plain PyTorch: the running
    (acc, m, l) of the flash recurrence over each whole chunk.
  * ``"pallas"`` / ``"pallas_interpret"``: the kernel body over the
    kernels / over their plain versions on any device.
  * ``"auto"``: the kernel body for every CUDA tensor (the port's
    ``attention`` rule, where the reference says "on a TPU"), so a shape
    or dtype the kernels do not take raises there; the scan body for CPU
    tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import (DEFAULT_MASK_VALUE, _flash, flash_attention_bwd_plain,
                        flash_bwd_di)

_IMPLS = ("auto", "pallas", "pallas_interpret", "xla")


def ring_kind(rank: int, src: int, causal: bool) -> str:
    """Which static case the chunk of rank ``src`` is for rank ``rank``'s
    queries: "diag", "full" or "masked"."""
    if not causal:
        return "full"
    if src == rank:
        return "diag"
    return "full" if src < rank else "masked"


def ring_chunk(q, k, v, kind: str, scale: float, plain: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk: (o f32 [B, H, S, D], lse f32 [B, H, S]) of q against
    this k/v chunk, normalized within the chunk."""
    if kind == "masked":
        b, h, s, d = q.shape
        return (torch.zeros((b, h, s, d), dtype=torch.float32,
                            device=q.device),
                torch.full((b, h, s), DEFAULT_MASK_VALUE,
                           dtype=torch.float32, device=q.device))
    o, lse = _flash(q, k, v, kind == "diag", scale, 0, True, plain)
    return o.float(), lse


def ring_merge(o_acc, lse_acc, o_c, lse_c):
    """Fold a chunk's (o, lse) into the running pair, in f32 log space
    with the reference's 1e-30 clamps."""
    m = torch.maximum(lse_acc, lse_c)
    w1 = torch.exp(lse_acc - m)
    w2 = torch.exp(lse_c - m)
    den = torch.clamp_min(w1 + w2, 1e-30)
    o = (o_acc * w1[..., None] + o_c * w2[..., None]) / den[..., None]
    return o, m + torch.log(den)


def ring_init(q) -> Tuple[torch.Tensor, torch.Tensor]:
    """The empty running pair: zeros and ``DEFAULT_MASK_VALUE``."""
    b, h, s, d = q.shape
    return (torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, s), DEFAULT_MASK_VALUE, dtype=torch.float32,
                       device=q.device))


def ring_step(q, k_cur, v_cur, o_acc, lse_acc, kind: str, scale: float,
              plain: bool = False):
    """One ring step: this chunk, then the merge.  A masked chunk leaves
    the pair as it is (its weight is exp(MASK - lse) = 0, so the merge
    would give the same bits)."""
    if kind == "masked":
        return o_acc, lse_acc
    o_c, lse_c = ring_chunk(q, k_cur, v_cur, kind, scale, plain)
    return ring_merge(o_acc, lse_acc, o_c, lse_c)


def _line(mesh, axis_name: str):
    from ray_tpu_torch.parallel.mesh import axis_index, axis_sizes

    if axis_name not in tuple(mesh.mesh_dim_names):
        raise ValueError(f"ring attention: axis {axis_name!r} is not in the "
                         f"mesh (axes: {tuple(mesh.mesh_dim_names)})")
    return axis_sizes(mesh)[axis_name], axis_index(mesh, axis_name)


def _rotate(k, v, mesh, axis_name: str, n: int):
    """K and V to the next rank of the ring, in one differentiable
    exchange (the scan body's: every rank's graph holds it)."""
    from ray_tpu_torch.collective.nccl_group import mesh_ppermute

    perm = [(i, (i + 1) % n) for i in range(n)]
    kv = mesh_ppermute(torch.stack([k, v]), mesh, perm, axis_name)
    return kv[0], kv[1]


def _chunk_bwd(q, k, v, o, lse, do, di, kind: str, scale: float,
               plain: bool):
    """(dq, dk, dv) of one unmasked chunk against the final (o, lse):
    K2/K3 for CUDA tensors, their plain versions otherwise."""
    causal = kind == "diag"
    if q.device.type == "cuda" and not plain:
        from ray_tpu_torch.ops import _kernels

        return _kernels.flash_bwd(q, k, v, do, lse, di, causal=causal,
                                  scale=scale, q_offset=0)
    return flash_attention_bwd_plain(q, k, v, o, lse, do, None,
                                     causal=causal, scale=scale)


class _RingFn(torch.autograd.Function):
    """The kernel body over m local ranks at once: q, k, v [m, B, H, S, D]
    hold ranks ``ranks``' chunks of an n-rank ring (m = 1 on a mesh; m =
    n when ``ring_simulate`` runs every rank on one device), and
    ``rotate`` passes a list of [m, ...] tensors one rank on."""

    @staticmethod
    def forward(ctx, q, k, v, ranks, n, causal, scale, plain, rotate):
        k_cur, v_cur = k, v
        state = [ring_init(q[i]) for i in range(len(ranks))]
        for t in range(n):
            for i, r in enumerate(ranks):
                src = (r - t) % n
                state[i] = ring_step(q[i], k_cur[i], v_cur[i], *state[i],
                                     ring_kind(r, src, causal), scale, plain)
            if t + 1 < n:
                k_cur, v_cur = rotate([k_cur, v_cur])
        out = torch.stack([o.to(q.dtype) for o, _ in state])
        lse = torch.stack([l for _, l in state])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (ranks, n, causal, scale, plain, rotate)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ranks, n, causal, scale, plain, rotate = ctx.ring
        do = do.contiguous()
        di = flash_bwd_di(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for t in range(n):
            for i, r in enumerate(ranks):
                kind = ring_kind(r, (r - t) % n, causal)
                if kind == "masked":
                    continue
                gq, gk, gv = _chunk_bwd(q[i], k_cur[i], v_cur[i], out[i],
                                        lse[i], do[i], di[i], kind, scale,
                                        plain)
                dq[i] += gq.float()
                dk[i] += gk.float()
                dv[i] += gv.float()
            # the accumulators travel with their chunk; the n-th rotation
            # brings each home
            if t + 1 < n:
                k_cur, v_cur = rotate([k_cur, v_cur])
            dk, dv = rotate([dk, dv])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def _mesh_rotate(mesh, axis_name: str, n: int):
    """The rotation over a mesh axis, stacked tensors in one exchange
    (recording no graph: ``_RingFn`` runs the backward's own)."""
    from ray_tpu_torch.collective.nccl_group import mesh_ppermute

    perm = [(i, (i + 1) % n) for i in range(n)]

    def rotate(xs):
        return list(mesh_ppermute(torch.stack(xs), mesh, perm,
                                  axis_name).unbind(0))

    return rotate


def _roll(xs):
    """The one-device rotation: rank r receives rank r - 1's."""
    return [torch.roll(x, 1, dims=0) for x in xs]


def _ring_attention_local_kernel(q, k, v, mesh, axis_name: str,
                                 causal: bool, scale: Optional[float],
                                 plain: bool = False):
    """The kernel body on this rank's chunks: rank r folds chunk
    (r - t) mod n at step t."""
    n, r = _line(mesh, axis_name)
    scale_ = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if n == 1:
        rotate = _roll
    else:
        rotate = _mesh_rotate(mesh, axis_name, n)
    return _RingFn.apply(q[None], k[None], v[None], (r,), n, causal, scale_,
                         plain, rotate)[0]


def ring_simulate(q, k, v, n: int, causal: bool = True,
                  scale: Optional[float] = None, impl: str = "pallas"):
    """Every rank of an n-rank ring on one device, with the rotation done
    by indexing (rank r holds chunk (r - t) mod n at step t): the kernel
    body (``"pallas"``, or ``"pallas_interpret"`` over the plain
    versions; the same ``_RingFn`` as on a mesh), or the scan body
    (``"xla"``).  Returns the whole output, the ranks' rows in order;
    differentiable as the ring is."""
    B, H, S, D = q.shape
    if S % n:
        raise ValueError(f"a sequence of {S} does not divide over {n} ranks")
    blk = S // n
    scale_ = (D ** -0.5) if scale is None else float(scale)
    if impl != "xla":
        def ranked(x):      # [n, B, H, blk, D], rank-major
            return x.view(B, H, n, blk, D).permute(2, 0, 1, 3, 4) \
                .contiguous()

        out = _RingFn.apply(ranked(q), ranked(k), ranked(v),
                            tuple(range(n)), n, causal, scale_,
                            impl == "pallas_interpret", _roll)
        return out.permute(1, 2, 0, 3, 4).reshape(B, H, S, D)
    outs = []
    for r in range(n):
        qr = q[:, :, r * blk:(r + 1) * blk]
        acc, m, l = _scan_init(qr)
        for t in range(n):
            src = (r - t) % n
            acc, m, l = _scan_step(qr, k[:, :, src * blk:(src + 1) * blk],
                                   v[:, :, src * blk:(src + 1) * blk], acc,
                                   m, l, scale_, causal, r * blk, src * blk)
        outs.append(_scan_out(acc, l, q.dtype))
    return torch.cat(outs, dim=2)


def _partial_scores(q, k_blk, scale: float, causal: bool, q_offset: int,
                    kv_offset: int):
    s = (q.float() @ k_blk.float().transpose(-1, -2)) * scale
    if causal:
        rows = q_offset + torch.arange(q.shape[-2], device=q.device)[:, None]
        cols = kv_offset + torch.arange(k_blk.shape[-2],
                                        device=q.device)[None, :]
        s = torch.where(rows >= cols, s, DEFAULT_MASK_VALUE)
    return s


def _scan_init(q):
    b, h, s_loc, d = q.shape
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, h, s_loc, 1), DEFAULT_MASK_VALUE,
                   dtype=torch.float32, device=q.device)
    return acc, m, torch.zeros_like(m)


def _scan_step(q, k_cur, v_cur, acc, m, l, scale: float, causal: bool,
               q_offset: int, kv_offset: int):
    """One chunk of the flash recurrence at its global offsets."""
    s = _partial_scores(q, k_cur, scale, causal, q_offset, kv_offset)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = alpha * l + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + (p.to(v_cur.dtype) @ v_cur).float()
    return acc, m_new, l


def _scan_out(acc, l, dtype):
    return (acc / torch.clamp_min(l, 1e-30)).to(dtype)


def _ring_attention_local(q, k, v, mesh, axis_name: str, causal: bool,
                          scale: Optional[float]):
    """The reference's scan body (``impl="xla"``): the flash recurrence
    (acc, m, l) over each rotated whole chunk at its global offset."""
    n, r = _line(mesh, axis_name)
    s_loc = q.shape[2]
    scale_ = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    acc, m, l = _scan_init(q)
    k_cur, v_cur = k, v
    for t in range(n):
        src = (r - t) % n
        acc, m, l = _scan_step(q, k_cur, v_cur, acc, m, l, scale_, causal,
                               r * s_loc, src * s_loc)
        if t + 1 < n:
            k_cur, v_cur = _rotate(k_cur, v_cur, mesh, axis_name, n)
    return _scan_out(acc, l, q.dtype)


def _ring_local_dispatch(q, k, v, mesh, axis_name: str, causal: bool,
                         scale: Optional[float], block_k: int, impl: str):
    if impl not in _IMPLS:
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if impl == "auto":
        impl = "pallas" if q.device.type == "cuda" else "xla"
    if impl == "xla":
        return _ring_attention_local(q, k, v, mesh, axis_name, causal, scale)
    # the kernels take contiguous chunks
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _ring_attention_local_kernel(q, k, v, mesh, axis_name, causal,
                                        scale, plain=impl == "pallas_interpret")


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = False, scale: Optional[float] = None,
                   block_k: int = 512, in_specs=None, impl: str = "auto"):
    """Sequence-parallel attention over ``axis_name``.

    q, k, v are DTensors [B, H, S, D] sharded on S over the axis (other
    dims may carry dp/tp sharding; ``in_specs`` names them, default
    ``P(None, None, axis_name, None)``): the result is a DTensor of the
    same layout.  Plain tensors are taken as this rank's chunks and give
    its rows of the output.  ``block_k`` is the reference's; the bodies
    here fold each whole chunk.
    """
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return _ring_local_dispatch(q, k, v, mesh, axis_name, causal, scale,
                                    block_k, impl)
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec

    spec = in_specs if in_specs is not None else \
        PartitionSpec(None, None, axis_name, None)
    pl = NamedSharding(mesh, spec).placements
    fn = local_map(
        lambda q_, k_, v_: _ring_local_dispatch(
            q_, k_, v_, mesh, axis_name, causal, scale, block_k, impl),
        out_placements=list(pl), in_placements=(pl, pl, pl), device_mesh=mesh,
        redistribute_inputs=True)
    return fn(q, k, v)


def ring_attention_sharded(q, k, v, axis_name: str = "sp",
                           causal: bool = False,
                           scale: Optional[float] = None,
                           block_k: int = 512, impl: str = "auto", *,
                           mesh=None):
    """The per-rank body alone, for use inside a rank-local region: q, k,
    v are this rank's chunks.  ``mesh`` defaults to the process's default
    mesh (the reference resolves the axis from the enclosing
    ``shard_map``)."""
    if mesh is None:
        from ray_tpu_torch.parallel.mesh import get_default_mesh

        mesh = get_default_mesh()
        if mesh is None:
            raise ValueError("ring_attention_sharded needs a mesh: pass "
                             "mesh= or install a default mesh")
    return _ring_local_dispatch(q, k, v, mesh, axis_name, causal, scale,
                                block_k, impl)
