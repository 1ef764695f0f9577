"""Attention: flash attention forward and backward (Hopper kernels on
CUDA tensors, their plain PyTorch versions on CPU tensors), the blockwise
streaming softmax and the naive oracle.

Counterpart of ``ray_tpu/ops/attention.py``.  Layout everywhere is
[batch, heads, seq, head_dim].

  * ``mha_reference``          — O(S^2) naive, the correctness oracle.
  * ``blockwise_attention``    — streaming softmax over KV blocks, the
    reference's XLA path, kept for the tests.
  * ``flash_attention_plain``  — the forward kernel's plain version: the
    same online-softmax recurrence over 64-key blocks with the same
    rounding points (f32 scores and state, P rounded to v's dtype before
    P·V).
  * ``flash_attention_bwd_plain`` — the backward kernels' plain version
    (K2 dK/dV, K3 dQ): the same 64-row and 64-key steps and rounding
    points.
  * ``flash_attention`` / ``flash_attention_with_lse`` — differentiable
    (a ``torch.autograd.Function``, the counterpart of the reference's
    ``jax.custom_vjp``): the kernels on a CUDA tensor
    (``ops/_kernels.py``), the plain versions on a CPU one.
  * ``attention`` — the dispatcher the model calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# KV block of the plain versions; the kernels' tile width (BK in
# csrc/flash_fwd.cu and csrc/flash_bwd.cu), so both take the same steps
PLAIN_BLOCK_K = 64
# q block of the backward's plain version (BQ in csrc/flash_bwd.cu)
PLAIN_BLOCK_Q = 64


def mha_reference(q, k, v, causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S^2) attention; causal masks anchor bottom-right
    (``tril(k=sk-sq)``)."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    s = (q @ k.transpose(-1, -2)).float() * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return p.to(q.dtype) @ v


def blockwise_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None, block_k: int = 512,
                        q_offset: int = 0) -> torch.Tensor:
    """Streaming-softmax attention over KV blocks; ``q_offset`` is the
    global position of q's row 0 in the causal mask."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    block_k = min(block_k, sk)
    q32 = q.float()
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    acc = torch.zeros(*q.shape[:-1], d, dtype=torch.float32,
                      device=q.device)
    m = torch.full((*q.shape[:-1], 1), DEFAULT_MASK_VALUE,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for start in range(0, sk, block_k):
        k_blk = k[..., start:start + block_k, :]
        v_blk = v[..., start:start + block_k, :]
        s = (q32 @ k_blk.float().transpose(-1, -2)) * scale
        if causal:
            cols = start + torch.arange(k_blk.shape[-2],
                                        device=q.device)[None, :]
            s = torch.where(rows >= cols, s, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + (p.to(v.dtype) @ v_blk).float()
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_attention_plain(q, k, v, causal: bool = False,
                          scale: Optional[float] = None, q_offset: int = 0,
                          with_lse: bool = False):
    """Plain PyTorch version of the flash forward kernel.

    The kernel's recurrence over 64-key blocks: f32 scores
    ``(q·k)·scale``, ``DEFAULT_MASK_VALUE`` on masked and ragged
    entries, f32 running max / sum / accumulator, P rounded to v's
    dtype before P·V (products summed in f32), ``l`` clamped at 1e-30.
    Returns out (q's dtype), or (out, lse [B, H, Sq] f32)."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    q32 = q.float()
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    acc = torch.zeros(*q.shape[:-1], d, dtype=torch.float32,
                      device=q.device)
    m = torch.full((*q.shape[:-1], 1), DEFAULT_MASK_VALUE,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    # blocks wholly above every row's diagonal contribute exactly nothing
    # (p underflows to 0, alpha is 1); the kernel skips them, so may this
    kend = min(sk, q_offset + sq) if causal else sk
    for start in range(0, kend, PLAIN_BLOCK_K):
        k_blk = k[..., start:start + PLAIN_BLOCK_K, :]
        v_blk = v[..., start:start + PLAIN_BLOCK_K, :]
        s = (q32 @ k_blk.float().transpose(-1, -2)) * scale
        if causal:
            cols = start + torch.arange(k_blk.shape[-2],
                                        device=q.device)[None, :]
            s = torch.where(rows >= cols, s, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ v_blk.float()
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(lc))[..., 0]
    return out


def flash_bwd_di(o: torch.Tensor, do: torch.Tensor,
                 dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """di = rowsum(do * o) in f32, less the lse cotangent (the
    reference's ``_flash_backward``, without the 128-lane replication):
    [B, H, Sq] f32."""
    di = (do.float() * o.float()).sum(dim=-1)
    return di if dlse is None else di - dlse.float()


def _p_ds(q_blk, k_blk, v_blk, do_blk, lse_blk, di_blk, q0, k0, causal,
          scale, q_offset):
    """One (q tile, key tile) of the recomputation: f32 p (0 where
    masked) and ds = p·(dp − di)·scale rounded to q's dtype, as f32."""
    s = (q_blk.float() @ k_blk.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse_blk[..., None])
    if causal:
        rows = q_offset + q0 + torch.arange(q_blk.shape[-2],
                                            device=q_blk.device)[:, None]
        cols = k0 + torch.arange(k_blk.shape[-2],
                                 device=q_blk.device)[None, :]
        p = torch.where(rows >= cols, p, 0.0)
    dp = do_blk.float() @ v_blk.float().transpose(-1, -2)
    ds = (p * (dp - di_blk[..., None]) * scale).to(q_blk.dtype).float()
    return p, ds


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal: bool,
                                  scale: float, q_offset: int = 0):
    """Plain version of K2: (dk, dv) like k.  For each 64-key tile, f32
    sums over the 64-row q tiles that reach it, from the first one the
    causal mask lets through, in the kernel's order."""
    sq, sk = q.shape[-2], k.shape[-2]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for k0 in range(0, sk, PLAIN_BLOCK_K):
        kb = slice(k0, k0 + PLAIN_BLOCK_K)
        qstart = ((max(0, k0 - q_offset) // PLAIN_BLOCK_Q) * PLAIN_BLOCK_Q
                  if causal else 0)
        for q0 in range(qstart, sq, PLAIN_BLOCK_Q):
            qb = slice(q0, q0 + PLAIN_BLOCK_Q)
            p, ds = _p_ds(q[..., qb, :], k[..., kb, :], v[..., kb, :],
                          do[..., qb, :], lse[..., qb], di[..., qb], q0, k0,
                          causal, scale, q_offset)
            dv[..., kb, :] += (p.to(do.dtype).float().transpose(-1, -2)
                               @ do[..., qb, :].float())
            dk[..., kb, :] += ds.transpose(-1, -2) @ q[..., qb, :].float()
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal: bool,
                                 scale: float, q_offset: int = 0):
    """Plain version of K3: dq like q.  For each 64-row q tile, f32 sums
    over the 64-key tiles up to the causal diagonal, in the kernel's
    order."""
    sq, sk = q.shape[-2], k.shape[-2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, PLAIN_BLOCK_Q):
        qb = slice(q0, q0 + PLAIN_BLOCK_Q)
        kend = min(sk, q_offset + q0 + PLAIN_BLOCK_Q) if causal else sk
        for k0 in range(0, kend, PLAIN_BLOCK_K):
            kb = slice(k0, k0 + PLAIN_BLOCK_K)
            _, ds = _p_ds(q[..., qb, :], k[..., kb, :], v[..., kb, :],
                          do[..., qb, :], lse[..., qb], di[..., qb], q0, k0,
                          causal, scale, q_offset)
            dq[..., qb, :] += ds @ k[..., kb, :].float()
    return dq.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, dlse=None,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              q_offset: int = 0):
    """Plain PyTorch version of the backward kernels K2 and K3, from the
    forward's residuals (q, k, v, o, lse [B, H, Sq] f32) and the
    cotangents of out (``do``) and of lse (``dlse``, or None).

    The kernels' recurrence: p = exp((q·k)·scale − lse) in f32, 0 where
    masked; p rounded to do's dtype before pᵀ·do; ds = p·(dp − di)·scale
    rounded to q's dtype before dsᵀ·q and ds·k; f32 sums over 64-row and
    64-key tiles.  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    di = flash_bwd_di(o, do, dlse)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal,
                                           scale, q_offset)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal, scale,
                                      q_offset)
    return dq, dk, dv


def _check_offset(sq: int, sk: int, causal: bool, q_offset: int) -> None:
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if causal and sq != sk and q_offset == 0:
        raise ValueError(
            f"causal flash attention with sq ({sq}) != sk ({sk}) needs an "
            f"explicit query anchor: pass q_offset=sk-sq ({sk - sq}) for "
            f"bottom-right (decode) alignment, or pad q to sk.")


def _forward(q, k, v, causal, scale, q_offset, with_lse):
    """(out, lse or None): the forward kernel for CUDA tensors, its plain
    version for CPU tensors."""
    if q.device.type == "cuda":
        from ray_tpu_torch.ops import _kernels

        return _kernels.flash_fwd(q, k, v, causal=causal, scale=scale,
                                  q_offset=q_offset, with_lse=with_lse)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    if with_lse:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, with_lse=True)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 q_offset=q_offset), None


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward: the counterpart of the
    reference's ``jax.custom_vjp`` pair.  Saves (q, k, v, o, lse), never
    P; the backward recomputes it tile by tile in K2 and K3.  Outputs
    (out, lse), both differentiable: lse's cotangent folds into di."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        out, lse = _forward(q, k, v, causal, scale, q_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.q_offset = causal, scale, q_offset
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        # the grad of o arrives through transpose(1, 2).reshape
        do = torch.zeros_like(o) if do is None else do.contiguous()
        if q.device.type == "cuda":
            from ray_tpu_torch.ops import _kernels

            dq, dk, dv = _kernels.flash_bwd(
                q, k, v, do, lse, flash_bwd_di(o, do, dlse),
                causal=ctx.causal, scale=ctx.scale, q_offset=ctx.q_offset)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, o, lse, do, dlse, causal=ctx.causal,
                scale=ctx.scale, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def _flash(q, k, v, causal, scale, q_offset, with_lse):
    _check_offset(q.shape[-2], k.shape[-2], causal, q_offset)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal, scale, q_offset)
    else:   # nothing to differentiate: no graph, and lse only on request
        out, lse = _forward(q, k, v, causal, scale, q_offset, with_lse)
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention, differentiable: the Hopper kernels (K1 forward,
    K2/K3 backward) for CUDA tensors, their plain versions for CPU
    tensors.  ``q_offset`` is the global position of q's row 0 in the
    causal mask (sk - sq anchors bottom-right)."""
    return _flash(q, k, v, causal, scale, q_offset, False)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) variant: lse is [B, H, Sq] f32 logsumexp of the scaled
    scores.  Differentiable in both outputs: lse's cotangent folds into
    the same backward kernels (di -= dlse)."""
    return _flash(q, k, v, causal, scale, q_offset, True)


def attention(q, k, v, causal: bool = False,
              scale: Optional[float] = None) -> torch.Tensor:
    """The model's attention: flash attention with the bottom-right
    causal anchor for rectangular inputs (sk >= sq).  Causal sq > sk has
    no anchor here and raises."""
    sq, sk = q.shape[-2], k.shape[-2]
    if causal and sq > sk:
        raise ValueError(
            f"causal attention with sq ({sq}) > sk ({sk}) is not supported")
    qoff = (sk - sq) if causal else 0
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           q_offset=qoff)
