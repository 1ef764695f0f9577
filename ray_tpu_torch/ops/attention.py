"""Attention: the flash-attention forward (Hopper kernel on CUDA tensors,
its plain PyTorch version on CPU tensors), the blockwise streaming
softmax and the naive oracle.

Counterpart of ``ray_tpu/ops/attention.py``.  Layout everywhere is
[batch, heads, seq, head_dim].  The forward only: the backward kernels
come with the training slice.

  * ``mha_reference``          — O(S^2) naive, the correctness oracle.
  * ``blockwise_attention``    — streaming softmax over KV blocks, the
    reference's XLA path, kept for the tests.
  * ``flash_attention_plain``  — the kernel's plain version: the same
    online-softmax recurrence over 64-key blocks with the same rounding
    points (f32 scores and state, P rounded to v's dtype before P·V).
  * ``flash_attention`` / ``flash_attention_with_lse`` — the kernel on a
    CUDA tensor (``ops/_kernels.py``), the plain version on a CPU one.
  * ``attention`` — the dispatcher the model calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# KV block of the plain version; the kernel's tile width (BK in
# csrc/flash_fwd.cu), so both take the same online-softmax steps
PLAIN_BLOCK_K = 64


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


def _check_offset(sq: int, sk: int, causal: bool, q_offset: int) -> None:
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if causal and sq != sk and q_offset == 0:
        raise ValueError(
            f"causal flash attention with sq ({sq}) != sk ({sk}) needs an "
            f"explicit query anchor: pass q_offset=sk-sq ({sk - sq}) for "
            f"bottom-right (decode) alignment, or pad q to sk.")


def _flash(q, k, v, causal, scale, q_offset, with_lse):
    _check_offset(q.shape[-2], k.shape[-2], causal, q_offset)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cuda":
        from ray_tpu_torch.ops import _kernels

        out, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=scale,
                                      q_offset=q_offset, with_lse=with_lse)
        return (out, lse) if with_lse else out
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 q_offset=q_offset, with_lse=with_lse)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention forward: the Hopper kernel for CUDA tensors, the
    plain version for CPU tensors.  ``q_offset`` is the global position
    of q's row 0 in the causal mask (sk - sq anchors bottom-right)."""
    return _flash(q, k, v, causal, scale, q_offset, False)


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) variant: lse is [B, H, Sq] f32 logsumexp of the scaled
    scores."""
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
