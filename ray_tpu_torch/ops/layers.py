"""Core layer math: rmsnorm, layernorm, rope, MLPs, cross-entropy.

Counterpart of ``ray_tpu/ops/layers.py``.  Statistics are taken in f32
and results cast back to the input dtype, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics and the POPULATION variance
    (``jnp.var``'s default; ``torch.var`` defaults to unbiased)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rope_table(seq_len: int, head_dim: int, base: float = 10000.0,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precomputed cos/sin tables [seq, head_dim/2]."""
    half = head_dim // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freqs)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split-half rotary embedding for [B, H, S, D] with tables
    [S_max, D/2]; ``positions`` [S] overrides arange(S)."""
    s = x.shape[2]
    if positions is None:
        c, sn = cos[:s][None, None], sin[:s][None, None]
    else:
        c, sn = cos[positions][None, None], sin[positions][None, None]
    x1, x2 = x.chunk(2, dim=-1)
    y1 = x1 * c - x2 * sn
    y2 = x2 * c + x1 * sn
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x@Wg) * (x@Wu) @ Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """GELU MLP with the tanh approximation (``jax.nn.gelu``'s default;
    torch's default is the exact erf form)."""
    h = x @ w_in + b_in
    return F.gelu(h, approximate="tanh") @ w_out + b_out


def fused_softmax_cross_entropy(x: torch.Tensor, unembed: torch.Tensor,
                                labels: torch.Tensor, z_loss: float = 0.0,
                                chunk: int = 128) -> torch.Tensor:
    """Vocab-projected CE without materialising [B, S, V] logits: one
    sequence chunk at a time, each under activation checkpointing (the
    reference's ``jax.checkpoint`` inside a scan), so the peak is
    [B, chunk, V] and the backward recomputes a chunk's logits.  The same
    numbers as the dense path: the projection in x's dtype, the
    logsumexp in f32.

    x [B, S, D], unembed [D, V], labels [B, S] int; S % chunk == 0
    (else ValueError).
    Returns the per-token loss [B, S] f32."""
    S = x.shape[1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {chunk}")

    def chunk_loss(xc, lc):
        return softmax_cross_entropy(xc @ unembed, lc, z_loss=z_loss)

    return torch.cat([
        checkpoint(chunk_loss, x[:, i:i + chunk], labels[:, i:i + chunk],
                   use_reentrant=False, preserve_rng_state=False)
        for i in range(0, S, chunk)], dim=1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Token-level CE in f32 with the optional z-loss (z_loss * lse^2,
    which keeps large-vocab logits from drifting); logits [..., V],
    labels [...] int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss
