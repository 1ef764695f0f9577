"""Core layer math: rmsnorm, layernorm, rope, MLPs.

Counterpart of ``ray_tpu/ops/layers.py``.  Statistics are taken in f32
and results cast back to the input dtype, as in the reference.  The
cross-entropy functions come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
