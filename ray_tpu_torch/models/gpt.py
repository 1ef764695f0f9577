"""GPT-class transformer LM: forward, loss, KV-cache decode, slot and
paged caches.  Counterpart of ``ray_tpu/models/gpt.py``.

Params are a plain dict of tensors with the reference's keys and shapes
(layers stacked on a leading axis), stored in ``param_dtype`` and cast to
``cfg.dtype`` at use, so ``models/convert.py`` carries a JAX tree over key
for key.  ``lax.scan`` over the stack becomes a Python layer loop.

Attention in the forward goes through ``ops.attention`` — the Hopper
flash kernels on CUDA tensors, differentiable through the backward
kernels.  With ``cfg.remat`` each block runs under activation
checkpointing when gradients are recorded (``jax.checkpoint`` in the
reference's layer scan), so the backward recomputes the block's forward.
Decode attention is plain tensor math, as in the reference
(``_slot_attention``).

Where the reference returns an updated KV array, this port writes the
cache tensors IN PLACE and returns the same dict (no copy of the arena
per step); callers that need the old contents must clone first.

Meshes (dp/fsdp/tp/sp/pp) are not ported: passing ``mesh`` raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.ops import (apply_rope, attention,
                               fused_softmax_cross_entropy, gelu_mlp,
                               layer_norm, rms_norm, rope_table,
                               softmax_cross_entropy, swiglu)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_head: int = 64
    d_ff: int = 3072
    max_seq: int = 1024
    norm: str = "ln"          # "ln" | "rms"
    act: str = "gelu"         # "gelu" | "swiglu"
    pos: str = "learned"      # "learned" | "rope"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # training: recompute each block in the backward ("full"; the
    # reference's "dots" policy is not ported), CE over sequence chunks
    # of loss_chunk (None: dense), z-loss weight
    remat: bool = True
    remat_policy: str = "full"
    loss_chunk: Optional[int] = None
    z_loss: float = 1e-4
    # q/k/v/o projection biases (real GPT-2 checkpoints have them)
    attn_bias: bool = False
    tie_embeddings: bool = True

    @classmethod
    def gpt2_small(cls, **kw):
        return cls(n_layers=12, d_model=768, n_heads=12, d_head=64,
                   d_ff=3072, **kw)

    @classmethod
    def gpt2_medium(cls, **kw):
        return cls(n_layers=24, d_model=1024, n_heads=16, d_head=64,
                   d_ff=4096, **kw)

    @classmethod
    def gpt2_large(cls, **kw):
        return cls(n_layers=36, d_model=1280, n_heads=20, d_head=64,
                   d_ff=5120, **kw)

    @classmethod
    def gpt2_xl(cls, **kw):
        return cls(n_layers=48, d_model=1600, n_heads=25, d_head=64,
                   d_ff=6400, **kw)

    @classmethod
    def nano(cls, **kw):
        """Tiny config for tests."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq", 128)
        return cls(n_layers=4, d_model=64, n_heads=4, d_head=16, d_ff=128,
                   **kw)


def param_shapes(cfg: GPTConfig) -> Dict[str, Any]:
    """The param tree's shapes, key for key with the reference's init."""
    L, D, H, dh, F_, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.d_head, cfg.d_ff, cfg.vocab_size)
    lp = {"attn_norm": (L, D), "wq": (L, D, H, dh), "wk": (L, D, H, dh),
          "wv": (L, D, H, dh), "wo": (L, H, dh, D), "mlp_norm": (L, D),
          "mlp_out": (L, F_, D)}
    if cfg.act == "swiglu":
        lp.update(mlp_gate=(L, D, F_), mlp_up=(L, D, F_))
    else:
        lp.update(mlp_in=(L, D, F_), mlp_in_b=(L, F_), mlp_out_b=(L, D))
    if cfg.norm == "ln":
        lp.update(attn_norm_b=(L, D), mlp_norm_b=(L, D))
    if cfg.attn_bias:
        lp.update(wq_b=(L, H, dh), wk_b=(L, H, dh), wv_b=(L, H, dh),
                  wo_b=(L, D))
    out: Dict[str, Any] = {"embed": (V, D), "layers": lp,
                           "final_norm": (D,)}
    if cfg.norm == "ln":
        out["final_norm_b"] = (D,)
    if cfg.pos == "learned":
        out["pos_embed"] = (cfg.max_seq, D)
    if not cfg.tie_embeddings:
        out["unembed"] = (D, V)
    return out


def init(cfg: GPTConfig, *, seed: int = 0,
         generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Params:
    """Random params on ``device``, drawn from ``generator`` (default: a
    generator on that device seeded with ``seed``).  The recipe is the
    reference's: unit norms, zero biases, N(0, 1/fan_in) projections with
    the 1/sqrt(2L) residual-branch scale, embed 0.02, positions 0.01."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    L, D, H, dh, F_ = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head,
                       cfg.d_ff)
    pd = cfg.param_dtype

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=pd,
                           device=dev) * std

    fan_in = {"wq": D, "wk": D, "wv": D, "wo": H * dh, "mlp_out": F_,
              "mlp_gate": D, "mlp_up": D, "mlp_in": D}
    resid = {"wo", "mlp_out"}
    shapes = param_shapes(cfg)
    lp = {}
    for name, shape in shapes["layers"].items():
        if name in fan_in:
            std = 1.0 / math.sqrt(fan_in[name])
            if name in resid:
                std /= math.sqrt(2 * L)
            lp[name] = normal(shape, std)
        elif name.endswith("_norm"):
            lp[name] = torch.ones(shape, dtype=pd, device=dev)
        else:
            lp[name] = torch.zeros(shape, dtype=pd, device=dev)
    params: Params = {"embed": normal(shapes["embed"], 0.02), "layers": lp,
                      "final_norm": torch.ones(D, dtype=pd, device=dev)}
    if cfg.norm == "ln":
        params["final_norm_b"] = torch.zeros(D, dtype=pd, device=dev)
    if cfg.pos == "learned":
        params["pos_embed"] = normal(shapes["pos_embed"], 0.01)
    if not cfg.tie_embeddings:
        params["unembed"] = normal(shapes["unembed"], 1.0 / math.sqrt(D))
    return params


def num_params(cfg: GPTConfig) -> int:
    shapes = param_shapes(cfg)
    leaves = [s for k, s in shapes.items() if k != "layers"]
    leaves += list(shapes["layers"].values())
    return sum(math.prod(s) for s in leaves)


def _layer(params: Params, l: int) -> Params:
    return {k: w[l] for k, w in params["layers"].items()}


def _norm(x, w, b, kind):
    if kind == "rms":
        return rms_norm(x, w)
    return layer_norm(x, w, b)


def _qkv_proj(x, layer, cfg: GPTConfig, rope, positions=None):
    """Pre-norm + QKV projection + rope: x [B, S, D] -> q, k, v
    [B, H, S, dh] — the one recipe shared by the forward and the decode
    paths (decode==forward parity rests on it)."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.d_head
    h = _norm(x, layer["attn_norm"], layer.get("attn_norm_b"), cfg.norm)
    h = h.to(cfg.dtype)

    def proj(name):
        y = h @ layer[name].to(cfg.dtype).reshape(D, H * dh)
        y = y.view(B, S, H, dh).transpose(1, 2)
        if cfg.attn_bias:
            y = y + layer[name + "_b"].to(cfg.dtype)[None, :, None]
        return y

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    if rope is not None:
        q = apply_rope(q, *rope, positions=positions)
        k = apply_rope(k, *rope, positions=positions)
    return q, k, v


def _attn_out_and_mlp(x, o, layer, cfg: GPTConfig):
    """Output projection + residual + MLP sublayer (shared, see
    _qkv_proj).  o [B, H, S, dh], x [B, S, D]."""
    B, H, S, dh = o.shape
    D = cfg.d_model
    att = (o.transpose(1, 2).reshape(B, S, H * dh)
           @ layer["wo"].to(cfg.dtype).reshape(H * dh, D))
    if cfg.attn_bias:
        att = att + layer["wo_b"].to(cfg.dtype)
    x = x + att
    h2 = _norm(x, layer["mlp_norm"], layer.get("mlp_norm_b"), cfg.norm)
    h2 = h2.to(cfg.dtype)
    if cfg.act == "swiglu":
        m = swiglu(h2, layer["mlp_gate"].to(cfg.dtype),
                   layer["mlp_up"].to(cfg.dtype),
                   layer["mlp_out"].to(cfg.dtype))
    else:
        m = gelu_mlp(h2, layer["mlp_in"].to(cfg.dtype),
                     layer["mlp_in_b"].to(cfg.dtype),
                     layer["mlp_out"].to(cfg.dtype),
                     layer["mlp_out_b"].to(cfg.dtype))
    return x + m


def _attention_op(q, k, v):
    # the flash kernel takes contiguous [B, H, S, dh]
    return attention(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=True)


def _block(x, params: Params, l: int, cfg: GPTConfig, rope):
    """One transformer block (attention + MLP sublayers) of layer l."""
    layer = _layer(params, l)
    q, k, v = _qkv_proj(x, layer, cfg, rope)
    return _attn_out_and_mlp(x, _attention_op(q, k, v), layer, cfg)


def _check_remat(cfg: GPTConfig) -> None:
    if not cfg.remat or cfg.remat_policy == "full":
        return
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            'remat_policy="dots" (save the matmul outputs, recompute the '
            'rest) is not ported; use remat_policy="full" or remat=False')
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def apply_hidden(params: Params, tokens, cfg: GPTConfig, *,
                 device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """Transformer stack up to the final norm: tokens [B, S] ->
    hidden [B, S, D]."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported; run on one device")
    _check_remat(cfg)
    dev = resolve_device(device)
    check_params_on(params, dev)
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:S][None].to(cfg.dtype)
        rope = None
    else:
        rope = rope_table(S, cfg.d_head, device=dev)
    # with nothing recorded for a backward there is nothing to recompute
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        if remat:
            # the model draws no random numbers: no RNG state to replay
            x = checkpoint(_block, x, params, l, cfg, rope,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(x, params, l, cfg, rope)
    return _norm(x, params["final_norm"], params.get("final_norm_b"),
                 cfg.norm)


def _unembed_table(params: Params, cfg: GPTConfig) -> torch.Tensor:
    return (params["embed"].T if cfg.tie_embeddings
            else params["unembed"]).to(cfg.dtype)


def apply(params: Params, tokens, cfg: GPTConfig, *,
          device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """Forward pass: tokens [B, S] -> logits [B, S, V] in cfg.dtype."""
    x = apply_hidden(params, tokens, cfg, device=device, mesh=mesh)
    return x.to(cfg.dtype) @ _unembed_table(params, cfg)


def loss_fn(params: Params, batch: Dict[str, Any], cfg: GPTConfig, *,
            device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """Next-token LM loss, a scalar f32 tensor.  batch: {"tokens":
    [B, S+1]} or {"inputs", "targets": [B, S]}, and an optional "mask"
    [B, S] that weights the per-token losses.  The fused chunked CE
    (``cfg.loss_chunk``) runs when the chunk divides S, the dense CE
    otherwise; both add ``cfg.z_loss``."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported; run on one device")
    dev = resolve_device(device)
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        toks = torch.as_tensor(batch["tokens"], device=dev)
        inputs, targets = toks[:, :-1], toks[:, 1:]
    targets = torch.as_tensor(targets, dtype=torch.long, device=dev)
    chunk = cfg.loss_chunk
    if chunk and targets.shape[1] % chunk == 0:
        x = apply_hidden(params, inputs, cfg, device=dev)
        loss = fused_softmax_cross_entropy(
            x.to(cfg.dtype), _unembed_table(params, cfg), targets,
            z_loss=cfg.z_loss, chunk=chunk)
    else:
        logits = apply(params, inputs, cfg, device=dev)
        loss = softmax_cross_entropy(logits, targets, z_loss=cfg.z_loss)
    if "mask" in batch:
        mask = torch.as_tensor(batch["mask"], device=dev).float()
        return (loss * mask).sum() / mask.sum().clamp_min(1.0)
    return loss.mean()


# ---------------------------------------------------------------------------
# KV-cache decoding (lockstep batch, scalar write position)


def init_cache(cfg: GPTConfig, batch: int, max_seq: Optional[int] = None,
               *, device: DeviceLike = None) -> Dict[str, Any]:
    """Empty KV cache: [L, B, H, max_seq, d_head] per side + the write
    position (a host int)."""
    dev = resolve_device(device)
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, cfg.n_heads, S, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": 0}


def _decode_hidden(params: Params, cache, tokens, cfg: GPTConfig,
                   rope=None):
    """One decode position through the stack: tokens [B] at position
    cache['pos'] -> (final-norm hidden [B, D], cache with pos+1).  Writes
    the new K/V into the cache in place."""
    S = cache["k"].shape[3]
    pos = int(cache["pos"])
    dev = cache["k"].device
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][pos][None].to(cfg.dtype)
        rope = None
    elif rope is None:
        rope = rope_table(S, cfg.d_head, device=dev)
    x = x[:, None]
    mask = torch.arange(S, device=dev) <= pos
    positions = torch.tensor([pos], device=dev)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        kc, vc = cache["k"][l], cache["v"][l]
        q, k, v = _qkv_proj(x, layer, cfg, rope, positions=positions)
        kc[:, :, pos] = k[:, :, 0]
        vc[:, :, pos] = v[:, :, 0]
        s = (q.float() @ kc.float().transpose(-1, -2)) * (cfg.d_head ** -0.5)
        p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        x = _attn_out_and_mlp(x, p.to(cfg.dtype) @ vc, layer, cfg)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg.norm)
    return x[:, 0], {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def decode_step(params: Params, cache, tokens, cfg: GPTConfig, rope=None):
    """One decode position: tokens [B] -> (logits [B, V], cache)."""
    x, cache = _decode_hidden(params, cache, tokens, cfg, rope)
    return x.to(cfg.dtype) @ _unembed_table(params, cfg), cache


def _decode_fast_eligible(cfg: GPTConfig) -> bool:
    # the fast path hand-writes the GPT-2-family recipe
    return cfg.norm == "ln" and cfg.act == "gelu" and cfg.pos == "learned"


def _decode_view(params: Params, cfg: GPTConfig) -> Params:
    """Decode view of the params: compute-dtype weights (cast once, not
    per step) and q/k/v fused into one [D, 3*H*dh] matrix per layer."""
    L, D, H, dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head
    lp = params["layers"]
    dt = cfg.dtype

    def f(w):
        return w.to(dt)

    view = {
        "embed": f(params["embed"]),
        "pos_embed": f(params["pos_embed"]),
        "wqkv": torch.cat([f(lp["wq"]).reshape(L, D, H * dh),
                           f(lp["wk"]).reshape(L, D, H * dh),
                           f(lp["wv"]).reshape(L, D, H * dh)], -1),
        "wo": f(lp["wo"]).reshape(L, H * dh, D),
        "attn_norm": lp["attn_norm"], "attn_norm_b": lp["attn_norm_b"],
        "mlp_norm": lp["mlp_norm"], "mlp_norm_b": lp["mlp_norm_b"],
        "mlp_in": f(lp["mlp_in"]), "mlp_in_b": f(lp["mlp_in_b"]),
        "mlp_out": f(lp["mlp_out"]), "mlp_out_b": f(lp["mlp_out_b"]),
        "final_norm": params["final_norm"],
        "final_norm_b": params["final_norm_b"],
    }
    if cfg.attn_bias:
        view["bqkv"] = torch.cat([f(lp["wq_b"]).reshape(L, H * dh),
                                  f(lp["wk_b"]).reshape(L, H * dh),
                                  f(lp["wv_b"]).reshape(L, H * dh)], -1)
        view["wo_b"] = f(lp["wo_b"])
    view["unembed"] = (view["embed"].T if cfg.tie_embeddings
                       else f(params["unembed"]))
    return view


def _decode_hidden_fast(view: Params, cfg: GPTConfig, kcache, vcache,
                        pos: int, toks) -> torch.Tensor:
    """One decode position on the view: toks [B] -> final-norm hidden
    [B, D] in cfg.dtype; writes K/V at ``pos`` in place.  Cache layout
    [L, B, H, S, dh]."""
    B = toks.shape[0]
    H, dh = cfg.n_heads, cfg.d_head
    S = kcache.shape[3]
    dt = cfg.dtype
    x = view["embed"][toks] + view["pos_embed"][pos][None]
    mask = torch.arange(S, device=kcache.device) <= pos
    for l in range(cfg.n_layers):
        h = layer_norm(x, view["attn_norm"][l],
                       view["attn_norm_b"][l]).to(dt)
        qkv = h @ view["wqkv"][l]
        if cfg.attn_bias:
            qkv = qkv + view["bqkv"][l]
        q, k, v = qkv.split(H * dh, dim=-1)
        kcache[l, :, :, pos] = k.reshape(B, H, dh).to(kcache.dtype)
        vcache[l, :, :, pos] = v.reshape(B, H, dh).to(vcache.dtype)
        q = q.reshape(B, H, 1, dh)
        s = (q.float() @ kcache[l].float().transpose(-1, -2))[:, :, 0]
        s = torch.where(mask, s * (dh ** -0.5), -1e30)
        p = torch.softmax(s, dim=-1)
        o = (p.to(dt)[:, :, None] @ vcache[l].to(dt))[:, :, 0]
        att = o.reshape(B, H * dh) @ view["wo"][l]
        if cfg.attn_bias:
            att = att + view["wo_b"][l]
        x = x + att
        h2 = layer_norm(x, view["mlp_norm"][l],
                        view["mlp_norm_b"][l]).to(dt)
        m = F.gelu(h2 @ view["mlp_in"][l] + view["mlp_in_b"][l],
                   approximate="tanh")
        x = x + (m @ view["mlp_out"][l] + view["mlp_out_b"][l])
    x = layer_norm(x, view["final_norm"], view["final_norm_b"])
    return x.to(dt)


# ---------------------------------------------------------------------------
# Slot-batch decoding (continuous batching): every slot at its own
# position.  The contiguous slot cache [L, B, H, S, dh] and the paged
# arena [L, P, H, ps, dh] (page 0 the reserved null page) feed the one
# attention recipe _slot_attention, which is what makes paged ==
# contiguous an identity rather than a numerical accident.


def _slot_rope(x, cos, sin, positions):
    """Per-slot rotary embedding: x [B, H, 1, dh], positions [B]."""
    c = cos[positions][:, None, None]
    sn = sin[positions][:, None, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn],
                     dim=-1).to(x.dtype)


def _slot_embed(params: Params, tokens, pos, cfg: GPTConfig):
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][pos].to(cfg.dtype)
    return x[:, None]


def _slot_qkv(x, layer, cfg: GPTConfig, rope, pos):
    q, k, v = _qkv_proj(x, layer, cfg, rope=None)
    if rope is not None:
        q = _slot_rope(q, *rope, positions=pos)
        k = _slot_rope(k, *rope, positions=pos)
    return q, k, v


def _slot_attention(q, kc, vc, pos, cfg: GPTConfig):
    """q [B, H, 1, dh] against a per-slot cache view kc/vc [B, H, S, dh]
    with per-slot causal masks (<= pos[b]): scores in f32, -1e30 on
    masked entries, P·V in cfg.dtype."""
    S = kc.shape[2]
    mask = (torch.arange(S, device=kc.device)[None, None, None, :]
            <= pos[:, None, None, None])
    s = (q.float() @ kc.float().transpose(-1, -2)) * (cfg.d_head ** -0.5)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return p.to(cfg.dtype) @ vc.to(cfg.dtype)


def init_slot_cache(cfg: GPTConfig, slots: int, max_total: int, *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Contiguous slot cache: [L, slots, H, max_total, d_head] per side;
    positions live with the engine, per slot."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, cfg.n_heads, max_total, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _rope_for(cfg: GPTConfig, S: int, rope, dev):
    if cfg.pos == "learned":
        return None
    return rope if rope is not None else rope_table(S, cfg.d_head,
                                                    device=dev)


def _slot_decode_hidden(params: Params, kcache, vcache, tokens, pos,
                        cfg: GPTConfig, rope=None) -> torch.Tensor:
    """One decode position for every slot: tokens [B] at positions
    pos [B] -> hidden [B, D]; K/V written in place into kcache/vcache
    [L, B, H, S, dh]."""
    B = tokens.shape[0]
    rope = _rope_for(cfg, kcache.shape[3], rope, kcache.device)
    x = _slot_embed(params, tokens, pos, cfg)
    bidx = torch.arange(B, device=kcache.device)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        kc, vc = kcache[l], vcache[l]
        q, k, v = _slot_qkv(x, layer, cfg, rope, pos)
        kc[bidx, :, pos, :] = k[:, :, 0, :].to(kc.dtype)
        vc[bidx, :, pos, :] = v[:, :, 0, :].to(vc.dtype)
        x = _attn_out_and_mlp(x, _slot_attention(q, kc, vc, pos, cfg),
                              layer, cfg)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg.norm)
    return x[:, 0]


def slot_decode_step(params: Params, cache, tokens, pos, cfg: GPTConfig,
                     rope=None):
    """Slot-batch decode on the contiguous cache: tokens [B] at per-slot
    positions pos [B] -> (logits [B, V], cache updated in place)."""
    x = _slot_decode_hidden(params, cache["k"], cache["v"], tokens, pos,
                            cfg, rope)
    return x.to(cfg.dtype) @ _unembed_table(params, cfg), cache


def slot_prefill(params: Params, cache, toks, start: int, slot: int,
                 cfg: GPTConfig, rope=None):
    """Prefill one slot: toks [T] (the prompt suffix, unpadded) at
    positions ``start .. start+T-1``; logits of the last token.  Returns
    (logits [V], cache updated in place).

    The reference pads toks to a bucket (one static program per bucket)
    and takes the logits at a ``last_idx``; eager decode steps need no
    static length, so here toks holds only the real tokens."""
    S = cache["k"].shape[3]
    dev = cache["k"].device
    kc = cache["k"][:, slot:slot + 1]       # views: writes land in cache
    vc = cache["v"][:, slot:slot + 1]
    positions = start + torch.arange(toks.shape[0], device=dev)
    rope = _rope_for(cfg, S, rope, dev)
    for t in range(toks.shape[0]):
        x = _slot_decode_hidden(params, kc, vc, toks[t:t + 1],
                                positions[t:t + 1], cfg, rope)
    return x[0].to(cfg.dtype) @ _unembed_table(params, cfg), cache


def init_paged_cache(cfg: GPTConfig, num_pages: int, page_size: int, *,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Paged KV arena: [L, num_pages, H, page_size, d_head] per side.
    Page 0 is the reserved null page."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_pages, cfg.n_heads, page_size, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _paged_decode_hidden(params: Params, kpages, vpages, tokens, ptab, pos,
                         cfg: GPTConfig, rope=None) -> torch.Tensor:
    """One decode position for every slot against the page arena:
    tokens [B], ptab [B, max_pages] (page ids in sequence order, unused
    entries 0), pos [B] -> hidden [B, D].  K/V scatter in place into each
    slot's current page; attention gathers the slot's pages into the
    contiguous [B, H, S, dh] view of _slot_attention.

    Inactive slots all write to null page 0 at offset 0: with repeated
    indices the winning write is unspecified, which is harmless only
    because page 0 is never attended by a live sequence."""
    B = tokens.shape[0]
    H, dh = cfg.n_heads, cfg.d_head
    ps = kpages.shape[3]
    S = ptab.shape[1] * ps
    pos = pos.clamp(max=S - 1)
    rope = _rope_for(cfg, S, rope, kpages.device)
    x = _slot_embed(params, tokens, pos, cfg)
    pidx = ptab.gather(1, (pos // ps)[:, None])[:, 0]
    poff = pos % ps

    def gather(pages):
        g = pages[ptab]                         # [B, maxp, H, ps, dh]
        return g.permute(0, 2, 1, 3, 4).reshape(B, H, S, dh)

    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        kc, vc = kpages[l], vpages[l]
        q, k, v = _slot_qkv(x, layer, cfg, rope, pos)
        kc[pidx, :, poff, :] = k[:, :, 0, :].to(kc.dtype)
        vc[pidx, :, poff, :] = v[:, :, 0, :].to(vc.dtype)
        o = _slot_attention(q, gather(kc), gather(vc), pos, cfg)
        x = _attn_out_and_mlp(x, o, layer, cfg)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), cfg.norm)
    return x[:, 0]


def paged_decode_step(params: Params, cache, tokens, ptab, pos,
                      cfg: GPTConfig, rope=None):
    """Slot-batch decode on the paged cache -> (logits [B, V], cache
    updated in place)."""
    x = _paged_decode_hidden(params, cache["k"], cache["v"], tokens, ptab,
                             pos, cfg, rope)
    return x.to(cfg.dtype) @ _unembed_table(params, cfg), cache


def paged_prefill(params: Params, cache, toks, ptab_row, start: int,
                  cfg: GPTConfig, rope=None):
    """Prefill one slot's pages: toks [T] (unpadded, as in slot_prefill)
    from position ``start`` (earlier positions are prefix-shared pages
    already holding valid K/V); logits of the last token.  Returns
    (logits [V], cache updated in place)."""
    ps = cache["k"].shape[3]
    dev = cache["k"].device
    S = ptab_row.shape[0] * ps
    positions = start + torch.arange(toks.shape[0], device=dev)
    rope = _rope_for(cfg, S, rope, dev)
    for t in range(toks.shape[0]):
        x = _paged_decode_hidden(params, cache["k"], cache["v"],
                                 toks[t:t + 1], ptab_row[None],
                                 positions[t:t + 1], cfg, rope)
    return x[0].to(cfg.dtype) @ _unembed_table(params, cfg), cache


def copy_page(cache, dst: int, src: int):
    """Copy-on-write: duplicate page ``src`` into ``dst`` across all
    layers, both sides, in place."""
    cache["k"][:, dst] = cache["k"][:, src]
    cache["v"][:, dst] = cache["v"][:, src]
    return cache


# ---------------------------------------------------------------------------
# sampling


def token_key(seed: int, index: int) -> int:
    """Sampling key of a request's ``index``-th generated token: a pure
    function of (seed, index), so a resumed continuation that skips
    ``key_offset`` tokens draws exactly the uninterrupted run's noise.
    (jax.random keys cannot be matched bit for bit; seeded sampling is
    held port against port.)"""
    ss = np.random.SeedSequence([seed % (1 << 64), index])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def _gumbel(key: int, rows: int, vocab: int) -> torch.Tensor:
    """[rows, vocab] f32 Gumbel noise from a CPU generator seeded with
    ``key`` — drawn on the host so every device gets the same numbers."""
    g = torch.Generator().manual_seed(key)
    u = torch.rand((rows, vocab), generator=g)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample_logits(logits: torch.Tensor, key: Optional[int],
                  temperature: float = 0.0,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """The ONE sampling recipe (greedy argmax at temperature 0, else
    temperature-scaled, optionally top-k-truncated Gumbel-max) shared by
    generate() and the engine's step.  logits [B, V] -> tokens [B]."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k:
        kth = logits.sort(dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    noise = _gumbel(key, logits.shape[0], logits.shape[1])
    return (logits.float() + noise.to(logits.device)).argmax(dim=-1)


@torch.no_grad()
def generate_tokens(params: Params, cfg: GPTConfig, prompt,
                    max_new_tokens: int, *, temperature: float = 0.0,
                    top_k: Optional[int] = None, seed: int = 0,
                    key_offset: int = 0, max_seq: Optional[int] = None,
                    device: DeviceLike = None) -> Iterator[torch.Tensor]:
    """generate() one position at a time: prompt [B, S] -> yields the
    tokens [B] drawn for each new position, before the next decode step
    runs.  Token i is sampled with ``token_key(seed, key_offset + i)``:
    a continuation that folds k delivered tokens into the prompt and
    passes ``key_offset=k`` draws the uninterrupted run's noise.

    Prefill and decode are both loops of the decode step; GPT-2-family
    configs take the decode-view fast path (fused QKV, compute-dtype
    weights).  The arguments are checked at the first ``next``."""
    dev = resolve_device(device)
    check_params_on(params, dev)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    B, S = prompt.shape
    total = S + max_new_tokens
    max_seq = total if max_seq is None else max_seq
    if total > max_seq:
        raise ValueError(f"prompt ({S}) + max_new_tokens "
                         f"({max_new_tokens}) > max_seq ({max_seq})")
    if cfg.pos == "learned" and total > cfg.max_seq:
        raise ValueError(f"learned positions stop at {cfg.max_seq}")
    if _decode_fast_eligible(cfg):
        view = _decode_view(params, cfg)
        shape = (cfg.n_layers, B, cfg.n_heads, max_seq, cfg.d_head)
        kc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        vc = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        for p in range(S):
            x = _decode_hidden_fast(view, cfg, kc, vc, p, prompt[:, p])
        for i in range(max_new_tokens):
            tok = sample_logits(x @ view["unembed"],
                                token_key(seed, key_offset + i),
                                temperature, top_k)
            yield tok
            if i + 1 < max_new_tokens:
                x = _decode_hidden_fast(view, cfg, kc, vc, S + i, tok)
    else:
        cache = init_cache(cfg, B, max_seq, device=dev)
        rope = _rope_for(cfg, max_seq, None, dev)
        for p in range(S):
            x, cache = _decode_hidden(params, cache, prompt[:, p], cfg, rope)
        logits = x.to(cfg.dtype) @ _unembed_table(params, cfg)
        for i in range(max_new_tokens):
            tok = sample_logits(logits, token_key(seed, key_offset + i),
                                temperature, top_k)
            yield tok
            if i + 1 < max_new_tokens:
                logits, cache = decode_step(params, cache, tok, cfg, rope)


def generate(params: Params, cfg: GPTConfig, prompt, max_new_tokens: int,
             *, temperature: float = 0.0, top_k: Optional[int] = None,
             seed: int = 0, max_seq: Optional[int] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """Autoregressive generation: prompt [B, S] -> [B, S + new], the
    tokens of ``generate_tokens`` (token i sampled with
    ``token_key(seed, i)``)."""
    new = list(generate_tokens(params, cfg, prompt, max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               seed=seed, max_seq=max_seq, device=device))
    prompt = torch.as_tensor(prompt, dtype=torch.long,
                             device=resolve_device(device))
    if not new:
        return prompt
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)


def sample_rows(logits: torch.Tensor, temps: Sequence[float],
                topks: Sequence[int], keys: Sequence[Optional[int]]
                ) -> torch.Tensor:
    """Per-row sampling for a slot batch: each row through
    sample_logits with its own temperature, top-k (0 = off) and key —
    a B=1 generate() and an engine slot draw identical tokens."""
    out = logits.argmax(dim=-1)
    for b, t in enumerate(temps):
        if t > 0:
            out[b] = sample_logits(logits[b:b + 1], keys[b], float(t),
                                   int(topks[b]) or None)[0]
    return out
