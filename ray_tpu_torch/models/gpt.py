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

Meshes (dp/fsdp/ep/sp/tp): ``logical_axes`` annotates the param tree as
the reference's does, and ``apply_hidden`` / ``apply`` / ``loss_fn``
take ``mesh=``.  The reference passes global arrays to one program; here
every rank calls with DTensors (``parallel.shard_tree``), whose global
view is the reference's array, and the model runs on their local shards
in one rank-local region with explicit collectives
(``parallel/spmd.py``): each layer's fsdp-sharded weights gathered on use
(their gradient reduce-scattered), Megatron's column/row split over
``tp`` for the heads and the MLP, the vocab-parallel embedding and
cross-entropy over ``tp``, ring attention (K1-K3 per chunk) over ``sp``,
GPipe over ``pp`` (``parallel/pipeline.py``: each pp rank runs its
stage's layers on microbatches that rotate over pp), and every
parameter's gradient summed over the data ranks it is replicated on.
The activations are laid out by ``ACTIVATION_RULES``
(batch over the data axes, seq over ``sp``, heads over ``tp``), and what
leaves the region is a DTensor of that layout.  Without a mesh the same
code runs as one rank (every axis 1), where each collective is the
identity and runs nothing.

Under ``pp`` the leaves outside the layer stack are whole on every pp
rank: the final norm and the cross-entropy run the same on each (their
gradients are whole there), while only pp rank 0 feeds the embedding
into the pipeline, so the embedding's output has its gradient summed
over pp (the other ranks contribute zeros) and the tied table's total is
the lookup's plus the unembedding's on every rank.

MPMD pipelines (``parallel/mpmd.py``) slice the model into per-stage
trees instead (``partition_stage_params``, ``stage_hidden``,
``stage_loss``), each stage running the same block loop.
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
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.sharding import (ACTIVATION_RULES, Logical,
                                             NamedSharding, _entry_axes,
                                             _tree_map, from_local,
                                             spec_from_logical)

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
    # training: recompute each block in the backward ("full"), or save
    # the matmul outputs and recompute the rest ("dots", the reference's
    # dots_with_no_batch_dims_saveable), CE over sequence chunks of
    # loss_chunk (None: dense; off when sp > 1), z-loss weight
    remat: bool = True
    remat_policy: str = "full"
    loss_chunk: Optional[int] = None
    z_loss: float = 1e-4
    # q/k/v/o projection biases (real GPT-2 checkpoints have them)
    attn_bias: bool = False
    tie_embeddings: bool = True
    # how a >1 sp axis attends: "ring" (ring attention) or "none" (K/V
    # gathered over sp, each rank's rows at their global offset)
    sp_mode: str = "ring"
    num_microbatches: Optional[int] = None  # pp microbatches; default = pp

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


def logical_axes(cfg: GPTConfig) -> Dict[str, Any]:
    """Logical sharding annotations mirroring the param tree (the
    reference's, ``ray_tpu/models/gpt.py:99-135``)."""
    lp = {
        "attn_norm": Logical("layers", None),
        "wq": Logical("layers", "embed", "heads", "head_dim"),
        "wk": Logical("layers", "embed", "heads", "head_dim"),
        "wv": Logical("layers", "embed", "heads", "head_dim"),
        "wo": Logical("layers", "heads", "head_dim", "embed"),
        "mlp_norm": Logical("layers", None),
        "mlp_out": Logical("layers", "mlp", "embed"),
    }
    if cfg.act == "swiglu":
        lp["mlp_gate"] = Logical("layers", "embed", "mlp")
        lp["mlp_up"] = Logical("layers", "embed", "mlp")
    else:
        lp["mlp_in"] = Logical("layers", "embed", "mlp")
        lp["mlp_in_b"] = Logical("layers", "mlp")
        lp["mlp_out_b"] = Logical("layers", None)
    if cfg.norm == "ln":
        lp["attn_norm_b"] = Logical("layers", None)
        lp["mlp_norm_b"] = Logical("layers", None)
    if cfg.attn_bias:
        lp["wq_b"] = Logical("layers", "heads", "head_dim")
        lp["wk_b"] = Logical("layers", "heads", "head_dim")
        lp["wv_b"] = Logical("layers", "heads", "head_dim")
        lp["wo_b"] = Logical("layers", None)
    out = {
        # vocab-only: the lookup is a gather over the vocab rows
        "embed": Logical("vocab", None),
        "layers": lp,
        "final_norm": Logical(None),
    }
    if cfg.norm == "ln":
        out["final_norm_b"] = Logical(None)
    if cfg.pos == "learned":
        out["pos_embed"] = Logical(None, "embed")
    if not cfg.tie_embeddings:
        out["unembed"] = Logical("embed", "vocab")
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


def _qkv_proj(x, layer, cfg: GPTConfig, rope, positions=None, ctx=None):
    """Pre-norm + QKV projection + rope: x [B, S, D] -> q, k, v
    [B, H, S, dh] — the one recipe shared by the forward and the decode
    paths (decode==forward parity rests on it).  H is the weights' own
    (a rank's heads under tp, whose input's gradient is summed over tp)."""
    B, S, D = x.shape
    H, dh = layer["wq"].shape[-2], cfg.d_head
    h = _norm(x, layer["attn_norm"], layer.get("attn_norm_b"), cfg.norm)
    h = h.to(cfg.dtype)
    if ctx is not None:
        h = spmd.reduce_grad(h, ctx)

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


def _attn_out_and_mlp(x, o, layer, cfg: GPTConfig, ctx=None):
    """Output projection + residual + MLP sublayer (shared, see
    _qkv_proj).  o [B, H, S, dh], x [B, S, D].  Under tp the row-parallel
    products are summed over tp before their biases."""
    B, H, S, dh = o.shape
    D = cfg.d_model
    att = (o.transpose(1, 2).reshape(B, S, H * dh)
           @ layer["wo"].to(cfg.dtype).reshape(H * dh, D))
    if ctx is not None:
        att = spmd.reduce_out(att, ctx)
    if cfg.attn_bias:
        att = att + layer["wo_b"].to(cfg.dtype)
    x = x + att
    h2 = _norm(x, layer["mlp_norm"], layer.get("mlp_norm_b"), cfg.norm)
    h2 = h2.to(cfg.dtype)
    if ctx is not None:
        h2 = spmd.reduce_grad(h2, ctx)
    if cfg.act == "swiglu":
        m = swiglu(h2, layer["mlp_gate"].to(cfg.dtype),
                   layer["mlp_up"].to(cfg.dtype),
                   layer["mlp_out"].to(cfg.dtype))
        if ctx is not None:
            m = spmd.reduce_out(m, ctx)
    elif ctx is None or ctx.size("tp") == 1:
        m = gelu_mlp(h2, layer["mlp_in"].to(cfg.dtype),
                     layer["mlp_in_b"].to(cfg.dtype),
                     layer["mlp_out"].to(cfg.dtype),
                     layer["mlp_out_b"].to(cfg.dtype))
    else:   # gelu_mlp with the tp sum before the output bias
        m = F.gelu(h2 @ layer["mlp_in"].to(cfg.dtype)
                   + layer["mlp_in_b"].to(cfg.dtype), approximate="tanh")
        m = spmd.reduce_out(m @ layer["mlp_out"].to(cfg.dtype), ctx)
        m = m + layer["mlp_out_b"].to(cfg.dtype)
    return x + m


def _attention_op(q, k, v, cfg: GPTConfig, ctx):
    """The forward's attention: flash attention over the whole sequence,
    or, with an sp axis > 1, the ring over sp (``sp_mode="ring"``) or
    attention against K/V gathered over sp (``"none"``)."""
    # the flash kernel takes contiguous [B, H, S, dh]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if ctx.size("sp") == 1:
        return attention(q, k, v, causal=True)
    if cfg.sp_mode == "ring":
        return ring_attention_sharded(q, k, v, "sp", causal=True,
                                      mesh=ctx.mesh)
    if cfg.sp_mode != "none":
        raise ValueError(f"unknown sp_mode {cfg.sp_mode!r}")
    # rank r's rows see the keys of ranks 0..r: the bottom-right corner
    # of the first (r+1)*S_loc keys, attention's own causal anchor
    end = (ctx.coords["sp"] + 1) * q.shape[2]
    kf = spmd.gather(k, 2, ctx, "sp")[:, :, :end].contiguous()
    vf = spmd.gather(v, 2, ctx, "sp")[:, :, :end].contiguous()
    return attention(q, kf, vf, causal=True)


def _block(x, params: Params, l: int, cfg: GPTConfig, rope,
           shards: "_Shards", positions=None):
    """One transformer block (attention + MLP sublayers) of layer l, its
    fsdp-sharded weights gathered first."""
    ctx = shards.ctx
    layer = {k: shards.gather_layer(k, w)
             for k, w in _layer(params, l).items()}
    q, k, v = _qkv_proj(x, layer, cfg, rope, positions, ctx)
    return _attn_out_and_mlp(x, _attention_op(q, k, v, cfg, ctx), layer,
                             cfg, ctx)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the weight matmuls' outputs (2-D products, no batch dims),
    recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_kwargs(cfg: GPTConfig) -> Dict[str, Any]:
    if cfg.remat_policy == "full":
        return {}
    if cfg.remat_policy == "dots":
        import functools

        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _n_layers(params: Params) -> int:
    """The stacked layers' count in ``params`` (a pp rank's or a stage's
    slice holds fewer than ``cfg.n_layers``)."""
    return next(iter(params["layers"].values())).shape[0]


def _blocks(x, params: Params, cfg: GPTConfig, rope, shards: "_Shards",
            positions=None):
    """Every block of ``params``' layer stack over x: the one block loop
    of the whole model, a pp rank's stage and an MPMD stage."""
    remat = cfg.remat and torch.is_grad_enabled()
    kw = _remat_kwargs(cfg) if cfg.remat else {}
    for l in range(_n_layers(params)):
        if remat:
            # the model draws no random numbers: no RNG state to replay
            x = checkpoint(_block, x, params, l, cfg, rope, shards,
                           positions, use_reentrant=False,
                           preserve_rng_state=False, **kw)
        else:
            x = _block(x, params, l, cfg, rope, shards, positions)
    return x


def _stack(x, params: Params, cfg: GPTConfig, rope, shards: "_Shards",
           positions=None):
    """Every block over x, then the final norm.  Over a pp axis > 1 this
    rank's layers are one stage of a GPipe pipeline over
    ``cfg.num_microbatches`` (default pp) microbatches of its rows."""
    pp = shards.ctx.size("pp")
    if pp == 1:
        x = _blocks(x, params, cfg, rope, shards, positions)
    else:
        from ray_tpu_torch.parallel.pipeline import (merge_microbatches,
                                                     pipeline_apply,
                                                     split_microbatches)

        if cfg.n_layers % pp:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                             f"pp {pp}")
        M = cfg.num_microbatches or pp

        def stage_fn(local, xm):
            return _blocks(xm, local, cfg, rope, shards, positions)

        x = merge_microbatches(pipeline_apply(
            stage_fn, params, split_microbatches(x, M), shards.ctx))
    return _norm(x, params["final_norm"], params.get("final_norm_b"),
                 cfg.norm)


def apply_hidden(params: Params, tokens, cfg: GPTConfig, *,
                 device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """Transformer stack up to the final norm: tokens [B, S] ->
    hidden [B, S, D].  Under a mesh: params and tokens DTensors (or
    global tokens), the hidden a DTensor laid out (batch, seq, embed)."""
    shards = _Shards(cfg, mesh, device)
    x = _hidden(shards.params(params), shards.block(tokens), cfg, shards)
    return shards.wrap(x, ("batch", "seq", "embed"))


def _unembed_table(params: Params, cfg: GPTConfig) -> torch.Tensor:
    return (params["embed"].T if cfg.tie_embeddings
            else params["unembed"]).to(cfg.dtype)


def apply(params: Params, tokens, cfg: GPTConfig, *,
          device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """Forward pass: tokens [B, S] -> logits [B, S, V] in cfg.dtype
    (under a mesh a DTensor laid out (batch, seq, vocab))."""
    shards = _Shards(cfg, mesh, device)
    local = shards.params(params)
    x = _hidden(local, shards.block(tokens), cfg, shards)
    logits = (spmd.reduce_grad(x.to(cfg.dtype), shards.ctx)
              @ shards.unembed(local))
    return shards.wrap(logits, ("batch", "seq", "vocab"))


def loss_fn(params: Params, batch: Dict[str, Any], cfg: GPTConfig, *,
            device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """Next-token LM loss, a scalar f32 tensor.  batch: {"tokens":
    [B, S+1]} or {"inputs", "targets": [B, S]}, and an optional "mask"
    [B, S] that weights the per-token losses.  The fused chunked CE
    (``cfg.loss_chunk``) runs when the chunk divides S (and sp is 1),
    the dense CE otherwise; both add ``cfg.z_loss``.  Under a mesh the
    params are DTensors, the batch DTensors laid out by ``shard_batch``
    or ``batch_sharding`` (or global arrays), and the loss the global
    mean, the same scalar on every rank."""
    shards = _Shards(cfg, mesh, device)
    return _loss(shards.params(params), batch, cfg, shards)


# ---------------------------------------------------------------------------
# One rank-local region over this rank's shards (the whole model without
# a mesh)


class _Shards:
    """A rank's view of the model: its place on the mesh
    (``parallel.spmd.MeshCtx``), each leaf's spec under the reference's
    rules, and the device the shards live on.  With no mesh it is the one
    rank of an unsharded model on ``device``."""

    def __init__(self, cfg: GPTConfig, mesh=None, device: DeviceLike = None):
        if mesh is not None and not (hasattr(mesh, "mesh_dim_names")
                                     and hasattr(mesh, "get_group")):
            raise TypeError(f"mesh must be a torch DeviceMesh "
                            f"(parallel.make_mesh), got "
                            f"{type(mesh).__name__}")
        self.cfg = cfg
        self.mesh = mesh
        self.ctx = spmd.MeshCtx.of(mesh)
        if mesh is None:
            self.device = resolve_device(device)
            self.specs = None
            return
        from ray_tpu_torch.parallel.mesh import mesh_device

        self.device = mesh_device(mesh)
        self.specs = _tree_map(lambda l: spec_from_logical(l.axes, None, mesh),
                               logical_axes(cfg))

    def params(self, params: Params) -> Params:
        """The local shards of a DTensor tree (differentiable: gradients
        reach the DTensors), each with its gradient summed over the data
        ranks and sp (those the leaf is replicated over).  Without a mesh:
        the tree itself, checked to lie on the device."""
        if self.mesh is None:
            check_params_on(params, self.device)
            return params
        from torch.distributed.tensor import DTensor

        def one(w, spec):
            if isinstance(w, DTensor):
                w = w.to_local()
            if w.device != self.device:
                raise ValueError(f"a param shard is on {w.device}, the mesh "
                                 f"computes on {self.device}")
            used = {a for e in spec for a in _entry_axes(e)}
            axes = [a for a in ("dp", "fsdp", "ep", "sp") if a not in used]
            return spmd.reduce_grad(w, self.ctx, axes)

        return _tree_map(one, params, self.specs)

    def fsdp_dim(self, spec) -> Optional[int]:
        for d, e in enumerate(spec):
            if "fsdp" in _entry_axes(e):
                return d
        return None

    def gather_layer(self, name: str, w):
        """Layer ``name``'s slice (the stacked dim dropped) whole over
        fsdp."""
        if self.ctx.size("fsdp") == 1:
            return w
        d = self.fsdp_dim(self.specs["layers"][name])
        return w if d is None else spmd.gather(w, d - 1, self.ctx)

    def gather_top(self, name: str, w):
        if self.ctx.size("fsdp") == 1:
            return w
        d = self.fsdp_dim(self.specs[name])
        return w if d is None else spmd.gather(w, d, self.ctx)

    def unembed(self, local: Params) -> torch.Tensor:
        """This rank's vocab columns of the unembedding, [D, V/tp]."""
        if self.cfg.tie_embeddings:
            return local["embed"].T.to(self.cfg.dtype)
        return self.gather_top("unembed", local["unembed"]).to(
            self.cfg.dtype)

    def batch_rows(self, x):
        """(this rank's rows of a batch leaf, whether its dim 1 is already
        this rank's sp slice).  A DTensor must be laid out batch over the
        data axes (``shard_batch``, or ``batch_sharding``'s seq over sp);
        anything else is the global batch."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            names = tuple(x.device_mesh.mesh_dim_names)
            rows, seq = [], []
            for a, p in zip(names, x.placements):
                if p.is_shard(0):
                    rows.append(a)
                elif p.is_shard(1):
                    seq.append(a)
                elif p.is_shard():
                    raise ValueError(f"a batch sharded on dim {p.dim} over "
                                     f"{a!r}: batches shard dim 0 over the "
                                     f"data axes, dim 1 over sp")
            want = [a for a in spmd.DATA_AXES if self.ctx.size(a) > 1]
            got = [a for a in rows if self.ctx.size(a) > 1]
            if got != want or [a for a in seq if self.ctx.size(a) > 1]                     not in ([], ["sp"] if self.ctx.size("sp") > 1 else []):
                raise ValueError(
                    f"batch placements {x.placements} do not shard the "
                    f"batch over {want} (and the sequence over sp)")
            return x.to_local().to(self.device), "sp" in seq and                 self.ctx.size("sp") > 1
        x = torch.as_tensor(x, device=self.device)
        n = self.ctx.data_size
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not divide "
                             f"over {n} data ranks")
        blk = x.shape[0] // n
        i = self.ctx.data_index
        return x[i * blk:(i + 1) * blk], False

    def seq_slice(self, x, done: bool = False):
        """This rank's sp slice of dim 1."""
        n = self.ctx.size("sp")
        if n == 1 or done:
            return x
        if x.shape[1] % n:
            raise ValueError(f"a sequence of {x.shape[1]} does not divide "
                             f"over sp={n}")
        blk = x.shape[1] // n
        r = self.ctx.coords["sp"]
        return x[:, r * blk:(r + 1) * blk]

    def block(self, x):
        """This rank's block of a batch leaf: its rows and sp slice."""
        rows, done = self.batch_rows(x)
        return self.seq_slice(rows, done)

    def wrap(self, local: torch.Tensor, logical):
        """A DTensor of this rank's block of an activation laid out by
        ``ACTIVATION_RULES`` (without a mesh, the tensor itself)."""
        if self.mesh is None:
            return local
        return from_local(local, NamedSharding(self.mesh, spec_from_logical(
            logical, ACTIVATION_RULES, self.mesh)))


def _hidden(local: Params, tokens, cfg: GPTConfig, shards: _Shards):
    """The stack on this rank's rows and sp slice of the tokens: hidden
    [B/data, S/sp, D], replicated over tp."""
    ctx = shards.ctx
    tokens = tokens.to(dtype=torch.long)
    S = tokens.shape[1]
    off = ctx.coords["sp"] * S
    table = local["embed"]
    if ctx.size("tp") == 1:
        x = table[tokens]
    else:   # vocab-parallel lookup: this rank's rows, summed over tp
        v_loc = table.shape[0]
        ids = tokens - ctx.coords["tp"] * v_loc
        hit = (ids >= 0) & (ids < v_loc)
        x = table[ids.clamp(0, v_loc - 1)] * hit[..., None].to(table.dtype)
        x = spmd.reduce_out(x, ctx)
    x = x.to(cfg.dtype)
    positions = None
    if cfg.pos == "learned":
        pe = shards.gather_top("pos_embed", local["pos_embed"])
        x = x + pe[off:off + S][None].to(cfg.dtype)
        rope = None
    else:
        rope = rope_table(off + S, cfg.d_head, device=shards.device)
        if ctx.size("sp") > 1:
            positions = off + torch.arange(S, device=shards.device)
    # only pp rank 0 feeds this into the pipeline: the lookup's gradient
    # is that rank's, summed over pp so each rank holds the table's total
    x = spmd.reduce_grad(x, ctx, ("pp",))
    return _stack(x, local, cfg, rope, shards, positions)


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float, ctx) -> torch.Tensor:
    """``softmax_cross_entropy`` on logits whose vocab is split over tp:
    the max, the sum of exponentials and the label's logit each summed
    over tp."""
    logits = logits.float()
    v_loc = logits.shape[-1]
    m = spmd.all_max(logits.detach().amax(dim=-1), ctx, ("tp",))
    se = spmd.reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1), ctx)
    lse = m + torch.log(se)
    ids = labels.long() - ctx.coords["tp"] * v_loc
    hit = (ids >= 0) & (ids < v_loc)
    ll = logits.gather(-1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    ll = spmd.reduce_out(ll * hit.to(ll.dtype), ctx)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


def _ce(x, table, targets, cfg: GPTConfig, ctx, chunk):
    """Per-token CE of hidden x against this rank's vocab columns."""
    x = spmd.reduce_grad(x.to(cfg.dtype), ctx)
    if ctx.size("tp") == 1:
        if chunk:
            return fused_softmax_cross_entropy(x, table, targets,
                                               z_loss=cfg.z_loss, chunk=chunk)
        return softmax_cross_entropy(x @ table, targets, z_loss=cfg.z_loss)
    if not chunk:
        return _vocab_parallel_ce(x @ table, targets, cfg.z_loss, ctx)
    S = x.shape[1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {chunk}")

    def chunk_loss(xc, lc):
        return _vocab_parallel_ce(xc @ table, lc, cfg.z_loss, ctx)

    return torch.cat([
        checkpoint(chunk_loss, x[:, i:i + chunk], targets[:, i:i + chunk],
                   use_reentrant=False, preserve_rng_state=False)
        for i in range(0, S, chunk)], dim=1)


def _loss(local: Params, batch: Dict[str, Any], cfg: GPTConfig,
          shards: _Shards) -> torch.Tensor:
    """``loss_fn`` on this rank's shards (``_Shards.params``): the global
    mean, summed over the data ranks and sp."""
    ctx = shards.ctx
    if "inputs" in batch:
        inputs, in_done = shards.batch_rows(batch["inputs"])
        targets, t_done = shards.batch_rows(batch["targets"])
    else:
        toks, _ = shards.batch_rows(batch["tokens"])
        inputs, targets = toks[:, :-1], toks[:, 1:]
        in_done = t_done = False
    inputs = shards.seq_slice(inputs, in_done)
    targets = shards.seq_slice(targets, t_done).to(torch.long)
    chunk = cfg.loss_chunk
    # the sequence is split over sp: chunking it would cut across ranks
    if not (chunk and ctx.size("sp") == 1
            and targets.shape[1] % chunk == 0):
        chunk = None
    x = _hidden(local, inputs, cfg, shards)
    loss = _ce(x, shards.unembed(local), targets, cfg, ctx, chunk)
    over = spmd.DATA_AXES + ("sp",)
    if "mask" in batch:
        mask, m_done = shards.batch_rows(batch["mask"])
        mask = shards.seq_slice(mask, m_done).float()
        num = spmd.reduce_out((loss * mask).sum(), ctx, over)
        return num / spmd.all_sum(mask.sum(), ctx, over).clamp_min(1.0)
    if ctx.data_size * ctx.size("sp") == 1:
        return loss.mean()
    total = spmd.reduce_out(loss.sum(), ctx, over)
    return total / (loss.numel() * ctx.data_size * ctx.size("sp"))


# ---------------------------------------------------------------------------
# MPMD pipeline partitioning (parallel/mpmd.py): the model sliced into
# per-stage param trees and per-stage forward functions, each stage run
# by its own gang on its own device


def partition_stage_params(params: Params, cfg: GPTConfig, stages: int
                           ) -> list:
    """Slice the param tree into ``stages`` contiguous per-stage trees
    (views of ``params``' tensors).

    Stage 0 owns embed (and learned positions); the last stage owns the
    final norm and the vocab projection.  With tied embeddings BOTH end
    stages hold the table (stage 0 for the lookup, the last for the
    unembedding): ``parallel/mpmd.py`` keeps the two copies equal by
    exchanging their gradients every step."""
    if cfg.n_layers % stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"stages {stages}")
    per = cfg.n_layers // stages
    out = []
    for s in range(stages):
        st: Params = {"layers": {k: w[s * per:(s + 1) * per]
                                 for k, w in params["layers"].items()}}
        if s == 0:
            st["embed"] = params["embed"]
            if cfg.pos == "learned":
                st["pos_embed"] = params["pos_embed"]
        if s == stages - 1:
            st["final_norm"] = params["final_norm"]
            if cfg.norm == "ln":
                st["final_norm_b"] = params["final_norm_b"]
            if cfg.tie_embeddings:
                st.setdefault("embed", params["embed"])
            else:
                st["unembed"] = params["unembed"]
        out.append(st)
    return out


def merge_stage_trees(stage_trees: Sequence[Params], cfg: GPTConfig,
                      grads: bool = False, tie_summed: bool = False
                      ) -> Params:
    """Inverse of ``partition_stage_params``: the whole tree.

    For params (``grads=False``) the tied table's copies are equal and
    stage 0's is taken; for gradients the two ends' partials are SUMMED
    (the lookup's and the unembedding's contributions to the one table),
    unless the pipeline's tied-table exchange already left the total in
    both (``tie_summed=True``)."""
    stages = len(stage_trees)
    first, last = stage_trees[0], stage_trees[-1]
    out: Params = {"layers": {
        k: torch.cat([t["layers"][k] for t in stage_trees], dim=0)
        for k in first["layers"]}}
    out["embed"] = first["embed"]
    if grads and cfg.tie_embeddings and stages > 1 and not tie_summed:
        out["embed"] = out["embed"] + last["embed"]
    if cfg.pos == "learned":
        out["pos_embed"] = first["pos_embed"]
    out["final_norm"] = last["final_norm"]
    if cfg.norm == "ln":
        out["final_norm_b"] = last["final_norm_b"]
    if not cfg.tie_embeddings:
        out["unembed"] = last["unembed"]
    return out


def stage_hidden(stage_params: Params, x, cfg: GPTConfig, stage: int,
                 stages: int) -> torch.Tensor:
    """One MPMD stage's forward: tokens [B, S] (stage 0) or hidden
    [B, S, D] -> hidden [B, S, D] (final-normed on the last stage).  The
    blocks are the unpipelined model's (``_blocks``, remat included), so
    a stage computes exactly its slice of the whole stack."""
    dev = next(iter(stage_params["layers"].values())).device
    shards = _Shards(cfg, None, dev)
    S = x.shape[1]
    if stage == 0:
        h = stage_params["embed"][x.to(dtype=torch.long)].to(cfg.dtype)
        if cfg.pos == "learned":
            h = h + stage_params["pos_embed"][:S][None].to(cfg.dtype)
    else:
        h = x.to(cfg.dtype)
    rope = (None if cfg.pos == "learned"
            else rope_table(S, cfg.d_head, device=dev))
    h = _blocks(h, stage_params, cfg, rope, shards)
    if stage == stages - 1:
        h = _norm(h, stage_params["final_norm"],
                  stage_params.get("final_norm_b"), cfg.norm)
    return h


def stage_loss(stage_params: Params, x, targets, cfg: GPTConfig,
               stage: int, stages: int) -> torch.Tensor:
    """Last-stage forward + next-token CE (the mean over this
    microbatch; with equal microbatches the mean of the means is
    ``loss_fn``'s global mean)."""
    h = stage_hidden(stage_params, x, cfg, stage, stages)
    table = (stage_params["embed"].T if cfg.tie_embeddings
             else stage_params["unembed"]).to(cfg.dtype)
    return softmax_cross_entropy(h.to(cfg.dtype) @ table,
                                 targets.to(dtype=torch.long),
                                 z_loss=cfg.z_loss).mean()


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
