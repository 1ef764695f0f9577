"""Mixture-of-experts GPT: the expert-parallel model.  Counterpart of
``ray_tpu/models/moe.py``.

A decoder-only transformer whose MLP is a top-k routed expert bank
(``ops/moe.py``).  It runs in GPT's rank-local region
(``models/gpt.py`` ``_Shards``): the attention half of every block is
GPT's (``_qkv_proj``, ``_attention_op``: K1 in the forward, K2/K3 in the
backward, the ring over sp), fsdp-sharded weights are gathered per layer,
the experts' mlp dim splits over tp with Megatron's f/g pair, and the
experts themselves split over ``ep``, each rank's dispatched slots sent
to their experts' owners by ``mesh_all_to_all`` and back.

The routing group is the reference's, whatever rank holds a token.  With
``ep`` > 1 (and no pp) the reference routes each contiguous 1/ep of the
global ``[B·S]`` tokens as one group (its ``shard_map(P("ep"))`` over the
flattened tokens), with the capacity of B·S/ep tokens; otherwise (no
mesh, data axes only, or every microbatch of a pp pipeline) the whole
global token set of the call is one group.  The port's rows lie over
``("dp", "fsdp", "ep")`` with dp outermost, so a group's tokens are spread
over several ranks: each rank gathers the top-k choices of the token
plane (the data axes and sp), counts the queue positions over its
group in the group's order, fills only its own tokens' slots of the
group's [E, C, D] buffer (the experts act slot by slot), and the aux
losses' means are summed over the group's ranks.  Under pp each rank's
rows are first laid out as its share of each of the reference's global
microbatches (rows m·B/M + i·B/(M·data) + r on data rank i), so a
microbatch's group is the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.moe import (RoutingGroup, expert_capacity,
                                   expert_ffn, gelu, route_topk)
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.sharding import Logical

from . import gpt
from .gpt import GPTConfig, Params, _norm


@dataclasses.dataclass(frozen=True)
class MoEConfig(GPTConfig):
    """GPT config + expert bank; d_ff is the per-expert hidden size.  The
    experts' activation is always the tanh GELU (``act`` names nothing
    here, as in the reference) and the attention has no biases."""

    n_experts: int = 8
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 0.001

    def __post_init__(self):
        if self.attn_bias:
            raise ValueError("MoEConfig has no attention biases "
                             "(attn_bias=True)")

    @classmethod
    def mixtral_nano(cls, **kw):
        kw.setdefault("norm", "rms")
        kw.setdefault("act", "gelu")
        kw.setdefault("pos", "rope")
        return cls(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=128,
                   vocab_size=256, max_seq=128, n_experts=4,
                   tie_embeddings=True, **kw)

    @classmethod
    def small(cls, **kw):
        kw.setdefault("norm", "rms")
        kw.setdefault("pos", "rope")
        return cls(n_layers=12, d_model=768, n_heads=12, d_head=64,
                   d_ff=2048, n_experts=8, **kw)


def param_shapes(cfg: MoEConfig) -> Dict[str, Any]:
    """The param tree's shapes, key for key with the reference's init."""
    L, D, H, dh, F, V, E = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                            cfg.d_head, cfg.d_ff, cfg.vocab_size,
                            cfg.n_experts)
    lp = {"attn_norm": (L, D), "wq": (L, D, H, dh), "wk": (L, D, H, dh),
          "wv": (L, D, H, dh), "wo": (L, H, dh, D), "mlp_norm": (L, D),
          "router": (L, D, E), "w_in": (L, E, D, F), "w_out": (L, E, F, D)}
    if cfg.norm == "ln":
        lp.update(attn_norm_b=(L, D), mlp_norm_b=(L, D))
    out: Dict[str, Any] = {"embed": (V, D), "layers": lp,
                           "final_norm": (D,)}
    if cfg.norm == "ln":
        out["final_norm_b"] = (D,)
    if cfg.pos == "learned":
        out["pos_embed"] = (cfg.max_seq, D)
    if not cfg.tie_embeddings:
        out["unembed"] = (D, V)
    return out


def logical_axes(cfg: MoEConfig) -> Dict[str, Any]:
    """The reference's annotations (``ray_tpu/models/moe.py:56-83``): the
    router replicated over experts, the experts' banks over ``experts``
    (``ep``)."""
    lp = {
        "attn_norm": Logical("layers", None),
        "wq": Logical("layers", "embed", "heads", "head_dim"),
        "wk": Logical("layers", "embed", "heads", "head_dim"),
        "wv": Logical("layers", "embed", "heads", "head_dim"),
        "wo": Logical("layers", "heads", "head_dim", "embed"),
        "mlp_norm": Logical("layers", None),
        "router": Logical("layers", "embed", None),
        "w_in": Logical("layers", "experts", "embed", "mlp"),
        "w_out": Logical("layers", "experts", "mlp", "embed"),
    }
    if cfg.norm == "ln":
        lp["attn_norm_b"] = Logical("layers", None)
        lp["mlp_norm_b"] = Logical("layers", None)
    out = {"embed": Logical("vocab", "embed"), "layers": lp,
           "final_norm": Logical(None)}
    if cfg.norm == "ln":
        out["final_norm_b"] = Logical(None)
    if cfg.pos == "learned":
        out["pos_embed"] = Logical(None, "embed")
    if not cfg.tie_embeddings:
        out["unembed"] = Logical("embed", "vocab")
    return out


def init(cfg: MoEConfig, *, seed: int = 0,
         generator: torch.Generator = None,
         device: DeviceLike = None) -> Params:
    """Random params on ``device`` by the reference's recipe: unit norms,
    zero biases, N(0, 1/fan_in) projections and experts, the residual
    branches (wo, w_out) scaled by 1/sqrt(2L), embed 0.02."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    L, D, H, dh, F = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head,
                      cfg.d_ff)
    pd = cfg.param_dtype

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=pd,
                           device=dev) * std

    fan_in = {"wq": D, "wk": D, "wv": D, "wo": H * dh, "router": D,
              "w_in": D, "w_out": F}
    shapes = param_shapes(cfg)
    lp = {}
    for name, shape in shapes["layers"].items():
        if name in fan_in:
            std = 1.0 / math.sqrt(fan_in[name])
            if name in ("wo", "w_out"):
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


def num_params(cfg: MoEConfig) -> int:
    shapes = param_shapes(cfg)
    leaves = [s for k, s in shapes.items() if k != "layers"]
    leaves += list(shapes["layers"].values())
    return sum(math.prod(s) for s in leaves)


class _Shards(gpt._Shards):
    """GPT's rank-local region over the MoE param tree."""

    logical_axes = staticmethod(logical_axes)


def _data_gather(x, ctx: spmd.MeshCtx):
    """Every data rank's block of x along dim 0, in data-index order (the
    innermost axis first)."""
    for axis in reversed(spmd.DATA_AXES):
        x = spmd.gather(x, 0, ctx, axis)
    return x


class _TokenPlane(RoutingGroup):
    """The tokens of one routing pass on the mesh: this rank holds rows
    [i·b, (i+1)·b) (i its data index) and positions [r·s, (r+1)·s) (r its
    sp coordinate) of a global [B, S] block; the global ``[B·S]``
    row-major order splits into ``n_groups`` contiguous groups.  The
    plane's ranks are those of the data axes and sp (tp ranks hold the
    same tokens)."""

    def __init__(self, ctx: spmd.MeshCtx, b: int, s: int, n_groups: int):
        self.ctx, self.b, self.s, self.n_groups = ctx, b, s, n_groups
        self.B, self.S = b * ctx.data_size, s * ctx.size("sp")
        self.row0 = ctx.data_index * b
        self.col0 = ctx.coords["sp"] * s
        if (self.B * self.S) % n_groups:
            raise ValueError(f"{self.B * self.S} tokens do not split into "
                             f"{n_groups} routing groups")
        self.index = ((self.row0 * self.S + self.col0)
                      // (self.B * self.S // n_groups))

    @property
    def group_tokens(self) -> int:
        return self.B * self.S // self.n_groups

    def gather(self, t):
        rest = tuple(t.shape[1:])
        t = spmd.gather(t.reshape((self.b, self.s) + rest), 1, self.ctx,
                        "sp")
        return _data_gather(t, self.ctx).reshape((self.n_groups, -1) + rest)

    def mine(self, t):
        rest = tuple(t.shape[2:])
        t = t.reshape((self.B, self.S) + rest)
        t = t[self.row0:self.row0 + self.b, self.col0:self.col0 + self.s]
        return t.reshape((self.b * self.s,) + rest)

    def sum(self, t):
        return spmd.reduce_out(t, self.ctx, spmd.DATA_AXES + ("sp",))


def _moe_op(h, layer, cfg: MoEConfig, ctx: spmd.MeshCtx):
    """The routed MLP on this rank's [b, s, D] block: (out, aux, z).  The
    router reads h as it is (its gradient is whole on every tp rank); the
    experts' column-parallel product reads it through Megatron's f, and
    their row-parallel product is summed over tp before the return
    all_to_all."""
    b, s, D = h.shape
    ep = ctx.size("ep")
    G = ep if ep > 1 and ctx.size("pp") == 1 else 1
    plane = _TokenPlane(ctx, b, s, G)
    C = expert_capacity(plane.group_tokens, cfg.n_experts,
                        cfg.expert_top_k, cfg.capacity_factor)
    x2 = h.reshape(b * s, D)
    r = route_topk(x2 @ layer["router"].to(cfg.dtype), cfg.expert_top_k, C,
                   plane)
    xe = torch.einsum("td,tec->ecd", spmd.reduce_grad(x2, ctx),
                      r.dispatch.to(x2.dtype))
    tp_sum = ((lambda y: spmd.reduce_out(y, ctx)) if ctx.size("tp") > 1
              else None)
    y = expert_ffn(xe, layer["w_in"].to(cfg.dtype),
                   layer["w_out"].to(cfg.dtype), gelu,
                   ep_group=ctx.groups["ep"] if ep > 1 else None,
                   tp_sum=tp_sum)
    out = torch.einsum("ecd,tec->td", y, r.combine.to(y.dtype))
    return out.reshape(b, s, D), r.aux_loss, r.z_loss


def _block(x, params: Params, l: int, cfg: MoEConfig, rope,
           shards: _Shards, positions=None):
    """One MoE block of layer l: GPT's attention half, then the routed
    MLP.  Returns (x, aux, z)."""
    ctx = shards.ctx
    layer = {k: shards.gather_layer(k, w)
             for k, w in gpt._layer(params, l).items()}
    q, k, v = gpt._qkv_proj(x, layer, cfg, rope, positions, ctx)
    x = gpt._attn_residual(x, gpt._attention_op(q, k, v, cfg, ctx), layer,
                           cfg, ctx)
    h2 = _norm(x, layer["mlp_norm"], layer.get("mlp_norm_b"), cfg.norm)
    m, aux, z = _moe_op(h2.to(cfg.dtype), layer, cfg, ctx)
    return x + m, aux, z


def _blocks(carry, params: Params, cfg: MoEConfig, rope, shards: _Shards,
            positions=None):
    """Every block of ``params``' stack over the (x, aux sum, z sum)
    carry, each under activation checkpointing with ``cfg.remat``."""
    x, aux, z = carry
    remat = cfg.remat and torch.is_grad_enabled()
    kw = gpt._remat_kwargs(cfg) if cfg.remat else {}
    for l in range(gpt._n_layers(params)):
        if remat:
            x, a, zl = checkpoint(_block, x, params, l, cfg, rope, shards,
                                  positions, use_reentrant=False,
                                  preserve_rng_state=False, **kw)
        else:
            x, a, zl = _block(x, params, l, cfg, rope, shards, positions)
        aux, z = aux + a, z + zl
    return x, aux, z


def _microbatches(cfg: MoEConfig, ctx: spmd.MeshCtx) -> int:
    return cfg.num_microbatches or ctx.size("pp")


def _pp_rows(x, ctx: spmd.MeshCtx, M: int):
    """Under pp with data ranks: from this rank's contiguous block of a
    batch leaf, its share of each of the reference's M global
    microbatches, microbatch-major (rows m·B/M + i·B/(M·data) + r)."""
    n = ctx.data_size
    if ctx.size("pp") == 1 or n == 1:
        return x
    g = _data_gather(x, ctx)
    B = g.shape[0]
    if B % (M * n):
        raise ValueError(f"a batch of {B} rows does not split into {M} "
                         f"microbatches over {n} data ranks")
    bm = B // (M * n)
    rest = tuple(g.shape[1:])
    return g.reshape((M, n, bm) + rest)[:, ctx.data_index].reshape(
        (M * bm,) + rest)


def _pp_unrows(x, ctx: spmd.MeshCtx, M: int):
    """The inverse of ``_pp_rows`` on an activation (differentiable):
    this rank's contiguous block again."""
    n = ctx.data_size
    if ctx.size("pp") == 1 or n == 1:
        return x
    g = _data_gather(x, ctx)
    b = g.shape[0] // n
    rest = tuple(g.shape[1:])
    whole = g.reshape((n, M, b // M) + rest).transpose(0, 1).reshape(
        (n * b,) + rest)
    i = ctx.data_index
    return whole[i * b:(i + 1) * b]


def _hidden(local: Params, tokens, cfg: MoEConfig, shards: _Shards):
    """The stack on this rank's block of the tokens (microbatch-major
    rows under pp): (final-normed hidden, aux, z), the aux losses the
    reference's means over the layers."""
    ctx = shards.ctx
    x, rope, positions = gpt._embed(local, tokens, cfg, shards)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    pp = ctx.size("pp")
    if pp == 1:
        x, aux, z = _blocks((x, zero, zero), local, cfg, rope, shards,
                            positions)
    else:
        # the (x, aux, z) triple rides the rotation as a tuple carry; the
        # aux losses are the mean over microbatches of each one's sum
        from ray_tpu_torch.parallel.pipeline import (merge_microbatches,
                                                     pipeline_apply,
                                                     split_microbatches)

        if cfg.n_layers % pp:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                             f"pp {pp}")
        M = _microbatches(cfg, ctx)
        zeros = torch.zeros((M,), dtype=torch.float32, device=x.device)

        def stage_fn(stage, carry):
            return _blocks(carry, stage, cfg, rope, shards, positions)

        x_mb, aux_mb, z_mb = pipeline_apply(
            stage_fn, local, (split_microbatches(x, M), zeros, zeros), ctx)
        x, aux, z = merge_microbatches(x_mb), aux_mb.mean(), z_mb.mean()
    x = _norm(x, local["final_norm"], local.get("final_norm_b"), cfg.norm)
    return x, aux / cfg.n_layers, z / cfg.n_layers


def apply(params: Params, tokens, cfg: MoEConfig, *,
          device: DeviceLike = None, mesh=None
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward: tokens [B, S] -> (logits [B, S, V] in cfg.dtype, {"aux",
    "z"} router losses).  Under a mesh the params are DTensors (and the
    tokens a DTensor laid out by ``shard_batch``, or global), the logits
    a DTensor laid out (batch, seq, vocab), the losses the global ones,
    the same on every rank."""
    shards = _Shards(cfg, mesh, device)
    ctx = shards.ctx
    local = shards.params(params)
    M = _microbatches(cfg, ctx)
    x, aux, z = _hidden(local, _pp_rows(shards.block(tokens), ctx, M), cfg,
                        shards)
    x = _pp_unrows(x, ctx, M)
    logits = (spmd.reduce_grad(x.to(cfg.dtype), ctx)
              @ shards.unembed(local))
    return (shards.wrap(logits, ("batch", "seq", "vocab")),
            {"aux": aux, "z": z})


def loss_fn(params: Params, batch: Dict[str, Any], cfg: MoEConfig, *,
            device: DeviceLike = None, mesh=None) -> torch.Tensor:
    """LM loss + the weighted router losses (``aux_loss_weight`` · aux +
    ``router_z_weight`` · z), a scalar f32 tensor: batch and mesh as
    ``gpt.loss_fn`` takes them."""
    shards = _Shards(cfg, mesh, device)
    return _loss(shards.params(params), batch, cfg, shards)


def _loss(local: Params, batch: Dict[str, Any], cfg: MoEConfig,
          shards: _Shards) -> torch.Tensor:
    """``loss_fn`` on this rank's shards: the global LM mean plus the
    router losses, the same on every rank."""
    ctx = shards.ctx
    M = _microbatches(cfg, ctx)
    inputs, targets, mask = (None if t is None else _pp_rows(t, ctx, M)
                             for t in gpt._batch_block(batch, shards))
    x, aux, z = _hidden(local, inputs, cfg, shards)
    lm = gpt._lm_loss(x, targets, mask, local, cfg, shards)
    return lm + cfg.aux_loss_weight * aux + cfg.router_z_weight * z
