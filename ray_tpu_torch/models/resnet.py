"""ResNet-50, the vision model.  Counterpart of
``ray_tpu/models/resnet.py``.

A plain-function param tree like ``models/gpt.py``: ``init`` returns
``(params, state)``, the batch-norm running statistics in their own
tree, and ``apply(params, state, images) -> (logits, new_state)``.
Images and activations are NHWC at the interface and conv kernels HWIO,
as in the reference; inside, the convolutions are ``F.conv2d`` (cuDNN on
the card, as the reference's are XLA convolutions outside any Pallas
kernel) on the same memory seen as channels-last NCHW.

Two of XLA's semantics are kept exactly:

  * ``"SAME"`` padding is asymmetric: a total pad of
    max((ceil(n/s) - 1)·s + k - n, 0) splits low = total // 2, high =
    the rest (the 7x7 stride-2 stem on 224 pads (2, 3), every 3x3
    stride-2 conv and the 3x3 stride-2 max pool (0, 1)); torch's
    symmetric ``padding=`` would shift every window, so each input is
    padded explicitly (the pool's with -inf);
  * batch norm is synchronised over the global batch: under a mesh the
    mean and then the population variance (the mean of (x - mean)^2,
    ``jnp.var``) are sums over every data rank's rows, and each rank's
    gradient reaches the statistics of all of them; the running
    statistics follow momentum·s + (1 - momentum)·batch.

The pooled features and the head run in f32.  Over a mesh the batch
splits over the data axes (dp, fsdp, ep); the model axes (pp, sp, tp)
must be 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.sharding import Logical

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @classmethod
    def resnet18(cls, **kw):
        return cls(stage_sizes=(2, 2, 2, 2), **kw)

    @classmethod
    def resnet50(cls, **kw):
        return cls(stage_sizes=(3, 4, 6, 3), **kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests: 2 stages, narrow."""
        kw.setdefault("num_classes", 10)
        return cls(stage_sizes=(1, 1), width=8, **kw)


def _blocks(cfg: ResNetConfig):
    """(name, cin, cmid, cout, stride) of every bottleneck block."""
    out, cin = [], cfg.width
    for si, nblocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** si)
        for bi in range(nblocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            out.append((f"s{si}b{bi}", cin, cmid, cmid * 4, stride))
            cin = cmid * 4
    return out


def param_shapes(cfg: ResNetConfig) -> Dict[str, Any]:
    """The param tree's shapes, key for key with the reference's init."""
    def bn(c):
        return {"scale": (c,), "bias": (c,)}

    out: Dict[str, Any] = {"stem_conv": (7, 7, 3, cfg.width),
                           "stem_bn": bn(cfg.width)}
    for name, cin, cmid, cout, stride in _blocks(cfg):
        blk = {"conv1": (1, 1, cin, cmid), "bn1": bn(cmid),
               "conv2": (3, 3, cmid, cmid), "bn2": bn(cmid),
               "conv3": (1, 1, cmid, cout), "bn3": bn(cout)}
        if cin != cout or stride != 1:
            blk.update(proj=(1, 1, cin, cout), proj_bn=bn(cout))
        out[name] = blk
    cin = _blocks(cfg)[-1][3]
    out["head"] = {"w": (cin, cfg.num_classes), "b": (cfg.num_classes,)}
    return out


def state_shapes(cfg: ResNetConfig) -> Dict[str, Any]:
    """The batch-norm state's shapes (running mean and variance)."""
    def bn(c):
        return {"mean": (c,), "var": (c,)}

    out: Dict[str, Any] = {"stem_bn": bn(cfg.width)}
    for name, cin, cmid, cout, stride in _blocks(cfg):
        st = {"bn1": bn(cmid), "bn2": bn(cmid), "bn3": bn(cout)}
        if cin != cout or stride != 1:
            st["proj_bn"] = bn(cout)
        out[name] = st
    return out


def init(cfg: ResNetConfig, *, seed: int = 0,
         generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Tuple[Params, Params]:
    """(params, state) on ``device`` by the reference's recipe: He-normal
    convs (std sqrt(2 / fan_in)), unit scales, zero biases, the head
    N(0, 0.01²); running means 0 and variances 1 (f32)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    pd = cfg.param_dtype

    def draw(shape):
        if len(shape) == 4:
            std = math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
        else:
            std = 0.01
        return torch.randn(shape, generator=generator, dtype=pd,
                           device=dev) * std

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "scale":
                out[k] = torch.ones(v, dtype=pd, device=dev)
            elif k in ("bias", "b"):
                out[k] = torch.zeros(v, dtype=pd, device=dev)
            else:
                out[k] = draw(v)
        return out

    def stats(tree):
        return {k: (stats(v) if isinstance(v, dict) else
                    (torch.zeros if k == "mean" else torch.ones)(
                        v, dtype=torch.float32, device=dev))
                for k, v in tree.items()}

    return fill(param_shapes(cfg)), stats(state_shapes(cfg))


def logical_axes(cfg: ResNetConfig, params: Optional[Params] = None) -> Any:
    """Conv kernels shard their output channels over fsdp (ZeRO); the
    head's classes over tp; batch-norm and biases replicate (the
    reference's rule by rank; ``params`` is accepted as the reference
    takes it, the shapes come from ``cfg``)."""
    def annotate(v):
        if isinstance(v, dict):
            return {k: annotate(x) for k, x in v.items()}
        if len(v) == 4:
            return Logical(None, None, None, "conv_out")
        if len(v) == 2:
            return Logical("embed", "vocab")
        return Logical(*([None] * len(v)))

    return annotate(param_shapes(cfg))


# ---------------------------------------------------------------------------
# The layers (activations channels-last NCHW: an NHWC tensor's memory)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of a side of n for a window k, stride s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    (hl, hh), (wl, wh) = (_same_pads(x.shape[2], k, s),
                          _same_pads(x.shape[3], k, s))
    if hl or hh or wl or wh:
        x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x


def _conv(x, w, stride: int = 1):
    """x [N, C, H, W], w [kh, kw, cin, cout] (HWIO), "SAME" padding."""
    x = _pad_same(x, w.shape[0], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride)


def _max_pool(x):
    """``reduce_window(max, (3, 3), (2, 2), "SAME")``, padded with -inf."""
    return F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)


class _Region:
    """A rank's view of the model: its place on the mesh and the device.
    Without a mesh, one rank on ``device``."""

    def __init__(self, mesh=None, device: DeviceLike = None):
        self.mesh = mesh
        self.ctx = spmd.MeshCtx.of(mesh)
        if mesh is None:
            self.device = resolve_device(device)
            return
        from ray_tpu_torch.parallel.mesh import mesh_device

        if device is not None:
            raise ValueError("a mesh computes on the mesh's device; pass "
                             "no device")
        model = [a for a in ("pp", "sp", "tp") if self.ctx.size(a) > 1]
        if model:
            raise ValueError(f"ResNet runs over the data axes only; the "
                             f"mesh's {model} axes are > 1")
        self.device = mesh_device(mesh)

    def global_sum(self, t):
        """The sum of ``t`` over the data ranks, each rank's gradient the
        sum over all of them (synchronised batch norm)."""
        t = spmd.reduce_out(t, self.ctx, spmd.DATA_AXES)
        return spmd.reduce_grad(t, self.ctx, spmd.DATA_AXES)

    def params(self, params: Params) -> Params:
        """This rank's whole params: a DTensor leaf's local shard gathered
        over fsdp on use, each leaf's gradient summed over the data ranks
        that hold it whole."""
        if self.mesh is None:
            where = params["stem_conv"].device
            if where.type != self.device.type:
                raise ValueError(f"params are on {where}, expected device "
                                 f"{self.device}")
            return params
        from torch.distributed.tensor import DTensor

        def one(w):
            if isinstance(w, dict):
                return {k: one(v) for k, v in w.items()}
            if not isinstance(w, DTensor):
                w = torch.as_tensor(w, device=self.device)
                return spmd.reduce_grad(w, self.ctx, spmd.DATA_AXES)
            names = tuple(w.device_mesh.mesh_dim_names)
            dims = {a: p.dim for a, p in zip(names, w.placements)
                    if p.is_shard() and self.ctx.size(a) > 1}
            local = spmd.reduce_grad(
                w.to_local(), self.ctx,
                [a for a in spmd.DATA_AXES if a not in dims])
            for a in reversed(spmd.DATA_AXES):
                if a in dims:
                    local = spmd.gather(local, dims[a], self.ctx, a)
            return local

        return one(params)

    def rows(self, x):
        """This rank's rows of a batch leaf (a DTensor is laid out batch
        over the data axes first; anything else is the global batch)."""
        from torch.distributed.tensor import DTensor

        if self.mesh is None:
            return torch.as_tensor(x, device=self.device)
        from ray_tpu_torch.parallel.sharding import (NamedSharding,
                                                     PartitionSpec)

        if isinstance(x, DTensor):
            sh = NamedSharding(self.mesh, PartitionSpec(spmd.DATA_AXES))
            return x.redistribute(self.mesh, sh.placements).to_local()
        x = torch.as_tensor(x, device=self.device)
        n = self.ctx.data_size
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not "
                             f"divide over {n} data ranks")
        blk, i = x.shape[0] // n, self.ctx.data_index
        return x[i * blk:(i + 1) * blk]

    def wrap(self, local):
        if self.mesh is None:
            return local
        from ray_tpu_torch.parallel.sharding import (NamedSharding,
                                                     PartitionSpec,
                                                     from_local)

        return from_local(local, NamedSharding(
            self.mesh, PartitionSpec(spmd.DATA_AXES)))

    def rows_total(self, n_local: int) -> int:
        return n_local * self.ctx.data_size


def _batch_norm(x, p, s, training: bool, cfg: ResNetConfig,
                region: _Region):
    x32 = x.float()
    if training:
        n = region.rows_total(x32.numel() // x32.shape[1])
        mean = region.global_sum(x32.sum(dim=(0, 2, 3))) / n
        c = x32 - mean[None, :, None, None]
        var = region.global_sum(c.square().sum(dim=(0, 2, 3))) / n
        m = cfg.bn_momentum
        with torch.no_grad():
            new_s = {"mean": m * s["mean"] + (1 - m) * mean,
                     "var": m * s["var"] + (1 - m) * var}
    else:
        mean, var = s["mean"], s["var"]
        c = x32 - mean[None, :, None, None]
        new_s = s
    y = c * torch.rsqrt(var + cfg.bn_eps)[None, :, None, None]
    y = (y * p["scale"].float()[None, :, None, None]
         + p["bias"].float()[None, :, None, None])
    return y.to(x.dtype), new_s


def _forward(params: Params, state: Params, images, cfg: ResNetConfig,
             training: bool, region: _Region):
    """This rank's images [n, H, W, 3] -> (logits [n, classes] f32, new
    state)."""
    x = torch.as_tensor(images, device=region.device).to(cfg.dtype)
    x = x.permute(0, 3, 1, 2)
    new_state: Params = {}

    def bn(y, p, s):
        return _batch_norm(y, p, s, training, cfg, region)

    x, new_state["stem_bn"] = bn(_conv(x, params["stem_conv"], 2),
                                 params["stem_bn"], state["stem_bn"])
    x = _max_pool(torch.relu(x))
    for name, _, _, _, stride in _blocks(cfg):
        blk, st = params[name], state[name]
        ns: Params = {}
        residual = x
        y, ns["bn1"] = bn(_conv(x, blk["conv1"]), blk["bn1"], st["bn1"])
        y, ns["bn2"] = bn(_conv(torch.relu(y), blk["conv2"], stride),
                          blk["bn2"], st["bn2"])
        y, ns["bn3"] = bn(_conv(torch.relu(y), blk["conv3"]), blk["bn3"],
                          st["bn3"])
        if "proj" in blk:
            residual, ns["proj_bn"] = bn(_conv(x, blk["proj"], stride),
                                         blk["proj_bn"], st["proj_bn"])
        x = torch.relu(y + residual)
        new_state[name] = ns
    x = x.float().mean(dim=(2, 3))
    head = params["head"]
    return x @ head["w"].float() + head["b"].float(), new_state


def apply(params: Params, state: Params, images, cfg: ResNetConfig,
          training: bool = False, *, device: DeviceLike = None, mesh=None):
    """images [B, H, W, 3] -> (logits [B, classes] f32, new_state).  Under
    a mesh (data axes only) the params may be DTensors, the images a
    DTensor laid out batch over the data axes or the global batch; the
    logits are a DTensor of that layout and the new state the global
    batch's, the same on every rank."""
    region = _Region(mesh, device)
    logits, new_state = _forward(region.params(params), state,
                                 region.rows(images), cfg, training, region)
    return region.wrap(logits), new_state


def loss_fn(params: Params, state: Params, batch: Dict[str, Any],
            cfg: ResNetConfig, training: bool = True, *,
            device: DeviceLike = None, mesh=None):
    """Mean softmax cross-entropy over the global batch: (loss,
    (new_state, {"loss", "accuracy"})), the reference's aux layout."""
    region = _Region(mesh, device)
    logits, new_state = _forward(region.params(params), state,
                                 region.rows(batch["image"]), cfg,
                                 training, region)
    labels = region.rows(batch["label"]).to(torch.long)
    nll = -torch.log_softmax(logits, dim=-1).gather(
        1, labels[:, None])[:, 0]
    n = region.rows_total(labels.shape[0])
    loss = spmd.reduce_out(nll.sum(), region.ctx, spmd.DATA_AXES) / n
    hits = (logits.argmax(-1) == labels).float().sum()
    acc = spmd.all_sum(hits, region.ctx, spmd.DATA_AXES) / n
    return loss, (new_state, {"loss": loss.detach(), "accuracy": acc})
