"""Train and eval steps, on one device or over a mesh: the counterpart
of ``ray_tpu/models/training.py``.

The reference jits one program per step over a mesh (forward, backward,
gradient reduction, optimizer update) with the state donated.  Here the
step runs eagerly: ``gpt.loss_fn``'s backward goes through the
flash-attention backward kernels (K2, K3) and, with ``cfg.remat``,
recomputes each block's forward (K1 again); then a ``torch.optim``
optimizer updates the params IN PLACE, the port's form of
``donate=True``.  The optimizer's update is plain PyTorch, as XLA
computed the reference's: no TPU kernel is involved.

Over a mesh (``make_train_step(cfg, mesh)``) every rank runs the step on
its own shards: the params are DTensors laid out by ``param_shardings``
(the reference's logical-axis rules), the optimizer holds their local
shards, so AdamW's moments take their parameter's placement
(``opt_state_shardings``), and the step is ``gpt.loss_fn``'s mesh path
(see ``models/gpt.py``), whose gradients arrive already summed over the
data ranks; ``global_norm`` sums each leaf's squares over the axes it is
sharded on.  The step without a mesh is the same body on one rank, so a
mesh whose every axis is 1 runs the unsharded step's ops.

Each returned program runs through the program ledger
(``telemetry/device.py``) under the reference's names (``train.init_state``,
``train.step``, ``train.eval_step``): a step fed a new batch shape shows
there as a new signature with its cause.

"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.parallel.mesh import mesh_device
from ray_tpu_torch.parallel.sharding import (NamedSharding, PartitionSpec,
                                             _entry_axes, _tree_map,
                                             distribute, from_local,
                                             shard_tree, tree_shardings)
from ray_tpu_torch.telemetry import device as devtel

State = Dict[str, Any]
# builds the optimizer over the param leaves, in ``param_leaves`` order
OptimizerFactory = Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> OptimizerFactory:
    """``optax.adamw`` with its defaults (eps_root 0, bias correction,
    decoupled decay on EVERY leaf, as optax applies it with no mask):
    ``torch.optim.AdamW`` over all leaves in one group computes the same
    update."""
    def make(leaves: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(list(leaves), lr=learning_rate,
                                 betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    return make


def param_leaves(params: gpt.Params, prefix: str = ""
                 ) -> List[Tuple[str, torch.Tensor]]:
    """The param tree's leaves as (dotted key, tensor), in the tree's
    order: the order of the optimizer's parameter list."""
    out = []
    for name, val in params.items():
        key = f"{prefix}{name}"
        if isinstance(val, dict):
            out += param_leaves(val, key + ".")
        else:
            out.append((key, val))
    return out


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares over every
    tensor, in f32, on the tensors' device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


def param_shardings(cfg: gpt.GPTConfig, mesh):
    """Each param's NamedSharding under the reference's rules."""
    return tree_shardings(gpt.logical_axes(cfg), mesh)


def opt_state_shardings(tx, params_shape, p_shardings, mesh):
    """AdamW's state: the first and second moments take their param's
    sharding (the optimizer holds each rank's shards), the count is
    replicated.  ``tx`` and ``params_shape`` are the reference's
    arguments; the port's optimizers keep per-param state only."""
    return {"mu": p_shardings, "nu": p_shardings,
            "count": NamedSharding(mesh, PartitionSpec())}


def init_sharded(seed: int, cfg: gpt.GPTConfig, mesh):
    """Params drawn from ``seed`` and placed on the mesh: every rank draws
    the whole tree on its card (the same numbers) and keeps its shards,
    where the reference materializes only each device's shard."""
    return shard_tree(gpt.init(cfg, seed=seed, device=mesh_device(mesh)),
                      gpt.logical_axes(cfg), mesh)


def shard_batch(batch: Dict[str, Any], mesh):
    """Place a host batch onto the mesh: batch over ``("dp", "fsdp",
    "ep")``, the rest whole (the reference's ``P(data, None)``); every
    rank passes the same global batch.  ``batch_sharding`` also splits
    the sequence over sp."""
    dev = mesh_device(mesh)
    sh = NamedSharding(mesh, PartitionSpec(("dp", "fsdp", "ep"), None))
    return {k: distribute(torch.as_tensor(v, device=dev), sh)
            for k, v in batch.items()}


def _sharded_global_norm(grads: Sequence[torch.Tensor], specs,
                         ctx) -> torch.Tensor:
    """``global_norm`` of this rank's shards: each leaf's squares summed
    over the axes it is sharded on (``specs`` None: no mesh)."""
    used = [{a for e in spec for a in _entry_axes(e)
             if ctx.size(a) > 1} for spec in specs] if specs else []
    if not any(used):
        return global_norm(grads)
    sq = []
    for g, axes in zip(grads, used):
        s = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        sq.append(spmd.all_sum(s, ctx, sorted(axes)) if axes else s)
    return torch.stack(sq).sum().sqrt()


def _local_leaf(w, sh: NamedSharding, cfg: gpt.GPTConfig,
                dev: torch.device) -> torch.Tensor:
    """This rank's shard of a global param (a tensor, an array, or a
    DTensor), a leaf of its own memory that requires grad."""
    from torch.distributed.tensor import DTensor

    if isinstance(w, DTensor):
        local = w.redistribute(sh.mesh, sh.placements).to_local()
    else:
        w = torch.as_tensor(w)
        local = w[sh.local_slices(w.shape)]
    return local.detach().to(device=dev, dtype=cfg.param_dtype,
                             copy=True).contiguous().requires_grad_()


def make_train_step(cfg: gpt.GPTConfig, mesh=None,
                    tx: Optional[OptimizerFactory] = None, *,
                    device: DeviceLike = None
                    ) -> Tuple[Callable[..., State], Callable]:
    """Returns (init_state, step) on one device.

    state = {"params", "opt_state", "step"}: the param tree (leaves that
    require grad), the optimizer built by ``tx`` (default
    ``adamw(3e-4, weight_decay=0.1)``, the reference's default) and the
    count of steps taken (an int tensor on the device).

    ``init_state(seed=0, params=None)`` draws params with ``gpt.init`` or
    takes a copy of ``params`` (e.g. from ``convert.from_jax_params``).
    ``step(state, batch) -> (state, {"loss", "grad_norm"})``: batch as
    ``gpt.loss_fn`` takes it; the metrics are f32 tensors on the device,
    and nothing in the step waits for the device.  The step updates the
    params, the optimizer state and the count IN PLACE and returns the
    same state dict.

    With ``mesh`` (a DeviceMesh, ``parallel.make_mesh``) every rank calls
    both: ``init_state`` takes this rank's shards of the drawn (or given,
    global) params; the state's "params" are DTensors over those shards,
    "shards" the local tensors the optimizer updates; ``step`` takes a
    batch laid out by ``shard_batch`` (or the global batch) and returns
    the global loss and grad norm, the same on every rank.  The device is
    the mesh's (``device`` must be None)."""
    tx = adamw(3e-4, weight_decay=0.1) if tx is None else tx
    if mesh is not None and device is not None:
        raise ValueError("a mesh step runs on the mesh's device; pass no "
                         "device")
    shards = gpt._Shards(cfg, mesh, device)
    dev = shards.device
    specs = None
    if mesh is not None:
        specs = [s for _, s in param_leaves(shards.specs)]
        shardings = param_shardings(cfg, mesh)

    def init_state(seed: int = 0,
                   params: Optional[gpt.Params] = None) -> State:
        if params is None:
            params = gpt.init(cfg, seed=seed, device=dev)
        if mesh is None:
            local = _as_leaves(params, cfg, dev)
        else:
            local = _tree_map(lambda w, sh: _local_leaf(w, sh, cfg, dev),
                              params, shardings)
        state = {"params": local,
                 "opt_state": tx([t for _, t in param_leaves(local)]),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if mesh is not None:
            # DTensors over the shards' memory: the optimizer's in-place
            # updates show through them
            state["params"] = _tree_map(
                lambda t, sh: from_local(t.detach(), sh), local, shardings)
            state["shards"] = local
        return state

    def step(state: State, batch: Dict[str, Any]):
        local = state["shards"] if mesh is not None else state["params"]
        opt = state["opt_state"]
        leaves = [t for _, t in param_leaves(local)]
        opt.zero_grad(set_to_none=True)
        loss = gpt._loss(shards.params(local), batch, cfg, shards)
        loss.backward()
        gnorm = _sharded_global_norm([t.grad for t in leaves], specs,
                                     shards.ctx)
        opt.step()
        state["step"].add_(1)
        return state, {"loss": loss.detach().float(), "grad_norm": gnorm}

    return (devtel.instrument(init_state, name="train.init_state"),
            devtel.instrument(step, name="train.step"))


def _as_leaves(params: gpt.Params, cfg: gpt.GPTConfig,
               dev: torch.device) -> gpt.Params:
    """A copy of the tree on ``dev`` in ``cfg.param_dtype``, each leaf a
    tensor that requires grad."""
    return {k: (_as_leaves(v, cfg, dev) if isinstance(v, dict) else
                v.detach().to(device=dev, dtype=cfg.param_dtype,
                              copy=True).requires_grad_())
            for k, v in params.items()}


def make_eval_step(cfg: gpt.GPTConfig, mesh=None, *,
                   device: DeviceLike = None) -> Callable:
    """Returns ``eval_step(params, batch) -> loss``: ``gpt.loss_fn`` with
    no graph recorded (the reference's ``make_eval_step``); over a mesh
    the params are DTensors (a train state's "params")."""
    shards = gpt._Shards(cfg, mesh, device)

    @torch.no_grad()
    def eval_step(params: gpt.Params, batch: Dict[str, Any]) -> torch.Tensor:
        return gpt._loss(shards.params(params), batch, cfg, shards)

    return devtel.instrument(eval_step, name="train.eval_step")
