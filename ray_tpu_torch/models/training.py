"""Single-device train step: the counterpart of
``ray_tpu/models/training.py`` on one GPU.

The reference jits one program per step over a mesh (forward, backward,
gradient reduction, optimizer update) with the state donated.  Here the
step runs eagerly on one device: ``gpt.loss_fn``'s backward goes through
the flash-attention backward kernels (K2, K3) and, with ``cfg.remat``,
recomputes each block's forward (K1 again); then a ``torch.optim``
optimizer updates the params IN PLACE, the port's form of
``donate=True``.  The optimizer's update is plain PyTorch, as XLA
computed the reference's: no TPU kernel is involved.

Each returned program runs through the program ledger
(``telemetry/device.py``) under the reference's names (``train.init_state``,
``train.step``, ``train.eval_step``): a step fed a new batch shape shows
there as a new signature with its cause.

Meshes (``init_sharded``, ``param_shardings``, ``opt_state_shardings``,
``shard_batch``) are not ported: passing ``mesh`` raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("meshes are not ported; run on one device")


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
    same state dict."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    tx = adamw(3e-4, weight_decay=0.1) if tx is None else tx

    def init_state(seed: int = 0,
                   params: Optional[gpt.Params] = None) -> State:
        if params is None:
            params = gpt.init(cfg, seed=seed, device=dev)
        params = _as_leaves(params, cfg, dev)
        return {"params": params,
                "opt_state": tx([t for _, t in param_leaves(params)]),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(state: State, batch: Dict[str, Any]):
        params, opt = state["params"], state["opt_state"]
        leaves = [t for _, t in param_leaves(params)]
        opt.zero_grad(set_to_none=True)
        loss = gpt.loss_fn(params, batch, cfg, device=dev)
        loss.backward()
        gnorm = global_norm([t.grad for t in leaves])
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
    no graph recorded (the reference's ``make_eval_step``)."""
    _no_mesh(mesh)
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(params: gpt.Params, batch: Dict[str, Any]) -> torch.Tensor:
        return gpt.loss_fn(params, batch, cfg, device=dev)

    return devtel.instrument(eval_step, name="train.eval_step")
