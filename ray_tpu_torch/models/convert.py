"""Weights and training state carried between the JAX reference and
the port.

``from_jax_params`` takes a reference param tree with numpy leaves
(``jax.tree.map(np.asarray, params)``) of GPT, the MoE model or ResNet
(which the config names) and returns the port's dict, key for key and
shape for shape, so both packages compute the same function;
``from_jax_state`` does the same for ResNet's batch-norm state, and
``to_numpy_params`` goes back.  ``from_optax_adamw_state``
carries the reference's AdamW state over, so a run resumed from a JAX
step continues as the JAX run would.  Nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.models.training import (OptimizerFactory, adamw,
                                           model_of, param_leaves)


def _param_shapes(cfg) -> Dict[str, Any]:
    from ray_tpu_torch.models import resnet

    if isinstance(cfg, resnet.ResNetConfig):
        return resnet.param_shapes(cfg)
    return model_of(cfg).param_shapes(cfg)


def from_jax_params(tree: Dict[str, Any], cfg, *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Numpy param tree of the reference's ``init`` for ``cfg``
    (``GPTConfig``, ``MoEConfig`` or ``ResNetConfig``; ResNet's params,
    the first of its ``init``'s pair) -> port params in
    ``cfg.param_dtype`` on ``device``.  Raises on a missing, extra or
    misshapen leaf."""
    return _convert(tree, _param_shapes(cfg), cfg.param_dtype,
                    resolve_device(device))


def from_jax_state(tree: Dict[str, Any], cfg, *,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """ResNet's batch-norm state (the second of the reference's
    ``init``'s pair, or a new state from its ``apply``) -> the port's,
    f32 on ``device``; raises as ``from_jax_params`` does."""
    from ray_tpu_torch.models import resnet

    return _convert(tree, resnet.state_shapes(cfg), torch.float32,
                    resolve_device(device))


def _convert(sub: Dict[str, Any], shapes: Dict[str, Any],
             dtype: torch.dtype, dev: torch.device, path: str = ""
             ) -> Dict[str, Any]:
    if set(sub) != set(shapes):
        raise ValueError(f"{path or 'params'}: keys {sorted(sub)} != "
                         f"expected {sorted(shapes)}")
    out = {}
    for name, want in shapes.items():
        key = f"{path}.{name}" if path else name
        if isinstance(want, dict):
            out[name] = _convert(sub[name], want, dtype, dev, key)
            continue
        arr = np.asarray(sub[name], dtype=np.float32)
        if arr.shape != tuple(want):
            raise ValueError(f"{key}: shape {arr.shape} != {want}")
        out[name] = torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)
    return out


def shard_jax_params(tree: Dict[str, Any], cfg: GPTConfig, mesh
                     ) -> Dict[str, Any]:
    """``from_jax_params`` onto the mesh's device, then each rank's shards
    as DTensors laid out by the reference's rules."""
    from ray_tpu_torch.parallel.mesh import mesh_device
    from ray_tpu_torch.parallel.sharding import shard_tree

    params = from_jax_params(tree, cfg, device=mesh_device(mesh))
    return shard_tree(params, model_of(cfg).logical_axes(cfg), mesh)


def to_numpy_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's param tree -> the same keys with f32 numpy leaves (the
    form ``jax.tree.map(np.asarray, params)`` gives the reference's); a
    DTensor leaf is gathered whole (``full_tensor()``)."""
    def leaf(v):
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        return v.detach().float().cpu().numpy()

    return {k: (to_numpy_params(v) if isinstance(v, dict) else leaf(v))
            for k, v in params.items()}


def from_optax_adamw_state(opt_state: Any, params: Dict[str, Any],
                           cfg: GPTConfig, *,
                           tx: Optional[OptimizerFactory] = None
                           ) -> torch.optim.Optimizer:
    """The reference's AdamW state -> the port's optimizer over
    ``params`` (the tree the train step updates, e.g. its
    ``state["params"]``).

    ``opt_state`` holds ``count`` (updates taken), ``mu`` and ``nu``
    (numpy trees keyed like the params): a mapping, or optax's
    ``ScaleByAdamState`` with numpy leaves (``opt_state[0]`` of
    ``optax.adamw``'s state).  ``tx`` builds the optimizer (default:
    ``adamw(3e-4, weight_decay=0.1)``, the train step's default); its
    first and second moments and step count are set from the state."""
    def get(name):
        return (opt_state[name] if isinstance(opt_state, Mapping)
                else getattr(opt_state, name))

    leaves = param_leaves(params)
    dev = leaves[0][1].device
    mu = dict(param_leaves(from_jax_params(get("mu"), cfg, device=dev)))
    nu = dict(param_leaves(from_jax_params(get("nu"), cfg, device=dev)))
    count = int(np.asarray(get("count")))
    tx = adamw(3e-4, weight_decay=0.1) if tx is None else tx
    opt = tx([t for _, t in leaves])
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": mu[key], "exp_avg_sq": nu[key]}
                   for i, (key, _) in enumerate(leaves)}
    opt.load_state_dict(sd)
    return opt
