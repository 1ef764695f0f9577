"""Parameter bridge from the JAX reference to the port.

``from_jax_params`` takes the reference's GPT param tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the port's
dict, key for key and shape for shape, so both packages compute the
same function.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt import GPTConfig, param_shapes


def from_jax_params(tree: Dict[str, Any], cfg: GPTConfig, *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Numpy param tree of ``ray_tpu.models.gpt.init`` -> port params in
    ``cfg.param_dtype`` on ``device``.  Raises on a missing, extra or
    misshapen leaf."""
    dev = resolve_device(device)

    def convert(sub: Dict[str, Any], shapes: Dict[str, Any], path: str):
        if set(sub) != set(shapes):
            raise ValueError(
                f"{path or 'params'}: keys {sorted(sub)} != expected "
                f"{sorted(shapes)}")
        out = {}
        for name, want in shapes.items():
            key = f"{path}.{name}" if path else name
            if isinstance(want, dict):
                out[name] = convert(sub[name], want, key)
                continue
            arr = np.asarray(sub[name], dtype=np.float32)
            if arr.shape != tuple(want):
                raise ValueError(f"{key}: shape {arr.shape} != {want}")
            out[name] = torch.from_numpy(arr.copy()).to(
                device=dev, dtype=cfg.param_dtype)
        return out

    return convert(tree, param_shapes(cfg), "")
