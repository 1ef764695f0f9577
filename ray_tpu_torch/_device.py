"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  With no device given and no GPU present this raises:
    the port never drops to the CPU without being asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def check_params_on(params: Dict[str, Any], device: torch.device) -> None:
    """Raise unless the model params lie on ``device``."""
    where = params["embed"].device
    if where.type != device.type:
        raise ValueError(f"params are on {where}, expected device {device}")
