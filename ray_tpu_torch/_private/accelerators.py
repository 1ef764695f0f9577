"""GPU detection and visibility for the port's runtime.

The port's counterpart of ``ray_tpu/_private/accelerators.py`` (the
reference counts TPU chips by ``/dev/accel*`` and scopes a worker to its
chips with ``TPU_VISIBLE_CHIPS``; Ray's own GPU manager is
``python/ray/_private/accelerators/nvidia_gpu.py``).  Nothing here
imports torch: the raylet counts cards from the device nodes the NVIDIA
driver creates, one ``/dev/nvidia<N>`` per card (those this process may
open: a container can show nodes its device cgroup denies), so a daemon
never pays for a CUDA context or for torch's import.

``RAY_TPU_TORCH_NUM_GPUS`` overrides the count (as ``RAY_TPU_NUM_CHIPS``
does in the reference) and ``RAY_TPU_TORCH_GPU_DEVICES`` the device-node
list (comma-separated paths: tests and unusual layouts).  The TPU-only
parts of the reference (GCE metadata, pod-slice labels and per-pod
resources) have no single-host GPU counterpart and are left out.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Tuple

_CARD_NODE = re.compile(r"^/dev/nvidia(\d+)$")


def card_nodes(paths: List[str]) -> List[int]:
    """Card indices among device-node paths (``/dev/nvidia<N>``)."""
    return [int(m.group(1)) for m in map(_CARD_NODE.match, paths) if m]


def gpu_device_paths() -> List[str]:
    """Host device nodes a GPU container must be granted: every
    ``/dev/nvidia<N>`` card node, the control node ``/dev/nvidiactl`` and
    the unified-memory nodes ``/dev/nvidia-uvm*``."""
    env = os.environ.get("RAY_TPU_TORCH_GPU_DEVICES")
    if env is not None:
        return [p for p in env.split(",") if p]
    cards = sorted((p for p in glob.glob("/dev/nvidia*")
                    if _CARD_NODE.match(p)),
                   key=lambda p: int(_CARD_NODE.match(p).group(1)))
    extra = [p for p in ["/dev/nvidiactl"] if os.path.exists(p)]
    return cards + extra + sorted(glob.glob("/dev/nvidia-uvm*"))


def _openable(path: str) -> bool:
    """A card node this process may open.  A container can show nodes of
    cards its device cgroup denies (open fails with EPERM): CUDA skips
    those cards, and so does the count."""
    try:
        os.close(os.open(path, os.O_RDWR | os.O_CLOEXEC))
        return True
    except OSError:
        return False


def _usable_cards() -> List[int]:
    paths = gpu_device_paths()
    if os.environ.get("RAY_TPU_TORCH_GPU_DEVICES") is None:
        paths = [p for p in paths if not _CARD_NODE.match(p)
                 or _openable(p)]
    return card_nodes(paths)


def num_gpus() -> int:
    """Cards this host offers the runtime: the card nodes this process may
    open, restricted by ``CUDA_VISIBLE_DEVICES`` when it is set (an empty
    value hides every card), or the ``RAY_TPU_TORCH_NUM_GPUS`` override."""
    env = os.environ.get("RAY_TPU_TORCH_NUM_GPUS")
    if env:
        return int(env)
    cards = _usable_cards()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return len(cards)
    ids = [v.strip() for v in visible.split(",") if v.strip()]
    n = 0
    for v in ids:
        # CUDA stops at the first index the driver does not know
        # (GPU-<uuid> / MIG-<uuid> entries name one card each)
        if v.isdigit() and int(v) >= len(cards):
            break
        n += 1
    return min(n, len(cards))


def default_resources() -> Dict[str, float]:
    res: Dict[str, float] = {"CPU": float(os.cpu_count() or 1)}
    gpus = num_gpus()
    if gpus:
        res["GPU"] = float(gpus)
    return res


def visible_chip_env(assigned: Tuple[int, ...]) -> Dict[str, str]:
    """Env confining a worker to its assigned cards (Ray's
    ``CUDA_VISIBLE_DEVICES`` scoping, nvidia_gpu.py); an empty tuple hides
    every card."""
    return {"CUDA_VISIBLE_DEVICES": ",".join(str(c) for c in assigned)}


#: host env a GPU container needs forwarded (the container runtime does
#: not inherit its client's environment)
_GPU_FORWARD_ENV = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                    "NVIDIA_DRIVER_CAPABILITIES", "CUDA_DEVICE_ORDER")


def gpu_container_env() -> Dict[str, str]:
    """Env to forward into a GPU actor's container.  An empty
    ``CUDA_VISIBLE_DEVICES`` inherited from a host process pinned off the
    cards must not pin the actor's container off them too (the silent
    fallback while holding the lease); then every host card is made
    visible."""
    out = {k: os.environ[k] for k in _GPU_FORWARD_ENV if k in os.environ}
    if not out.get("CUDA_VISIBLE_DEVICES", "").strip():
        out.pop("CUDA_VISIBLE_DEVICES", None)
        cards = _usable_cards()
        if cards:
            out.update(visible_chip_env(tuple(range(len(cards)))))
    return out
