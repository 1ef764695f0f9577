"""TorchTrainer + torch train-loop utilities.

Reference parity: python/ray/train/torch/ — ``TorchTrainer``
(torch_trainer.py) is a DataParallelTrainer whose backend sets up
torch.distributed; ``prepare_model`` / ``prepare_data_loader``
(train_loop_utils.py) wrap the user's model in DDP and the loader in a
DistributedSampler.

The port's copy of ``ray_tpu/train/torch.py``, where a worker that holds
a GPU lease computes on a card: ``get_device()`` is ``cuda:<local
rank>`` there (a GPU worker sees every card the raylet sees, so the
local rank picks one; ``CUDA_VISIBLE_DEVICES`` does not scope it) and
the CPU elsewhere; ``prepare_model`` puts the model on that card and
passes it to DDP as ``device_ids``.  Both raise on a GPU worker that
finds no card; neither falls back to the CPU.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

from .backend import TorchConfig
from .trainer import JaxTrainer

__all__ = ["TorchTrainer", "TorchConfig", "prepare_model",
           "prepare_data_loader", "get_device"]


class TorchTrainer(JaxTrainer):
    """Data-parallel torch training on the cluster (reference:
    train/torch/torch_trainer.py).

    Same orchestration as JaxTrainer (BackendExecutor -> WorkerGroup ->
    per-worker train loop with session.report), with the torch process
    group as the backend::

        def train_loop(config):
            model = prepare_model(Net())
            for epoch in range(3):
                ...
                session.report({"loss": loss.item()})

        TorchTrainer(train_loop,
                     scaling_config=ScalingConfig(num_workers=2)).fit()
    """

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 **kwargs):
        kwargs.setdefault("backend_config", torch_config or TorchConfig())
        super().__init__(train_loop_per_worker,
                         train_loop_config=train_loop_config, **kwargs)


def get_device():
    """``cuda:<local rank>`` on a worker that holds a GPU lease (modulo the
    cards it sees, so fractional leases share a card), the CPU on any
    other process."""
    import torch

    if os.environ.get("RAY_TPU_TORCH_WORKER_GPU") != "1":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"worker pid {os.getpid()} holds a GPU lease but CUDA finds no "
            f"card; refusing to run on the CPU")
    from .session import get_context

    local = get_context().get_local_rank()
    return torch.device("cuda", local % torch.cuda.device_count())


def prepare_model(model, *, ddp_kwargs: Optional[Dict[str, Any]] = None):
    """Move to the worker's card (on a GPU worker) and wrap in
    DistributedDataParallel when a process group is up (reference:
    train_loop_utils.py prepare_model)."""
    import torch.distributed as dist

    device = get_device()
    if device.type == "cuda":
        model = model.to(device)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        kw = dict(ddp_kwargs or {})
        if device.type == "cuda":
            kw.setdefault("device_ids", [device.index])
        return DistributedDataParallel(model, **kw)
    return model


def prepare_data_loader(data_loader):
    """Re-build the loader with a DistributedSampler so each rank sees
    its shard (reference: train_loop_utils.py prepare_data_loader)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    sampler = DistributedSampler(data_loader.dataset,
                                 num_replicas=dist.get_world_size(),
                                 rank=dist.get_rank())
    return DataLoader(data_loader.dataset,
                      batch_size=data_loader.batch_size,
                      sampler=sampler,
                      num_workers=0,
                      collate_fn=data_loader.collate_fn,
                      drop_last=data_loader.drop_last)


def get_world_rank() -> int:
    return int(os.environ.get("RAY_TPU_TORCH_TRAIN_WORLD_RANK", "0"))


def get_world_size() -> int:
    return int(os.environ.get("RAY_TPU_TORCH_TRAIN_WORLD_SIZE", "1"))
