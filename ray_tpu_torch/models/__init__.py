"""Models of the port (see ray_tpu/models)."""

from . import gpt, moe, resnet, training
from .gpt import GPTConfig
from .moe import MoEConfig
from .resnet import ResNetConfig
from .training import (init_sharded, make_eval_step, make_train_step,
                       shard_batch)

__all__ = [
    "gpt", "moe", "resnet", "training", "GPTConfig", "MoEConfig",
    "ResNetConfig", "make_train_step", "make_eval_step", "init_sharded",
    "shard_batch",
]
