"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model, serving and
collective path.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports).  Plain tensor math is PyTorch; every Pallas TPU kernel on the
ported path is a hand-written Hopper kernel under ``csrc/``, built at
first use and bound with ctypes (``ops/_kernels.py``).

Entry points take an explicit ``device`` and run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU and no explicit request they
raise rather than carry on silently on the CPU.

Layout mirrors ``ray_tpu``:
  * ``ops.layers`` / ``ops.attention`` — layer math and cross-entropy,
    attention + the flash-attention kernels' plain versions, their
    autograd ``Function`` and dispatcher;
  * ``models.gpt`` — GPT forward, loss, KV-cache decode, slot + paged
    caches;
  * ``models.training`` — the single-device train step (AdamW);
  * ``models.convert`` — the JAX parameter tree and AdamW state (numpy
    leaves) ↔ port;
  * ``serve._engine`` — the continuous-batching engine;
  * ``ops.quantize`` — block-wise int8 quantization (K4-K6's plain
    versions and dispatch);
  * ``collective`` — the group API over ``torch.distributed`` (store
    rendezvous, nccl/gloo), the rank-local collectives with their
    int8-compressed paths, the compression config and codec;
  * ``parallel.sharding`` — ``GradientSynchronizer``, the bucketed,
    error-feedback gradient sync of data-parallel training.
"""

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.training import (adamw, make_eval_step,
                                           make_train_step)

__all__ = ["adamw", "make_eval_step", "make_train_step", "resolve_device"]
