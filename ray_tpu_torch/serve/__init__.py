"""Serving for the port (see ray_tpu/serve): the continuous-batching
engine.  The Serve deployment layer needs the task/actor runtime and is
not ported yet."""

from ray_tpu_torch.serve._engine import (AdmissionRejected, ContinuousEngine,
                                         PageAllocator)

__all__ = ["AdmissionRejected", "ContinuousEngine", "PageAllocator"]
