"""ray_tpu_torch.dag: lazily-bound DAGs + compiled multi-actor graphs.

Reference: python/ray/dag/ (2.4k LoC compiled_dag_node.py) +
experimental/channel/.  The port's copy of ``ray_tpu/dag``: ``.bind`` and
interpreted ``execute`` (``dag_node``), ``experimental_compile()``'s
per-actor exec loops (``compiled_dag``) over shared-memory ring channels
that carry CUDA tensors as raw bytes (``channel``), and the allreduce
inside a compiled graph (``collective``).  Importing it loads no torch.
"""

from .channel import Channel, ChannelClosed, ChannelTimeout
from .collective import allreduce_bind
from .compiled_dag import CompiledDAG, CompiledDAGRef
from .dag_node import (ClassMethodNode, CollectiveOutputNode, DAGNode,
                       FunctionNode, InputNode, MultiOutputNode)

__all__ = [
    "Channel", "ChannelClosed", "ChannelTimeout", "ClassMethodNode",
    "CollectiveOutputNode", "CompiledDAG", "CompiledDAGRef", "DAGNode",
    "FunctionNode", "InputNode", "MultiOutputNode", "allreduce_bind",
]
