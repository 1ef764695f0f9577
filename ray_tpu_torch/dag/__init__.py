"""Lazily-bound DAGs over the port's runtime: ``.bind`` and interpreted
``execute`` (``dag_node``, the copy of ``ray_tpu/dag/dag_node.py``).
Compiled graphs and their channels come with ROADMAP A.4c."""

from .dag_node import (ClassMethodNode, DAGNode, FunctionNode, InputNode,
                       MultiOutputNode)

__all__ = ["ClassMethodNode", "DAGNode", "FunctionNode", "InputNode",
           "MultiOutputNode"]
