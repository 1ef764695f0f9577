"""DAG node API: lazily-bound task graphs over actors.

Reference: python/ray/dag/ (dag_node.py, class_node.py, input_node.py) —
``actor.method.bind(x)`` builds a node; ``dag.execute(v)`` runs it
interpreted (one actor task per node per call); ``experimental_compile()``
returns a CompiledDAG with persistent per-actor exec loops over
shared-memory channels (compiled_dag.py).

The port's copy of ``ray_tpu/dag/dag_node.py``.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

_node_counter = itertools.count()


class DAGNode:
    def __init__(self):
        self._id = next(_node_counter)

    # -- graph walking ------------------------------------------------------

    def _upstream(self) -> List["DAGNode"]:
        return []

    def topo_sort(self) -> List["DAGNode"]:
        order: List[DAGNode] = []
        seen = set()

        def walk(n: "DAGNode"):
            if id(n) in seen:
                return
            seen.add(id(n))
            for u in n._upstream():
                walk(u)
            order.append(n)

        walk(self)
        return order

    # -- interpreted execution ---------------------------------------------

    def execute(self, *args, _timeout: Optional[float] = None):
        """Run the DAG once, interpreted: one actor task per node
        (reference: dag_node.py execute)."""
        values: Dict[int, Any] = {}
        for node in self.topo_sort():
            values[node._id] = node._exec_interpreted(values, args)
        return values[self._id]

    def _exec_interpreted(self, values: Dict[int, Any], args: Tuple) -> Any:
        raise NotImplementedError

    def experimental_compile(self, *, buffer_size_bytes: int = 1 << 20,
                             nslots: int = 4):
        from .compiled_dag import CompiledDAG

        return CompiledDAG(self, buffer_size_bytes=buffer_size_bytes,
                           nslots=nslots)


def _resolve(arg: Any, values: Dict[int, Any], input_args: Tuple) -> Any:
    if isinstance(arg, DAGNode):
        v = values[arg._id]
        return v
    return arg


class InputNode(DAGNode):
    """The DAG's runtime argument (reference: dag/input_node.py).  Usable
    as a context manager for parity with the reference:

        with InputNode() as inp:
            dag = a.fwd.bind(inp)
    """

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _exec_interpreted(self, values, args):
        if len(args) == 1:
            return args[0]
        return args

    def __repr__(self):
        return f"InputNode({self._id})"


class ClassMethodNode(DAGNode):
    def __init__(self, handle, method_name: str, args: Tuple,
                 kwargs: Dict[str, Any]):
        super().__init__()
        self.handle = handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs

    def _upstream(self):
        return [a for a in list(self.args) + list(self.kwargs.values())
                if isinstance(a, DAGNode)]

    def _exec_interpreted(self, values, input_args):
        args = [_resolve(a, values, input_args) for a in self.args]
        kwargs = {k: _resolve(v, values, input_args)
                  for k, v in self.kwargs.items()}
        # upstream interpreted results are ObjectRefs: pass through so the
        # runtime pipelines them (no driver round-trip); input values pass
        # as-is
        method = getattr(self.handle, self.method_name)
        return method.remote(*args, **kwargs)

    def __repr__(self):
        return (f"ClassMethodNode({self.handle._class_name}."
                f"{self.method_name}#{self._id})")


class FunctionNode(DAGNode):
    """A bound stateless task (interpreted mode only)."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any]):
        super().__init__()
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    def _upstream(self):
        return [a for a in list(self.args) + list(self.kwargs.values())
                if isinstance(a, DAGNode)]

    def _exec_interpreted(self, values, input_args):
        args = [_resolve(a, values, input_args) for a in self.args]
        kwargs = {k: _resolve(v, values, input_args)
                  for k, v in self.kwargs.items()}
        return self.remote_fn.remote(*args, **kwargs)

    def __repr__(self):
        return f"FunctionNode({self.remote_fn._fn.__name__}#{self._id})"


class MultiOutputNode(DAGNode):
    """Bundle several leaves as the DAG output (reference:
    dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__()
        self.outputs = list(outputs)

    def _upstream(self):
        return list(self.outputs)

    def _exec_interpreted(self, values, input_args):
        return [values[o._id] for o in self.outputs]

    def __repr__(self):
        return f"MultiOutputNode({len(self.outputs)})"


class CollectiveOutputNode(DAGNode):
    """One participant's output of a cross-actor collective inside a
    compiled DAG (reference: dag/collective_node.py:19,93 — aDAG
    allreduce over NCCL channels; here the reduction data plane is the
    shm channel mesh between the participating actors).

    Built via :func:`ray_tpu_torch.dag.allreduce_bind`; each contributor
    (a ClassMethodNode) yields one CollectiveOutputNode carrying the
    reduced value on that contributor's actor."""

    def __init__(self, contributor: "ClassMethodNode",
                 group: List["ClassMethodNode"], op: str):
        super().__init__()
        self.contributor = contributor
        self.group = group
        self.op = op
        self.handle = contributor.handle

    def _upstream(self):
        return list(self.group)

    def _exec_interpreted(self, values, input_args):
        # interpreted mode: materialize every contribution at the driver
        # and reduce (compiled mode reduces inside the actors)
        import ray_tpu_torch

        from .collective import REDUCERS

        vals = [values[c._id] for c in self.group]
        vals = [ray_tpu_torch.get(v)
                if isinstance(v, ray_tpu_torch.ObjectRef) else v
                for v in vals]
        return REDUCERS[self.op](vals)

    def __repr__(self):
        return (f"CollectiveOutputNode({self.op}@"
                f"{self.handle._class_name}#{self._id})")
