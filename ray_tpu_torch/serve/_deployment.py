"""@serve.deployment decorator, Deployment, and application binding.

Reference: python/ray/serve/api.py:240 @serve.deployment,
serve/deployment.py Deployment.bind building the deployment DAG.  An
`Application` is the bound DAG; `serve.run` topologically instantiates it,
replacing nested bound nodes in init args with `DeploymentHandle`s.

The port's copy of ``ray_tpu/serve/_deployment.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ._common import AutoscalingConfig


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    user_config: Optional[Any] = None
    max_ongoing_requests: int = 100
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    health_check_period_s: float = 10.0
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)

    def options(self, **kwargs) -> "Deployment":
        d = copy.copy(self)
        for k, v in kwargs.items():
            if not hasattr(d, k):
                raise ValueError(f"unknown deployment option {k!r}")
            setattr(d, k, v)
        if isinstance(d.autoscaling_config, dict):
            d.autoscaling_config = AutoscalingConfig(**d.autoscaling_config)
        return d

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    @property
    def is_function(self) -> bool:
        return not isinstance(self.func_or_class, type)


class Application:
    """A bound deployment node; init args may contain other Applications
    (composition — reference: serve model composition docs)."""

    def __init__(self, deployment: Deployment, args: Tuple,
                 kwargs: Dict[str, Any]):
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs

    @property
    def name(self) -> str:
        return self._deployment.name

    def _flatten(self) -> List["Application"]:
        """All nodes, dependencies first, deduped by deployment name."""
        seen: Dict[int, "Application"] = {}
        order: List["Application"] = []

        def walk(node: "Application"):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for a in list(node._args) + list(node._kwargs.values()):
                if isinstance(a, Application):
                    walk(a)
            order.append(node)

        walk(self)
        names = set()
        for n in order:
            if n.name in names:
                raise ValueError(
                    f"duplicate deployment name {n.name!r} in application")
            names.add(n.name)
        return order


def deployment(_func_or_class: Optional[Callable] = None, *,
               name: Optional[str] = None, num_replicas: int = 1,
               user_config: Optional[Any] = None,
               max_ongoing_requests: int = 100,
               autoscaling_config: Optional[Any] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               health_check_period_s: float = 10.0):
    """Decorator converting a class or function into a Deployment
    (reference: serve/api.py:240)."""
    if isinstance(autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)
    if autoscaling_config is not None and num_replicas == 1:
        num_replicas = autoscaling_config.min_replicas

    def wrap(obj):
        return Deployment(
            func_or_class=obj,
            name=name or getattr(obj, "__name__", "deployment"),
            num_replicas=num_replicas,
            user_config=user_config,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            ray_actor_options=dict(ray_actor_options or {}),
            health_check_period_s=health_check_period_s,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
