"""Declarative serve config: schema + YAML/dict deploy.

Reference parity: python/ray/serve/schema.py (ServeDeploySchema /
ServeApplicationSchema / DeploymentSchema pydantic models) and the
``serve deploy config.yaml`` CLI flow — a config file describes
applications by import path with per-deployment overrides; deploying
reconciles the cluster to the declared state.

Config shape (same field names as the reference)::

    applications:
      - name: app1
        import_path: mypkg.module:app      # an Application or Deployment
        route_prefix: /app1
        args: {}                           # passed to an app *builder*
        deployments:                       # per-deployment overrides
          - name: Model
            num_replicas: 3
            max_ongoing_requests: 16

The port's copy of ``ray_tpu/serve/schema.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ._deployment import Application, Deployment

_ALLOWED_OVERRIDES = ("num_replicas", "user_config",
                      "max_ongoing_requests", "autoscaling_config",
                      "ray_actor_options", "health_check_period_s")


@dataclass
class DeploymentSchema:
    name: str
    overrides: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def parse(cls, d: Dict[str, Any]) -> "DeploymentSchema":
        d = dict(d)
        name = d.pop("name", None)
        if not name:
            raise ValueError("deployment override needs a 'name'")
        unknown = set(d) - set(_ALLOWED_OVERRIDES)
        if unknown:
            raise ValueError(
                f"unknown deployment fields for {name!r}: {sorted(unknown)}")
        return cls(name=name, overrides=d)


@dataclass
class ServeApplicationSchema:
    name: str
    import_path: str
    route_prefix: Optional[str] = None
    args: Dict[str, Any] = field(default_factory=dict)
    deployments: List[DeploymentSchema] = field(default_factory=list)

    @classmethod
    def parse(cls, d: Dict[str, Any]) -> "ServeApplicationSchema":
        if "import_path" not in d:
            raise ValueError(
                f"application {d.get('name', '?')!r} needs 'import_path'")
        return cls(
            name=d.get("name", "default"),
            import_path=d["import_path"],
            route_prefix=d.get("route_prefix"),
            args=dict(d.get("args") or {}),
            deployments=[DeploymentSchema.parse(x)
                         for x in d.get("deployments") or []],
        )


@dataclass
class ServeDeploySchema:
    applications: List[ServeApplicationSchema]

    @classmethod
    def parse(cls, d: Dict[str, Any]) -> "ServeDeploySchema":
        apps = d.get("applications")
        if not apps:
            raise ValueError("config needs a non-empty 'applications' list")
        parsed = [ServeApplicationSchema.parse(a) for a in apps]
        names = [a.name for a in parsed]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate application names: {names}")
        return cls(applications=parsed)


def import_attr(import_path: str):
    """'pkg.module:attr' (or dotted fallback) -> the attribute."""
    if ":" in import_path:
        mod_name, attr = import_path.split(":", 1)
    else:
        mod_name, _, attr = import_path.rpartition(".")
    mod = importlib.import_module(mod_name)
    obj = mod
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def build_app(schema: ServeApplicationSchema) -> Application:
    """Materialize an Application from its import path + overrides."""
    target = import_attr(schema.import_path)
    if callable(target) and not isinstance(target,
                                           (Application, Deployment)):
        target = target(**schema.args)  # app builder function
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(
            f"{schema.import_path} resolved to {type(target).__name__}, "
            "expected an Application, Deployment, or builder returning one")
    if schema.deployments:
        by_name = {d.name: d.overrides for d in schema.deployments}
        for node in target._flatten():
            ov = by_name.pop(node.name, None)
            if ov:
                node._deployment = node._deployment.options(**ov)
        if by_name:
            raise ValueError(
                f"overrides for unknown deployments: {sorted(by_name)}")
    return target


def deploy_config(config: Dict[str, Any]) -> List[str]:
    """Deploy every application in a config dict; returns app names
    (reference: `serve deploy` -> controller deploy_apps)."""
    from . import api

    schema = ServeDeploySchema.parse(config)
    deployed = []
    for app in schema.applications:
        application = build_app(app)
        kwargs = ({} if app.route_prefix is None
                  else {"route_prefix": app.route_prefix})
        api.run(application, name=app.name, **kwargs)
        deployed.append(app.name)
    return deployed


def deploy_config_file(path: str) -> List[str]:
    import yaml

    with open(path) as f:
        return deploy_config(yaml.safe_load(f))
