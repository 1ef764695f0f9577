"""serve public API: run/start/shutdown/delete/status + handles.

Reference: python/ray/serve/api.py (serve.run :463, @serve.deployment :240,
serve.start, serve.status, serve.delete, serve.get_app_handle,
serve.get_deployment_handle).

The port's copy of ``ray_tpu/serve/api.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import cloudpickle

import ray_tpu_torch

from ._common import (APP_RUNNING, CONTROLLER_NAME, DEPLOY_FAILED,
                      DEFAULT_ROUTE_PREFIX)
from ._controller import ServeController
from ._deployment import Application, Deployment
from ._handle import DeploymentHandle
from ._router import reset_routers

logger = logging.getLogger(__name__)

_controller_handle = None


def start(http_host: str = "127.0.0.1", http_port: int = 0,
          proxy: bool = False):
    """Start (or connect to) the serve controller; optionally the HTTP
    proxy.  Idempotent (reference: serve/api.py serve.start)."""
    global _controller_handle
    from ray_tpu_torch._private.usage_stats import record_library_usage

    record_library_usage("serve")
    if _controller_handle is None:
        try:
            _controller_handle = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except ValueError:
            _controller_handle = ray_tpu_torch.remote(ServeController).options(
                name=CONTROLLER_NAME, lifetime="detached",
                max_concurrency=8, num_cpus=0).remote(http_host, http_port)
            # wait for it to be live
            ray_tpu_torch.get(_controller_handle.get_replica_version.remote(),
                              timeout=30.0)
    if proxy:
        return ray_tpu_torch.get(_controller_handle.ensure_proxy.remote(),
                                 timeout=60.0)
    return _controller_handle


def start_rpc_proxy():
    """Start the binary RPC ingress (the native-protocol fast path);
    returns its (host, port)."""
    return ray_tpu_torch.get(_get_controller().ensure_rpc_proxy.remote(),
                             timeout=60.0)


def start_grpc(servicer_functions, *, host: Optional[str] = None):
    """Start the REAL gRPC ingress (reference: serve/_private/proxy.py:558
    gRPCProxy): `servicer_functions` are standard generated
    `add_<Service>Servicer_to_server` callables; any grpc client that
    speaks the user's proto can then call deployments (app selected via
    the `application` request metadata). Returns (host, port). Requires
    grpcio."""
    try:
        import grpc  # noqa: F401
    except ImportError:
        raise ImportError(
            "serve.start_grpc requires grpcio, which is not installed in "
            "this environment") from None
    import cloudpickle

    from ray_tpu_torch._private import common as _common

    for fn in servicer_functions:
        _common._ensure_picklable_by_value(fn)
    blob = cloudpickle.dumps(list(servicer_functions))
    return ray_tpu_torch.get(
        _get_controller().ensure_grpc_proxy.remote(blob, host),
        timeout=60.0)


def _get_controller():
    global _controller_handle
    if _controller_handle is None:
        start()
    return _controller_handle


def _spec_of(node: Application, handle_env: Dict[str, DeploymentHandle],
             app_name: str) -> Dict[str, Any]:
    from ray_tpu_torch._private import common as _common

    d: Deployment = node._deployment
    _common._ensure_picklable_by_value(d.func_or_class)

    def sub(a):
        if isinstance(a, Application):
            return handle_env[a.name]
        return a

    args = tuple(sub(a) for a in node._args)
    kwargs = {k: sub(v) for k, v in node._kwargs.items()}
    import inspect as _inspect

    # the HTTP proxy streams (chunked transfer) when the ingress __call__
    # is a generator, and speaks ASGI when @serve.ingress wrapped it
    target = d.func_or_class if d.is_function else \
        getattr(d.func_or_class, "__call__", None)
    streaming = bool(target is not None and
                     (_inspect.isgeneratorfunction(target)
                      or _inspect.isasyncgenfunction(target)))
    return {
        "streaming": streaming,
        "asgi": bool(getattr(d.func_or_class, "__serve_asgi__", False)),
        "name": d.name,
        "num_replicas": d.num_replicas,
        "user_config": d.user_config,
        "max_ongoing_requests": d.max_ongoing_requests,
        "autoscaling_config": (d.autoscaling_config.to_dict()
                               if d.autoscaling_config else None),
        "ray_actor_options": d.ray_actor_options,
        "is_function": d.is_function,
        "callable_blob": cloudpickle.dumps(d.func_or_class),
        "init_args_blob": cloudpickle.dumps((args, kwargs)),
    }


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = DEFAULT_ROUTE_PREFIX,
        blocking_timeout_s: float = 60.0) -> DeploymentHandle:
    """Deploy an application and wait for it to be RUNNING; returns the
    ingress deployment's handle (reference: serve/api.py:463)."""
    import time

    controller = _get_controller()
    nodes = app._flatten()
    handle_env = {n.name: DeploymentHandle(n.name, name) for n in nodes}
    specs = [_spec_of(n, handle_env, name) for n in nodes]
    ray_tpu_torch.get(controller.deploy_app.remote(
        name, route_prefix, specs, app.name), timeout=30.0)
    deadline = time.time() + blocking_timeout_s
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.status.remote(), timeout=30.0)
        app_st = st.get(name)
        if app_st is not None and app_st.status == APP_RUNNING:
            return handle_env[app.name]
        if app_st is not None and app_st.status == DEPLOY_FAILED:
            raise RuntimeError(
                f"deploying app {name!r} failed: {app_st.message}")
        time.sleep(0.1)
    raise TimeoutError(f"app {name!r} did not become RUNNING "
                       f"in {blocking_timeout_s}s")


def status() -> Dict[str, Any]:
    return ray_tpu_torch.get(_get_controller().status.remote(), timeout=30.0)


def delete(name: str):
    ray_tpu_torch.get(_get_controller().delete_app.remote(name), timeout=30.0)
    reset_routers()


def get_app_handle(name: str = "default") -> DeploymentHandle:
    st = status()
    if name not in st:
        raise ValueError(f"no serve app named {name!r}")
    return DeploymentHandle(st[name].ingress, name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def shutdown():
    """Tear down all apps, the proxy, and the controller."""
    global _controller_handle
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except (ValueError, Exception):
        _controller_handle = None
        reset_routers()
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30.0)
    except Exception:
        pass
    for proxy_name in ("SERVE_PROXY", "SERVE_RPC_PROXY"):
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(proxy_name))
        except Exception:
            pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    _controller_handle = None
    reset_routers()
