"""ray_tpu_torch.serve: online model serving on the port's runtime.

The port's copy of ``ray_tpu/serve`` (reference: python/ray/serve/) —
controller + proxy + replica actors, p2c routing, autoscaling, batching,
multiplexing, composition via DeploymentHandle, the HTTP/ASGI, RPC and
gRPC ingresses, declarative config.  ``serve.llm`` hosts the GPT behind a
deployment on the port's continuous-batching engine; an LLM replica
computes on a card when its deployment asks for one
(``ray_actor_options={"num_gpus": 1}``).

Importing this package loads no torch, so the controller and proxy
workers never pay its import: the engine exports below resolve on first
use (PEP 562).
"""

from ._common import AutoscalingConfig
from ._deployment import Application, Deployment, deployment
from .schema import (ServeApplicationSchema, ServeDeploySchema,
                     deploy_config, deploy_config_file)
from ._asgi import ingress
from ._handle import (DeploymentHandle, DeploymentResponse,
                      DeploymentResponseGenerator)
from ._proxy import Request, Response, RpcClient
from .api import (delete, get_app_handle, get_deployment_handle, run,
                  shutdown, start, start_grpc, start_rpc_proxy, status)
from .batching import batch
from . import llm  # noqa: F401  (serve.llm.LLMServer / build_llm_app)
from .multiplex import get_multiplexed_model_id, multiplexed

# torch-backed exports (the continuous-batching engine), resolved on
# first use
_LAZY = {name: "ray_tpu_torch.serve._engine"
         for name in ("AdmissionRejected", "ContinuousEngine",
                      "PageAllocator")}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "Application", "AutoscalingConfig", "Deployment", "DeploymentHandle",
    "DeploymentResponse", "DeploymentResponseGenerator", "ingress",
    "Request", "Response", "RpcClient", "batch",
    "delete", "deployment", "get_app_handle", "get_deployment_handle",
    "get_multiplexed_model_id", "multiplexed", "run", "shutdown", "start",
    "start_grpc", "start_rpc_proxy", "status",
    "ServeApplicationSchema", "ServeDeploySchema", "deploy_config",
    "deploy_config_file",
    "AdmissionRejected", "ContinuousEngine", "PageAllocator",
]
