"""Shared Serve dataclasses (reference: python/ray/serve/schema.py,
serve/config.py AutoscalingConfig/DeploymentConfig).

The port's copy of ``ray_tpu/serve/_common.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"
DEFAULT_ROUTE_PREFIX = "/"


class NoCapacityError(Exception):
    """Every candidate replica is shedding (engine accepting=False):
    the router refuses the request up front so the proxy can answer
    503 + Retry-After instead of letting replica queues collapse."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s

# replica states (reference: serve/_private/common.py ReplicaState)
STARTING = "STARTING"
RUNNING = "RUNNING"
STOPPING = "STOPPING"

# app states (reference: ApplicationStatus)
DEPLOYING = "DEPLOYING"
APP_RUNNING = "RUNNING"
DEPLOY_FAILED = "DEPLOY_FAILED"
DELETING = "DELETING"


@dataclass
class AutoscalingConfig:
    """reference: serve/config.py AutoscalingConfig."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    # serve-SLO signals (0 = disabled): consumed by the controller's
    # _autoscale from decode-engine stats — average engine waiting-queue
    # depth per replica to hold, and the p99 time-to-first-token SLO
    target_queue_depth: float = 0.0
    ttft_slo_s: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "target_ongoing_requests": self.target_ongoing_requests,
                "upscale_delay_s": self.upscale_delay_s,
                "downscale_delay_s": self.downscale_delay_s,
                "target_queue_depth": self.target_queue_depth,
                "ttft_slo_s": self.ttft_slo_s}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AutoscalingConfig":
        return AutoscalingConfig(**d)


@dataclass
class ReplicaStatus:
    replica_id: str
    state: str
    ongoing: int = 0


@dataclass
class DeploymentStatus:
    name: str
    status: str
    target_num_replicas: int
    replicas: List[ReplicaStatus] = field(default_factory=list)
    message: str = ""


@dataclass
class ApplicationStatus:
    name: str
    status: str
    route_prefix: Optional[str]
    deployments: Dict[str, DeploymentStatus] = field(default_factory=dict)
    message: str = ""
    ingress: str = ""
