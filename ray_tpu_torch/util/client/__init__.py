"""Remote-driver client mode (reference: python/ray/util/client/ — the
"Ray Client": ray.init("ray://host:port") proxies a driver outside the
cluster through a server-side proxied driver).

Here (the port's copy of ``ray_tpu/util/client``):
ray_tpu_torch.init("ray-tpu-torch://host:port") connects a ClientCore that
duck-types the in-process CoreWorker, so the entire public API (remote
functions, actors, get/put/wait, placement groups, collectives, the
libraries) runs unchanged over one multiplexed TCP connection; objects are
owned by the server-side driver and pinned per-client until released or
disconnect.
"""

from .client_core import ClientCore, parse_client_address
from .server import ClientServer

__all__ = ["ClientCore", "ClientServer", "parse_client_address"]
