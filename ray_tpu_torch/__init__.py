"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports).  Plain tensor math is PyTorch; every Pallas TPU kernel on the
ported path is a hand-written Hopper kernel under ``csrc/``, built at
first use and bound with ctypes (``ops/_kernels.py``).

Entry points take an explicit ``device`` and run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU and no explicit request they
raise rather than carry on silently on the CPU.

The task/actor runtime's API is the reference's (``init``, ``remote``,
``get``, ``put``, ``wait``, ``kill``, ``get_actor``, ``shutdown``; Ray's
python/ray/_private/worker.py — init :1260, get :2617, put :2785, wait
:2850, remote :3239) with ``num_gpus`` where the reference has
``num_tpus``.  A task or actor granted ``num_gpus`` runs in a worker that
sees the cards; every other worker sees none (``CUDA_VISIBLE_DEVICES=""``).
CUDA tensors cross the object plane staged through the host and land on
the receiver's default device (``_private/serialization.py``).  The
package's top level imports no torch: the model exports below resolve on
first use (PEP 562), so a runtime daemon or worker that never touches a
tensor never pays torch's import.

Layout mirrors ``ray_tpu``:
  * ``_private`` — the runtime: control plane (``control``), raylet
    (``node``), core worker and object store (``core``, ``shm_store``,
    ``native_store``), worker entry (``worker_proc``), GPU detection
    (``accelerators``), tensor-aware serialization;
  * ``native`` — the C++ scheduler and shm arena, built with g++ at first
    use into ``_build/native/``;
  * ``util.tracing``, ``elastic.preemption`` — the runtime's copies of
    the reference's modules of those names;
  * ``dag`` — ``.bind``, interpreted and compiled DAGs over shared-memory
    ring channels that carry CUDA tensors as raw bytes, the allreduce
    inside a compiled graph;
  * ``scripts.cli`` (``python -m ray_tpu_torch``), ``job``, ``util.state``,
    ``util.client``, ``experimental.internal_kv`` — the CLI-started
    cluster, job submission, the state API and ``timeline()``, client
    mode;
  * ``ops.layers`` / ``ops.attention`` — layer math and cross-entropy,
    attention + the flash-attention kernels' plain versions, their
    autograd ``Function`` and dispatcher;
  * ``models.gpt`` — GPT forward, loss, KV-cache decode, slot + paged
    caches;
  * ``models.training`` — the single-device train step (AdamW);
  * ``models.convert`` — the JAX parameter tree and AdamW state (numpy
    leaves) ↔ port;
  * ``serve`` — Serve (controller, router, replicas, handles, the
    HTTP / RPC / gRPC ingresses) with ``serve.llm``, the GPT behind a
    deployment on ``serve._engine``, the continuous-batching engine;
  * ``ops.quantize`` — block-wise int8 quantization (K4-K6's plain
    versions and dispatch);
  * ``collective`` — the group API: ``torch.distributed`` (store
    rendezvous, nccl/gloo) and the ``kv`` backend over the runtime's
    control-plane KV, the rank-local collectives with their
    int8-compressed paths, the compression config and codec;
  * ``parallel.sharding`` — ``GradientSynchronizer``, the bucketed,
    error-feedback gradient sync of data-parallel training;
  * ``telemetry``, ``util.metrics``, ``dashboard`` — the training
    flight recorder (phase-timed steps with CUDA-event fences, goodput,
    stragglers, Chrome traces), the device census and program ledger,
    the Prometheus registry and the dashboard's HTTP head; none of them
    loads torch at import.
"""

from __future__ import annotations

import atexit
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ._private.api import (ActorClass, ActorHandle, RemoteFunction, get_actor,
                           kill, remote)
from ._private.common import (ActorDiedError, GetTimeoutError, ObjectLostError,
                              RayTpuError, TaskCancelledError, TaskError,
                              WorkerCrashedError)
from ._private.core import CoreWorker, ObjectRef, ObjectRefGenerator

logger = logging.getLogger(__name__)

__version__ = "0.1.0"

_lock = threading.RLock()
_core: Optional[CoreWorker] = None
_owned_cluster = None

# the environment variable through which init() finds a running cluster
# (the reference's is RAY_TPU_ADDRESS: the two runtimes never attach to
# each other's clusters)
ADDRESS_ENV = "RAY_TPU_TORCH_ADDRESS"
# init()'s client-mode scheme (the reference's is ray-tpu://)
CLIENT_SCHEME = "ray-tpu-torch://"

# torch-backed exports, resolved on first use
_LAZY = {
    "resolve_device": "ray_tpu_torch._device",
    "adamw": "ray_tpu_torch.models.training",
    "make_eval_step": "ray_tpu_torch.models.training",
    "make_train_step": "ray_tpu_torch.models.training",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def is_initialized() -> bool:
    return _core is not None


def init(address: Optional[str] = None, *, num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: Optional[str] = None,
         ignore_reinit_error: bool = False,
         log_to_driver: bool = True,
         _tracing_startup_hook: Optional[str] = None,
         _tracing_config: Optional[Dict[str, Any]] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         logging_level: int = logging.INFO) -> Dict[str, Any]:
    """Start (or connect to) a cluster of the port's runtime and connect
    this driver.

    With no address (and no ``RAY_TPU_TORCH_ADDRESS``), boots a local
    single-node cluster: a control-plane process and one raylet, which
    offers ``num_gpus`` cards (default: the cards this host shows,
    ``_private/accelerators.num_gpus``).  ``address="host:port"`` joins a
    running control plane of this runtime; ``address="auto"`` joins the
    one ``python -m ray_tpu_torch start --head`` started on this host (its
    cluster file, ``/tmp/ray_tpu_torch/ray_current_cluster.json`` or
    ``RAY_TPU_TORCH_CLUSTER_FILE``); ``"ray-tpu-torch://host:port"``
    connects this process as a client of a ``ClientServer``
    (``util/client``), which drives the cluster on its behalf.
    """
    global _core, _owned_cluster
    with _lock:
        if _core is not None:
            if ignore_reinit_error:
                return connection_info()
            raise RuntimeError("ray_tpu_torch.init() called twice; use "
                               "ignore_reinit_error=True to allow")
        if address is None and os.environ.get(ADDRESS_ENV):
            address = os.environ[ADDRESS_ENV]
        if address and address.startswith(CLIENT_SCHEME):
            # remote-driver client mode (reference: ray.init("ray://...")
            # through python/ray/util/client/)
            from ._private import core as core_mod
            from .util.client import ClientCore

            cc = ClientCore(address)
            _core = cc
            core_mod._current_core = cc
            atexit.register(shutdown)
            return {"control_address": "%s:%s" % cc._server_control_addr,
                    "job_id": cc.job_id, "client": True}
        if address == "auto":
            # connect to the CLI-started cluster (reference: address="auto"
            # reading /tmp/ray/ray_current_cluster)
            from .scripts.cli import read_cluster_file

            info = read_cluster_file()
            if info is None:
                raise ConnectionError(
                    "address='auto' but no running cluster found (start "
                    "one with `python -m ray_tpu_torch start --head`)")
            address = info["control_address"]
        if _system_config:
            # typed flag overrides, inherited by every daemon this init
            # spawns (reference: _system_config through ray.init)
            from ._private.config import set_system_config

            set_system_config(_system_config)
        if address is None:
            from ._private import bootstrap

            cluster, node = bootstrap.start_local(num_cpus=num_cpus,
                                                  num_gpus=num_gpus,
                                                  resources=resources)
            _owned_cluster = cluster
            control_addr = cluster.control_addr
            raylet_addr = node.addr
        else:
            host, port = address.rsplit(":", 1)
            control_addr = (host, int(port))
            raylet_addr = None
        # find the local raylet & its store
        from ._private.protocol import Client

        node_id = None
        store_root = None
        if raylet_addr is None:
            probe = Client(control_addr, name="init-probe")
            nodes = probe.call("get_nodes", timeout=30.0)
            probe.close()
            alive = [n for n in nodes if n["state"] == "ALIVE"]
            if alive:
                raylet_addr = tuple(alive[0]["addr"])
        if raylet_addr is not None:
            probe = Client(raylet_addr, name="init-probe-raylet")
            info = probe.call("node_info", timeout=30.0)
            probe.close()
            node_id = info["node_id"]
            if os.path.isdir(info["store_root"]):
                store_root = info["store_root"]
        _core = CoreWorker(control_addr, raylet_addr, mode="driver",
                           namespace=namespace, log_to_driver=log_to_driver,
                           node_id=node_id, store_root=store_root)
        atexit.register(shutdown)
        # metrics created before a previous shutdown() flush again
        _metrics = sys.modules.get("ray_tpu_torch.util.metrics")
        if _metrics is not None:
            _metrics._registry.restart_if_needed()
        if _tracing_startup_hook:
            # run locally + register in KV so every worker applies it
            # (reference: ray.init(_tracing_startup_hook=...))
            from .util import tracing as _tracing

            _tracing.run_hook(_tracing_startup_hook, _tracing_config)
            _tracing.register_hook(_core.control, _tracing_startup_hook,
                                   _tracing_config)
            _tracing.ensure_collector(_core.control, proc="driver",
                                      worker_id=_core.worker_id,
                                      node_id=_core.node_id or "",
                                      job_id=_core.job_id)
        return connection_info()


def connection_info() -> Dict[str, Any]:
    core = _require()
    return {
        "control_address": f"{core.control.addr[0]}:{core.control.addr[1]}",
        "node_id": core.node_id,
        "job_id": core.job_id,
    }


def shutdown() -> None:
    global _core, _owned_cluster
    with _lock:
        core, _core = _core, None
        cluster, _owned_cluster = _owned_cluster, None
    if core is not None:
        core.shutdown()
        from ._private import core as core_mod

        if core_mod._current_core is core:
            core_mod._current_core = None
    # the metrics flusher must stop AT shutdown, not race it (it would
    # otherwise wake after teardown and trip on the dead core)
    _metrics = sys.modules.get("ray_tpu_torch.util.metrics")
    if _metrics is not None:
        _metrics._registry.stop()
    if cluster is not None:
        cluster.shutdown()


def _require() -> CoreWorker:
    if _core is not None:
        return _core
    # inside a worker process the CoreWorker registers itself globally
    from ._private.core import current_core

    return current_core()


def put(value: Any) -> ObjectRef:
    return _require().put(value)


def get(refs, timeout: Optional[float] = None):
    return _require().get(refs, timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    return _require().wait(refs, num_returns=num_returns, timeout=timeout)


def cancel(ref: "ObjectRef", *, force: bool = False,
           recursive: bool = True) -> bool:
    """Cancel the task that produces `ref` (reference: ray.cancel).
    Queued tasks are dropped; running ones get TaskCancelledError
    injected; force=True kills the worker process (normal tasks only).
    Getting the ref afterwards raises TaskCancelledError."""
    return _require().cancel(ref, force=force, recursive=recursive)


def cluster_resources() -> Dict[str, float]:
    return _require().control.call("cluster_resources", {})["total"]


def available_resources() -> Dict[str, float]:
    return _require().control.call("cluster_resources", {})["available"]


def nodes() -> List[Dict[str, Any]]:
    return _require().control.call("get_nodes", {})


def timeline(filename: Optional[str] = None) -> Optional[str]:
    """Export the task timeline as Chrome trace JSON (reference:
    ray.timeline, python/ray/_private/worker.py)."""
    from .util.state import timeline as _timeline

    _require().task_events.flush()
    return _timeline(filename)


class profile:
    """Span context manager feeding the task-event buffer (reference:
    ray._private.profiling / TaskEventBuffer profile events)."""

    def __init__(self, event_name: str, task_id: str = ""):
        self._name = event_name
        self._task_id = task_id

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        core = _require()
        if core is not None:
            core.task_events.record_profile(
                self._task_id, self._name, self._t0, time.time())
        return False


__all__ = [
    "init", "shutdown", "is_initialized", "put", "get", "wait", "remote",
    "kill", "cancel", "get_actor", "cluster_resources",
    "available_resources", "nodes", "timeline", "profile",
    "connection_info",
    "ObjectRef", "ObjectRefGenerator", "ActorHandle", "ActorClass",
    "RemoteFunction",
    "RayTpuError", "TaskError", "ActorDiedError", "WorkerCrashedError",
    "ObjectLostError", "GetTimeoutError", "TaskCancelledError",
    "adamw", "make_eval_step", "make_train_step", "resolve_device",
]
