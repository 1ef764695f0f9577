"""Training backends: per-framework worker-group setup.

Mirrors the reference's Backend/BackendConfig split (reference:
python/ray/train/backend.py; torch impl train/torch/config.py — sets
MASTER_ADDR/PORT then torch.distributed.init_process_group on every
worker).  The port's copy of ``ray_tpu/train/backend.py``.

``JaxConfig`` keeps the reference's name and fields, so a run written
against ``ray_tpu.train`` runs when only the import changes; "Jax" there
names the reference's API, not a dependency (nothing here imports JAX).
Its two modes join the workers as the reference's do, with the port's
collective groups (``ray_tpu_torch.collective``):

  * "spmd": one ``torch.distributed`` group over the gang, rendezvous at
    rank 0's node on ``coordinator_port`` — NCCL when every worker holds
    a card, gloo when none does — where the reference calls
    ``jax.distributed.initialize``.  At one worker no group is made, as
    in the reference.
  * "local": the control-plane KV collective group (the ``kv`` backend),
    as in the reference.

Either way the group's name goes out as
``RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP`` and the run's compression
becomes the group default, so one train loop (``GradientSynchronizer``
over that group) runs unchanged in both modes.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Union

from ray_tpu_torch.collective.compression import (CompressionConfig,
                                                  parse_compression)

if TYPE_CHECKING:
    from ray_tpu_torch.elastic.config import ElasticConfig

logger = logging.getLogger(__name__)

# the variable through which every process of the gang finds the group
GROUP_ENV = "RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"
# the flag the port's compression module reads (collective/compression.py)
COMPRESSION_ENV = "RAY_TPU_COLLECTIVE_COMPRESSION"


def publish_run_state(trial_name: str, status: str, *, name: str,
                      workers: int, rounds: int,
                      metrics: Optional[Dict[str, Any]] = None,
                      telemetry: Optional[Dict[str, Any]] = None):
    """Run-state snapshot into the control KV (ns 'train') for the
    dashboard and the autoscaler's LoadMetrics (reference:
    TrainStateActor feeding dashboard/modules/train/train_head.py).
    Advisory, never raises: a run must not fail because the dashboard
    missed a frame."""
    try:
        import json as _json
        import time as _time

        from ray_tpu_torch._private.api import current_core

        state: Dict[str, Any] = {
            "name": name, "trial": trial_name, "status": status,
            "workers": workers, "rounds": rounds,
            "last_metrics": metrics, "ts": _time.time(),
        }
        if telemetry is not None:
            state["telemetry"] = telemetry
        current_core().control.call("kv_put", {
            "ns": "train", "key": trial_name,
            "val": _json.dumps(state).encode()})
    except Exception:
        pass


@dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks called by the BackendExecutor around the worker group."""

    share_env_vars = ()

    def on_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_shutdown(self, worker_group, backend_config: BackendConfig):
        pass


def local_ranks(workers) -> List[int]:
    """Each worker's rank among the workers on its node, by node ip in
    world-rank order (the reference's rule, backend_executor.py:388): the
    contexts' local ranks, and the card each GPU worker binds."""
    seen: Dict[str, int] = defaultdict(int)
    out = []
    for w in workers:
        ip = w.metadata.get("node_ip", "?")
        out.append(seen[ip])
        seen[ip] += 1
    return out


def _require_card(backend: str) -> None:
    """An NCCL group needs a card; it never turns into a gloo one."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {backend!r} needs a CUDA device and this worker sees "
            f"none; give the workers cards (ScalingConfig(use_gpu=True)) or "
            f"ask for 'gloo'")


@dataclass
class TorchConfig(BackendConfig):
    """Backend config for torch.distributed training (reference:
    train/torch/config.py TorchConfig — sets MASTER_ADDR/PORT, then
    init_process_group on every worker).  gloo is the portable default;
    ``nccl`` needs a card on every worker (each binds
    ``cuda:<local rank>``) and raises on a worker without one."""

    backend: str = "gloo"
    init_method: str = "tcp"
    timeout_s: float = 120.0

    def backend_cls(self):
        return _TorchBackend


def _setup_torch_group(init_method: str, backend: str, world_size: int,
                       rank: int, timeout_s: float, local_rank: int = 0):
    import datetime

    import torch.distributed as dist

    kw = {}
    if backend == "nccl":
        import torch

        _require_card(backend)
        kw["device_id"] = torch.device(
            "cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size()}


def _teardown_torch_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: "TorchConfig"):
        import ray_tpu_torch
        from ray_tpu_torch._private.protocol import free_port

        n = worker_group.num_workers
        head_ip = worker_group.workers[0].metadata.get("node_ip",
                                                       "127.0.0.1")
        # probe the port on rank 0's host — the torch master binds there,
        # not on the driver (reference picks the port on the worker too)
        port = ray_tpu_torch.get(
            worker_group.workers[0].actor.execute.remote(free_port),
            timeout=60)
        init_method = f"tcp://{head_ip}:{port}"
        env = {"MASTER_ADDR": head_ip, "MASTER_PORT": str(port),
               "RAY_TPU_TORCH_TRAIN_WORLD_SIZE": str(n)}
        ray_tpu_torch.get([
            w.actor.set_env_vars.remote(
                {**env, "RAY_TPU_TORCH_TRAIN_WORLD_RANK": str(i)})
            for i, w in enumerate(worker_group.workers)])
        if n > 1 or backend_config.init_method == "always":
            local = local_ranks(worker_group.workers)
            refs = [w.actor.execute.remote(
                        _setup_torch_group, init_method,
                        backend_config.backend, n, i,
                        backend_config.timeout_s, local[i])
                    for i, w in enumerate(worker_group.workers)]
            infos = ray_tpu_torch.get(refs)
            logger.info("torch.distributed initialized: %s", infos[0])

    def on_shutdown(self, worker_group, backend_config: "TorchConfig"):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get([w.actor.execute.remote(_teardown_torch_group)
                               for w in worker_group.workers], timeout=30)
        except Exception:
            pass


@dataclass
class JaxConfig(BackendConfig):
    """Backend config of the trainer: the reference's ``JaxConfig``,
    under its own name and with its fields so code written against
    ``ray_tpu.train`` runs unchanged.  "Jax" names the reference's API;
    the port imports no JAX.

    mode: "auto" picks "spmd" when every worker holds a card and there is
        more than one, else "local" (the reference's rule,
        ray_tpu/train/backend.py:300-303).  "spmd" joins the gang into one
        ``torch.distributed`` group (NCCL on cards, gloo without), "local"
        into a control-plane KV group.
    coordinator_port: the rendezvous port on rank 0's node (spmd mode).
    collective_group: stem of the gang's group name.
    compression: the gang's gradient-sync compression (a
        CompressionConfig or a spec string such as "int8"), installed as
        every worker's group default.
    elastic: opt into peer-replicated emergency checkpoints and
        shrink-to-fit restarts (ray_tpu_torch.elastic.ElasticConfig).
    mesh_shape: installs a default mesh of this shape (``parallel.
        make_mesh``) on every worker once the gang's group is up (the
        reference's ``_install_default_mesh``): over the "spmd" group's
        ranks, or a world-1 mesh on a lone worker.
    pipeline: MPMD pipeline parallelism across worker gangs: a
        ``parallel.mpmd.PipelineConfig`` (stages/schedule/microbatches)
        or a spec string ("stages=4,schedule=1f1b,microbatches=8").  The
        spec is checked here, on the driver (a bad one raises), and
        published to every worker as ``RAY_TPU_TORCH_TRAIN_PIPELINE``, so
        the train fn builds its stage with ``PipelineConfig.from_env()``.
    telemetry: the flight recorder (``ray_tpu_torch.telemetry``): None
        (the default) and True turn it on, False turns it off; a dict or
        a ``TelemetryConfig`` sets its knobs, as in the reference.
    """

    mode: str = "auto"
    coordinator_port: int = 8476
    collective_group: str = "train"
    mesh_shape: Optional[Dict[str, int]] = None
    compression: Union[None, str, CompressionConfig] = None
    elastic: Optional["ElasticConfig"] = None
    telemetry: Union[None, bool, Dict[str, Any], Any] = None
    pipeline: Union[None, str, Any] = None

    def __post_init__(self):
        if self.mode not in ("auto", "spmd", "local"):
            raise ValueError(f"mode must be 'auto', 'spmd' or 'local', got "
                             f"{self.mode!r}")
        if self.pipeline is not None:
            # checked on the driver, where the error is actionable, not
            # inside N workers
            _pipeline_spec(self.pipeline)

    def backend_cls(self):
        return _JaxBackend


def _pipeline_spec(pipeline) -> str:
    """The env form of ``JaxConfig.pipeline`` (a PipelineConfig or a spec
    string), raising on a bad spec."""
    from ray_tpu_torch.parallel.mpmd import PipelineConfig

    if isinstance(pipeline, str):
        pipeline = PipelineConfig.from_spec(pipeline)
    if not isinstance(pipeline, PipelineConfig):
        raise TypeError(f"JaxConfig(pipeline=...) takes a PipelineConfig "
                        f"or a spec string, got {type(pipeline).__name__}")
    return pipeline.to_spec()


def _setup_spmd_group(group_name: str, world_size: int, rank: int,
                      backend: str, init_method: str,
                      compression: str = "", local_rank: int = 0):
    from ray_tpu_torch import collective
    from ray_tpu_torch.collective.compression import set_group_compression

    if backend == "nccl":
        _require_card(backend)
    # an NCCL member binds the card get_device() gives the loop
    g = collective.init_collective_group(world_size, rank, backend=backend,
                                         group_name=group_name,
                                         init_method=init_method,
                                         device=local_rank)
    if compression:
        set_group_compression(compression)
    return {"rank": rank, "backend": backend, "device": str(g.device)}


def _setup_kv_group(group_name: str, world_size: int, rank: int,
                    compression: str = ""):
    from ray_tpu_torch import collective
    from ray_tpu_torch.collective.compression import set_group_compression

    collective.init_collective_group(world_size, rank, backend="kv",
                                     group_name=group_name)
    if compression:
        set_group_compression(compression)
    return {"rank": rank, "backend": "kv", "device": None}


def _install_default_mesh(shape: Dict[str, int]):
    """Make the gang's mesh on this worker and install it as the default
    (every worker calls it: the mesh's groups are made collectively)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import axis_sizes, make_mesh, set_default_mesh

    # a lone worker has no group: its card if it holds a GPU lease
    dev = None if dist.is_initialized() else (
        "cuda" if os.environ.get("RAY_TPU_TORCH_WORKER_GPU") == "1"
        else "cpu")
    mesh = make_mesh(device_type=dev, **shape)
    set_default_mesh(mesh)
    return {"mesh": axis_sizes(mesh)}


def _destroy_group(group_name: str):
    from ray_tpu_torch import collective

    collective.destroy_collective_group(group_name)
    return True


class _JaxBackend(Backend):
    def on_start(self, worker_group, backend_config: JaxConfig):
        import ray_tpu_torch

        n = worker_group.num_workers
        mode = backend_config.mode
        all_gpu = all(w.metadata.get("has_gpu")
                      for w in worker_group.workers)
        if mode == "auto":
            mode = "spmd" if (all_gpu and n > 1) else "local"
        self.mode = mode
        self._group = None

        # publish the gang layout to every worker's env (the analog of
        # _share_cuda_visible_devices, reference: backend_executor.py:271)
        env = {"RAY_TPU_TORCH_TRAIN_WORLD_SIZE": str(n)}
        cc = parse_compression(backend_config.compression)
        comp_spec = cc.to_spec() if cc is not None else ""
        if comp_spec:
            # the flag form reaches subprocesses a worker may itself
            # spawn; the group default below covers the workers directly
            env[COMPRESSION_ENV] = comp_spec
        if backend_config.pipeline is not None:
            from ray_tpu_torch.parallel.mpmd import PIPELINE_ENV

            env[PIPELINE_ENV] = _pipeline_spec(backend_config.pipeline)
        ray_tpu_torch.get([
            w.actor.set_env_vars.remote(
                {**env, "RAY_TPU_TORCH_TRAIN_WORLD_RANK": str(i)})
            for i, w in enumerate(worker_group.workers)])

        if n > 1:
            # incarnation in the name: an elastically rebuilt gang must
            # never rendezvous with stale members of the old group
            inc = getattr(worker_group, "incarnation", 0)
            group = (f"{backend_config.collective_group}"
                     f"-{id(worker_group)}-i{inc}")
            self._group = group
            ray_tpu_torch.get([
                w.actor.set_env_vars.remote({GROUP_ENV: group})
                for w in worker_group.workers])
            if mode == "spmd":
                head_ip = worker_group.workers[0].metadata.get(
                    "node_ip", "127.0.0.1")
                init_method = (f"tcp://{head_ip}:"
                               f"{backend_config.coordinator_port}")
                backend = "nccl" if all_gpu else "gloo"
                local = local_ranks(worker_group.workers)
                refs = [w.actor.execute.remote(
                            _setup_spmd_group, group, n, i, backend,
                            init_method, comp_spec, local[i])
                        for i, w in enumerate(worker_group.workers)]
            else:
                refs = [w.actor.execute.remote(_setup_kv_group, group, n, i,
                                               comp_spec)
                        for i, w in enumerate(worker_group.workers)]
            infos = ray_tpu_torch.get(refs)
            logger.info("training group %s (%s) up: %s", group, mode,
                        infos[0])
        if backend_config.elastic is not None:
            self._init_emergency_checkpointers(worker_group,
                                               backend_config.elastic)
        if backend_config.mesh_shape:
            # after the group, so the mesh spans the gang's ranks
            meshes = ray_tpu_torch.get([
                w.actor.execute.remote(_install_default_mesh,
                                       dict(backend_config.mesh_shape))
                for w in worker_group.workers])
            logger.info("default mesh installed on %d workers: %s",
                        n, meshes[0])

    def _init_emergency_checkpointers(self, worker_group, ec):
        """Arm per-worker EmergencyCheckpointers.  Tag carries the gang
        incarnation: snapshots from before a shrink stay readable in the
        vault (recovery source) but new writes land under the new tag."""
        import ray_tpu_torch
        from ray_tpu_torch.elastic.emergency import _init_worker_checkpointer

        n = worker_group.num_workers
        inc = getattr(worker_group, "incarnation", 0)
        tag = f"em-{id(worker_group)}-i{inc}"
        ray_tpu_torch.get([
            w.actor.execute.remote(
                _init_worker_checkpointer, tag, i, n,
                ec.replication_factor, ec.keep_steps, ec.snapshot_every,
                ec.replicate_timeout_s)
            for i, w in enumerate(worker_group.workers)])
        logger.info("emergency checkpointers armed: tag=%s world=%d k=%d",
                    tag, n, ec.replication_factor)

    def on_shutdown(self, worker_group, backend_config: JaxConfig):
        group = getattr(self, "_group", None)
        if group and worker_group.workers:
            import ray_tpu_torch

            try:
                ray_tpu_torch.get([
                    w.actor.execute.remote(_destroy_group, group)
                    for w in worker_group.workers], timeout=60)
            except Exception:
                pass


# Alias of the reference's, for code written against ray_tpu.train.
TPUConfig = JaxConfig
