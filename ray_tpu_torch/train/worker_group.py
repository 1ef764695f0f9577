"""WorkerGroup: the gang of training worker actors.

Mirrors the reference (reference: python/ray/train/_internal/
worker_group.py — WorkerGroup, RayTrainWorker): N actors created inside a
placement group, each exposing `execute` (run an arbitrary fn in the worker)
plus the session lifecycle used by the BackendExecutor.

The port's copy of ``ray_tpu/train/worker_group.py``.  A worker's
``has_gpu`` says it holds a GPU lease; the runtime's worker has already
checked that such a worker sees a card (``worker_proc.check_granted_gpu``
raises before the actor is built otherwise), so no probe is needed here.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                placement_group, remove_placement_group)

from .checkpoint import Checkpoint
from .session import TrainContext, TrainSession, _set_session

logger = logging.getLogger(__name__)


class RayTrainWorker:
    """The actor class running on every training worker."""

    def __init__(self):
        self._session: Optional[TrainSession] = None

    # -- generic execution -------------------------------------------------

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def node_metadata(self) -> Dict[str, Any]:
        # a GPU lease on THIS worker, not the driver's environment: the
        # raylet spawns a worker for a GPU lease with the cards visible and
        # marks it, and the worker refused to start if it found no card
        has_gpu = os.environ.get("RAY_TPU_TORCH_WORKER_GPU") == "1"
        return {
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "node_ip": os.environ.get("RAY_TPU_TORCH_NODE_IP", "127.0.0.1"),
            # which raylet hosts this worker — the elastic supervisor
            # matches drain notices (keyed by node_id) to workers
            "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID"),
            "has_gpu": has_gpu,
        }

    def set_env_vars(self, env: Dict[str, str]):
        os.environ.update(env)

    def ping(self) -> bool:
        """Cheap liveness probe (elastic recovery separates slow from
        dead with a short-timeout ping rather than waiting for the
        heartbeat-timeout death declaration)."""
        return True

    # -- session lifecycle -------------------------------------------------

    def start_session(self, ctx: TrainContext, train_fn: Callable,
                      config: Dict[str, Any],
                      checkpoint: Optional[Checkpoint],
                      upload_dir: Optional[str],
                      dataset_shards: Optional[Dict[str, Any]] = None,
                      start_iteration: int = 0):
        import inspect

        params = inspect.signature(train_fn).parameters
        wrapped = (lambda: train_fn(config)) if params else train_fn
        self._session = TrainSession(ctx, wrapped, checkpoint=checkpoint,
                                     checkpoint_upload_dir=upload_dir,
                                     dataset_shards=dataset_shards,
                                     start_iteration=start_iteration)
        self._session.start()
        return True

    def next_result(self):
        assert self._session is not None, "session not started"
        return self._session.next_result()

    def end_session(self):
        if self._session is not None:
            self._session.finish()
            self._session = None
            _set_session(None)
        return True

    def abort_session(self) -> bool:
        """Unwind the user loop without killing the worker process — the
        elastic restart path keeps surviving actors alive (their
        emergency-checkpoint vaults are the recovery source).

        Short join: a loop blocked inside a collective (waiting on a
        peer that just died) unwinds on its own once the kv poll times
        out; recovery must not wait for it — this call doubles as the
        driver's reachability probe and has to answer fast."""
        if self._session is None:
            return False
        self._session.abort(timeout=0.2)
        self._session = None
        _set_session(None)
        return True


class Worker:
    def __init__(self, actor, metadata: Dict[str, Any]):
        self.actor = actor
        self.metadata = metadata


class WorkerGroup:
    def __init__(self, num_workers: int, bundles: List[Dict[str, float]],
                 placement_strategy: str = "PACK",
                 actor_cls=RayTrainWorker):
        self.num_workers = num_workers
        # bumped by shrink_to(); backends fold it into collective group
        # names so a rebuilt gang never collides with the old rendezvous
        self.incarnation = 0
        self._pg = placement_group(bundles, strategy=placement_strategy)
        if not self._pg.ready(timeout=60.0):
            remove_placement_group(self._pg)
            try:
                state = (f"cluster={ray_tpu_torch.cluster_resources()} "
                         f"available={ray_tpu_torch.available_resources()}")
            except Exception:
                state = "(cluster state unavailable)"
            raise RuntimeError(
                f"could not reserve {bundles} for {num_workers} training "
                f"workers (cluster too small?); {state}")
        remote_cls = ray_tpu_torch.remote(actor_cls)
        self.workers: List[Worker] = []
        handles = []
        try:
            for i in range(num_workers):
                b = bundles[i]
                handles.append(remote_cls.options(
                    num_cpus=b.get("CPU", 0),
                    num_gpus=b.get("GPU", 0) or None,
                    resources={k: v for k, v in b.items()
                               if k not in ("CPU", "GPU")} or None,
                    max_concurrency=2,  # next_result blocks; keep control lane free
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        self._pg, placement_group_bundle_index=i),
                ).remote())
            metas = ray_tpu_torch.get([h.node_metadata.remote() for h in handles])
        except Exception:
            for h in handles:
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            raise
        self.workers = [Worker(h, m) for h, m in zip(handles, metas)]

    @property
    def placement_group(self):
        return self._pg

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker, return all results (ordered by rank)."""
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs):
        from ray_tpu_torch._private import common as _common

        _common._ensure_picklable_by_value(fn)
        return [w.actor.execute.remote(fn, *args, **kwargs)
                for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(
            self.workers[rank].actor.execute.remote(fn, *args, **kwargs))

    # -- elastic support ---------------------------------------------------

    def ping_workers(self, timeout: float = 5.0) -> List[bool]:
        """Probe every worker with a shared deadline; True per index that
        answered.  Does not wait for the control plane's death declaration
        — a worker that can't answer within `timeout` is treated as lost
        by the elastic recovery path regardless of its official state."""
        import time

        refs = [w.actor.ping.remote() for w in self.workers]
        deadline = time.monotonic() + timeout
        alive = []
        for ref in refs:
            budget = max(0.05, deadline - time.monotonic())
            try:
                alive.append(bool(ray_tpu_torch.get(ref, timeout=budget)))
            except Exception:
                alive.append(False)
        return alive

    def shrink_to(self, keep_indices: List[int]):
        """Rebuild the gang from the surviving subset, in the given order.

        Dropped actors are killed best-effort; the placement group is
        kept (its bundles on dead nodes are simply unused — recreating a
        PG mid-recovery would race the drain deadline)."""
        keep = set(keep_indices)
        for i, w in enumerate(self.workers):
            if i not in keep:
                try:
                    ray_tpu_torch.kill(w.actor)
                except Exception:
                    pass
        self.workers = [self.workers[i] for i in keep_indices]
        self.num_workers = len(self.workers)
        self.incarnation += 1

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w.actor)
            except Exception:
                pass
        self.workers = []
        try:
            remove_placement_group(self._pg)
        except Exception:
            pass
