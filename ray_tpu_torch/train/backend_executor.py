"""BackendExecutor: drives the training worker group from the driver side.

Mirrors the reference (reference: python/ray/train/_internal/
backend_executor.py — start :135, _create_placement_group :219,
start_training :451, get_next_results :578, _restart :759): create the gang
placement group + WorkerGroup, run backend setup hooks, start per-worker
sessions, and poll results in lockstep.  Worker death surfaces as
TrainingWorkerError so the trainer can tear down and restart the whole
group from the latest checkpoint (elastic recovery; a collective group
cannot survive losing a participant mid-step, so whole-group restart is
the only sound recovery unit).

The port's copy of ``ray_tpu/train/backend_executor.py``: the
telemetry config rides into every session through ``ctx.extra``, drain
and recovery paths stamp the trainer's goodput accountant, and
``quarantine_worker`` is remediation's enforcement.
"""

from __future__ import annotations

import logging
import os
from collections import Counter
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import ActorDiedError, WorkerCrashedError

from .backend import BackendConfig, JaxConfig, local_ranks
from .checkpoint import Checkpoint
from .config import ScalingConfig
from .session import TrainContext
from .worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingWorkerError(Exception):
    """A worker actor died mid-training (restartable condition)."""


class WorkerDrainedError(TrainingWorkerError):
    """A node hosting training workers posted a drain notice: restart
    proactively (before the host disappears) rather than reactively."""


class WorkerQuarantinedError(TrainingWorkerError):
    """Remediation quarantined a sustained straggler's node: rebalance
    the gang off it (the host is alive — merely benched — so its vault
    remains a recovery source)."""


class EmergencyRecoveryError(Exception):
    """Elastic in-memory recovery is not possible (no quorum of
    replicated shards / too few survivors); fall back to the
    storage-checkpoint restart path."""


class TrainingFailedError(Exception):
    """User train code raised; not restartable."""


class BackendExecutor:
    def __init__(self, backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None):
        self._backend_config = backend_config or JaxConfig()
        self._scaling = scaling_config or ScalingConfig()
        self._backend = self._backend_config.backend_cls()()
        self.worker_group: Optional[WorkerGroup] = None
        self._elastic = getattr(self._backend_config, "elastic", None)
        self._draining_nodes: set = set()
        self._quarantined_nodes: set = set()
        self._drain_listener_installed = False
        # rounds consumed since the last (re)start — the elastic restart
        # resumes session iteration numbering from here
        self.rounds_consumed = 0
        # per-incarnation effective-rate records feeding goodput-predicted
        # width selection in elastic_recover
        from ray_tpu_torch.elastic.resume import IncarnationHistory

        self.history = IncarnationHistory()
        # GoodputAccountant installed by the trainer; drain/recover paths
        # stamp state transitions through it when present
        self.goodput = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        s = self._scaling
        if self._elastic is not None:
            self._elastic.validate_for(s.num_workers)
        self.worker_group = WorkerGroup(
            s.num_workers, s.as_placement_group_bundles(),
            placement_strategy=s.placement_strategy)
        try:
            self._backend.on_start(self.worker_group, self._backend_config)
        except BaseException:
            # a gang whose backend failed to join (e.g. NCCL asked of
            # workers without a card) must not keep its workers and its
            # placement group: the reference leaks both here
            self.shutdown()
            raise
        if self._elastic is not None:
            self._install_drain_listener()

    # -- drain notices -----------------------------------------------------

    def _install_drain_listener(self):
        """Track node_draining advisories from the control plane's pubsub
        (drivers already subscribe to the `node` topic)."""
        if self._drain_listener_installed:
            return
        try:
            from ray_tpu_torch._private.core import current_core

            current_core().add_push_handler("pub:node", self._on_node_event)
            self._drain_listener_installed = True
        except Exception:
            logger.warning("could not install drain listener; elastic "
                           "recovery will rely on worker death only",
                           exc_info=True)

    def _remove_drain_listener(self):
        if not self._drain_listener_installed:
            return
        self._drain_listener_installed = False
        try:
            from ray_tpu_torch._private.core import current_core

            current_core().remove_push_handler("pub:node",
                                               self._on_node_event)
        except Exception:
            pass

    def _on_node_event(self, payload: Dict[str, Any]):
        event = payload.get("event")
        node = payload.get("node") or {}
        nid = node.get("node_id")
        if not nid:
            return
        if event == "draining":
            self._draining_nodes.add(nid)
            if self.goodput is not None:
                try:
                    if self.drain_pending():
                        self.goodput.transition("draining", node=nid)
                except Exception:
                    pass
        elif event in ("drain_canceled", "removed"):
            self._draining_nodes.discard(nid)
            if event == "removed":
                self._quarantined_nodes.discard(nid)
        elif event == "quarantined":
            self._quarantined_nodes.add(nid)
        elif event == "quarantine_cleared":
            self._quarantined_nodes.discard(nid)

    def drain_pending(self) -> bool:
        """True when any current training worker sits on a draining node."""
        if not self._draining_nodes or self.worker_group is None:
            return False
        return any(w.metadata.get("node_id") in self._draining_nodes
                   for w in self.worker_group.workers)

    def quarantine_worker(self, rank: int, reason: str,
                          grace_s: float = 600.0) -> Optional[str]:
        """Remediation enforcement: bench the node hosting ``rank`` on
        the control plane (scheduler avoidance + ``node_quarantined``
        pubsub) and exclude it locally so the next ``elastic_recover``
        sheds it.  Returns the node id (None when unknown).  The local
        exclusion is authoritative — a pubsub lag or an unreachable
        control must not leave the straggler in the rebuilt gang."""
        wg = self.worker_group
        if wg is None or not (0 <= rank < len(wg.workers)):
            return None
        nid = wg.workers[rank].metadata.get("node_id")
        if not nid:
            return None
        self._quarantined_nodes.add(nid)
        try:
            from ray_tpu_torch._private.core import current_core

            current_core().control.call("report_quarantine", {
                "node_id": nid, "grace_s": grace_s, "reason": reason,
            }, timeout=5.0)
        except Exception:
            logger.warning("could not report quarantine of node %s to the "
                           "control plane (local exclusion still applies)",
                           nid[:12], exc_info=True)
        return nid

    def _contexts(self, experiment_name: str, trial_name: str,
                  trial_dir: str) -> List[TrainContext]:
        """Compute world/local/node ranks from worker placement (the
        reference groups by node ip, backend_executor.py:388)."""
        workers = self.worker_group.workers
        node_ips = [w.metadata.get("node_ip", "?") for w in workers]
        ips = list(dict.fromkeys(node_ips))
        per_node = Counter(node_ips)
        ctxs = [TrainContext(
                    world_size=self.worker_group.num_workers,
                    world_rank=i,
                    local_rank=lr,
                    local_world_size=per_node[ip],
                    node_rank=ips.index(ip),
                    experiment_name=experiment_name,
                    trial_name=trial_name,
                    trial_id=trial_name,
                    trial_dir=trial_dir,
                )
                for i, (ip, lr) in enumerate(zip(node_ips,
                                                 local_ranks(workers)))]
        ec = self._elastic
        if ec is not None:
            n = self.worker_group.num_workers
            inc = getattr(self.worker_group, "incarnation", 0)
            if ec.global_batch_size:
                from ray_tpu_torch.elastic.resume import (batch_offsets,
                                                    per_replica_batches)

                batches = per_replica_batches(ec.global_batch_size, n)
                offsets = batch_offsets(batches)
            for ctx in ctxs:
                ctx.extra["elastic_incarnation"] = inc
                if ec.global_batch_size:
                    # the contract that keeps resumed runs comparable to
                    # uninterrupted ones: sum(per_replica_batch) == global
                    # at every width
                    ctx.extra["global_batch_size"] = ec.global_batch_size
                    ctx.extra["per_replica_batch"] = batches[ctx.world_rank]
                    ctx.extra["batch_offset"] = offsets[ctx.world_rank]
        try:
            from ray_tpu_torch.telemetry import resolve_telemetry

            tc = resolve_telemetry(
                getattr(self._backend_config, "telemetry", None))
            for ctx in ctxs:
                ctx.extra["telemetry"] = tc.to_dict()
        except Exception:
            pass
        return ctxs

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       experiment_name: str, trial_name: str, trial_dir: str,
                       checkpoint: Optional[Checkpoint] = None,
                       dataset_shards_per_worker: Optional[List[Dict[str, Any]]] = None,
                       start_iteration: int = 0,
                       per_worker_checkpoints: Optional[List[Optional[Checkpoint]]] = None):
        from . import storage

        storage.makedirs(trial_dir)
        from ray_tpu_torch._private import common as _common

        _common._ensure_picklable_by_value(train_fn)
        self._backend.on_training_start(self.worker_group,
                                        self._backend_config)
        ctxs = self._contexts(experiment_name, trial_name, trial_dir)
        shards = dataset_shards_per_worker or [None] * len(ctxs)
        cks = per_worker_checkpoints or [checkpoint] * len(ctxs)
        refs = [
            w.actor.start_session.remote(ctxs[i], train_fn, config,
                                         cks[i], trial_dir, shards[i],
                                         start_iteration)
            for i, w in enumerate(self.worker_group.workers)
        ]
        self._get_with_failure_handling(refs)
        import time as _time

        self.history.begin(getattr(self.worker_group, "incarnation", 0),
                           self.worker_group.num_workers,
                           self.rounds_consumed, _time.monotonic())

    def get_next_results(self) -> Optional[List[tuple]]:
        """One lockstep round of next_result() from every worker.

        Returns None when all workers finished; raises TrainingFailedError
        on a user exception; TrainingWorkerError on actor death;
        WorkerDrainedError (before issuing the round) when a hosting node
        posted a drain notice — restarting at a report() boundary is what
        keeps elastic recovery deterministic.
        """
        if self._elastic is not None and self.drain_pending():
            draining = sorted(
                n for n in self._draining_nodes
                if any(w.metadata.get("node_id") == n
                       for w in self.worker_group.workers))
            raise WorkerDrainedError(
                f"training workers on draining node(s) {draining}")
        refs = [w.actor.next_result.remote()
                for w in self.worker_group.workers]
        results = self._get_with_failure_handling(refs)
        kinds = {r[0] for r in results}
        if kinds == {"finished"}:
            return None
        if "finished" in kinds:
            # some workers returned while others still report: the loop is
            # mis-specified (unequal iteration counts); fail loudly.
            raise TrainingFailedError(
                "training workers returned out of sync: some finished while "
                "others are still reporting; ensure every worker runs the "
                "same number of report() calls")
        self.rounds_consumed += 1
        return results

    def _get_with_failure_handling(self, refs):
        try:
            return ray_tpu_torch.get(refs)
        except (ActorDiedError, WorkerCrashedError) as e:
            raise TrainingWorkerError(str(e)) from e
        except (TrainingWorkerError, TrainingFailedError):
            raise
        except ray_tpu_torch.TaskError as e:
            # a worker's death stalls its peers' collectives until they
            # time out, and a peer's error can come first in the round's
            # order: the death, which elastic recovery acts on, is what
            # the round reports
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                          timeout=1.0)
            for r in ready:
                try:
                    ray_tpu_torch.get(r)
                except (ActorDiedError, WorkerCrashedError) as died:
                    raise TrainingWorkerError(str(died)) from e
                except Exception:
                    pass
            raise TrainingFailedError(str(e)) from e

    # -- elastic recovery --------------------------------------------------

    def elastic_recover(self):
        """Shrink-to-fit restart after a drain notice or worker death.

        Sequence (all with short timeouts — the whole point is finishing
        inside the drain grace / well under the death-timeout interval):

          1. abort sessions on every reachable worker (frees their result
             lanes; survivors stay alive — their in-memory vaults are the
             recovery source),
          2. pick survivors = reachable workers NOT on draining nodes,
          3. select the freshest fully-covered snapshot step across ALL
             reachable vaults (draining hosts are still up and fetchable),
          4. pull the shard payloads to the driver BEFORE shrinking,
          5. shrink the gang to the largest feasible width, re-run backend
             setup (new collective group incarnation, re-armed
             checkpointers),
          6. hand back per-rank EmergencyCheckpoints (old-world shards
             folded onto new ranks) for a fresh start_training call.

        Returns (per_worker_checkpoints, step, new_world_size).
        Raises EmergencyRecoveryError when in-memory recovery can't work;
        InsufficientWorkersError when survivors < min_workers.
        """
        import time

        from ray_tpu_torch.elastic.emergency import (EmergencyCheckpoint,
                                               _fetch, _inventory,
                                               fold_shards, select_quorum)
        from ray_tpu_torch.elastic.resume import choose_width

        ec = self._elastic
        if ec is None:
            raise EmergencyRecoveryError("no ElasticConfig on the backend")
        wg = self.worker_group
        if wg is None:
            raise EmergencyRecoveryError("worker group not started")
        # close the dying incarnation's history record — its effective
        # rate (recovery churn included) informs the width choice below
        self.history.end(self.rounds_consumed, time.monotonic())
        if self.goodput is not None:
            try:
                self.goodput.transition("recovering")
            except Exception:
                pass
        t0 = time.monotonic()

        # 1. abort + reachability probe in one pass: a worker that can't
        # abort within the budget is treated as gone.
        abort_refs = [(i, w.actor.abort_session.remote())
                      for i, w in enumerate(wg.workers)]
        deadline = time.monotonic() + ec.recover_timeout_s
        reachable: List[int] = []
        for i, ref in abort_refs:
            budget = max(0.05, deadline - time.monotonic())
            try:
                ray_tpu_torch.get(ref, timeout=budget)
                reachable.append(i)
            except Exception:
                pass

        # 2. survivors exclude draining hosts (reachable now but won't be
        # for long) and quarantined ones (alive but benched by
        # remediation — keeping a sustained straggler in the new gang
        # would defeat the rebalance).
        tainted = self._draining_nodes | self._quarantined_nodes
        survivors = [i for i in reachable
                     if wg.workers[i].metadata.get("node_id")
                     not in tainted]

        # 3. freshest quorum across every vault we can still read.
        inv_refs = [(i, wg.workers[i].actor.execute.remote(_inventory))
                    for i in reachable]
        deadline = time.monotonic() + ec.recover_timeout_s
        inventories: Dict[int, Any] = {}
        for i, ref in inv_refs:
            budget = max(0.05, deadline - time.monotonic())
            try:
                inventories[i] = ray_tpu_torch.get(ref, timeout=budget)
            except Exception:
                pass
        quorum = select_quorum(inventories)
        if quorum is None:
            raise EmergencyRecoveryError(
                "no snapshot step is fully covered by surviving vaults "
                f"(inventories from {sorted(inventories)})")
        step, old_world, holders = quorum

        # 4. pull payloads while the draining hosts are still up.
        payload_refs = [
            (sid, wg.workers[widx].actor.execute.remote(_fetch, step, sid))
            for sid, widx in holders.items()]
        payloads: Dict[int, bytes] = {}
        deadline = time.monotonic() + ec.replicate_timeout_s
        for sid, ref in payload_refs:
            budget = max(0.05, deadline - time.monotonic())
            try:
                b = ray_tpu_torch.get(ref, timeout=budget)
            except Exception as e:
                raise EmergencyRecoveryError(
                    f"failed to fetch shard {sid} of step {step}: {e}") from e
            if b is None:  # vault pruned between inventory and fetch
                raise EmergencyRecoveryError(
                    f"shard {sid} of step {step} vanished from its vault")
            payloads[sid] = b

        # 5. shrink to the goodput-predicted width and re-run backend
        # setup on the new gang.
        new_n = choose_width(len(survivors), ec.min_workers,
                             ec.max_workers, ec.workers_per_replica,
                             history=self.history)
        keep = survivors[:new_n]
        logger.warning(
            "elastic recovery: step=%d old_world=%d survivors=%s -> "
            "new_world=%d (draining=%s quarantined=%s)", step, old_world,
            survivors, new_n, sorted(self._draining_nodes),
            sorted(self._quarantined_nodes))
        wg.shrink_to(keep)
        self._backend.on_start(wg, self._backend_config)

        # 6. fold old-world shards onto the new ranks.
        cks = []
        for r in range(new_n):
            shards = {sid: payloads[sid]
                      for sid in fold_shards(old_world, r, new_n)}
            cks.append(EmergencyCheckpoint(step=step,
                                           source_world_size=old_world,
                                           shards=shards))
        logger.info("elastic recovery completed in %.2fs",
                    time.monotonic() - t0)
        if self.goodput is not None:
            try:
                self.goodput.note_incarnation(
                    getattr(wg, "incarnation", 0))
            except Exception:
                pass
        return cks, step, new_n

    def finish_training(self):
        if self.worker_group is None:
            return
        try:
            ray_tpu_torch.get([w.actor.end_session.remote()
                         for w in self.worker_group.workers])
        except Exception:
            pass

    def shutdown(self):
        self._remove_drain_listener()
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group,
                                          self._backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None

    def restart(self):
        """Tear down and respawn the whole group (reference:
        backend_executor.py:759 _restart)."""
        self.shutdown()
        self.start()
