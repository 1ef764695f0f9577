"""ElasticConfig: user-facing knobs for preemption-aware elastic training.

Attached to ``JaxConfig(elastic=ElasticConfig(...))``; consumed by the
BackendExecutor's supervised restart loop (train/backend_executor.py) and
by the per-worker EmergencyCheckpointer (elastic/emergency.py).

The port's copy of ``ray_tpu/elastic/config.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ElasticConfig:
    """How a training run shrinks and recovers when hosts are lost.

    min_workers: smallest data-parallel width the run may shrink to;
        below it elastic recovery gives up and the normal
        restart-from-storage path (FailureConfig) takes over.
    max_workers: cap on width (None = the ScalingConfig's num_workers).
        Shrink-to-fit never grows past the current width; the cap exists
        so configs round-trip when re-used after capacity returns.
    replication_factor: K — each worker's emergency shard is replicated
        to its K ring successors, so recovery survives losing any K
        hosts without a persistent-storage round-trip.
    workers_per_replica: workers per model replica (the product of the
        non-data-parallel mesh axes, tp*sp, in hosts).  Shrink-to-fit
        only drops whole model replicas: the new width is always a
        multiple of this unit, preserving tp/sp axes.
    snapshot_every: emergency-snapshot cadence in steps (1 = every
        ``elastic.snapshot()`` call replicates).
    keep_steps: how many distinct snapshot steps each worker's in-memory
        vault retains.
    drain_grace_s: advisory deadline attached to a drain notice that
        carries no explicit grace.
    global_batch_size: when set, the executor publishes an exact
        per-replica batch split (``ctx.extra["per_replica_batch"]`` /
        ``"batch_offset"``) that keeps the global batch constant across
        width changes.
    replicate_timeout_s: per-snapshot bound on the background peer
        exchange (a dead peer must not wedge the replication thread).
    recover_timeout_s: per-RPC bound during recovery (ping / abort /
        inventory / fetch) — recovery must finish well inside one
        heartbeat-death interval, so no call may block on a dead host.

    Remediation (self-healing — see elastic/remediation.py):

    remediation_mode: what the RemediationEngine does with sustained
        ``straggler_detected`` advisories.
          "off"      — no engine; advisories stay advisories.
          "advisory" — the default.  The engine runs the full policy
                       (hysteresis, rate limits) and records/publishes
                       exactly what it WOULD do (cause→action records
                       with ``dry_run=True``) but changes nothing.
                       Inspect with ``ray-tpu remediations <trial>``.
          "enforce"  — act: quarantine the straggler's node (scheduler
                       avoidance on the control plane) and rebalance the
                       gang off it through elastic recovery.
    remediation_confirm_rounds: hysteresis — rounds an episode must stay
        open BEYOND the aggregator's ``straggler_sustain`` before the
        policy acts; a transient pause never triggers a rebalance.
    remediation_cooldown_s: minimum seconds between two remediation
        episodes (rate limit against thrash).
    remediation_max_episodes: cap on remediation episodes per run.
    remediation_effect_window: post-rebalance rounds measured before the
        cause→action→effect record is stamped recovered-or-not.
    remediation_recover_tolerance: the effect verdict — recovered when
        the post-rebalance gang median busy time is within this fraction
        of the pre-episode baseline (0.15 = within 15%).
    quarantine_grace_s: how long the control plane keeps the quarantined
        node out of scheduling before it may take work again.
    """

    min_workers: int = 1
    max_workers: Optional[int] = None
    replication_factor: int = 1
    workers_per_replica: int = 1
    snapshot_every: int = 1
    keep_steps: int = 2
    drain_grace_s: float = 30.0
    global_batch_size: Optional[int] = None
    replicate_timeout_s: float = 15.0
    recover_timeout_s: float = 5.0
    remediation_mode: str = "advisory"
    remediation_confirm_rounds: int = 2
    remediation_cooldown_s: float = 30.0
    remediation_max_episodes: int = 2
    remediation_effect_window: int = 3
    remediation_recover_tolerance: float = 0.15
    quarantine_grace_s: float = 600.0

    def __post_init__(self):
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers is not None and self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) < min_workers "
                f"({self.min_workers})")
        if self.replication_factor < 0:
            raise ValueError("replication_factor must be >= 0")
        if self.workers_per_replica < 1:
            raise ValueError("workers_per_replica must be >= 1")
        if self.min_workers % self.workers_per_replica:
            raise ValueError(
                f"min_workers ({self.min_workers}) must be a multiple of "
                f"workers_per_replica ({self.workers_per_replica}): shrink "
                f"drops whole model replicas")
        if self.snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        if self.keep_steps < 1:
            raise ValueError("keep_steps must be >= 1")
        if self.remediation_mode not in ("off", "advisory", "enforce"):
            raise ValueError(
                f"remediation_mode must be 'off', 'advisory' or 'enforce', "
                f"got {self.remediation_mode!r}")
        if self.remediation_confirm_rounds < 0:
            raise ValueError("remediation_confirm_rounds must be >= 0")
        if self.remediation_max_episodes < 0:
            raise ValueError("remediation_max_episodes must be >= 0")
        if self.remediation_effect_window < 1:
            raise ValueError("remediation_effect_window must be >= 1")
        if not 0.0 <= self.remediation_recover_tolerance < 1.0:
            raise ValueError(
                "remediation_recover_tolerance must be in [0, 1)")

    def validate_for(self, num_workers: int) -> None:
        """Check this config against a worker-group width at start."""
        if num_workers < self.min_workers:
            raise ValueError(
                f"ScalingConfig.num_workers ({num_workers}) < "
                f"ElasticConfig.min_workers ({self.min_workers})")
        if self.max_workers is not None and num_workers > self.max_workers:
            raise ValueError(
                f"ScalingConfig.num_workers ({num_workers}) > "
                f"ElasticConfig.max_workers ({self.max_workers})")
        if num_workers % self.workers_per_replica:
            raise ValueError(
                f"num_workers ({num_workers}) must be a multiple of "
                f"workers_per_replica ({self.workers_per_replica})")
        if self.replication_factor > num_workers - 1:
            raise ValueError(
                f"replication_factor ({self.replication_factor}) must be "
                f"< num_workers ({num_workers}): a shard cannot replicate "
                f"to more peers than exist")
