"""ray_tpu_torch.elastic: preemption-aware elastic training, the port's
copy of ``ray_tpu/elastic``.

  * preemption  — PreemptionWatcher + sources: raylets learn a host is
    going away and report a drain notice to the control plane, which
    broadcasts a ``node_draining`` advisory over pubsub (no GCE metadata
    source: ROADMAP §C).
  * emergency   — EmergencyCheckpointer: async device->host snapshots of
    each worker's train-state shard (a tree of tensors), peer-replicated
    to K ring successors through the control-plane KV mailbox; recovery
    needs no persistent-storage round-trip.
  * resume      — shrink-to-fit width selection (goodput-predicted via
    IncarnationHistory) + exact global-batch resplitting, driven by
    BackendExecutor.elastic_recover().
  * remediation — RemediationEngine: turns sustained straggler
    advisories into quarantine+rebalance actions (advisory by default)
    with hysteresis, rate limits, and measured cause→action→effect
    records.

User surface: ``JaxConfig(elastic=ElasticConfig(...))`` plus
``elastic.snapshot(state, step)`` inside the train loop.

Exports resolve lazily (PEP 562): raylets import only the preemption
submodule, and must not drag the train stack (which ``emergency`` needs
for its Checkpoint base class) into every node daemon.
"""

_EXPORTS = {
    "ElasticConfig": "config",
    "EmergencyCheckpoint": "emergency",
    "EmergencyCheckpointer": "emergency",
    "fold_shards": "emergency",
    "get_checkpointer": "emergency",
    "select_quorum": "emergency",
    "snapshot": "emergency",
    "wait_replicated": "emergency",
    "FakePreemptionSource": "preemption",
    "FilePreemptionSource": "preemption",
    "PreemptionNotice": "preemption",
    "PreemptionSource": "preemption",
    "PreemptionWatcher": "preemption",
    "source_from_env": "preemption",
    "IncarnationHistory": "resume",
    "InsufficientWorkersError": "resume",
    "batch_offsets": "resume",
    "choose_width": "resume",
    "per_replica_batches": "resume",
    "predict_rate": "resume",
    "shrink_to_fit": "resume",
    "REMEDIATION_NS": "remediation",
    "RemediationEngine": "remediation",
    "fetch_records": "remediation",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
