"""ray_tpu_torch.train: distributed training orchestration on the port's
runtime, the port's copy of ``ray_tpu/train``.

Mirrors the reference's Ray Train surface (reference: python/ray/train/):
JaxTrainer + JaxConfig (the reference's names; the loops are torch) and
TorchTrainer + TorchConfig; report/get_context/get_checkpoint/
get_dataset_shard match the module-level session API
(train/_internal/session.py:667-790).  Workers ask for cards with
``ScalingConfig(use_gpu=True)``; ``JaxConfig(mode="spmd")`` joins them
into one NCCL group (gloo on CPU workers).

Exports resolve on first use (PEP 562), so importing this package loads
neither torch nor the runtime's worker code; ``JaxTrainer.as_trainable()``
makes a trainer a trial of ``ray_tpu_torch.tune``.  The trainers for GBDT
libraries and TensorFlow come with ROADMAP A.10b.
"""

_EXPORTS = {
    "Backend": "backend", "BackendConfig": "backend",
    "JaxConfig": "backend", "TorchConfig": "backend", "TPUConfig": "backend",
    "publish_run_state": "backend",
    "BackendExecutor": "backend_executor",
    "TrainingFailedError": "backend_executor",
    "TrainingWorkerError": "backend_executor",
    "WorkerDrainedError": "backend_executor",
    "Checkpoint": "checkpoint",
    "CheckpointManager": "checkpoint_manager",
    "CheckpointConfig": "config", "CompressionConfig": "config",
    "FailureConfig": "config", "RunConfig": "config",
    "ScalingConfig": "config",
    "Result": "result",
    "TrainContext": "session", "get_checkpoint": "session",
    "get_context": "session", "get_dataset_shard": "session",
    "report": "session",
    "DataParallelTrainer": "trainer", "JaxTrainer": "trainer",
    "WorkerGroup": "worker_group",
}

__all__ = sorted([*_EXPORTS, "ElasticConfig"])


def __getattr__(name):
    import importlib

    if name == "ElasticConfig":
        return importlib.import_module(
            "ray_tpu_torch.elastic.config").ElasticConfig
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
