"""ray_tpu_torch.telemetry: the training flight recorder, the port's copy
of ``ray_tpu.telemetry``.

Cooperating pieces:

  * recorder   — per-worker StepTimer: phase-resolved step timing
    (data / compute / collective / checkpoint) with CUDA-event fences,
    a bounded ring buffer, and rate-limited KV snapshot flushes;
    ``record_collective`` is the hook the collective layer reports
    per-op timing + wire bytes through.
  * goodput    — GoodputAccountant: wall-clock state machine
    (productive / draining / recovering / idle) stamped by the elastic
    subsystem across incarnations.
  * aggregator — driver-side StepAggregator: merges per-round
    cross-worker step records, flags stragglers (busy time >
    multiple × gang median, sustained-N hysteresis) and publishes
    ``straggler_detected`` advisories on the "train" topic.
  * timeline   — Chrome trace-event export for Perfetto, serving
    ``GET /api/train/timeline`` and ``python -m ray_tpu_torch timeline
    --job <trial>``.
  * device     — the program ledger (instrumented programs, new-signature
    cause diffs, storm advisories, ``kernels.build`` events) + the card
    memory census (CUDA tensors by storage, the allocator's counters, KV
    page arena occupancy); flushes to KV ns ``_device`` and serves
    ``python -m ray_tpu_torch device-stats`` / ``GET /api/device/stats``.

Exports resolve lazily (PEP 562) so importing ``ray_tpu_torch`` does not
drag the train stack in, and no module here loads torch at import.
"""

_EXPORTS = {
    "TelemetryConfig": "config",
    "resolve_telemetry": "config",
    "StepTimer": "recorder",
    "phase": "recorder",
    "set_current_timer": "recorder",
    "current_timer": "recorder",
    "record_collective": "recorder",
    "flush_snapshot": "recorder",
    "TELEMETRY_KEY_PREFIX": "recorder",
    "GoodputAccountant": "goodput",
    "set_current_accountant": "goodput",
    "current_accountant": "goodput",
    "stamp": "goodput",
    "StepAggregator": "aggregator",
    "collect_snapshots": "timeline",
    "collect_device_workers": "timeline",
    "chrome_trace": "timeline",
    "validate_chrome_trace": "timeline",
    "CompilationLedger": "device",
    "DeviceMemoryCensus": "device",
    "InstrumentedProgram": "device",
    "get_ledger": "device",
    "get_census": "device",
    "instrument": "device",
    "device_snapshot": "device",
    "flush_device_snapshot": "device",
    "collect_device_stats": "device",
    "DEVICE_NS": "device",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        modname = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib

    mod = importlib.import_module(f".{modname}", __name__)
    val = getattr(mod, name)
    globals()[name] = val
    return val


def __dir__():
    return __all__
