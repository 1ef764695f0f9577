"""Runtime utilities of the port: ``tracing``, the runtime's copy of
``ray_tpu/util/tracing.py``.  The rest of ``ray_tpu.util`` (placement
groups, actor pools, queues, the state API, metrics) comes with the
slices that need it (ROADMAP A.4d, A.5)."""
