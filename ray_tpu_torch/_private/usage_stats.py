"""Usage stats: opt-out feature-usage telemetry, local-only.

Reference parity: python/ray/_private/usage/usage_lib.py — Ray records
which libraries/features a cluster used and (unless opted out) reports
them.  Here collection is the same shape — feature tags + library usage
counters in the control-plane KV — but nothing ever leaves the cluster:
the "report" is a JSON blob readable via the dashboard
(``/api/usage_stats``) or :func:`usage_report`.  Opt out entirely with
``RAY_TPU_TORCH_USAGE_STATS_ENABLED=0`` (reference env:
RAY_USAGE_STATS_ENABLED).

The port's copy of ``ray_tpu/_private/usage_stats.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

USAGE_NS = "__usage_stats__"


def enabled() -> bool:
    from .config import cfg

    return cfg().usage_stats_enabled


def _core():
    from .core import current_core

    return current_core()


def record_library_usage(library: str) -> None:
    """Tag a library as used (reference: record_library_usage) — called
    from library entry points (serve.start, Tuner.fit, ...)."""
    record_extra_usage_tag(f"library_{library}", "1")


def record_extra_usage_tag(key: str, value: str) -> None:
    """Best-effort write-through of a usage tag to the control KV
    (reference: TagKey + record_extra_usage_tag)."""
    if not enabled():
        return
    try:
        core = _core()
        core.control.call("kv_put", {
            "ns": USAGE_NS, "key": key,
            "val": json.dumps({"value": value, "ts": time.time()}).encode(),
            "overwrite": True,
        }, timeout=5.0)
    except Exception:
        pass  # telemetry must never break the caller


def usage_report(control_client=None) -> Dict[str, Any]:
    """Aggregate recorded tags into one report blob."""
    try:
        cli = control_client or _core().control
        keys = cli.call("kv_keys", {"ns": USAGE_NS, "prefix": ""},
                        timeout=5.0) or []
        tags = {}
        for k in keys:
            raw = cli.call("kv_get", {"ns": USAGE_NS, "key": k},
                           timeout=5.0)
            if raw:
                tags[k] = json.loads(raw)
        return {"usage_stats_enabled": enabled(), "tags": tags,
                "collected_at": time.time()}
    except Exception as e:
        return {"usage_stats_enabled": enabled(), "error": str(e)}
