"""Cluster-wide KV store API (reference:
python/ray/experimental/internal_kv.py — thin client over the GCS KV;
ours talks to the control plane's KV manager, control.py h_kv_*).  The
port's copy of ``ray_tpu/experimental/internal_kv.py``."""

from __future__ import annotations

from typing import List, Optional, Tuple

DEFAULT_NAMESPACE = "default"


def _control():
    from .._private.api import current_core

    return current_core().control


def _norm(key, namespace) -> Tuple[str, str]:
    ns = namespace or DEFAULT_NAMESPACE
    if isinstance(ns, bytes):
        ns = ns.decode()
    k = key.decode() if isinstance(key, bytes) else key
    return ns, k


def _internal_kv_initialized() -> bool:
    try:
        _control()
        return True
    except Exception:
        return False


def _internal_kv_put(key, value, overwrite: bool = True,
                     namespace=None) -> bool:
    """Returns True if the key already existed (reference semantics)."""
    ns, k = _norm(key, namespace)
    c = _control()
    if overwrite:
        existed = bool(c.call("kv_exists", {"ns": ns, "key": k},
                              timeout=30.0))
        c.call("kv_put", {"ns": ns, "key": k, "val": value,
                          "overwrite": True}, timeout=30.0)
        return existed
    stored = c.call("kv_put", {"ns": ns, "key": k, "val": value,
                               "overwrite": False}, timeout=30.0)
    return not stored


def _internal_kv_get(key, namespace=None) -> Optional[bytes]:
    ns, k = _norm(key, namespace)
    return _control().call("kv_get", {"ns": ns, "key": k}, timeout=30.0)


def _internal_kv_exists(key, namespace=None) -> bool:
    ns, k = _norm(key, namespace)
    return bool(_control().call("kv_exists", {"ns": ns, "key": k},
                                timeout=30.0))


def _internal_kv_del(key, namespace=None) -> bool:
    ns, k = _norm(key, namespace)
    return bool(_control().call("kv_del", {"ns": ns, "key": k},
                                timeout=30.0))


def _internal_kv_list(prefix, namespace=None) -> List[bytes]:
    ns, p = _norm(prefix, namespace)
    keys = _control().call("kv_keys", {"ns": ns, "prefix": p}, timeout=30.0)
    return [k.encode() for k in keys]


# public aliases (the reference keeps these private but they are widely
# used; we also expose unprefixed names)
kv_put = _internal_kv_put
kv_get = _internal_kv_get
kv_del = _internal_kv_del
kv_exists = _internal_kv_exists
kv_list = _internal_kv_list
