"""Dask-on-ray_tpu_torch: execute dask task graphs on the cluster.

Reference parity: python/ray/util/dask/ — a dask scheduler
(`ray_dask_get`) that walks the dask graph, submits each task as a Ray
task with its dependencies passed as ObjectRefs, and materializes the
requested keys.  Usage (when dask is installed):

    import dask
    from ray_tpu_torch.util.dask import ray_dask_get
    dask.config.set(scheduler=ray_dask_get)
    ddf.sum().compute()

The scheduler itself only needs the graph *protocol* — a dict of
``key -> computation`` where a computation is a ``(callable, *args)``
tuple, a literal, or a key reference — so it works (and is tested)
without dask installed.  The port's copy of ``ray_tpu/util/dask.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch

__all__ = ["ray_dask_get"]


def _ishashable(x) -> bool:
    try:
        hash(x)
        return True
    except TypeError:
        return False


def _istask(x) -> bool:
    return isinstance(x, tuple) and bool(x) and callable(x[0])


def _execute_task(func, args):
    """Remote body: args arrive with ObjectRefs already materialized by
    the runtime; nested structures were resolved at submit time."""
    return func(*args)


def _resolve(arg, refs: Dict[Hashable, Any], dsk: Dict):
    """Substitute graph keys with their (possibly ObjectRef) results;
    recurse into list/tuple/dict containers like dask.core.subs."""
    if _ishashable(arg) and arg in refs:
        return refs[arg]
    if _istask(arg):
        # nested task: execute inline at submit time semantics would
        # diverge; submit it as its own anonymous node
        func, *fargs = arg
        fargs = [_resolve(a, refs, dsk) for a in fargs]
        return _remote_exec.remote(func, fargs)
    if isinstance(arg, list):
        return [_resolve(a, refs, dsk) for a in arg]
    if isinstance(arg, tuple):
        return tuple(_resolve(a, refs, dsk) for a in arg)
    if isinstance(arg, dict):
        return {k: _resolve(v, refs, dsk) for k, v in arg.items()}
    return arg


@ray_tpu_torch.remote
def _remote_exec(func, args):
    # ObjectRefs nested in containers are materialized here so arbitrary
    # arg shapes work (the runtime only auto-resolves top-level refs)
    def deep(a):
        if isinstance(a, ray_tpu_torch.ObjectRef):
            return ray_tpu_torch.get(a)
        if isinstance(a, list):
            return [deep(x) for x in a]
        if isinstance(a, tuple):
            return tuple(deep(x) for x in a)
        if isinstance(a, dict):
            return {k: deep(v) for k, v in a.items()}
        return a

    return func(*[deep(a) for a in args])


def _toposort(dsk: Dict) -> List[Hashable]:
    seen: Dict[Hashable, int] = {}  # 0=visiting, 1=done
    out: List[Hashable] = []

    def deps_of(val):
        if _ishashable(val) and val in dsk:
            yield val
            return
        if _istask(val):
            for a in val[1:]:
                yield from deps_of(a)
        elif isinstance(val, (list, tuple)):
            for a in val:
                yield from deps_of(a)
        elif isinstance(val, dict):
            for a in val.values():
                yield from deps_of(a)

    def visit(key):
        state = seen.get(key)
        if state == 1:
            return
        if state == 0:
            raise ValueError(f"cycle in dask graph at {key!r}")
        seen[key] = 0
        for dep in deps_of(dsk[key]):
            visit(dep)
        seen[key] = 1
        out.append(key)

    for k in dsk:
        visit(k)
    return out


def ray_dask_get(dsk: Dict, keys, **kwargs):
    """Dask scheduler entry point (reference: util/dask/scheduler.py
    ray_dask_get): every graph node becomes one ray_tpu_torch task; shared
    dependencies run once and flow between tasks as ObjectRefs."""
    refs: Dict[Hashable, Any] = {}
    for key in _toposort(dsk):
        val = dsk[key]
        if _istask(val):
            func, *args = val
            args = [_resolve(a, refs, dsk) for a in args]
            refs[key] = _remote_exec.remote(func, args)
        else:
            refs[key] = _resolve(val, refs, dsk)

    def unpack(ks):
        if isinstance(ks, list):
            return [unpack(k) for k in ks]
        v = refs[ks] if _ishashable(ks) and ks in refs else ks
        return ray_tpu_torch.get(v) if isinstance(v, ray_tpu_torch.ObjectRef) else v

    return unpack(keys)
