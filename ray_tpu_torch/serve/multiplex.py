"""Model multiplexing: many models time-share one replica pool.

Reference: python/ray/serve/multiplex.py (_ModelMultiplexWrapper) +
serve/api.py get_multiplexed_model_id.  A replica lazily loads models via
the decorated loader and keeps an LRU of at most
``max_num_models_per_replica``; the router prefers replicas that already
hold the requested model (model ids travel in the controller's metrics
probes — see _controller._poll_replica_futures / _router._pick).

The port's copy of ``ray_tpu/serve/multiplex.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import inspect
from typing import Any, Callable, List, Optional

from ._replica import _request_context


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id the current request asked for
    (reference: serve/api.py get_multiplexed_model_id)."""
    ctx = _request_context.get() or {}
    return ctx.get("multiplexed_model_id", "")


class _MultiplexCache:
    def __init__(self, loader: Callable, max_models: int):
        self.loader = loader
        self.max_models = max_models
        self.cache: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self.locks: dict = {}

    async def get(self, owner, model_id: str) -> Any:
        if model_id in self.cache:
            self.cache.move_to_end(model_id)
            return self.cache[model_id]
        lock = self.locks.setdefault(model_id, asyncio.Lock())
        async with lock:
            if model_id in self.cache:
                return self.cache[model_id]
            out = self.loader(owner, model_id) if owner is not None \
                else self.loader(model_id)
            if inspect.iscoroutine(out):
                out = await out
            while len(self.cache) >= self.max_models:
                old_id, old = self.cache.popitem(last=False)
                del_fn = getattr(old, "__del__", None)
                if del_fn is not None:
                    try:
                        del_fn()
                    except Exception:
                        pass
            self.cache[model_id] = out
            return out


def multiplexed(_func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator on the replica's model-loader method."""

    def wrap(fn):
        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"
        attr = f"__serve_multiplex_{fn.__name__}"

        if is_method:
            @functools.wraps(fn)
            async def method_wrapper(self, model_id: str):
                cache = getattr(self, attr, None)
                if cache is None:
                    cache = _MultiplexCache(fn, max_num_models_per_replica)
                    setattr(self, attr, cache)
                return await cache.get(self, model_id)

            method_wrapper._serve_multiplex_attr = attr
            return method_wrapper

        holder: List[Optional[_MultiplexCache]] = [None]

        @functools.wraps(fn)
        async def func_wrapper(model_id: str):
            if holder[0] is None:
                holder[0] = _MultiplexCache(fn, max_num_models_per_replica)
            return await holder[0].get(None, model_id)

        func_wrapper._serve_multiplex_holder = holder
        return func_wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


def loaded_model_ids(callable_obj: Any) -> List[str]:
    """Model ids currently cached on a replica's callable (for the
    controller's metrics probe -> router affinity)."""
    ids: List[str] = []
    for name in dir(type(callable_obj)):
        try:
            m = getattr(type(callable_obj), name)
        except AttributeError:
            continue
        attr = getattr(m, "_serve_multiplex_attr", None)
        if attr:
            cache = getattr(callable_obj, attr, None)
            if cache is not None:
                ids.extend(cache.cache.keys())
    return ids
