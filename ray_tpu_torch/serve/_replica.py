"""Replica actor: hosts one copy of a deployment's callable.

Reference: python/ray/serve/_private/replica.py — the replica wraps the
user callable, tracks ongoing-request counts (the router's routing signal
and the controller's autoscaling signal), runs health checks, and applies
``reconfigure(user_config)`` without a restart.

Requests run as *async actor tasks*: ``handle_request`` is a coroutine, so
one replica interleaves up to max_ongoing_requests concurrent calls on its
event loop — the GPU-relevant case being a replica that holds a model on
its card and batches requests into it (see batching.py).

The port's copy of ``ray_tpu/serve/_replica.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import contextvars
import inspect
import time
from typing import Any, Dict, Optional

import cloudpickle

# set during request execution; read by serve.get_multiplexed_model_id()
_request_context: contextvars.ContextVar = contextvars.ContextVar(
    "serve_request_context", default=None)


class _FunctionWrapper:
    """Adapts a function deployment to the callable-object protocol."""

    def __init__(self, fn):
        self._fn = fn

    async def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        if inspect.iscoroutine(out):
            out = await out
        return out


class Replica:
    def __init__(self, app_name: str, deployment_name: str, replica_id: str,
                 callable_blob: bytes, init_args_blob: bytes,
                 user_config: Optional[Any], is_function: bool):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self._ongoing = 0
        self._total = 0
        func_or_class = cloudpickle.loads(callable_blob)
        args, kwargs = cloudpickle.loads(init_args_blob)
        if is_function:
            self._callable = _FunctionWrapper(func_or_class)
        else:
            self._callable = func_or_class(*args, **kwargs)
        if user_config is not None:
            self._apply_reconfigure(user_config)

    # -- request path -------------------------------------------------------

    def _resolve_target(self, method_name: Optional[str],
                        allow_fallback: bool = False):
        if method_name in (None, "__call__") and callable(self._callable):
            return self._callable
        if allow_fallback:
            # opt-in (gRPC ingress routes RPC method names and declares
            # the fallback): a deployment that only defines __call__
            # still serves named RPCs.  NOT the default — handle callers
            # typo-ing a method name must keep getting AttributeError,
            # not a silently-wrong __call__ result.
            target = getattr(self._callable, method_name or "__call__",
                             None)
            if target is None and callable(self._callable):
                return self._callable
            if target is not None:
                return target
        return getattr(self._callable, method_name or "__call__")

    async def handle_request(self, method_name: Optional[str], args, kwargs,
                             metadata: Optional[Dict[str, Any]] = None):
        self._ongoing += 1
        self._total += 1
        token = _request_context.set(metadata or {})
        try:
            out = self._resolve_target(
                method_name,
                allow_fallback=bool((metadata or {}).get(
                    "_method_fallback")))(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = await out
            return out
        finally:
            _request_context.reset(token)
            self._ongoing -= 1

    def handle_request_streaming(self, method_name: Optional[str], args,
                                 kwargs, metadata: Optional[Dict] = None):
        """Streaming request path (reference: proxy.py:864
        receive_asgi_messages / generator deployments): the user target's
        yields flow out as a streaming generator — the first token
        reaches the client while the rest is still being produced.

        Sync generator method: on this async-actor replica it drains in
        an executor thread (see worker_proc), so blocking iteration is
        fine; async generators pump on a private event loop."""
        import asyncio

        self._ongoing += 1
        self._total += 1
        token = _request_context.set(metadata or {})
        loop = None
        try:
            out = self._resolve_target(
                method_name,
                allow_fallback=bool((metadata or {}).get(
                    "_method_fallback")))(*args, **kwargs)
            if inspect.iscoroutine(out):
                # e.g. _FunctionWrapper: the coroutine may resolve to the
                # generator itself
                loop = asyncio.new_event_loop()
                out = loop.run_until_complete(out)
            if inspect.isasyncgen(out):
                loop = loop or asyncio.new_event_loop()
                while True:
                    try:
                        yield loop.run_until_complete(out.__anext__())
                    except StopAsyncIteration:
                        break
            elif inspect.isgenerator(out):
                yield from out
            else:
                yield out
        finally:
            if loop is not None:
                loop.close()
            _request_context.reset(token)
            self._ongoing -= 1

    # -- control path ---------------------------------------------------------

    def get_metrics(self) -> Dict[str, Any]:
        """Queue-length probe (router p2c) + autoscaling stats + loaded
        multiplexed models (router affinity) + decode-engine scheduler
        stats when the callable hosts one (queue depth / TTFT / page
        headroom — the serve-SLO autoscaling signals)."""
        from .multiplex import loaded_model_ids

        out = {"ongoing": self._ongoing, "total": self._total,
               "model_ids": loaded_model_ids(self._callable),
               "ts": time.time()}
        stats_fn = getattr(self._callable, "engine_stats", None)
        if stats_fn is not None:
            try:
                eng = stats_fn()
                if eng:
                    out["engine"] = eng
            except Exception:
                pass  # a metrics probe must never take the replica down
        return out

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True

    def _apply_reconfigure(self, user_config):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    def reconfigure(self, user_config) -> bool:
        self._apply_reconfigure(user_config)
        return True

    async def prepare_shutdown(self, drain_s: float = 5.0) -> bool:
        """Drain: wait (cooperatively — this replica is an async actor, so
        in-flight requests keep running) until ongoing hits 0.  A callable
        that owns a decode engine drains it first (stop admitting, let
        active slots finish) instead of dropping the in-flight decodes
        when the actor is killed."""
        import asyncio

        deadline = time.time() + drain_s
        fn = getattr(self._callable, "prepare_shutdown", None)
        if fn is not None:
            # engine drain blocks: run it off the actor event loop so
            # concurrent metric probes / streaming reads keep flowing
            try:
                await asyncio.get_event_loop().run_in_executor(
                    None, lambda: fn(drain_s))
            except Exception:
                pass  # shutdown best-effort: the kill follows regardless
        while self._ongoing > 0 and time.time() < deadline:
            await asyncio.sleep(0.02)
        return True
