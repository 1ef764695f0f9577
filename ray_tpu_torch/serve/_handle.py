"""DeploymentHandle: typed Python calls into a deployment.

Reference: python/ray/serve/handle.py DeploymentHandle/DeploymentResponse —
``handle.remote(*a)`` routes through the same p2c router as HTTP and
returns a `DeploymentResponse` future; handles pickle by (app, deployment)
name so they can be shipped into other replicas for model composition, and
`await response` works inside async replicas without blocking their loop.

Responses resolve through the router's replay core (_router.py): a
replica that dies mid-call is ejected and the request replayed on a
survivor, transparently to the caller.  Streaming responses registered
with a resume continuation (``options(resume="llm_tokens")``) continue
from the last item the client received instead of restarting.

The port's copy of ``ray_tpu/serve/_handle.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from ._router import get_router


class DeploymentResponse:
    def __init__(self, router, sub):
        self._router = router
        self._sub = sub
        self._result = None
        self._have_result = False

    def result(self, timeout_s: Optional[float] = 300.0):
        if not self._have_result:
            self._result = self._router.call(self._sub,
                                             timeout_s=timeout_s)
            self._have_result = True
        return self._result

    def _to_object_ref(self):
        return self._sub.ref

    def _fire_done(self):
        self._sub.fire_done()

    def __await__(self):
        loop = asyncio.get_event_loop()
        fut = loop.run_in_executor(None, self.result)
        return fut.__await__()

    def __del__(self):
        # dropped without .result(): still release the router's inflight slot
        self._fire_done()


class DeploymentResponseGenerator:
    """Streaming response: iterate to receive items as the deployment
    yields them (reference: handle.py DeploymentResponseGenerator).
    Sync iteration blocks per item; `async for` hops via an executor.
    Abandoning the iteration (break / close / GC before exhaustion)
    releases the router's in-flight slot instead of inflating the
    replica's load score forever."""

    def __init__(self, router, sub):
        self._router = router
        self._sub = sub
        self._it = None

    def _fire_done(self):
        self._sub.fire_done()

    def close(self):
        """Abandon the stream: close the underlying iterator (its
        finally releases the in-flight slot)."""
        it, self._it = self._it, None
        if it is not None:
            try:
                it.close()
            except Exception:
                pass
        self._fire_done()

    def __iter__(self):
        # a generator, so the iteration holds this object: in `for x in
        # h.options(stream=True).remote()` nothing else does, and its
        # __del__ would close the stream before the first item (the
        # reference returns the router's iterator itself)
        if self._it is None:
            self._it = self._router.iter_stream(self._sub)
        yield from self._it

    async def __aiter__(self):
        loop = asyncio.get_event_loop()
        it = iter(self)
        sentinel = object()
        try:
            while True:
                item = await loop.run_in_executor(
                    None, lambda: next(it, sentinel))
                if item is sentinel:
                    return
                yield item
        finally:
            # a client that stops consuming (disconnect, early break in
            # `async for`) must release the in-flight slot NOW, not when
            # the GC eventually finds the generator
            await loop.run_in_executor(None, self.close)

    def __del__(self):
        self.close()


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str,
                 method_name: Optional[str] = None,
                 multiplexed_model_id: Optional[str] = None,
                 stream: bool = False, resume: Optional[str] = None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._multiplexed_model_id = multiplexed_model_id
        self._stream = stream
        self._resume = resume

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                resume: Optional[str] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name=method_name or self._method_name,
            multiplexed_model_id=(multiplexed_model_id
                                  or self._multiplexed_model_id),
            stream=self._stream if stream is None else stream,
            resume=resume or self._resume)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs):
        router = get_router(self.app_name, self.deployment_name)
        metadata: Dict[str, Any] = {}
        if self._multiplexed_model_id:
            metadata["multiplexed_model_id"] = self._multiplexed_model_id
        if self._resume:
            metadata["resume"] = self._resume
        sub = router.submit(self._method_name, args, kwargs, metadata,
                            streaming=self._stream)
        if self._stream:
            return DeploymentResponseGenerator(router, sub)
        return DeploymentResponse(router, sub)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self._method_name,
                 self._multiplexed_model_id, self._stream, self._resume))

    def __repr__(self):
        return (f"DeploymentHandle(app={self.app_name!r}, "
                f"deployment={self.deployment_name!r})")
