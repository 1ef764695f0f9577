"""@serve.batch: transparent request batching inside a replica.

Reference: python/ray/serve/batching.py (692 LoC) — callers invoke the
wrapped method with a single item and get a single result; the wrapper
pools concurrent calls into a list, invokes the underlying function once
per batch, and scatters results.  On GPU replicas this is the mechanism
that turns concurrent single requests into one batched forward pass on
the card.

The port's copy of ``ray_tpu/serve/batching.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self.queue: Optional[asyncio.Queue] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._flusher: Optional[asyncio.Task] = None

    def _ensure(self):
        # bound to the loop actually running the request; a dead flusher
        # (raised, or cancelled when a previous loop was torn down — the
        # between-tests case) or a loop change re-arms instead of
        # silently queueing onto a task nobody is draining
        loop = asyncio.get_running_loop()
        if (self.queue is not None and self._loop is loop
                and self._flusher is not None
                and not self._flusher.done()):
            return
        if self.queue is not None:
            err: BaseException
            if (self._flusher is not None and self._flusher.done()
                    and not self._flusher.cancelled()
                    and self._flusher.exception() is not None):
                err = self._flusher.exception()
            else:
                err = RuntimeError(
                    "serve.batch flusher died (event loop torn down?)")
            self._fail_pending(err)
        self._loop = loop
        self.queue = asyncio.Queue()
        self._flusher = loop.create_task(self._flush_loop())

    def _fail_pending(self, err: BaseException):
        """Propagate a flusher death to everything still queued — their
        futures may belong to an already-closed loop, so failures to
        set are swallowed (the awaiter is gone with its loop)."""
        while self.queue is not None and not self.queue.empty():
            _, f = self.queue.get_nowait()
            try:
                if not f.done():
                    f.set_exception(err)
            except Exception:
                pass

    async def submit(self, item: Any) -> Any:
        self._ensure()
        fut = asyncio.get_running_loop().create_future()
        self.queue.put_nowait((item, fut))
        return await fut

    async def _flush_loop(self):
        while True:
            item, fut = await self.queue.get()
            batch = [(item, fut)]
            try:
                deadline = asyncio.get_event_loop().time() \
                    + self.batch_wait_timeout_s
                while len(batch) < self.max_batch_size:
                    remaining = deadline - asyncio.get_event_loop().time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self.queue.get(), timeout=remaining))
                    except asyncio.TimeoutError:
                        break
                out = self.fn([b[0] for b in batch])
                if inspect.iscoroutine(out):
                    out = await out
                if not isinstance(out, (list, tuple)) \
                        or len(out) != len(batch):
                    raise TypeError(
                        f"@serve.batch function must return a list of "
                        f"{len(batch)} results, got {type(out).__name__}")
                for (_, f), r in zip(batch, out):
                    if not f.done():
                        f.set_result(r)
            except BaseException as e:
                # fn errors scatter to the batch and the flusher lives
                # on; cancellation (loop teardown) also fails the batch
                # it was holding — hung futures were the old failure
                # mode — then propagates so _ensure can re-arm later
                for _, f in batch:
                    try:
                        if not f.done():
                            f.set_exception(e)
                    except Exception:
                        pass
                if isinstance(e, (asyncio.CancelledError, GeneratorExit)):
                    raise


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator for (async) methods taking a List of items and returning a
    List of results; callers pass single items."""

    def wrap(fn):
        attr = f"__serve_batch_queue_{fn.__name__}"

        if _is_method(fn):
            @functools.wraps(fn)
            async def method_wrapper(self, item):
                q = getattr(self, attr, None)
                if q is None:
                    q = _BatchQueue(
                        lambda items: fn(self, items),
                        max_batch_size, batch_wait_timeout_s)
                    setattr(self, attr, q)
                return await q.submit(item)

            method_wrapper._is_serve_batch = True
            return method_wrapper

        q_holder: List[Optional[_BatchQueue]] = [None]

        @functools.wraps(fn)
        async def func_wrapper(item):
            if q_holder[0] is None:
                q_holder[0] = _BatchQueue(fn, max_batch_size,
                                          batch_wait_timeout_s)
            return await q_holder[0].submit(item)

        func_wrapper._is_serve_batch = True
        return func_wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


def _is_method(fn: Callable) -> bool:
    params = list(inspect.signature(fn).parameters)
    return bool(params) and params[0] == "self"
