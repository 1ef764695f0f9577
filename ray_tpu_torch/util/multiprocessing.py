"""Drop-in `multiprocessing.Pool` backed by ray_tpu_torch actors.

Analog of the reference's ray.util.multiprocessing (reference:
python/ray/util/multiprocessing/pool.py): the Pool API (map/imap/starmap/
apply, sync + async variants) over a pool of actor processes, so existing
multiprocessing code scales past one node by changing an import.
The port's copy of ``ray_tpu/util/multiprocessing.py``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch
from .actor_pool import ActorPool


class AsyncResult:
    """multiprocessing.pool.AsyncResult equivalent."""

    def __init__(self, refs, single: bool, callback=None,
                 error_callback=None):
        self._refs = refs
        self._single = single
        self._value = None
        self._error = None
        self._done = threading.Event()
        t = threading.Thread(target=self._wait_thread,
                             args=(callback, error_callback), daemon=True)
        t.start()

    def _wait_thread(self, callback, error_callback):
        try:
            vals = ray_tpu_torch.get(list(self._refs))
            self._value = vals[0] if self._single else vals
            if callback is not None:
                callback(self._value)
        except Exception as e:
            self._error = e
            if error_callback is not None:
                error_callback(e)
        finally:
            self._done.set()

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def wait(self, timeout: Optional[float] = None):
        self._done.wait(timeout)

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self._done.is_set():
            raise ValueError("result not ready")
        return self._error is None


@ray_tpu_torch.remote
class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_chunk(self, fn, chunk):
        return [fn(*args) for args in chunk]


class Pool:
    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=()):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(ray_tpu_torch.cluster_resources()
                                   .get("CPU", 1)))
        self._size = processes
        self._actors = [_PoolWorker.remote(initializer, initargs)
                        for _ in range(processes)]
        self._idx = itertools.count()
        self._closed = False

    # -- apply -------------------------------------------------------------

    def _next_actor(self):
        return self._actors[next(self._idx) % self._size]

    def apply(self, func: Callable, args=(), kwds=None):
        return ray_tpu_torch.get(
            self._next_actor().run.remote(func, args, kwds))

    def apply_async(self, func, args=(), kwds=None, callback=None,
                    error_callback=None) -> AsyncResult:
        ref = self._next_actor().run.remote(func, args, kwds)
        return AsyncResult([ref], single=True, callback=callback,
                           error_callback=error_callback)

    # -- map ---------------------------------------------------------------

    def _chunks(self, iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], chunksize

    def _map_refs(self, func, star_items, chunksize):
        chunks, _ = self._chunks(star_items, chunksize)
        return [self._actors[i % self._size].run_chunk.remote(func, c)
                for i, c in enumerate(chunks)]

    def map(self, func, iterable: Iterable, chunksize=None) -> List[Any]:
        refs = self._map_refs(func, [(x,) for x in iterable], chunksize)
        return [v for chunk in ray_tpu_torch.get(refs) for v in chunk]

    def map_async(self, func, iterable, chunksize=None, callback=None,
                  error_callback=None) -> AsyncResult:
        refs = self._map_refs(func, [(x,) for x in iterable], chunksize)

        # flatten on completion
        class _FlatResult(AsyncResult):
            def _wait_thread(self, cb, ecb):
                try:
                    chunks = ray_tpu_torch.get(list(self._refs))
                    self._value = [v for c in chunks for v in c]
                    if cb:
                        cb(self._value)
                except Exception as e:
                    self._error = e
                    if ecb:
                        ecb(e)
                finally:
                    self._done.set()

        return _FlatResult(refs, single=False, callback=callback,
                           error_callback=error_callback)

    def starmap(self, func, iterable: Iterable, chunksize=None):
        refs = self._map_refs(func, list(iterable), chunksize)
        return [v for chunk in ray_tpu_torch.get(refs) for v in chunk]

    def imap(self, func, iterable, chunksize=1):
        chunks, _ = self._chunks([(x,) for x in iterable], chunksize)
        refs = [self._actors[i % self._size].run_chunk.remote(func, c)
                for i, c in enumerate(chunks)]
        for ref in refs:
            for v in ray_tpu_torch.get(ref):
                yield v

    def imap_unordered(self, func, iterable, chunksize=1):
        chunks, _ = self._chunks([(x,) for x in iterable], chunksize)
        pending = {self._actors[i % self._size]
                   .run_chunk.remote(func, c): None
                   for i, c in enumerate(chunks)}
        refs = list(pending)
        while refs:
            ready, refs = ray_tpu_torch.wait(refs, num_returns=1)
            for v in ray_tpu_torch.get(ready[0]):
                yield v

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("join() before close()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
