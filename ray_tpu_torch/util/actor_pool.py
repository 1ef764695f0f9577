"""ActorPool: round-robin work distribution over a fixed set of actors.

Mirrors the reference's ray.util.ActorPool (reference:
python/ray/util/actor_pool.py): submit/map/map_unordered/get_next/
get_next_unordered/has_next/push/pop_idle.  The port's copy of
``ray_tpu/util/actor_pool.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable):
        self._idle: List[Any] = list(actors)
        self._inflight = {}
        self._pending_by_seq = {}
        self._submit_seq = 0
        self._deliver_seq = 0
        self._pending_submits: List[tuple] = []

    # -- submission --------------------------------------------------------

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queued if no actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._inflight[future] = (self._submit_seq, actor)
            self._pending_by_seq[self._submit_seq] = future
            self._submit_seq += 1
        else:
            self._pending_submits.append((fn, value))

    def map(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- consumption -------------------------------------------------------

    def has_next(self) -> bool:
        return bool(self._inflight)

    def get_next(self, timeout: Optional[float] = None):
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no more results")
        # skip holes left by earlier unordered consumption
        while (self._deliver_seq not in self._pending_by_seq
               and self._deliver_seq < self._submit_seq):
            self._deliver_seq += 1
        future = self._pending_by_seq[self._deliver_seq]
        if timeout is not None:
            ready, _ = ray_tpu_torch.wait([future], num_returns=1, timeout=timeout)
            if not ready:
                # pool state untouched: the caller can retry
                raise TimeoutError("timed out waiting for result")
        del self._pending_by_seq[self._deliver_seq]
        self._deliver_seq += 1
        _, actor = self._inflight.pop(future)
        self._return_actor(actor)
        # a task error propagates but the actor is back in the pool
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: Optional[float] = None):
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError("timed out waiting for result")
        future = ready[0]
        i, actor = self._inflight.pop(future)
        del self._pending_by_seq[i]
        # unordered consumption shifts the ordered cursor past holes
        while (self._deliver_seq not in self._pending_by_seq
               and self._deliver_seq < self._submit_seq):
            self._deliver_seq += 1
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    # -- membership --------------------------------------------------------

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        while self._pending_submits and self._idle:
            fn, v = self._pending_submits.pop(0)
            self.submit(fn, v)

    def push(self, actor) -> None:
        busy = {a for _, a in self._inflight.values()}
        if actor in self._idle or actor in busy:
            raise ValueError("actor already in pool")
        self._return_actor(actor)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits
