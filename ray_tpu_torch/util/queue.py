"""Distributed FIFO queue backed by a single queue actor.

Mirrors the reference's ray.util.queue.Queue (reference:
python/ray/util/queue.py): put/get with block+timeout, put/get_nowait,
batch variants, qsize/empty/full, shutdown.

The port's copy of ``ray_tpu/util/queue.py``.  The queue actor only
passes items on, so its loads keep a tensor staged from a card as its
stand-in (as the client server's do): the item is serialized again as
what it was and comes back to life on the reader's card, bitwise, while
the queue actor imports no torch for it and opens no CUDA context.  A
CPU tensor stays a CPU tensor (ROADMAP §C).
"""

from __future__ import annotations

import queue as _stdlib_queue
import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        from .._private.core import current_core

        # this worker runs nothing but the queue: every load it makes
        # keeps card tensors as their stand-ins
        current_core().keep_device_stand_ins = True
        self._q = _stdlib_queue.Queue(maxsize=maxsize)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()

    def put(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except _stdlib_queue.Full:
            return False

    def put_batch(self, items: List[Any]) -> bool:
        """All-or-nothing: insert only if every item fits (matching the
        reference's put_nowait_batch, which raises Full without inserting)."""
        if self._q.maxsize and self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for it in items:
            self._q.put_nowait(it)
        return True

    def get(self):
        try:
            return True, self._q.get_nowait()
        except _stdlib_queue.Empty:
            return False, None

    def get_batch(self, num_items: int):
        """All-or-nothing: dequeue only if num_items are present (matching
        the reference's get_nowait_batch, which raises Empty without
        removing anything)."""
        if self._q.qsize() < num_items:
            return None
        return [self._q.get_nowait() for _ in range(num_items)]


class Queue:
    """Actor-backed queue usable from any worker or driver."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        self.actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        if not ray_tpu_torch.get(self.actor.put.remote(item)):
            if not block:
                raise Full
            # ship the payload once: poll full-ness with a payload-free
            # probe, resend only when space appeared
            while True:
                if deadline is not None and time.monotonic() > deadline:
                    raise Full
                time.sleep(0.01)
                if not ray_tpu_torch.get(self.actor.full.remote()):
                    if ray_tpu_torch.get(self.actor.put.remote(item)):
                        return
        else:
            return

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_batch.remote(list(items))):
            raise Full(f"batch of {len(items)} does not fit")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() > deadline:
                raise Empty
            time.sleep(0.01)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        items = ray_tpu_torch.get(self.actor.get_batch.remote(num_items))
        if items is None:
            raise Empty(f"queue has fewer than {num_items} items")
        return items

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
