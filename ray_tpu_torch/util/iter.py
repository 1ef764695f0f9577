"""Parallel iterators over actor shards.

Analog of the reference's ray.util.iter (reference: python/ray/util/iter.py
— from_items/from_range/from_iterators -> ParallelIterator over
ParallelIteratorWorker actors, with for_each/filter/batch/gather_sync/
gather_async/union and local shard access).  The port's copy of
``ray_tpu/util/iter.py``.  A shard actor passes a tensor it is given on
by the object plane's rule: one staged from a card comes back to its
reader from a CPU-only shard as a CPU tensor (ROADMAP §C).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, TypeVar

import ray_tpu_torch

T = TypeVar("T")
U = TypeVar("U")


@ray_tpu_torch.remote
class ParallelIteratorWorker:
    """Hosts one shard: a base iterable + a chain of transforms."""

    def __init__(self, items, repeat: bool = False):
        self._base = items
        self._repeat = repeat
        self._ops: List = []
        self._it = None

    def apply_op(self, kind: str, fn):
        self._ops.append((kind, fn))
        self._it = None
        return True

    def _build(self):
        if callable(self._base):
            it = self._base()
        else:
            it = iter(self._base)
        if self._repeat:
            base = self._base

            def forever():
                while True:
                    src = base() if callable(base) else iter(list(base))
                    yielded = False
                    for x in src:
                        yielded = True
                        yield x
                    if not yielded:
                        return

            it = forever()
        for kind, fn in self._ops:
            if kind == "for_each":
                it = map(fn, it)
            elif kind == "filter":
                it = filter(fn, it)
            elif kind == "batch":
                it = _batched(it, fn)
            elif kind == "flatten":
                it = itertools.chain.from_iterable(it)
        return it

    def next_batch(self, n: int = 1):
        """Pull up to n items; [] signals exhaustion."""
        if self._it is None:
            self._it = self._build()
        out = list(itertools.islice(self._it, n))
        return out


def _batched(it, n):
    while True:
        chunk = list(itertools.islice(it, n))
        if not chunk:
            return
        yield chunk


class LocalIterator:
    """Driver-side view of gathered results."""

    def __init__(self, gen_factory: Callable[[], Iterable]):
        self._factory = gen_factory

    def __iter__(self):
        return iter(self._factory())

    def take(self, n: int) -> List[Any]:
        return list(itertools.islice(iter(self), n))


class ParallelIterator:
    def __init__(self, actors: List):
        self._actors = actors

    @property
    def num_shards(self) -> int:
        return len(self._actors)

    # -- transforms (lazy, applied on the shard actors) --------------------

    def _apply(self, kind: str, fn) -> "ParallelIterator":
        ray_tpu_torch.get([a.apply_op.remote(kind, fn) for a in self._actors])
        return self

    def for_each(self, fn: Callable[[T], U]) -> "ParallelIterator":
        return self._apply("for_each", fn)

    def filter(self, fn: Callable[[T], bool]) -> "ParallelIterator":
        return self._apply("filter", fn)

    def batch(self, n: int) -> "ParallelIterator":
        return self._apply("batch", n)

    def flatten(self) -> "ParallelIterator":
        return self._apply("flatten", None)

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        return ParallelIterator(self._actors + other._actors)

    # -- consumption -------------------------------------------------------

    def gather_sync(self, batch: int = 16) -> LocalIterator:
        """Round-robin over shards, in order."""
        actors = self._actors

        def gen():
            live = list(actors)
            while live:
                done = []
                for a in live:
                    chunk = ray_tpu_torch.get(a.next_batch.remote(batch))
                    if not chunk:
                        done.append(a)
                    else:
                        yield from chunk
                live = [a for a in live if a not in done]

        return LocalIterator(gen)

    def gather_async(self, batch: int = 16) -> LocalIterator:
        """Yield from whichever shard finishes first."""
        actors = self._actors

        def gen():
            inflight = {a.next_batch.remote(batch): a for a in actors}
            while inflight:
                ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1)
                a = inflight.pop(ready[0])
                chunk = ray_tpu_torch.get(ready[0])
                if chunk:
                    inflight[a.next_batch.remote(batch)] = a
                    yield from chunk

        return LocalIterator(gen)

    def take(self, n: int) -> List[Any]:
        return self.gather_sync().take(n)


# -- constructors (reference: from_items :1078, from_range, from_iterators) -

def from_items(items: List[T], num_shards: int = 2,
               repeat: bool = False) -> ParallelIterator:
    shards = [items[i::num_shards] for i in range(num_shards)]
    return ParallelIterator([
        ParallelIteratorWorker.remote(s, repeat) for s in shards])


def from_range(n: int, num_shards: int = 2,
               repeat: bool = False) -> ParallelIterator:
    return from_items(list(range(n)), num_shards, repeat)


def from_iterators(generators: List[Callable[[], Iterable]],
                   repeat: bool = False) -> ParallelIterator:
    return ParallelIterator([
        ParallelIteratorWorker.remote(g, repeat) for g in generators])
