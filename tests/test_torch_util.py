"""``ray_tpu_torch.util`` on the port's runtime: the cases of
tests/test_util.py (placement groups, ActorPool, Queue; reference:
python/ray/tests/test_placement_group*.py, test_actor_pool.py,
test_queue.py) on one cluster of the port's own per module, and what the
port adds: a tensor staged from a card passes through the queue actor as
its stand-in (the queue's worker loads no torch) and comes back to life
in the reader, bitwise, while a CPU tensor stays a CPU tensor."""

import pickle

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import serialization
from ray_tpu_torch.util import (ActorPool, Empty,
                                PlacementGroupSchedulingStrategy, Queue,
                                get_placement_group, placement_group,
                                placement_group_table,
                                remove_placement_group)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_placement_group_lifecycle(cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK",
                         name="test-pg")
    assert pg.ready(timeout=30)
    table = placement_group_table()
    assert pg.id in table
    assert table[pg.id]["state"] == "ALIVE"
    assert get_placement_group("test-pg").id == pg.id
    assert pg.bundle_count == 2
    remove_placement_group(pg)


def test_placement_group_infeasible(cluster):
    pg = placement_group([{"CPU": 512}])
    assert not pg.ready(timeout=1.0)
    remove_placement_group(pg)


def test_placement_group_scheduling(cluster):
    pg = placement_group([{"CPU": 1}])
    assert pg.ready(timeout=30)

    @rt.remote
    def where():
        import os

        return os.getpid()

    pid = rt.get(where.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=0)).remote())
    assert pid > 0
    remove_placement_group(pg)


def test_placement_group_validation(cluster):
    with pytest.raises(ValueError):
        placement_group([], strategy="PACK")
    with pytest.raises(ValueError):
        placement_group([{"CPU": 1}], strategy="BOGUS")
    with pytest.raises(ValueError):
        placement_group([{}])


@rt.remote
class _PoolWorker:
    def double(self, x):
        return 2 * x


def test_actor_pool_ordered(cluster):
    actors = [_PoolWorker.options(num_cpus=0).remote() for _ in range(2)]
    pool = ActorPool(actors)
    out = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
    assert out == [0, 2, 4, 6, 8, 10]
    for a in actors:
        rt.kill(a)


def test_actor_pool_unordered(cluster):
    actors = [_PoolWorker.options(num_cpus=0).remote() for _ in range(2)]
    pool = ActorPool(actors)
    out = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                    range(6)))
    assert out == [0, 2, 4, 6, 8, 10]
    for a in actors:
        rt.kill(a)


def test_actor_pool_push_pop(cluster):
    a1 = _PoolWorker.options(num_cpus=0).remote()
    pool = ActorPool([a1])
    got = pool.pop_idle()
    assert got is a1
    assert pool.pop_idle() is None
    pool.push(a1)
    with pytest.raises(ValueError):
        pool.push(a1)
    rt.kill(a1)


def test_queue_basic(cluster):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    assert q.qsize() == 2
    assert q.full()
    assert q.get() == 1
    assert q.get_nowait() == 2
    with pytest.raises(Empty):
        q.get_nowait()
    q.put_nowait_batch([5, 6])
    assert q.get_nowait_batch(2) == [5, 6]
    q.shutdown()


def test_queue_from_workers(cluster):
    q = Queue()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return True

    assert rt.get(producer.remote(q, 5))
    assert sorted(q.get() for _ in range(5)) == [0, 1, 2, 3, 4]
    q.shutdown()


# -- what the port adds ------------------------------------------------------

def _card_stand_ins():
    """bf16 tensors' stand-ins as a worker on a card stages them (the CPU
    stands in for the card here): one small enough to ride inline, one
    that goes through the object store."""
    out = []
    for n in (96, 1 << 18):
        x = torch.linspace(-3, 3, n).to(torch.bfloat16)
        stand_in = serialization._stage_tensor(x)
        stand_in.device_type = "cuda"
        out.append((x, stand_in))
    return out


def test_queue_passes_card_tensors_on_as_stand_ins(cluster):
    """A producer that staged card tensors puts them; the queue actor
    keeps each as its stand-in (its worker never imports torch) and the
    reader restores it, bitwise.  A CPU tensor stays a CPU tensor."""
    pairs = _card_stand_ins()
    blobs = [pickle.dumps(s) for _, s in pairs]
    q = Queue()

    @rt.remote
    def producer(q, blobs):
        import pickle as _p

        # plain pickle keeps the stand-ins as they were staged on a card
        for b in blobs:
            q.put({"t": _p.loads(b)})
        q.put_nowait_batch([_p.loads(b) for b in blobs])
        return True

    assert rt.get(producer.remote(q, blobs), timeout=60)
    got = [q.get(timeout=30)["t"] for _ in pairs] + q.get_nowait_batch(2)
    for (x, _), y in zip(pairs + pairs, got):
        # in a process that sees no card, the object plane's rule: the
        # CPU; on the card, the reader's card
        assert isinstance(y, torch.Tensor) and y.dtype == torch.bfloat16
        assert y.device.type == "cpu"
        assert torch.equal(y.view(torch.int16), x.view(torch.int16))

    # the queue actor's worker never loaded torch for them
    from ray_tpu_torch.util import state

    (w,) = [w for w in state.list_workers()
            if w["actor_id"] == q.actor._actor_id]
    with open(f"/proc/{w['pid']}/maps") as f:
        maps = f.read()
    assert "libtorch" not in maps and "libc10" not in maps
    # a CPU tensor is never kept: it stays a CPU tensor through the queue
    cpu = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    q.put(cpu)
    back = q.get(timeout=30)
    assert back.device.type == "cpu" and torch.equal(back, cpu)
    q.shutdown()
