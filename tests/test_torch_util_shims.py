"""Util shims on the port's runtime: the cases of
tests/test_util_shims.py against ``ray_tpu_torch.util.multiprocessing``
(Pool), ``util.joblib`` (the ``"ray_tpu_torch"`` backend), ``util.iter``
(parallel iterators), ``experimental.internal_kv`` and
``experimental.tqdm_ray`` (reference: python/ray/util/multiprocessing,
util/joblib, util/iter, experimental/).  The driver listener's case waits
for the rendered bar with a deadline, as the reference's does."""

import math

import pytest

import ray_tpu_torch as rt


@pytest.fixture(scope="module", autouse=True)
def _cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


# defined as lambdas so cloudpickle serializes them by value — a worker
# process cannot import this test module by name
_sq = lambda x: x * x  # noqa: E731
_add = lambda a, b: a + b  # noqa: E731


class TestPool:
    def test_map(self):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(2) as p:
            assert p.map(_sq, range(10)) == [x * x for x in range(10)]

    def test_apply_and_async(self):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(2) as p:
            assert p.apply(_add, (2, 3)) == 5
            r = p.apply_async(_add, (10, 20))
            assert r.get(timeout=30) == 30
            assert r.successful()

    def test_starmap_and_imap(self):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(2) as p:
            assert p.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
            assert list(p.imap(_sq, range(6), chunksize=2)) == \
                [0, 1, 4, 9, 16, 25]
            assert sorted(p.imap_unordered(_sq, range(6), chunksize=2)) == \
                [0, 1, 4, 9, 16, 25]

    def test_map_async_error(self):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(2) as p:
            r = p.map_async(math.sqrt, [-1.0])
            with pytest.raises(Exception):
                r.get(timeout=30)


class TestJoblib:
    def test_parallel_backend(self):
        import joblib

        from ray_tpu_torch.util.joblib import register_ray_tpu_torch

        register_ray_tpu_torch()
        with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
            out = joblib.Parallel()(
                joblib.delayed(_sq)(i) for i in range(8))
        assert out == [i * i for i in range(8)]


class TestParallelIterator:
    def test_from_items_for_each(self):
        from ray_tpu_torch.util import iter as rit

        it = rit.from_items(list(range(10)), num_shards=2).for_each(_sq)
        assert sorted(it.gather_sync()) == sorted(x * x for x in range(10))

    def test_filter_batch_flatten(self):
        from ray_tpu_torch.util import iter as rit

        it = (rit.from_range(20, num_shards=2)
              .filter(lambda x: x % 2 == 0)
              .batch(3))
        batches = list(it.gather_sync())
        assert all(isinstance(b, list) for b in batches)
        flat = [x for b in batches for x in b]
        assert sorted(flat) == [x for x in range(20) if x % 2 == 0]

    def test_gather_async_and_union(self):
        from ray_tpu_torch.util import iter as rit

        a = rit.from_items([1, 2, 3], num_shards=1)
        b = rit.from_items([10, 20], num_shards=1)
        u = a.union(b)
        assert u.num_shards == 2
        assert sorted(u.gather_async()) == [1, 2, 3, 10, 20]

    def test_take(self):
        from ray_tpu_torch.util import iter as rit

        assert len(rit.from_range(100, num_shards=4).take(5)) == 5


def test_internal_kv():
    from ray_tpu_torch.experimental import internal_kv as kv

    assert kv._internal_kv_initialized()
    existed = kv._internal_kv_put(b"ik-key", b"v1")
    assert existed is False
    assert kv._internal_kv_get(b"ik-key") == b"v1"
    assert kv._internal_kv_exists(b"ik-key")
    assert b"ik-key" in kv._internal_kv_list(b"ik-")
    assert kv._internal_kv_del(b"ik-key")
    assert kv._internal_kv_get(b"ik-key") is None


def test_tqdm_ray():
    from ray_tpu_torch.experimental import tqdm_ray

    out = list(tqdm_ray.tqdm(range(10), desc="probe"))
    assert out == list(range(10))

    import ray_tpu_torch as rt

    @rt.remote
    def work():
        from ray_tpu_torch.experimental.tqdm_ray import tqdm

        t = tqdm(total=5, desc="remote")
        for _ in range(5):
            t.update(1)
        t.close()
        return t.n

    assert rt.get(work.remote(), timeout=60) == 5


def test_tqdm_driver_listener():
    import io
    import sys
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental import tqdm_ray

    assert tqdm_ray.install_driver_listener()

    @rt.remote
    def work():
        from ray_tpu_torch.experimental.tqdm_ray import tqdm

        t = tqdm(total=3, desc="listened", flush_interval_s=0.0)
        for _ in range(3):
            t.update(1)
        t.close()
        return True

    old = sys.stderr
    sys.stderr = io.StringIO()
    try:
        assert rt.get(work.remote(), timeout=60)
        deadline = time.time() + 10
        while time.time() < deadline:
            if "listened" in sys.stderr.getvalue():
                break
            time.sleep(0.2)
        rendered = sys.stderr.getvalue()
    finally:
        sys.stderr = old
    assert "listened" in rendered
