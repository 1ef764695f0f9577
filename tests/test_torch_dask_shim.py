"""Dask-on-ray scheduler shim on the port's runtime: the cases of
tests/test_dask_shim.py against ``ray_tpu_torch.util.dask`` (reference:
python/ray/util/dask tests).

Exercised with raw dask-protocol graphs (dicts of key -> (fn, *args))
so the tests run without dask installed; with dask present the same
scheduler plugs into dask.config.set(scheduler=ray_dask_get).
"""

import operator

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util.dask import ray_dask_get


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_simple_graph(cluster):
    dsk = {
        "a": 1,
        "b": 2,
        "c": (operator.add, "a", "b"),
        "d": (operator.mul, "c", 10),
    }
    assert ray_dask_get(dsk, "d") == 30
    assert ray_dask_get(dsk, ["c", "d"]) == [3, 30]


def test_shared_dependency_runs_once(cluster):
    import ray_tpu_torch as rt

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def get(self):
            return self.n

    c = Counter.remote()

    def bump(_c=None):
        import ray_tpu_torch as rt

        return rt.get(c.inc.remote())

    dsk = {
        "base": (bump,),
        "l": (operator.add, "base", 0),
        "r": (operator.add, "base", 0),
        "sum": (operator.add, "l", "r"),
    }
    out = ray_dask_get(dsk, "sum")
    assert out == 2  # base ran once: 1 + 1
    assert rt.get(c.get.remote(), timeout=30) == 1


def test_nested_containers_and_tasks(cluster):
    dsk = {
        "xs": [1, 2, 3],
        "total": (sum, "xs"),
        "pair": (tuple, [(operator.add, "total", 1),
                         (operator.add, "total", 2)]),
    }
    # list of nested tasks resolves element-wise
    assert ray_dask_get(dsk, "total") == 6
    out = ray_dask_get(dsk, "pair")
    assert tuple(out) == (7, 8)


def test_cycle_detection(cluster):
    dsk = {"a": (operator.add, "b", 1), "b": (operator.add, "a", 1)}
    with pytest.raises(ValueError, match="cycle"):
        ray_dask_get(dsk, "a")
