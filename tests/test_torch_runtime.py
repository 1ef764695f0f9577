"""The port's task/actor runtime on the CPU: the cases of
tests/test_core_tasks.py, test_core_actors.py and test_core_objects.py,
each a parametrised case run on a cluster of ``ray_tpu_torch``'s own
control plane, raylet and workers, plus what the port adds (tensors
through the object plane, no JAX in its workers, CPU workers that see no
card).  One cluster per module; every get/wait has a timeout."""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt

T = 60  # seconds: any one get


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@rt.remote
def echo(x):
    return x


@rt.remote
def add(a, b):
    return a + b


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.v = start

    def inc(self, n=1):
        self.v += n
        return self.v

    def value(self):
        return self.v

    def fail(self):
        raise RuntimeError("method-error-marker")


# -- tasks (test_core_tasks.py) ----------------------------------------------


def _simple():
    assert rt.get(echo.remote(41), timeout=T) == 41


def _many():
    refs = [add.remote(i, 1) for i in range(50)]
    assert rt.get(refs, timeout=T) == [i + 1 for i in range(50)]


def _kwargs():
    @rt.remote
    def f(a, b=10, *, c=0):
        return a + b + c

    assert rt.get(f.remote(1, c=2), timeout=T) == 13


def _chained_refs():
    r1 = add.remote(1, 2)
    r2 = add.remote(r1, 10)
    assert rt.get(add.remote(r2, r1), timeout=T) == 16


def _nested_submission():
    @rt.remote
    def outer(x):
        return rt.get(add.remote(x, 1), timeout=T) * 2

    assert rt.get(outer.remote(10), timeout=2 * T) == 22


def _error_propagation():
    @rt.remote
    def boom():
        raise ValueError("kaboom-marker")

    with pytest.raises(rt.TaskError, match="kaboom-marker"):
        rt.get(boom.remote(), timeout=T)


def _error_through_dependency():
    @rt.remote
    def boom():
        raise RuntimeError("upstream-dead")

    with pytest.raises(rt.TaskError):
        rt.get(add.remote(boom.remote(), 1), timeout=T)


def _num_returns():
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    assert rt.get(list(three.remote()), timeout=T) == [1, 2, 3]


def _options_override():
    @rt.remote
    def pair():
        return "x", "y"

    a, b = pair.options(num_returns=2).remote()
    assert rt.get([a, b], timeout=T) == ["x", "y"]


def _wait():
    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    fast, slower = slow.remote(0.0), slow.remote(5.0)
    ready, not_ready = rt.wait([fast, slower], num_returns=1, timeout=30)
    assert ready and ready[0].id == fast.id
    assert not_ready and not_ready[0].id == slower.id


def _wait_timeout():
    @rt.remote
    def hang():
        time.sleep(5)

    ready, not_ready = rt.wait([hang.remote()], num_returns=1, timeout=0.5)
    assert not ready and len(not_ready) == 1


def _get_timeout():
    @rt.remote
    def hang():
        time.sleep(5)

    with pytest.raises(rt.GetTimeoutError):
        rt.get(hang.remote(), timeout=0.5)


def _large_args_and_returns():
    arr = np.random.default_rng(0).random((512, 512))

    @rt.remote
    def double(a):
        return a * 2

    np.testing.assert_array_equal(rt.get(double.remote(arr), timeout=T),
                                  arr * 2)


def _closure_capture():
    captured = {"k": 7}

    @rt.remote
    def use_closure():
        return captured["k"]

    assert rt.get(use_closure.remote(), timeout=T) == 7


def _retries_on_worker_death():
    @rt.remote(max_retries=2)
    def die_once(path):
        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)
        return "survived"

    with tempfile.TemporaryDirectory() as d:
        assert rt.get(die_once.remote(os.path.join(d, "once")),
                      timeout=2 * T) == "survived"


def _no_retries_raises():
    @rt.remote(max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(rt.WorkerCrashedError):
        rt.get(die.remote(), timeout=2 * T)


def _cancel_running():
    @rt.remote(max_retries=3)
    def spin():
        t0 = time.time()
        while time.time() - t0 < 30:
            sum(range(1000))
        return "finished"

    ref = spin.remote()
    time.sleep(1.0)
    assert rt.cancel(ref)
    t0 = time.time()
    with pytest.raises(rt.RayTpuError):
        rt.get(ref, timeout=T)
    assert time.time() - t0 < 30


def _cancel_finished_returns_false():
    ref = echo.remote(1)
    assert rt.get(ref, timeout=T) == 1
    assert rt.cancel(ref) is False


TASK_CASES = [_simple, _many, _kwargs, _chained_refs, _nested_submission,
              _error_propagation, _error_through_dependency, _num_returns,
              _options_override, _wait, _wait_timeout, _get_timeout,
              _large_args_and_returns, _closure_capture,
              _retries_on_worker_death, _no_retries_raises, _cancel_running,
              _cancel_finished_returns_false]


@pytest.mark.parametrize("case", TASK_CASES, ids=lambda f: f.__name__[1:])
def test_tasks(cluster, case):
    case()


# -- actors (test_core_actors.py) --------------------------------------------


def _actor_basic():
    c = Counter.remote(5)
    assert rt.get(c.inc.remote(), timeout=T) == 6
    assert rt.get(c.value.remote(), timeout=T) == 6


def _actor_ordering():
    c = Counter.remote(0)
    assert rt.get([c.inc.remote() for _ in range(20)],
                  timeout=T) == list(range(1, 21))


def _method_error_keeps_actor_alive():
    c = Counter.remote(0)
    with pytest.raises(rt.TaskError, match="method-error-marker"):
        rt.get(c.fail.remote(), timeout=T)
    assert rt.get(c.inc.remote(), timeout=T) == 1


def _named_actor():
    original = Counter.options(name="torch-named-counter").remote(42)
    h = rt.get_actor("torch-named-counter")
    assert rt.get(h.value.remote(), timeout=T) == 42
    del original


def _named_actor_collision():
    keep = Counter.options(name="torch-collide").remote(0)
    assert rt.get(keep.value.remote(), timeout=T) == 0
    with pytest.raises(Exception):
        h2 = Counter.options(name="torch-collide").remote(0)
        rt.get(h2.value.remote(), timeout=30)


def _constructor_error():
    @rt.remote
    class Bad:
        def __init__(self):
            raise ValueError("ctor-error")

        def m(self):
            return 1

    with pytest.raises(rt.ActorDiedError):
        rt.get(Bad.remote().m.remote(), timeout=T)


def _actor_restart():
    @rt.remote
    class Dier:
        def pid(self):
            return os.getpid()

        def die(self):
            os._exit(1)

    d = Dier.options(max_restarts=2).remote()
    pid1 = rt.get(d.pid.remote(), timeout=T)
    try:
        rt.get(d.die.remote(), timeout=30)
    except Exception:
        pass
    deadline = time.time() + T
    pid2 = None
    while time.time() < deadline:
        try:
            pid2 = rt.get(d.pid.remote(), timeout=30)
            break
        except rt.RayTpuError:
            time.sleep(0.5)
    assert pid2 is not None and pid2 != pid1


def _actor_kill():
    c = Counter.remote(0)
    assert rt.get(c.inc.remote(), timeout=T) == 1
    rt.kill(c)
    time.sleep(0.5)
    with pytest.raises(rt.ActorDiedError):
        rt.get(c.inc.remote(), timeout=30)


def _handle_in_task():
    c = Counter.remote(0)
    rt.get(c.inc.remote(), timeout=T)

    @rt.remote
    def use_handle(h):
        return rt.get(h.inc.remote(), timeout=T)

    assert rt.get(use_handle.remote(c), timeout=2 * T) == 2


def _actor_concurrency():
    @rt.remote
    class Slow:
        def work(self):
            time.sleep(0.5)
            return 1

    s = Slow.options(max_concurrency=4).remote()
    assert rt.get(s.work.remote(), timeout=T) == 1  # the actor is up
    t0 = time.time()
    assert sum(rt.get([s.work.remote() for _ in range(4)], timeout=T)) == 4
    assert time.time() - t0 < 1.9


def _bind_execute():
    c = Counter.remote(0)
    node = c.inc.bind(5)
    assert rt.get(node.execute(), timeout=T) == 5


ACTOR_CASES = [_actor_basic, _actor_ordering, _method_error_keeps_actor_alive,
               _named_actor, _named_actor_collision, _constructor_error,
               _actor_restart, _actor_kill, _handle_in_task,
               _actor_concurrency, _bind_execute]


@pytest.mark.parametrize("case", ACTOR_CASES, ids=lambda f: f.__name__[1:])
def test_actors(cluster, case):
    case()


# -- objects (test_core_objects.py), tensors among them ----------------------


def _put_get_small():
    ref = rt.put({"a": 1, "b": [1, 2, 3]})
    assert rt.get(ref, timeout=30) == {"a": 1, "b": [1, 2, 3]}


def _put_get_large():
    arr = np.arange(500_000, dtype=np.float64)
    np.testing.assert_array_equal(rt.get(rt.put(arr), timeout=30), arr)


def _put_ref_as_task_arg():
    ref = rt.put(np.ones(200_000, dtype=np.float32))

    @rt.remote
    def total(a):
        return float(a.sum())

    assert rt.get(total.remote(ref), timeout=T) == 200_000.0


def _ref_inside_container_not_materialized():
    ref = rt.put(123)

    @rt.remote
    def check(d):
        assert isinstance(d["ref"], rt.ObjectRef)
        return rt.get(d["ref"], timeout=T)

    assert rt.get(check.remote({"ref": ref}), timeout=T) == 123


def _shared_object_many_consumers():
    data = np.random.default_rng(1).random(100_000)
    ref = rt.put(data)

    @rt.remote
    def s(a):
        return float(a.sum())

    outs = rt.get([s.remote(ref) for _ in range(4)], timeout=T)
    assert all(abs(o - data.sum()) < 1e-6 for o in outs)


def _plain_pickle_of_ref_forbidden():
    import pickle

    with pytest.raises(TypeError):
        pickle.dumps(rt.put(1))


def _tensor_put_get():
    # a CPU tensor put by the driver comes back equal, dtype and all
    x = torch.arange(300_000, dtype=torch.float32).reshape(600, 500)
    got = rt.get(rt.put(x), timeout=30)
    assert got.dtype == torch.float32 and torch.equal(got, x)


def _tensor_task_arg_and_return():
    x = torch.randn(64, 33, generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16)

    @rt.remote
    def twice(a, b):
        return {"a": a * 2, "b": b * 2, "dtypes": (str(a.dtype),
                                                    str(b.dtype))}

    out = rt.get(twice.remote(x, xb), timeout=T)
    assert out["dtypes"] == ("torch.float32", "torch.bfloat16")
    assert torch.equal(out["a"], x * 2) and torch.equal(out["b"], xb * 2)


OBJECT_CASES = [_put_get_small, _put_get_large, _put_ref_as_task_arg,
                _ref_inside_container_not_materialized,
                _shared_object_many_consumers,
                _plain_pickle_of_ref_forbidden, _tensor_put_get,
                _tensor_task_arg_and_return]


@pytest.mark.parametrize("case", OBJECT_CASES, ids=lambda f: f.__name__[1:])
def test_objects(cluster, case):
    case()


# -- what the port adds ------------------------------------------------------


@rt.remote
def _worker_view():
    import sys

    return {"modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "ray_tpu",
                                                     "jaxlib")),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid()}


def test_workers_load_no_jax_and_see_no_card(cluster):
    """No worker of the port holds JAX or any module of the JAX package,
    and a worker that was not granted GPU is spawned with every card
    hidden."""
    views = rt.get([_worker_view.remote() for _ in range(4)], timeout=T)
    c = Counter.remote(0)

    @rt.remote
    def via_actor(h):
        return rt.get(h.value.remote(), timeout=T)

    assert rt.get(via_actor.remote(c), timeout=T) == 0
    for v in views:
        assert v["modules"] == [], v
        assert v["cuda_visible"] == "", v


def test_cluster_offers_no_gpu_here(cluster):
    assert "GPU" not in rt.cluster_resources()
    assert rt.cluster_resources()["CPU"] == 4.0


@rt.remote
def _burn(seconds):
    end = time.monotonic() + seconds
    n = 0
    while time.monotonic() < end:
        n += 1
    return n


@rt.remote
class _Released:
    def f(self, i):
        return i * i


def test_released_handle_keeps_its_queued_call(cluster):
    """A handle dropped as soon as its call is submitted releases its
    actor, and the release waits for the calls already submitted
    (ray_tpu/_private/core.py:3391-3395): under CPU-burning tasks, while
    the actors are still being placed, every call still returns."""
    for _ in range(3):
        burners = [_burn.remote(1.0) for _ in range(3)]
        got = rt.get([_Released.remote().f.remote(i)
                      for i in range(32)], timeout=120)
        assert got == [i * i for i in range(32)]
        rt.get(burners, timeout=T)
