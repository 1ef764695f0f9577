"""Remote-driver (client mode) on the port's runtime: the cases of
tests/test_client.py against ``ray_tpu_torch.util.client`` and
``init("ray-tpu-torch://...")`` (reference model:
python/ray/tests/test_client.py over util/client), plus what the port
adds: a tensor staged from a card passes through the client server as
its host-side stand-in, so the server imports no torch for it and the
client restores it by the object plane's rule, bitwise."""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as ray_tpu
from ray_tpu_torch._private import serialization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def client_cluster():
    """A cluster + ClientServer; yields the ray-tpu-torch:// address.

    Saves and restores the process-global core (a real remote driver is
    its own process; in-test we swap the global instead)."""
    from ray_tpu_torch._private import core as core_mod
    from ray_tpu_torch._private.bootstrap import Cluster
    from ray_tpu_torch.util.client import ClientServer

    prev_core = ray_tpu._core
    prev_current = core_mod._current_core
    ray_tpu._core = None

    c = Cluster()
    c.start_control()
    c.add_node(resources={"CPU": 4})
    srv = ClientServer(c.control_addr, port=0)
    srv.start()
    yield f"ray-tpu-torch://{srv.addr[0]}:{srv.addr[1]}"
    cc = ray_tpu._core
    if cc is not None and cc is not prev_core:
        try:
            cc.shutdown()
        except Exception:
            pass
    srv.stop()
    c.shutdown()
    ray_tpu._core = prev_core
    core_mod._current_core = prev_current


def test_client_tasks_and_objects(client_cluster):
    info = ray_tpu.init(client_cluster)
    assert info.get("client") is True

    @ray_tpu.remote
    def add(a, b):
        return a + b

    assert ray_tpu.get(add.remote(2, 3), timeout=60) == 5

    # put/get roundtrip incl. numpy
    ref = ray_tpu.put(np.arange(1000))
    out = ray_tpu.get(ref, timeout=60)
    assert out.sum() == np.arange(1000).sum()

    # refs as task args cross the wire as markers
    ref2 = add.remote(ref, ref)
    assert ray_tpu.get(ref2, timeout=60).sum() == 2 * out.sum()

    # wait
    refs = [add.remote(i, i) for i in range(4)]
    ready, not_ready = ray_tpu.wait(refs, num_returns=2, timeout=60)
    assert len(ready) == 2 and len(not_ready) == 2


def test_client_actors(client_cluster):
    ray_tpu.init(client_cluster)

    @ray_tpu.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def inc(self, n=1):
            self.v += n
            return self.v

    c = Counter.remote(10)
    assert ray_tpu.get(c.inc.remote(), timeout=60) == 11
    assert ray_tpu.get(c.inc.remote(5), timeout=60) == 16

    named = Counter.options(name="client-named").remote(0)
    h = ray_tpu.get_actor("client-named")
    assert ray_tpu.get(h.inc.remote(), timeout=60) == 1

    ray_tpu.kill(c)
    import time

    time.sleep(0.5)
    with pytest.raises(ray_tpu.RayTpuError):
        ray_tpu.get(c.inc.remote(), timeout=30)


def test_client_task_errors_propagate(client_cluster):
    ray_tpu.init(client_cluster)

    @ray_tpu.remote
    def boom():
        raise ValueError("client-boom")

    with pytest.raises(ray_tpu.TaskError, match="client-boom"):
        ray_tpu.get(boom.remote(), timeout=60)


def test_client_control_plane_passthrough(client_cluster):
    """Placement groups + cluster resources go through the control proxy."""
    ray_tpu.init(client_cluster)
    assert ray_tpu.cluster_resources().get("CPU") == 4.0

    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    pg = placement_group([{"CPU": 1}, {"CPU": 1}])
    assert pg.ready(timeout=60)

    @ray_tpu.remote
    def where():
        return 1

    assert ray_tpu.get(
        where.options(placement_group=pg).remote(), timeout=60) == 1
    remove_placement_group(pg)


def test_client_streaming_generator(client_cluster):
    """num_returns="streaming" proxied through ray-tpu-torch:// (direct-mode
    counterpart: tests/test_streaming_generator.py)."""
    ray_tpu.init(client_cluster)

    @ray_tpu.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    g = gen.remote(5)
    got = [ray_tpu.get(ref, timeout=60) for ref in g]
    assert got == [0, 10, 20, 30, 40]
    assert g.completed()

    # next_ready timeout semantics
    @ray_tpu.remote(num_returns="streaming")
    def slow():
        import time
        time.sleep(30)
        yield 1

    g2 = slow.remote()
    with pytest.raises(ray_tpu.GetTimeoutError):
        g2.next_ready(timeout=0.5)


def test_client_streaming_actor_method(client_cluster):
    ray_tpu.init(client_cluster)

    @ray_tpu.remote
    class Gen:
        def items(self, n):
            for i in range(n):
                yield i + 100

    a = Gen.remote()
    g = a.items.options(num_returns="streaming").remote(3)
    got = [ray_tpu.get(ref, timeout=60) for ref in g]
    assert got == [100, 101, 102]


def test_client_streaming_error_propagates(client_cluster):
    ray_tpu.init(client_cluster)

    @ray_tpu.remote(num_returns="streaming")
    def bad():
        yield 1
        raise RuntimeError("stream-boom")

    g = bad.remote()
    assert ray_tpu.get(next(g), timeout=60) == 1
    with pytest.raises(Exception, match="stream-boom"):
        for ref in g:
            ray_tpu.get(ref, timeout=60)


# -- what the port adds ------------------------------------------------------

def _card_stand_in():
    """A bf16 tensor's stand-in as a worker on a card stages it (the CPU
    stands in for the card here)."""
    x = torch.linspace(-3, 3, 96).reshape(8, 12).to(torch.bfloat16)
    stand_in = serialization._stage_tensor(x)
    stand_in.device_type = "cuda"
    return x, stand_in


def test_stand_in_kept_and_reserialized_as_itself():
    x, stand_in = _card_stand_in()
    blob = serialization.dumps_inline({"t": stand_in, "n": 3})
    kept = serialization.loads_inline(blob, keep_stand_ins=True)["t"]
    assert type(kept) is serialization._TensorStandIn
    assert kept.device_type == "cuda" and kept.dtype == "bfloat16"
    again = serialization.dumps_inline([kept])
    # where nothing keeps them, it comes back by the object plane's rule:
    # in a process that sees no card, on the CPU, bitwise
    (y,) = serialization.loads_inline(again)
    assert y.device.type == "cpu" and y.dtype == torch.bfloat16
    assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    # CPU tensors are never kept
    z = serialization.loads_inline(serialization.dumps_inline(x),
                                   keep_stand_ins=True)
    assert isinstance(z, torch.Tensor) and torch.equal(z, x)


def test_keeping_is_scoped_to_the_load_that_asks():
    """A load that keeps stand-ins leaves every other load of the process
    alone, in this thread and in threads that load at the same time."""
    import threading

    x, stand_in = _card_stand_in()
    meta, bufs = serialization.dumps_oob({"t": stand_in})
    assert type(serialization.loads_oob(meta, bufs, keep_stand_ins=True)
                ["t"]) is serialization._TensorStandIn
    assert isinstance(serialization.loads_oob(meta, bufs)["t"],
                      torch.Tensor)
    got = {}
    start = threading.Barrier(8)

    def load(i):
        start.wait()
        got[i] = [type(serialization.loads_oob(
            meta, bufs, keep_stand_ins=i % 2 == 1)["t"]) for _ in range(50)]

    threads = [threading.Thread(target=load, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, types in got.items():
        want = serialization._TensorStandIn if i % 2 else torch.Tensor
        assert all(issubclass(t, want) for t in types), (i, types)


def test_driver_beside_a_live_server_gets_tensors():
    """A ClientServer in this process keeps a card tensor's stand-in in its
    own loads, while a driver in the same process still gets the tensor."""
    from ray_tpu_torch._private import core as core_mod
    from ray_tpu_torch._private.bootstrap import Cluster
    from ray_tpu_torch.util.client import ClientServer

    prev_core, prev_current = ray_tpu._core, core_mod._current_core
    ray_tpu._core = None
    c = Cluster()
    c.start_control()
    c.add_node(resources={"CPU": 2})
    srv = ClientServer(c.control_addr, port=0)
    srv.start()
    try:
        ray_tpu.init(address="%s:%s" % c.control_addr)
        x, stand_in = _card_stand_in()
        blob = pickle.dumps(stand_in)

        @ray_tpu.remote
        def make():
            import pickle as _p

            return {"t": _p.loads(blob), "n": 7}

        ref = make.remote()
        got = ray_tpu.get(ref, timeout=60)
        assert isinstance(got["t"], torch.Tensor) and got["n"] == 7
        assert torch.equal(got["t"].view(torch.int16), x.view(torch.int16))
        # the server's own core, in this process, keeps the stand-in of
        # what it submits
        refs = srv.core.submit_task(make._fn, (), {})
        (kept,) = srv.core.get(refs, timeout=60)
        assert type(kept["t"]) is serialization._TensorStandIn
        # and the driver's next load is a tensor again
        again = ray_tpu.get(make.remote(), timeout=60)
        assert isinstance(again["t"], torch.Tensor)
    finally:
        cc = ray_tpu._core
        if cc is not None and cc is not prev_core:
            cc.shutdown()
        ray_tpu._core = prev_core
        core_mod._current_core = prev_current
        srv.stop()
        c.shutdown()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_card_tensor_passes_through_a_server_without_torch():
    """The server process proxies a value holding a tensor staged from a
    card, both ways, and never loads torch (so it can open no CUDA
    context); the client gets the tensor, bitwise."""
    from ray_tpu_torch._private import core as core_mod
    from ray_tpu_torch._private.bootstrap import Cluster

    c = Cluster()
    c.start_control()
    c.add_node(resources={"CPU": 2})
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    ctrl = f"{c.control_addr[0]}:{c.control_addr[1]}"
    srv = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.util.client.server",
         "--control", ctrl, "--port", str(port)], env=env, cwd="/",
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    prev_core, prev_current = ray_tpu._core, core_mod._current_core
    ray_tpu._core = None
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                ray_tpu.init(f"ray-tpu-torch://127.0.0.1:{port}")
                break
            except Exception:
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.3)
        x, stand_in = _card_stand_in()

        @ray_tpu.remote
        class OnCard:
            def make(self):
                import pickle as _p

                return {"t": _p.loads(blob), "n": 7}

        blob = pickle.dumps(stand_in)
        a = OnCard.remote()
        got = ray_tpu.get(a.make.remote(), timeout=60)
        assert got["n"] == 7 and got["t"].dtype == torch.bfloat16
        assert torch.equal(got["t"].view(torch.int16), x.view(torch.int16))
        # a value the client puts is held by the server, as it came
        ref = ray_tpu.put({"t": stand_in})
        back = ray_tpu.get(ref, timeout=60)
        assert torch.equal(back["t"].view(torch.int16), x.view(torch.int16))
        with open(f"/proc/{srv.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps and "libc10" not in maps
    finally:
        cc = ray_tpu._core
        if cc is not None and cc is not prev_core:
            cc.shutdown()
        ray_tpu._core = prev_core
        core_mod._current_core = prev_current
        srv.terminate()
        srv.wait(timeout=30)
        c.shutdown()
