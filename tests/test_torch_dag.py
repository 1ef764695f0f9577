"""Compiled graphs on the port's runtime: the cases of tests/test_dag.py,
each run against ``ray_tpu_torch.dag`` on a cluster of the port's own
control plane, raylet and workers (one cluster per module), plus the
port's reducers on tensors and its out-of-order ``get``.

Reference test model: python/ray/dag/tests/experimental/
test_accelerated_dag.py + channel tests."""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.dag import (Channel, ChannelClosed, InputNode,
                               MultiOutputNode, allreduce_bind)
from ray_tpu_torch.dag.channel import ChannelTimeout
from ray_tpu_torch.dag.collective import REDUCERS

T = 60  # seconds: any one get


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


# ---------------------------------------------------------------------------
# native channel layer
# ---------------------------------------------------------------------------

def test_channel_roundtrip(tmp_path):
    c = Channel(str(tmp_path / "c1"))
    c.write({"a": np.arange(10)})
    tag, v = c.read(timeout_s=5)
    np.testing.assert_array_equal(v["a"], np.arange(10))
    c.release()


def test_channel_ring_pipelining(tmp_path):
    c = Channel(str(tmp_path / "c2"), nslots=4)
    for i in range(4):  # fills the ring without blocking
        c.write(i, timeout_s=2)
    for i in range(4):
        assert c.read(timeout_s=2)[1] == i
    c.release()


def test_channel_backpressure_timeout(tmp_path):
    c = Channel(str(tmp_path / "c3"), nslots=2)
    c.write(1, timeout_s=1)
    c.write(2, timeout_s=1)
    with pytest.raises(ChannelTimeout):
        c.write(3, timeout_s=0.2)  # ring full, no reader
    c.release()


def test_channel_close_wakes_reader(tmp_path):
    c = Channel(str(tmp_path / "c4"))
    err = []

    def reader():
        try:
            c.read(timeout_s=10)
        except ChannelClosed:
            err.append("closed")

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.2)
    c.close()
    t.join(timeout=5)
    assert err == ["closed"]
    c.release()


# ---------------------------------------------------------------------------
# DAG API: interpreted
# ---------------------------------------------------------------------------

@rt.remote
class Adder:
    def __init__(self, inc):
        self.inc = inc
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.inc

    def combine(self, a, b):
        return a + b

    def num_calls(self):
        return self.calls


def test_interpreted_dag(cluster):
    a = Adder.remote(1)
    b = Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    ref = dag.execute(5)
    assert rt.get(ref, timeout=T) == 16


def test_interpreted_multi_output(cluster):
    a = Adder.remote(1)
    b = Adder.remote(2)
    with InputNode() as inp:
        dag = MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
    refs = dag.execute(10)
    assert rt.get(refs, timeout=T) == [11, 12]


# ---------------------------------------------------------------------------
# compiled DAGs
# ---------------------------------------------------------------------------

def test_compiled_linear_pipeline(cluster):
    a = Adder.remote(1)
    b = Adder.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    cdag = dag.experimental_compile()
    try:
        for i in range(10):
            assert cdag.execute(i).get(timeout=T) == i + 11
    finally:
        cdag.teardown()


def test_compiled_multi_output_and_fanout(cluster):
    a = Adder.remote(1)
    b = Adder.remote(2)
    c = Adder.remote(0)
    with InputNode() as inp:
        mid = a.add.bind(inp)           # fan-out: consumed by b and c
        dag = MultiOutputNode([b.add.bind(mid), c.combine.bind(mid, inp)])
    cdag = dag.experimental_compile()
    try:
        out = cdag.execute(5).get(timeout=T)
        assert out == [8, 11]  # [5+1+2, (5+1)+5]
    finally:
        cdag.teardown()


def test_compiled_pipelined_throughput(cluster):
    """In-flight iterations overlap across stages (the PP substrate)."""
    @rt.remote
    class Slow:
        def work(self, x):
            time.sleep(0.2)
            return x + 1

    s1, s2 = Slow.remote(), Slow.remote()
    with InputNode() as inp:
        dag = s2.work.bind(s1.work.bind(inp))
    cdag = dag.experimental_compile(nslots=4)
    try:
        # warmup iteration: actor-worker spawn + exec-loop attach happen
        # on the first execute and must not count against the overlap
        # measurement
        assert cdag.execute(100).get(timeout=120) == 102
        t0 = time.perf_counter()
        refs = [cdag.execute(i) for i in range(4)]
        outs = [r.get(timeout=T) for r in refs]
        dt = time.perf_counter() - t0
        assert outs == [i + 2 for i in range(4)]
        # serial would be 4 iters * 2 stages * 0.2s = 1.6s; pipelined ~1.0s
        assert dt < 1.45, f"no pipeline overlap: {dt:.2f}s"
    finally:
        cdag.teardown()


def test_compiled_error_propagation(cluster):
    @rt.remote
    class Bomb:
        def work(self, x):
            if x == 3:
                raise ValueError("boom on 3")
            return x

    a = Adder.remote(0)
    bomb = Bomb.remote()
    with InputNode() as inp:
        dag = a.add.bind(bomb.work.bind(inp))
    cdag = dag.experimental_compile()
    try:
        assert cdag.execute(1).get(timeout=T) == 1
        with pytest.raises(ValueError, match="boom on 3"):
            cdag.execute(3).get(timeout=T)
        # DAG stays usable after an error
        assert cdag.execute(4).get(timeout=T) == 4
    finally:
        cdag.teardown()


def test_compiled_large_payload_spills(cluster):
    """Payloads bigger than the channel slot go through the object store."""
    @rt.remote
    class Big:
        def work(self, x):
            return x * 2

    b = Big.remote()
    with InputNode() as inp:
        dag = b.work.bind(inp)
    cdag = dag.experimental_compile(buffer_size_bytes=1 << 14)  # 16 KiB slots
    try:
        arr = np.ones(1 << 20, dtype=np.float32)  # 4 MiB
        out = cdag.execute(arr).get(timeout=120)
        np.testing.assert_array_equal(out, arr * 2)
    finally:
        cdag.teardown()


def test_teardown_frees_actor(cluster):
    a = Adder.remote(1)
    b = Adder.remote(0)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    cdag = dag.experimental_compile()
    assert cdag.execute(1).get(timeout=T) == 2
    cdag.teardown()
    # the actor's exec thread is free again: normal calls work
    assert rt.get(a.num_calls.remote(), timeout=T) >= 1


@rt.remote
class Shard:
    def __init__(self, k):
        self.k = k

    def grad(self, x):
        return np.full(4, float(x * self.k))

    def scaled(self, g):
        return g * 10


def test_compiled_dag_allreduce(cluster):
    """Cross-actor allreduce inside a compiled graph (reference:
    dag/collective_node.py + experimental/collective/allreduce.py)."""
    a, b = Shard.remote(1), Shard.remote(2)
    with InputNode() as inp:
        outs = allreduce_bind([a.grad.bind(inp), b.grad.bind(inp)],
                              op="sum")
        # one participant consumes its reduced copy downstream
        dag = MultiOutputNode([outs[0], a.scaled.bind(outs[0]), outs[1]])
    cd = dag.experimental_compile()
    try:
        for x in (1, 2, 3):
            r0, r_scaled, r1 = cd.execute(x).get(timeout=120)
            want = np.full(4, float(x * 1 + x * 2))
            np.testing.assert_array_equal(r0, want)
            np.testing.assert_array_equal(r1, want)
            np.testing.assert_array_equal(r_scaled, want * 10)
    finally:
        cd.teardown()


def test_interpreted_dag_allreduce(cluster):
    @rt.remote
    class S:
        def v(self, x):
            return np.arange(3) + x

    s1, s2 = S.remote(), S.remote()
    with InputNode() as inp:
        outs = allreduce_bind([s1.v.bind(inp), s2.v.bind(inp)], op="max")
        dag = MultiOutputNode(outs)
    r = dag.execute(5)
    np.testing.assert_array_equal(r[0], np.arange(3) + 5)


def test_allreduce_bind_validation(cluster):
    @rt.remote
    class S:
        def v(self, x):
            return x

    s = S.remote()
    with InputNode() as inp:
        n = s.v.bind(inp)
        with pytest.raises(ValueError, match="distinct actors"):
            allreduce_bind([n, s.v.bind(inp)])
        with pytest.raises(ValueError, match="unknown reduce op"):
            allreduce_bind([n], op="median")


# ---------------------------------------------------------------------------
# what the port adds
# ---------------------------------------------------------------------------

@rt.remote
class TensorShard:
    def __init__(self, seed):
        self.seed = seed

    def contrib(self, n):
        g = torch.Generator().manual_seed(self.seed)
        return torch.randn(n, generator=g)

    def describe(self, t):
        return str(t.device), t.dtype, t.clone()


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_compiled_allreduce_of_tensors(cluster, op):
    """Tensor contributions reduce on each participant, in group order:
    bitwise the same fold of the same tensors on the driver."""
    a, b = TensorShard.remote(1), TensorShard.remote(2)
    with InputNode() as inp:
        outs = allreduce_bind([a.contrib.bind(inp), b.contrib.bind(inp)],
                              op=op)
        dag = MultiOutputNode([a.describe.bind(outs[0]),
                               b.describe.bind(outs[1])])
    cd = dag.experimental_compile()
    try:
        got = cd.execute(1000).get(timeout=120)
    finally:
        cd.teardown()
    xs = [torch.randn(1000, generator=torch.Generator().manual_seed(s))
          for s in (1, 2)]
    want = REDUCERS[op](xs)
    for device, dtype, t in got:
        assert device == "cpu" and dtype == torch.float32
        assert torch.equal(t, want)


def test_compiled_out_of_order_gets(cluster):
    """A later execution's get reads the earlier results ahead; their own
    gets then return them (and re-raise an error), in any order."""
    @rt.remote
    class Picky:
        def work(self, x):
            if x == 1:
                raise ValueError("one")
            return x * 3

    p = Picky.remote()
    with InputNode() as inp:
        dag = p.work.bind(inp)
    cd = dag.experimental_compile()
    try:
        refs = [cd.execute(i) for i in range(4)]
        assert refs[3].get(timeout=T) == 9
        assert refs[0].get(timeout=T) == 0
        assert refs[2].get(timeout=T) == 6
        with pytest.raises(ValueError, match="one"):
            refs[1].get(timeout=T)
        with pytest.raises(ValueError, match="already got"):
            refs[2].get(timeout=T)
    finally:
        cd.teardown()
