"""Tensor DAG channels on the port (the NCCL-channel role, reference:
experimental/channel/torch_tensor_nccl_channel.py): the cases of
tests/test_dag_device_channel.py with ``torch.Tensor`` payloads riding
the ring as raw bytes (no pickling of tensor data), plus what the port
adds: where a tensor staged from a card lands, float8/bool/non-contiguous
tensors, and a value read out of a slot that the writer then reuses.

CPU tensors take the raw path only when RAY_TPU_TORCH_DAG_DEVICE_CHANNEL
forces it (CUDA tensors take it by default); the fixture below forces it,
so the CPU exercises the path the card runs."""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import serialization
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.dag import channel as channel_mod
from ray_tpu_torch.dag.channel import (DEFAULT_NSLOTS, DEVICE_CHANNEL_ENV,
                                       TAG_DEVICE, TAG_INLINE, Channel)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture(autouse=True)
def _force_device_path(monkeypatch):
    # the raw-bytes path defaults on only for CUDA tensors; force it so
    # the CPU exercises it
    monkeypatch.setenv(DEVICE_CHANNEL_ENV, "1")


@pytest.fixture
def chan(tmp_path):
    c = Channel(str(tmp_path / "chan"), slot_bytes=4 << 20, nslots=4)
    yield c
    c.close()
    c.release()


def test_cpu_tensors_default_to_pickle_path(tmp_path, monkeypatch):
    """Policy: without the override, CPU tensors take the pickle path (the
    raw path's extra copy on the reader buys nothing there)."""
    monkeypatch.delenv(DEVICE_CHANNEL_ENV, raising=False)
    c = Channel(str(tmp_path / "plain"), slot_bytes=4 << 20, nslots=2)
    try:
        c.write(torch.ones((8, 8)))
        tag, v = c.read(timeout_s=10)
        assert tag == TAG_INLINE
        assert v.shape == (8, 8)
    finally:
        c.close()
        c.release()


def test_device_tensor_roundtrip(chan):
    x = torch.arange(1024, dtype=torch.float32).reshape(32, 32) * 0.5
    chan.write(x)
    tag, y = chan.read(timeout_s=10)
    assert tag == TAG_DEVICE            # the raw-bytes fast path ran
    assert isinstance(y, torch.Tensor)
    assert y.dtype == torch.float32 and y.shape == (32, 32)
    assert torch.equal(y, x)


def test_device_tensor_bf16(chan):
    x = torch.ones((16, 16), dtype=torch.bfloat16) * 3
    chan.write(x)
    tag, y = chan.read(timeout_s=10)
    assert tag == TAG_DEVICE
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.full((16, 16), 3.0, np.float32))


def test_steady_state_varying_shapes_reuse(chan):
    """The MPMD pipeline's steady state: microbatch-sized activations
    alternating with scalar losses/grad edges of OTHER shapes and dtypes
    through ONE channel, >= 100 round-trips.  The device path must stay
    enabled the whole time (every message TAG_DEVICE), values must
    survive bit-exact (header stays aligned as slot payload sizes jump
    around), and the ring must not leak slots."""
    shapes = [((4, 16, 8), torch.float32),   # activation
              ((), torch.float32),           # scalar loss
              ((2, 32, 8), torch.bfloat16),  # half-precision activation
              ((8, 8), torch.int32),         # token block
              ((3, 5, 7), torch.float32)]    # odd strides
    for i in range(120):
        shape, dt = shapes[i % len(shapes)]
        x = (torch.full(shape, i % 97, dtype=dt) if shape
             else torch.tensor(float(i), dtype=dt))
        chan.write(x, timeout_s=10)
        tag, y = chan.read(timeout_s=10)
        assert tag == TAG_DEVICE, f"device path fell back at round {i}"
        assert tuple(y.shape) == tuple(shape) and y.dtype == dt, \
            (i, y.shape)
        assert torch.equal(y, x)
    # no slot leaked: the full ring capacity is still writable without a
    # reader draining it
    for j in range(DEFAULT_NSLOTS):
        chan.write(torch.full((16,), j, dtype=torch.float32), timeout_s=10)
    for j in range(DEFAULT_NSLOTS):
        tag, y = chan.read(timeout_s=10)
        assert tag == TAG_DEVICE and float(y[0]) == float(j)


def test_non_array_values_unchanged(chan):
    chan.write({"a": 1})
    tag, v = chan.read(timeout_s=10)
    assert tag == TAG_INLINE and v == {"a": 1}


def test_oversize_tensor_spills(cluster, tmp_path):
    c = Channel(str(tmp_path / "small"), slot_bytes=1 << 16, nslots=2)
    try:
        big = torch.zeros((256, 256), dtype=torch.float32)  # 256 KiB > 64
        c.write(big)
        tag, y = c.read(timeout_s=30)
        assert tuple(y.shape) == (256, 256)
        assert float(y.sum()) == 0.0
    finally:
        c.close()
        c.release()


def test_device_path_comparable_on_large_tensors(chan, tmp_path):
    """Microbench guard: the raw-bytes path of a CPU tensor stays within 8x
    of the pickle path of its numpy host array (on the card the saved
    pickle and staging win; this bound only catches pathological
    regressions)."""
    x = torch.ones((512, 512), dtype=torch.float32)  # 1 MiB activation
    host = x.numpy()

    def roundtrip_device(n):
        t0 = time.perf_counter()
        for _ in range(n):
            chan.write(x)
            chan.read(timeout_s=10)
        return time.perf_counter() - t0

    pick = Channel(str(tmp_path / "pickled"), slot_bytes=4 << 20, nslots=4)
    try:
        def roundtrip_pickle(n):
            # numpy host arrays take the pickle path (dumps_inline)
            t0 = time.perf_counter()
            for _ in range(n):
                pick.write(host)
                pick.read(timeout_s=10)
            return time.perf_counter() - t0

        roundtrip_device(3)  # warm both paths
        pick.write(host)
        tag, _ = pick.read(timeout_s=10)
        assert tag == TAG_INLINE
        # best-of-3: a shared box's scheduler noise dwarfs a single
        # measurement
        t_dev = min(roundtrip_device(10) for _ in range(3))
        t_pkl = min(roundtrip_pickle(10) for _ in range(3))
        assert t_dev < t_pkl * 8.0, (t_dev, t_pkl)
    finally:
        pick.close()
        pick.release()


@rt.remote
class Stage:
    def __init__(self, scale):
        self.w = torch.tensor(scale, dtype=torch.float32)

    def fwd(self, x):
        return (x.float() * self.w).to(torch.bfloat16)


def test_pp_over_dag_with_device_activations(cluster):
    """2-stage MPMD pipeline over compiled-dag channels with tensor
    activations on every edge, the stages' edge on the raw path."""
    env = {"env_vars": {DEVICE_CHANNEL_ENV: "1"}}
    s1 = Stage.options(runtime_env=env).remote(2.0)
    s2 = Stage.options(runtime_env=env).remote(10.0)
    with InputNode() as inp:
        out = s2.fwd.bind(s1.fwd.bind(inp))
    dag = MultiOutputNode([out]).experimental_compile(
        buffer_size_bytes=4 << 20)
    try:
        for i in range(4):
            ref = dag.execute(torch.full((64, 64), float(i + 1)))
            (y,) = ref.get(timeout=120)
            assert y.dtype == torch.bfloat16 and tuple(y.shape) == (64, 64)
            assert float(y[0, 0]) == 20.0 * (i + 1)
    finally:
        dag.teardown()


# -- what the port adds ------------------------------------------------------

def _staged_from_card(t):
    """The raw path's header of ``t`` as a writer on a card would write
    it: a CPU tensor stands in for a CUDA one."""
    import pickle
    import struct

    meta = pickle.dumps((tuple(t.shape), str(t.dtype).split(".", 1)[1],
                         "cuda"), protocol=5)
    return struct.pack("<I", len(meta)) + meta


@pytest.mark.parametrize("source,receiver,expect", [
    ("cuda", "meta", "meta"),   # a card's tensor lands on the receiver's
    ("cuda", "cpu", "cpu"),     # a CPU-only receiver gets a CPU tensor
    ("cpu", "meta", "cpu"),     # a CPU tensor stays on the CPU
])
def test_tensor_lands_by_the_object_planes_rule(chan, monkeypatch, source,
                                                receiver, expect):
    """The reader places a tensor as serialization._receiving_device says:
    a tensor staged from a card lands on the reader's card when it sees
    one (injected here as "meta"), on the CPU only when it sees none."""
    x = torch.arange(48, dtype=torch.float32).reshape(6, 8).to(
        torch.bfloat16)
    if source == "cuda":
        monkeypatch.setattr(channel_mod, "_tensor_header", _staged_from_card)
    serialization.set_restore_device(lambda: receiver)
    try:
        chan.write(x)
        tag, y = chan.read(timeout_s=10)
    finally:
        serialization.set_restore_device(None)
    assert tag == TAG_DEVICE
    assert y.device.type == expect and y.dtype == torch.bfloat16
    assert tuple(y.shape) == (6, 8)
    if expect == "cpu":
        assert torch.equal(y, x)


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("make", [
    lambda: torch.arange(64, dtype=torch.float32).to(torch.float8_e4m3fn),
    lambda: torch.arange(30) % 3 == 0,
    lambda: torch.arange(60, dtype=torch.int64).reshape(6, 10).t(),
    lambda: torch.randn(5, 7, generator=torch.Generator().manual_seed(0),
                        requires_grad=True),
    lambda: torch.empty(0, 4, dtype=torch.float16),
    lambda: torch.randn(3, 5, dtype=torch.complex64,
                        generator=torch.Generator().manual_seed(1)),
], ids=["float8", "bool", "non-contiguous", "requires-grad", "empty",
        "complex"])
def test_raw_path_dtypes_and_layouts(chan, make):
    x = make()
    chan.write(x)
    tag, y = chan.read(timeout_s=10)
    assert tag == TAG_DEVICE
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.is_contiguous() and not y.requires_grad
    assert torch.equal(_bits(y), _bits(x))


def test_value_read_survives_the_writers_reuse_of_its_slot(tmp_path):
    """The reader copies a tensor out of the ring before it releases the
    slot: the writer filling every slot again leaves it intact."""
    c = Channel(str(tmp_path / "reuse"), slot_bytes=1 << 16, nslots=2)
    try:
        c.write(torch.full((1000,), 7.0))
        _, y = c.read(timeout_s=10)
        for j in range(2):
            c.write(torch.full((1000,), -1.0 - j), timeout_s=10)
        assert torch.equal(y, torch.full((1000,), 7.0))
        for j in range(2):
            assert float(c.read(timeout_s=10)[1][0]) == -1.0 - j
    finally:
        c.close()
        c.release()
