"""Where the port's runtime touches the device, on the CPU.

* Tensor serialization round trips (f32/bf16/int8/float16/int64, non-
  contiguous, zero-size, 0-dim, nested, requires_grad), with the
  stand-in's restore rule driven by an injected device choice (there is
  no card here): a tensor staged from a card lands on the receiver's
  device, a CPU tensor stays on the CPU.
* GPU detection through a fake device-node list and the count override;
  CUDA_VISIBLE_DEVICES narrowing and hiding; the container env.
* Scheduling: ``num_gpus=1`` on a cluster with no GPU stays pending; on a
  cluster that offers a (fake) GPU the task gets a fresh worker spawned
  for the lease, never a warm CPU worker, and that worker refuses to run
  on the CPU when CUDA finds no card.
* A device-resident value is staged to the store once, on its first
  remote fetch.
* A containerized GPU actor is granted the card nodes, or refused on a
  host that has none.
"""

import json
import os
import pickle
import stat
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import accelerators, serialization

T = 60


def _roundtrip(value):
    meta, bufs = serialization.dumps_oob(value)
    return serialization.loads_oob(meta, [b.raw() for b in bufs]), bufs


def _base(seed=0):
    return torch.randn(6, 10, generator=torch.Generator().manual_seed(seed))


CASES = {
    "f32": lambda: _base(),
    "bf16": lambda: _base().to(torch.bfloat16),
    "f16": lambda: _base().to(torch.float16),
    "int8": lambda: (_base() * 40).to(torch.int8),
    "int64": lambda: torch.arange(17, dtype=torch.int64),
    "bool": lambda: _base() > 0,
    "non_contiguous": lambda: _base().t()[::2],
    "zero_size": lambda: torch.empty(0, 7, dtype=torch.bfloat16),
    "zero_dim": lambda: torch.tensor(3.5, dtype=torch.bfloat16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_roundtrip(case):
    x = CASES[case]()
    y, bufs = _roundtrip(x)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(y, x)
    assert y.is_contiguous()
    if x.numel():
        # the host bytes ride pickle 5's out-of-band path
        assert bufs
    y.add_(0) if y.dtype != torch.bool else None  # writable


def test_bf16_travels_as_uint16_bits():
    x = _base().to(torch.bfloat16)
    stand_in = serialization._stage_tensor(x)
    assert stand_in.np_value.dtype == np.uint16
    assert stand_in.dtype == "bfloat16" and stand_in.device_type == "cpu"
    assert np.array_equal(stand_in.np_value,
                          x.view(torch.int16).numpy().view(np.uint16))


def test_nested_and_requires_grad():
    w = torch.nn.Parameter(_base())
    g = _base(1).requires_grad_()
    value = {"w": w, "inner": [g * 2, (torch.ones(3, dtype=torch.int8),)],
             "n": 5}
    out, _ = _roundtrip(value)
    # autograd graphs do not cross processes: tensors arrive detached
    assert type(out["w"]) is torch.Tensor and not out["w"].requires_grad
    assert torch.equal(out["w"], w.detach())
    assert not out["inner"][0].requires_grad
    assert torch.equal(out["inner"][0], (g * 2).detach())
    assert torch.equal(out["inner"][1][0], torch.ones(3, dtype=torch.int8))
    assert out["n"] == 5


@pytest.mark.parametrize("source,receiver,expect", [
    ("cuda", "meta", "meta"),   # a card's tensor lands on the receiver's
    ("cuda", "cpu", "cpu"),     # a CPU-only receiver gets a CPU tensor
    ("cpu", "meta", "cpu"),     # a CPU tensor stays on the CPU
])
def test_restore_rule_with_injected_device(source, receiver, expect):
    x = _base().to(torch.bfloat16)
    stand_in = serialization._stage_tensor(x)
    stand_in.device_type = source
    serialization.set_restore_device(lambda: receiver)
    try:
        blob = pickle.dumps(stand_in, protocol=5)
        y = serialization._restore_tensor(pickle.loads(blob))
    finally:
        serialization.set_restore_device(None)
    assert y.device.type == expect and y.dtype == torch.bfloat16
    if expect == "cpu":
        assert torch.equal(y, x)


def test_default_receiver_here_is_the_cpu():
    stand_in = serialization._stage_tensor(_base())
    stand_in.device_type = "cuda"
    assert serialization._restore_tensor(stand_in).device.type == "cpu"


def test_device_nbytes_and_cpu_values_are_not_device_resident():
    x = _base()
    assert serialization.device_nbytes(x) == 6 * 10 * 4
    assert not serialization.holds_cuda_tensor({"a": x, "b": [x]})
    assert serialization.device_nbytes({"a": x}) is None


# -- detection --------------------------------------------------------------

_NODES = ("/dev/nvidia0,/dev/nvidia1,/dev/nvidia2,/dev/nvidiactl,"
          "/dev/nvidia-uvm")


@pytest.mark.parametrize("visible,expect", [
    (None, 3), ("", 0), ("1", 1), ("0,2", 2), ("0,7,1", 1),
    ("GPU-aaaa,GPU-bbbb", 2)])
def test_num_gpus_from_device_nodes(monkeypatch, visible, expect):
    monkeypatch.setenv("RAY_TPU_TORCH_GPU_DEVICES", _NODES)
    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS", raising=False)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert accelerators.num_gpus() == expect
    res = accelerators.default_resources()
    assert res.get("GPU", 0) == expect


def test_detection_overrides_and_container_env(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_GPU_DEVICES", _NODES)
    assert accelerators.gpu_device_paths() == _NODES.split(",")
    assert accelerators.card_nodes(_NODES.split(",")) == [0, 1, 2]
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "5")
    assert accelerators.num_gpus() == 5
    # a host pinned off the cards must not pin a GPU actor's container
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert accelerators.gpu_container_env()["CUDA_VISIBLE_DEVICES"] == \
        "0,1,2"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert accelerators.gpu_container_env()["CUDA_VISIBLE_DEVICES"] == "1"
    assert accelerators.visible_chip_env(()) == {"CUDA_VISIBLE_DEVICES": ""}
    monkeypatch.setenv("RAY_TPU_TORCH_GPU_DEVICES", "")
    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert accelerators.num_gpus() == 0
    assert "GPU" not in accelerators.default_resources()


# -- scheduling and visibility on a cluster ----------------------------------


@rt.remote
def _pid_env():
    return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
def _torch_loaded():
    import sys

    return os.getpid(), "torch" in sys.modules


def test_gpu_request_without_gpu_stays_pending():
    rt.init(num_cpus=2, num_gpus=0)
    try:
        assert "GPU" not in rt.cluster_resources()
        ref = _pid_env.options(num_gpus=1).remote()
        ready, pending = rt.wait([ref], num_returns=1, timeout=2.0)
        assert not ready and pending
        # as in the reference (num_tpus on a cluster with no TPU), the
        # request waits; it can be cancelled
        assert rt.cancel(ref)
        with pytest.raises(rt.TaskCancelledError):
            rt.get(ref, timeout=T)
    finally:
        rt.shutdown()


def test_gpu_lease_gets_a_fresh_device_worker_that_refuses_the_cpu():
    # a (fake) card on a host where CUDA finds none
    rt.init(num_cpus=2, num_gpus=1)
    try:
        assert rt.cluster_resources()["GPU"] == 1.0
        # fresh CPU workers that ran no tensor have not imported torch
        assert not any(loaded for _, loaded in rt.get(
            [_torch_loaded.remote() for _ in range(4)], timeout=T))
        warm = rt.get([_pid_env.remote() for _ in range(4)], timeout=T)
        assert all(env == "" for _, env in warm)
        with pytest.raises(rt.TaskError, match="holds a GPU lease") as ei:
            rt.get(_pid_env.options(num_gpus=1, max_retries=0).remote(),
                   timeout=T)
        pid = int(str(ei.value).split("worker pid ")[1].split()[0])
        assert pid not in {p for p, _ in warm}

        @rt.remote(num_gpus=1)
        class OnCard:
            def where(self):
                return os.getpid()

        a = OnCard.remote()
        with pytest.raises(rt.ActorDiedError):
            rt.get(a.where.remote(), timeout=T)
        # the failed leases were released: the GPU is free again
        deadline = time.monotonic() + T
        while rt.available_resources().get("GPU") != 1.0:
            assert time.monotonic() < deadline, rt.available_resources()
            time.sleep(0.2)
    finally:
        rt.shutdown()


def test_fractional_gpu_leases_share_a_card():
    """Ray grants fractional ``num_gpus``: two 0.5 leases fit one card
    (Serve's two LLM replicas on a one-card machine), a third waits, and
    each lease gets a device-visible worker of its own.  Here those
    workers find no card and refuse the CPU, so each lease ends in that
    error; the books return to exactly one card."""
    from ray_tpu_torch._private import common

    card = common.normalize_resources({"GPU": 1})
    half = common.normalize_resources({"GPU": 0.5})
    for _ in range(2):
        assert common.fits(card, half)
        common.subtract(card, half)
    assert not common.fits(card, half) and card["GPU"] == 0
    rt.init(num_cpus=2, num_gpus=1)
    try:
        refs = [_pid_env.options(num_gpus=0.5, max_retries=0).remote()
                for _ in range(2)]
        pids = set()
        for ref in refs:
            with pytest.raises(rt.TaskError, match="holds a GPU lease") as ei:
                rt.get(ref, timeout=T)
            pids.add(int(str(ei.value).split("worker pid ")[1].split()[0]))
        assert len(pids) == 2
        deadline = time.monotonic() + T
        while rt.available_resources().get("GPU") != 1.0:
            assert time.monotonic() < deadline, rt.available_resources()
            time.sleep(0.2)
    finally:
        rt.shutdown()


def test_device_value_staged_to_store_once(monkeypatch):
    """The owner keeps a device-resident value for its own gets and stages
    it to the shm store on the first remote fetch only (CUDA is faked by
    marking a CPU dict device-resident)."""
    value = {"w": torch.arange(200_000, dtype=torch.float32),
             "b": torch.ones(3, dtype=torch.bfloat16)}
    marked = lambda v, _d=0: v is value  # noqa: E731
    monkeypatch.setattr(serialization, "holds_cuda_tensor", marked)
    rt.init(num_cpus=2)
    try:
        core = rt._require()
        calls = []
        real = core._store_create
        monkeypatch.setattr(core, "_store_create",
                            lambda *a: (calls.append(a[0]), real(*a)))
        ref = rt.put(value)
        entry = core.objects[ref.id]
        assert entry.has_value and entry.shm_node is None
        assert rt.get(ref, timeout=T) is value

        @rt.remote
        def total(d):
            return float(d["w"].sum()), str(d["b"].dtype)

        outs = rt.get([total.remote(ref) for _ in range(3)], timeout=T)
        assert outs == [(float(value["w"].sum()), "torch.bfloat16")] * 3
        assert calls == [ref.id]
        assert entry.shm_node == core.node_id
        assert rt.get(ref, timeout=T) is value
    finally:
        rt.shutdown()


# -- containerized GPU actors (tests/test_runtime_env_container.py's TPU
# cases): a shim container runtime records its argv and runs the worker
# on the host

IMAGE = "ray-tpu-torch-test-image:latest"


def _write_shim(path, log_file) -> str:
    shim = path / "docker-shim"
    shim.write_text(f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
with open({str(log_file)!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
for j, a in enumerate(args):
    if a == "-e":
        k, _, v = args[j + 1].partition("=")
        os.environ[k] = v
i = args.index({IMAGE!r})
os.execvp(args[i + 1], args[i + 1:])
""")
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    return str(shim)


@rt.remote
class _Probe:
    def ping(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


@pytest.mark.parametrize("devices", ["/dev/nvidia0,/dev/nvidiactl", ""])
def test_containerized_gpu_actor_devices(tmp_path, monkeypatch, devices):
    """A GPU actor's container is granted the card nodes and made to see
    every card; a host with no card node is refused instead (the
    container would run on the CPU while holding the lease)."""
    log_file = tmp_path / "shim_calls.jsonl"
    monkeypatch.setenv("RAY_TPU_TORCH_CONTAINER_RUNTIME",
                       _write_shim(tmp_path, log_file))
    monkeypatch.setenv("RAY_TPU_TORCH_ALLOW_PKG_INSTALL", "1")
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "1")
    monkeypatch.setenv("RAY_TPU_TORCH_GPU_DEVICES", devices)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    rt.init(num_cpus=2)
    try:
        a = _Probe.options(num_gpus=1, runtime_env={
            "container": {"image": IMAGE}}).remote()
        if not devices:
            with pytest.raises(Exception, match="device|spawn failed"):
                rt.get(a.ping.remote(), timeout=T)
            assert not log_file.exists()
            return
        # the shim runs the worker on this host, where CUDA finds no
        # card: it refuses to run on the CPU
        with pytest.raises(rt.ActorDiedError, match="holds a GPU lease"):
            rt.get(a.ping.remote(), timeout=T)
        argv = [json.loads(ln) for ln in open(log_file)][0]
        assert "--device=/dev/nvidia0" in argv
        assert "--device=/dev/nvidiactl" in argv
        assert "CUDA_VISIBLE_DEVICES=0" in argv
        assert "RAY_TPU_TORCH_WORKER_GPU=1" in argv
    finally:
        rt.shutdown()
