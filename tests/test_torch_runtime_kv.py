"""The port's ``kv`` collective backend on its own runtime, on the CPU.

Three CPU actors of ``ray_tpu_torch`` form a ``kv`` group and run one
sequence of collectives on seeded inputs.  Each result is held against its
plain version (numpy) and, for the int8-compressed ops, against the
reference's numpy codec (``ray_tpu.collective.compression``), bitwise.
The same sequence then runs on the JAX package's runtime and ``kv``
backend in a subprocess: every output is bitwise the port's.
``destroy_collective_group(timeout=)`` sweeps the group's keys, and raises
naming the absent rank when a member never arrives.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch as rt

REPO = Path(__file__).resolve().parent.parent
WORLD = 3
N = 5000  # not a multiple of the block: the codec's ragged tail
T = 120


def _inputs():
    rng = np.random.default_rng(7)
    return [rng.standard_normal(N).astype(np.float32) * (r + 1)
            for r in range(WORLD)]


# the op sequence, shared by both runtimes (kept free of either package)
_OPS = r"""
def run_ops(col, rank, world, xs, as_array, destroy_timeout):
    g = "kvtest"
    col.init_collective_group(world, rank, backend="kv", group_name=g)
    x = xs[rank]
    out = {}
    out["sum"] = as_array(col.allreduce(x, g, op="sum"))
    out["mean"] = as_array(col.allreduce(x, g, op="mean"))
    out["max"] = as_array(col.allreduce(x, g, op="max"))
    out["min"] = as_array(col.allreduce(x, g, op="min"))
    out["int8"] = as_array(col.allreduce(x, g, compression="int8"))
    out["int8_mean"] = as_array(col.allreduce(x, g, op="mean",
                                              compression="int8"))
    out["int8_stochastic"] = as_array(col.allreduce(
        x, g, compression="int8:block=128,stochastic=1"))
    out["async_sum"] = as_array(col.allreduce_async(x, g).result())
    for r, v in enumerate(col.allgather(x, g)):
        out[f"allgather_{r}"] = as_array(v)
    for r, v in enumerate(col.allgather(x, g, compression="int8")):
        out[f"allgather_int8_{r}"] = as_array(v)
    out["broadcast"] = as_array(col.broadcast(x if rank == 1 else None, 1, g))
    out["reducescatter"] = as_array(col.reducescatter(x, g))
    col.barrier(g)
    if rank == 0:
        col.send(x * 3, 2, g)
    if rank == 2:
        out["recv"] = as_array(col.recv(0, g))
    col.destroy_collective_group(g, timeout=destroy_timeout)
    return out
"""
_ns = {}
exec(_OPS, _ns)
run_ops = _ns["run_ops"]


@rt.remote
class Member:
    def __init__(self, rank):
        self.rank = rank

    def run(self, xs):
        import torch

        from ray_tpu_torch.collective import collective as col

        tensors = [torch.from_numpy(x) for x in xs]
        return run_ops(col, self.rank, WORLD, tensors,
                       lambda t: t.numpy(), 60)

    def join_alone(self, name, timeout):
        from ray_tpu_torch.collective import collective as col

        col.init_collective_group(1, 0, backend="kv", group_name=name)
        # as if the group had a second member that never arrives
        col._groups[name].world_size = 2
        try:
            col.destroy_collective_group(name, timeout=timeout)
        except col.CollectiveTeardownTimeout as e:
            return str(e)
        return None


@pytest.fixture(scope="module")
def results():
    rt.init(num_cpus=WORLD + 1)
    try:
        xs = _inputs()
        members = [Member.remote(r) for r in range(WORLD)]
        outs = rt.get([m.run.remote(xs) for m in members], timeout=T)
        keys = rt._require().control.call(
            "kv_keys", {"ns": "collective", "prefix": "kvtest/"})
        timeout_msg = rt.get(members[0].join_alone.remote("lonely", 0.5),
                             timeout=T)
        yield xs, outs, keys, timeout_msg
    finally:
        rt.shutdown()


def _ref_codec_allreduce(xs, spec, op="sum", op_idx=None):
    """The reference's kv compressed allreduce, on its own numpy codec."""
    from ray_tpu.collective.compression import (compress_array,
                                                decompress_array,
                                                parse_compression,
                                                result_block_size)

    cc = parse_compression(spec)

    def rng(rank):
        if not cc.stochastic:
            return None
        return np.random.default_rng(op_idx * (WORLD + 1) + rank + 1)

    acc = np.zeros(xs[0].shape, np.float32)
    for r, x in enumerate(xs):
        acc += decompress_array(compress_array(x, cc, rng(r))).astype(
            np.float32)
    if op == "mean":
        acc /= WORLD
    rcc = dataclasses.replace(cc, block_size=result_block_size(cc.block_size))
    return decompress_array(compress_array(acc, rcc, rng(WORLD)))


def _plain(xs, name):
    s = xs[0].copy()
    for x in xs[1:]:
        s = s + x
    return {"sum": s, "async_sum": s, "mean": s / WORLD,
            "max": np.maximum.reduce(xs), "min": np.minimum.reduce(xs)}[name]


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "async_sum"])
def test_allreduce_matches_plain(results, name):
    xs, outs, _, _ = results
    for out in outs:
        np.testing.assert_array_equal(out[name], _plain(xs, name))


@pytest.mark.parametrize("name,spec,op,op_idx", [
    ("int8", "int8", "sum", None),
    ("int8_mean", "int8", "mean", None),
    # op 7 of the group's sequence seeds the stochastic rounding
    ("int8_stochastic", "int8:block=128,stochastic=1", "sum", 7),
])
def test_int8_allreduce_bitwise_with_reference_codec(results, name, spec,
                                                     op, op_idx):
    xs, outs, _, _ = results
    ref = _ref_codec_allreduce(xs, spec, op, op_idx)
    for out in outs:
        assert out[name].dtype == np.float32
        np.testing.assert_array_equal(out[name], ref)
    # and within the codec's error of the plain sum
    plain = _plain(xs, op)
    assert np.abs(outs[0][name] - plain).max() < 0.1 * np.abs(plain).max()


def test_allgather_broadcast_reducescatter_send(results):
    from ray_tpu.collective.compression import (compress_array,
                                                decompress_array,
                                                parse_compression)

    xs, outs, _, _ = results
    cc = parse_compression("int8")
    for rank, out in enumerate(outs):
        for r in range(WORLD):
            np.testing.assert_array_equal(out[f"allgather_{r}"], xs[r])
            np.testing.assert_array_equal(
                out[f"allgather_int8_{r}"],
                decompress_array(compress_array(xs[r], cc)))
        np.testing.assert_array_equal(out["broadcast"], xs[1])
        np.testing.assert_array_equal(
            out["reducescatter"],
            np.array_split(_plain(xs, "sum"), WORLD)[rank])
    np.testing.assert_array_equal(outs[2]["recv"], xs[0] * 3)


def test_destroy_sweeps_and_times_out_naming_the_absent(results):
    _, _, keys, timeout_msg = results
    assert keys == []
    assert timeout_msg is not None and "ranks [1]" in timeout_msg


_REF_RUN = r"""
import json, sys
import numpy as np
import ray_tpu
from ray_tpu.collective import collective as col
ns = {}
exec(open(sys.argv[1]).read(), ns)
xs = [np.load(f"{sys.argv[2]}/x{r}.npy") for r in range(int(sys.argv[3]))]
world = len(xs)

@ray_tpu.remote
class M:
    def run(self, rank):
        # no timeout: the reference's timed destroy can raise when the
        # last member swept before an earlier one looked (ROADMAP C)
        return ns["run_ops"](col, rank, world, xs, np.asarray, None)

ray_tpu.init(num_cpus=world + 1)
# hold the handles: a handle dropped as soon as its call is submitted
# is released at once, and the reference may then kill its actor before
# the call runs
ms = [M.remote() for _ in range(world)]
outs = ray_tpu.get([m.run.remote(r) for r, m in enumerate(ms)],
                   timeout=120)
for rank, out in enumerate(outs):
    np.savez(f"{sys.argv[2]}/ref{rank}.npz", **out)
ray_tpu.shutdown()
print("done")
"""


def test_same_sequence_on_the_reference_runtime_is_bitwise(results):
    xs, outs, _, _ = results
    with tempfile.TemporaryDirectory() as d:
        ops = os.path.join(d, "ops.py")
        with open(ops, "w") as f:
            f.write(_OPS)
        for r, x in enumerate(xs):
            np.save(os.path.join(d, f"x{r}.npy"), x)
        env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
        env.pop("RAY_TPU_ADDRESS", None)
        proc = subprocess.run([sys.executable, "-c", _REF_RUN, ops, d,
                               str(WORLD)], cwd="/", env=env,
                              capture_output=True, text=True, timeout=180)
        assert proc.returncode == 0, proc.stderr[-3000:]
        for rank, out in enumerate(outs):
            ref = np.load(os.path.join(d, f"ref{rank}.npz"))
            assert sorted(ref.files) == sorted(out)
            for k in out:
                np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
