"""The fused int8 reduce-scatter hop (K7) of the port against the JAX
package, on the CPU.

The reference's own ``fused_reduce_scatter`` cannot run on the installed
JAX (it builds ``pltpu.TPUCompilerParams``, a name JAX has since dropped
for ``pltpu.CompilerParams``), so ``_reference_fused`` wraps its kernel
body, ``ray_tpu.ops.quantize._fused_rs_kernel``, in its own
``pl.pallas_call`` with the arguments of ``quantize.py:384-405`` but
``pltpu.CompilerParams``, ``use_barrier=False`` and ``interpret=True``,
under ``shard_map`` on a CPU mesh.  Nothing in the JAX package changes.

Gloo ranks (world 2, then 4; spawned, a 120 s deadline each, killed past
it) run the port's fused hop through its plain version (the exchange over
``all_to_all``) and the whole quantized allreduce with
``impl="fused_plain"``; the parent holds them against the reference.
Every comparison is bitwise (NaN equal to NaN): the fused hop is the
staged path's arithmetic, step for step.
"""

import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_collective import (AR_SHAPES, _global, _mesh, _rows, _same,
                                   _shard, _to_numpy)
from test_torch_collective import _fresh_device_ledger  # noqa: F401

SPAWN_DEADLINE_S = 120.0
HOP_SUB = 3 * 512          # per-rank row length of the hop cases
FUSED_CHUNKS = (1, 3)


def _hop_input(rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s [world, HOP_SUB] contributions, with a NaN in one
    block and an inf in another (a NaN block takes scale 1.0 and code 0
    for the NaN; an inf block scale inf)."""
    x = _shard("hop", rank, (world, HOP_SUB))
    x[0, 5 + rank] = np.nan
    x[world - 1, 300] = np.inf
    x[world - 1, 700] = -np.inf
    return x


# ---------------------------------------------------------------------------
# rank side (no JAX)
# ---------------------------------------------------------------------------


def _rank_work(rank: int, world: int):
    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective import nccl_group as ng
    from ray_tpu_torch.collective import peer_memory
    from ray_tpu_torch.ops import quantize as qz

    pg = col.get_group_handle("f").pg
    x2d = torch.from_numpy(_hop_input(rank, world))
    res = {"hop/sum": qz.fused_reduce_scatter(x2d, pg, 256, impl="plain"),
           # a CPU tensor under "auto" takes the plain version too
           "hop/mean": qz.fused_reduce_scatter(x2d, pg, 256,
                                               scale=qz.reciprocal(world))}
    for name, shape in AR_SHAPES.items():
        x = torch.from_numpy(_shard(f"ar-{name}", rank, shape))
        for op in ("sum", "mean"):
            for c in FUSED_CHUNKS:
                spec = f"int8:chunks={c}"
                res[f"ar/{name}/{op}/c{c}/fused"] = ng.mesh_allreduce(
                    x, pg, op=op, compression=spec, impl="fused_plain")
                res[f"ar/{name}/{op}/c{c}/staged"] = ng.mesh_allreduce(
                    x, pg, op=op, compression=spec)
    x = torch.from_numpy(_shard("ar-even", rank, AR_SHAPES["even"]))
    try:
        ng.mesh_allreduce(x, pg, compression="int8", impl="fused")
        res["fused_raises"] = 0
    except RuntimeError as e:
        res["fused_raises"] = int("peer memory" in str(e))
    res["has_peers"] = int(peer_memory.lookup(pg) is not None)
    return res


def _rank_main(rank: int, world: int, init_file: str, out_path: str):
    torch.set_num_threads(1)
    try:
        from ray_tpu_torch.collective import collective as col

        col.init_collective_group(world, rank, backend="gloo",
                                  group_name="f",
                                  init_method=f"file://{init_file}")
        try:
            res = _to_numpy(_rank_work(rank, world))
        finally:
            col.destroy_collective_group("f")
        np.save(out_path, res, allow_pickle=True)
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(world: int, tmp_dir):
    ctx = mp.get_context("spawn")
    outs = [os.path.join(tmp_dir, f"rank{r}.npy") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp_dir, "store"),
                               outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        pytest.fail(f"world {world}: ranks {hung} still running after "
                    f"{SPAWN_DEADLINE_S:.0f} s; killed")
    errs = [open(o + ".err").read() for o in outs if os.path.exists(o + ".err")]
    assert not errs and all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs], errs)
    return [np.load(o, allow_pickle=True).item() for o in outs]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _spawn(world, str(tmp_path_factory.mktemp(
                f"fused{world}")))
        return cache[world]

    return get


# ---------------------------------------------------------------------------
# JAX side
# ---------------------------------------------------------------------------


def _reference_fused(xs: np.ndarray, block: int = 256) -> np.ndarray:
    """The reference's K7 body on a CPU mesh: xs [world, world, sub] (rank
    r's contributions xs[r]) -> [world, sub]."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import PartitionSpec as P
    from ray_tpu._private.jax_compat import shard_map
    from ray_tpu.ops import quantize as rq

    world, _, sub = xs.shape
    nblk = sub // block
    kernel = functools.partial(rq._fused_rs_kernel, axis="dp", world=world,
                               nblk=nblk, block=block, use_barrier=False)

    def body(x):
        out = pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((nblk, block), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            scratch_shapes=[
                pltpu.VMEM((world, nblk, block), jnp.int8),
                pltpu.VMEM((world, nblk, 128), jnp.float32),
                pltpu.VMEM((world, nblk, block), jnp.int8),
                pltpu.VMEM((world, nblk, 128), jnp.float32),
                pltpu.SemaphoreType.DMA((2, world - 1)),
                pltpu.SemaphoreType.DMA((2, world - 1)),
            ],
            compiler_params=pltpu.CompilerParams(
                collective_id=rq._FUSED_COLLECTIVE_ID),
            interpret=True,
        )(x[0])
        return out.reshape(1, -1)

    f = jax.jit(shard_map(body, mesh=_mesh(world), in_specs=P("dp"),
                          out_specs=P("dp"), check_vma=False))
    return np.asarray(f(jnp.asarray(xs)))


@pytest.mark.parametrize("world", [2, 4])
def test_fused_hop_matches_reference_kernel_body(ranks, world):
    """Each rank's plain fused hop (sum, and the mean as the product with
    f32(1/world)) equals the reference's kernel body's output for that
    rank, NaN and inf blocks included."""
    res = ranks(world)
    want = _reference_fused(np.stack([_hop_input(r, world)
                                      for r in range(world)]))
    recip = np.float32(1.0) / np.float32(world)
    for r in range(world):
        _same(res[r]["hop/sum"], want[r])
        _same(res[r]["hop/mean"], want[r] * recip)
    assert np.isnan(want).any() and not np.isnan(want).all()


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_fused_hop_loopback_plain_matches_reference(world):
    """The loopback plain version (every rank's hop on one device, the
    exchange a transpose: what the card's loopback launch is held
    against) equals the reference's kernel body."""
    from ray_tpu_torch.ops import quantize as qz

    xs = np.stack([_hop_input(r, world) for r in range(world)])
    got = qz.fused_reduce_scatter_loopback_plain(torch.from_numpy(xs))
    _same(got.numpy(), _reference_fused(xs))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("shape", sorted(AR_SHAPES))
def test_fused_allreduce_matches_reference_xla(ranks, world, op, shape):
    """The whole quantized allreduce with the fused hop equals the
    reference's mesh_allreduce(impl="xla") and the port's staged path,
    at chunks 1 and 3 ("ragged" pads to world * block)."""
    from ray_tpu.collective import xla_group

    res = ranks(world)
    mesh = _mesh(world)
    arr = _global(mesh, [_shard(f"ar-{shape}", r, AR_SHAPES[shape])
                         for r in range(world)])
    for c in FUSED_CHUNKS:
        want = _rows(xla_group.mesh_allreduce(
            arr, mesh, "dp", op=op, compression=f"int8:chunks={c}",
            impl="xla"), world)
        for r in range(world):
            got = res[r][f"ar/{shape}/{op}/c{c}/fused"]
            _same(got, want[r])
            _same(got, res[r][f"ar/{shape}/{op}/c{c}/staged"])


@pytest.mark.parametrize("world", [2, 4])
def test_explicit_fused_raises_without_peer_memory(ranks, world):
    """A gloo group has no peer memory: impl="fused" raises (it never
    quietly runs the staged path)."""
    for r in ranks(world):
        assert r["has_peers"] == 0
        assert r["fused_raises"] == 1


RESOLVER_CASES = [
    # world, block, stochastic, chunk elements
    (w, b, st, ch)
    for w in (1, 2, 4, 8)
    for b in (64, 128, 256, 384, 512)
    for st in (False, True)
    for ch in (256, 65536, 190464, 262144, 1 << 20)
]


@pytest.mark.parametrize("env", [None, "1", "0", "false", "off"])
@pytest.mark.parametrize("peers", [True, False])
def test_resolver_picks_what_the_reference_picks(monkeypatch, env, peers):
    """``_resolve_rs_impl`` with "the group has peer memory on CUDA" in
    place of "the backend is a TPU" picks what the reference's picks, on
    the same world, block, stochastic flag, chunk size and
    RAY_TPU_FUSED_RS; the explicit impls pass through."""
    from ray_tpu.collective import xla_group
    from ray_tpu_torch.collective import nccl_group as ng

    if env is None:
        monkeypatch.delenv("RAY_TPU_FUSED_RS", raising=False)
    else:
        monkeypatch.setenv("RAY_TPU_FUSED_RS", env)
    monkeypatch.setattr(xla_group.jax, "default_backend",
                        lambda: "tpu" if peers else "cpu")
    names = {"xla": "staged", "fused": "fused"}
    picked = set()
    for w, b, st, ch in RESOLVER_CASES:
        want = names[xla_group._resolve_rs_impl("auto", w, b, st, ch)]
        got = ng._resolve_rs_impl("auto", w, b, st, ch, peers)
        assert got == want, (w, b, st, ch)
        picked.add(got)
        assert ng._resolve_rs_impl("fused", w, b, st, ch, peers) == "fused"
        assert ng._resolve_rs_impl("plain", w, b, st, ch, peers) == "staged"
    assert picked == ({"fused", "staged"} if peers and env in (None, "1")
                      else {"staged"})


def test_vmem_estimate_is_the_reference_one():
    from ray_tpu.ops import quantize as rq
    from ray_tpu_torch.ops import quantize as qz

    for w in (1, 2, 4, 8, 16):
        for sub in (256, 1000, 65536, 1 << 20):
            assert qz.fused_rs_vmem_bytes(w, sub) == rq.fused_rs_vmem_bytes(
                w, sub)


def test_nan_codes_match_the_reference():
    """A NaN ratio (a NaN element, or an inf one in its inf-scaled block)
    is code 0, as XLA converts float to int8: the plain K4 of the port,
    which K7's plain version runs, gives the reference's codes."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops import quantize as rq
    from ray_tpu_torch.ops import quantize as qz

    x = np.linspace(-3, 3, 1024).astype(np.float32)
    x[[5, 601]] = np.nan
    x[300], x[600] = np.inf, -np.inf
    q, s = jax.jit(lambda a: rq.quantize_blockwise(a, 256, impl="xla"))(
        jnp.asarray(x))
    pq, ps = qz.quantize_blockwise(torch.from_numpy(x), 256,
                                   reciprocal_scale=True)
    _same(ps.numpy(), np.asarray(s))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
    assert pq[5] == 0 and pq[601] == 0 and pq[600] == -127
