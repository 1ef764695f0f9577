"""The port's collective layer against the JAX package, on the CPU.

Gloo ranks are started with ``torch.multiprocessing`` (spawn): one spawn
of world 2 and one of world 4, each with a 120 s deadline past which its
ranks are killed and the tests fail.  Each rank runs every collective on
inputs made from numpy seeds and saves its results; the tests then run
the JAX package's ``xla_group`` on a CPU mesh of the same world size over
the same inputs and compare rank by rank.  This module imports JAX only
inside test functions, so the ranks never load it.

Tolerances: the int8 paths (``mesh_allreduce`` sum/mean at chunks 1, 2
and 5, ``mesh_reducescatter``, ``mesh_allgather``) are bitwise, as are
the uncompressed gathers, broadcast, all-to-all and ppermute.  The fp32
allreduce and reduce-scatter are bitwise at world 2 (two terms add the
same in any order) and within 2 ulps (4.8e-7 relative to the largest
|x|) at world 4, where gloo's ring adds the peers in another order than
XLA.  The nano-GPT data-parallel step matches the full batch's grads
within 1e-5 * max|g| per leaf (two half-batch means against one mean).
"""

import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SPAWN_DEADLINE_S = 120.0
AR_SHAPES = {"even": (4, 2560), "ragged": (3, 1000)}
CHUNKS = (1, 2, 5)
RS_SUB = 300          # per-rank reduce-scatter chunk: not a block multiple
SYNC_BUCKET_BYTES = 8192
SYNC_LEAVES = {"w": ((2048,), torch.float32), "b": ((300,), torch.float32),
               "e": ((40, 64), torch.bfloat16)}
GPT_BATCH = 4


def _shard(tag: str, rank: int, shape, seed: int = 0) -> np.ndarray:
    """Rank ``rank``'s input for ``tag``: heavy-tailed magnitudes so
    blocks get very different scales."""
    rng = np.random.default_rng([seed, rank, sum(map(ord, tag))])
    x = rng.standard_normal(shape).astype(np.float32)
    return (x * np.exp(rng.standard_normal(shape) * 2)).astype(np.float32)


def _sync_grads(rank: int, step: int):
    return {k: torch.from_numpy(_shard(f"sync-{k}-{step}", rank, shape)).to(dt)
            for k, (shape, dt) in SYNC_LEAVES.items()}


def _gpt_batch():
    return np.random.RandomState(7).randint(0, 256, (GPT_BATCH, 33))


# ---------------------------------------------------------------------------
# rank side (no JAX)
# ---------------------------------------------------------------------------


def _rank_work(rank: int, world: int):
    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective import nccl_group as ng
    from ray_tpu_torch.parallel import GradientSynchronizer

    pg = col.get_group_handle("t").pg
    res = {}
    for name, shape in AR_SHAPES.items():
        x = torch.from_numpy(_shard(f"ar-{name}", rank, shape))
        for op in ("sum", "mean"):
            res[f"ar/{name}/{op}/fp32"] = ng.mesh_allreduce(x, pg, op=op)
            for c in CHUNKS:
                res[f"ar/{name}/{op}/int8c{c}"] = ng.mesh_allreduce(
                    x, pg, op=op, compression=f"int8:chunks={c}")
            res[f"ar/{name}/{op}/plain"] = ng.mesh_allreduce(
                x, pg, op=op, compression="int8:chunks=2", impl="plain")
        for seed in (3, 3, 4):
            res.setdefault(f"ar/{name}/stoch", []).append(ng.mesh_allreduce(
                x, pg, op="mean", seed=seed,
                compression="int8:stochastic=1,chunks=2"))
    row = torch.from_numpy(_shard("rs", rank, (1, world * RS_SUB)))
    res["rs/int8"] = ng.mesh_reducescatter(row, pg, compression="int8")
    res["rs/fp32"] = ng.mesh_reducescatter(row, pg)
    ag = torch.from_numpy(_shard("ag", rank, (3, 100)))
    res["ag/int8"] = ng.mesh_allgather(ag, pg, compression="int8")
    res["ag/fp32"] = ng.mesh_allgather(ag, pg)
    res["bc"] = ng.mesh_broadcast(ag, pg, root=world - 1)
    res["a2a"] = ng.mesh_all_to_all(
        torch.from_numpy(_shard("a2a", rank, (3, 4 * world))), pg)
    res["ring"] = ng.mesh_ppermute(ag, [(r, (r + 1) % world)
                                        for r in range(world)], pg)
    res["pair"] = ng.mesh_ppermute(ag, [(0, 1)], pg)

    # the group API: op counts seed, handles finish out of order
    x = torch.from_numpy(_shard("api", rank, (2048,)))
    h1 = col.allreduce_async(x, "t", op="mean", compression="int8:min=0")
    h2 = col.allreduce_async(x, "t", op="max")
    res["api/max"], res["api/q_mean"] = h2.result(), h1.result()
    res["api/allgather"] = col.allgather(x[:10], "t")
    res["api/reducescatter"] = col.reducescatter(x[:10], "t")
    res["api/broadcast"] = col.broadcast(x[:5] + rank, src_rank=0,
                                         group_name="t")
    if rank == 0:
        col.send(x[:6].view(2, 3) * 2, 1, "t")
    elif rank == 1:
        res["api/recv"] = col.recv(0, "t")
    col.barrier("t")

    sync = GradientSynchronizer("t", compression="int8:min=0",
                                bucket_bytes=SYNC_BUCKET_BYTES)
    for step in range(2):
        res[f"sync/{step}/out"] = sync(_sync_grads(rank, step))
        res[f"sync/{step}/res"] = sync.residuals

    if world == 2:
        from ray_tpu_torch.models import gpt, training

        cfg = gpt.GPTConfig.nano(dtype=torch.float32)
        params = gpt.init(cfg, seed=0, device="cpu")
        leaves = [t.requires_grad_() for _, t in training.param_leaves(params)]
        half = GPT_BATCH // world
        toks = _gpt_batch()[rank * half:(rank + 1) * half]
        gpt.loss_fn(params, {"tokens": toks}, cfg, device="cpu").backward()
        res["gpt"] = GradientSynchronizer("t")([t.grad for t in leaves])
    return res


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().float().numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_numpy(v) for v in obj]
    return obj


def _rank_main(rank: int, world: int, init_file: str, out_path: str):
    torch.set_num_threads(1)
    try:
        from ray_tpu_torch.collective import collective as col

        col.init_collective_group(world, rank, backend="gloo",
                                  group_name="t",
                                  init_method=f"file://{init_file}")
        try:
            res = _to_numpy(_rank_work(rank, world))
        finally:
            col.destroy_collective_group("t")
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
    """world -> every rank's results (one spawn per world, on first
    use)."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _spawn(world, str(tmp_path_factory.mktemp(
                f"gloo{world}")))
        return cache[world]

    return get


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX references below compile ``xla_group``'s programs through
    the process's compilation ledger, at shapes enough to open recompile
    storms.  Leave later test modules in this process a fresh ledger, so
    no storm advisory of ours reaches their trainers."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


# ---------------------------------------------------------------------------
# JAX side
# ---------------------------------------------------------------------------


def _mesh(world):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:world]), ("dp",))


def _global(mesh, shards):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(np.concatenate(shards)),
                          NamedSharding(mesh, P("dp")))


def _rows(out, world):
    return np.split(np.asarray(out, np.float32), world)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("shape", sorted(AR_SHAPES))
def test_int8_allreduce_matches_jax(ranks, world, op, shape):
    from ray_tpu.collective import xla_group

    res = ranks(world)
    mesh = _mesh(world)
    arr = _global(mesh, [_shard(f"ar-{shape}", r, AR_SHAPES[shape])
                         for r in range(world)])
    for c in CHUNKS:
        want = _rows(xla_group.mesh_allreduce(
            arr, mesh, "dp", op=op, compression=f"int8:chunks={c}"), world)
        for r in range(world):
            _same(res[r][f"ar/{shape}/{op}/int8c{c}"], want[r])
            # chunked == monolithic, and the plain versions agree
            _same(res[r][f"ar/{shape}/{op}/int8c{c}"],
                  res[r][f"ar/{shape}/{op}/int8c1"])
            _same(res[r][f"ar/{shape}/{op}/plain"], want[r])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_fp32_allreduce_matches_jax(ranks, world, op):
    from ray_tpu.collective import xla_group

    res = ranks(world)
    mesh = _mesh(world)
    for shape in AR_SHAPES:
        shards = [_shard(f"ar-{shape}", r, AR_SHAPES[shape])
                  for r in range(world)]
        want = _rows(xla_group.mesh_allreduce(_global(mesh, shards), mesh,
                                              "dp", op=op), world)
        for r in range(world):
            got = res[r][f"ar/{shape}/{op}/fp32"]
            if world == 2:
                _same(got, want[r])
            else:
                scale = max(np.abs(s).max() for s in shards)
                np.testing.assert_allclose(got, want[r], rtol=0,
                                           atol=2 * 2.0 ** -23 * scale)


@pytest.mark.parametrize("world", [2, 4])
def test_stochastic_allreduce_is_reproducible(ranks, world):
    """Stochastic bits are the port's own (held port against port): the
    same seed gives the same result, another seed another, every rank
    lands on the same values, and the error against fp32 is at most
    twice round-to-nearest's (floor(y + u) has twice its variance)."""
    res = ranks(world)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for shape in AR_SHAPES:
        a, b, c = res[0][f"ar/{shape}/stoch"]
        _same(a, b)
        assert not np.array_equal(a, c)
        for r in range(1, world):
            _same(res[r][f"ar/{shape}/stoch"][0], a)
        exact = res[0][f"ar/{shape}/mean/fp32"]
        nearest = res[0][f"ar/{shape}/mean/int8c1"]
        assert rel(a, exact) < 2 * rel(nearest, exact)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["int8", "fp32"])
def test_reducescatter_matches_jax(ranks, world, kind):
    from ray_tpu.collective import xla_group

    res = ranks(world)
    mesh = _mesh(world)
    shards = [_shard("rs", r, (1, world * RS_SUB)) for r in range(world)]
    want = _rows(xla_group.mesh_reducescatter(
        _global(mesh, shards), mesh, "dp",
        compression="int8" if kind == "int8" else None), world)
    for r in range(world):
        got = res[r][f"rs/{kind}"]
        assert got.shape == (1, RS_SUB)
        if kind == "int8" or world == 2:
            _same(got, want[r])
        else:
            scale = max(np.abs(s).max() for s in shards)
            np.testing.assert_allclose(got, want[r], rtol=0,
                                       atol=2 * 2.0 ** -23 * scale)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["int8", "fp32"])
def test_allgather_matches_jax(ranks, world, kind):
    from ray_tpu.collective import xla_group

    res = ranks(world)
    mesh = _mesh(world)
    arr = _global(mesh, [_shard("ag", r, (3, 100)) for r in range(world)])
    want = np.asarray(xla_group.mesh_allgather(
        arr, mesh, "dp", compression="int8" if kind == "int8" else None))
    for r in range(world):
        assert res[r][f"ag/{kind}"].shape == (3 * world, 100)
        _same(res[r][f"ag/{kind}"], want)


@pytest.mark.parametrize("world", [2, 4])
def test_broadcast_all_to_all_ppermute_match_jax(ranks, world):
    from ray_tpu.collective import xla_group

    res = ranks(world)
    mesh = _mesh(world)
    ag = _global(mesh, [_shard("ag", r, (3, 100)) for r in range(world)])
    a2a = _global(mesh, [_shard("a2a", r, (3, 4 * world))
                         for r in range(world)])
    cases = {
        "bc": xla_group.mesh_broadcast(ag, mesh, "dp", root=world - 1),
        "a2a": xla_group.mesh_all_to_all(a2a, mesh, "dp"),
        "ring": xla_group.mesh_ppermute(
            ag, mesh, [(r, (r + 1) % world) for r in range(world)], "dp"),
        "pair": xla_group.mesh_ppermute(ag, mesh, [(0, 1)], "dp"),
    }
    for key, out in cases.items():
        want = _rows(out, world)
        for r in range(world):
            _same(res[r][key], want[r])


@pytest.mark.parametrize("world", [2, 4])
def test_group_api_matches_jax(ranks, world):
    """allreduce(_async) through the group: the int8 mean equals the
    reference's compressed xla-backend allreduce (each rank's tensor a
    [1, ...] shard of the stack), handles finish out of order, and the
    gather, reduce-scatter, broadcast and send/recv move what they
    should."""
    from ray_tpu.collective import xla_group

    res = ranks(world)
    mesh = _mesh(world)
    xs = [_shard("api", r, (2048,)) for r in range(world)]
    want = np.asarray(xla_group.mesh_allreduce(
        _global(mesh, [x[None] for x in xs]), mesh, "dp", op="mean",
        compression="int8"))
    full_sum = np.zeros(10, np.float32)
    for x in xs:
        full_sum = full_sum + x[:10]
    for r in range(world):
        _same(res[r]["api/q_mean"], want[r])
        _same(res[r]["api/max"], np.max(xs, axis=0))
        for p in range(world):
            _same(res[r]["api/allgather"][p], xs[p][:10])
        mine = np.array_split(np.arange(10), world)[r]
        np.testing.assert_allclose(res[r]["api/reducescatter"],
                                   full_sum[mine], rtol=1e-6, atol=1e-6)
        _same(res[r]["api/broadcast"], xs[0][:5])
    _same(res[1]["api/recv"], xs[0][:6].reshape(2, 3) * 2)


def _bucket_layout(sizes, cap):
    """GradientSynchronizer's bucket rule: flush once the f32 bytes
    pending reach ``cap``, and the tail at finish()."""
    buckets, cur, nbytes = [], [], 0
    for i, n in enumerate(sizes):
        cur.append(i)
        nbytes += n * 4
        if nbytes >= cap:
            buckets.append(cur)
            cur, nbytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


@pytest.mark.parametrize("world", [2, 4])
def test_gradient_synchronizer_matches_jax(ranks, world):
    """Two error-feedback steps of GradientSynchronizer("int8:min=0"):
    every rank gets the same leaves, each bucket's synced values equal
    the reference's compressed mean of the corrected buckets, and the
    residuals equal the reference's host codec (compression_residual)
    of the corrected bucket, in the parameter dtype."""
    import ml_dtypes
    from ray_tpu.collective import xla_group
    from ray_tpu.collective.compression import (CompressionConfig,
                                                compression_residual)

    res = ranks(world)
    mesh = _mesh(world)
    cc = CompressionConfig(min_size=0)
    keys = list(SYNC_LEAVES)
    sizes = [int(np.prod(SYNC_LEAVES[k][0])) for k in keys]
    buckets = _bucket_layout(sizes, SYNC_BUCKET_BYTES)
    assert len(buckets) == 2
    resid = [{k: np.zeros(SYNC_LEAVES[k][0], np.float32) for k in keys}
             for _ in range(world)]
    for step in range(2):
        grads = [{k: v.float().numpy() for k, v in _sync_grads(r, step)
                  .items()} for r in range(world)]
        for bucket in buckets:
            names = [keys[i] for i in bucket]
            corrected = [np.concatenate([(grads[r][k] + resid[r][k])
                                         .reshape(-1) for k in names])
                         for r in range(world)]
            synced = np.asarray(xla_group.mesh_allreduce(
                _global(mesh, [c[None] for c in corrected]), mesh, "dp",
                op="mean", compression=cc))[0]
            off = 0
            for k in names:
                shape, dt = SYNC_LEAVES[k]
                n = int(np.prod(shape))
                want = synced[off:off + n].reshape(shape)
                if dt == torch.bfloat16:
                    want = want.astype(ml_dtypes.bfloat16).astype(np.float32)
                for r in range(world):
                    _same(res[r][f"sync/{step}/out"][k], want)
                    e = compression_residual(corrected[r], cc)[off:off + n]
                    e = e.reshape(shape)
                    if dt == torch.bfloat16:
                        e = e.astype(ml_dtypes.bfloat16).astype(np.float32)
                    resid[r][k] = e
                    _same(res[r][f"sync/{step}/res"][keys.index(k)], e)
                off += n


def test_nano_gpt_dp_step_matches_full_batch(ranks):
    """A world-2 data-parallel step with compression=None: each rank's
    half-batch grads, mean-allreduced, give the full batch's grads
    within 1e-5 * max|g| per leaf."""
    from ray_tpu_torch.models import gpt, training

    res = ranks(2)
    cfg = gpt.GPTConfig.nano(dtype=torch.float32)
    params = gpt.init(cfg, seed=0, device="cpu")
    leaves = [t.requires_grad_() for _, t in training.param_leaves(params)]
    gpt.loss_fn(params, {"tokens": _gpt_batch()}, cfg,
                device="cpu").backward()
    for r in range(2):
        assert len(res[r]["gpt"]) == len(leaves)
        for got, t in zip(res[r]["gpt"], leaves):
            want = t.grad.numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    for a, b in zip(res[0]["gpt"], res[1]["gpt"]):
        _same(a, b)


# --- the dp step's sync plan: the shapes the quantize kernels are timed at --

GPT2_SMALL_BUCKETS = [38_633_472, 7_087_104, 7_077_888, 7_077_888,
                      7_077_888, 28_320_768, 28_311_552, 852_480]


@pytest.mark.parametrize("fused,launches", [
    (None, {"quantize": 106, "dequantize": 57, "dequantize_accumulate": 49,
            "fused_reduce_scatter": 0}),
    (True, {"quantize": 57, "dequantize": 57, "dequantize_accumulate": 0,
            "fused_reduce_scatter": 49})])
def test_gpt2_small_sync_plan_at_world_1(fused, launches):
    """GPT-2-small's gradient under GradientSynchronizer("int8") at world
    1 splits into 8 buckets and 49 chunks of 852,480-4,829,184 elements
    that sum to the whole gradient; K4/K5/K6/K7 launch 106/57/49/0 times
    a step under the reference's fused-hop rule (57/57/0/49 with the
    fused hop forced).  PERF.md times K5 and K6 at these chunks."""
    import math

    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import sharding

    cfg = gpt.GPTConfig.gpt2_small()
    sizes = [math.prod(shape) for _, shape in
             training.param_leaves(gpt.param_shapes(cfg))]
    cc = parse_compression("int8")
    assert sharding.bucket_sizes(sizes, cc.bucket_bytes) == GPT2_SMALL_BUCKETS
    plan = sharding.sync_plan(sizes, cc, 1, fused=fused)
    assert sharding.sync_launch_counts(plan) == launches
    hop = "fused_reduce_scatter" if fused else "dequantize_accumulate"
    chunks = sorted(launch.n for launch in plan if launch.kernel == hop)
    assert len(chunks) == 49
    assert sum(chunks) == gpt.num_params(cfg) == 124_439_040
    assert chunks[0] == 852_480 and chunks[-1] == 4_829_184
    assert sum(1_179_648 <= c <= 1_181_184 for c in chunks) == 24
    assert sum(3_538_944 <= c <= 3_540_224 for c in chunks) == 16
    assert chunks.count(4_829_184) == 8
    # phase 2 dequantizes each chunk at the result block; error feedback
    # each bucket at the block
    k5 = sorted((launch.n, launch.block) for launch in plan
                if launch.kernel == "dequantize")
    assert k5 == sorted([(c, 32) for c in chunks]
                        + [(n, 256) for n in GPT2_SMALL_BUCKETS])


@pytest.mark.parametrize("world", [1, 4])
def test_gpt2_small_sync_plan_k4_takes_the_vector_body(world):
    """Every K4 launch of the dp step's sync has a block K4's vector body
    takes: 49 at the result block 32 (phase 2), 57 at 256 (phase 1 and
    error feedback); and phase 1's column slice of [world, sub] at a
    block offset starts every row 16-byte aligned."""
    import collections
    import math

    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import sharding

    cfg = gpt.GPTConfig.gpt2_small()
    sizes = [math.prod(shape) for _, shape in
             training.param_leaves(gpt.param_shapes(cfg))]
    plan = sharding.sync_plan(sizes, parse_compression("int8"), world)
    blocks = collections.Counter(launch.block for launch in plan
                                 if launch.kernel == "quantize")
    assert blocks == {32: 49, 256: 57}
    assert set(blocks) <= set(_kernels.QUANTIZE_VECTOR_BLOCKS)
    x2d = torch.zeros(world, 3 * 2048)
    for off, csz in ((0, 2048), (2048, 1024), (3072, 3072)):
        assert _kernels.quantize_vector_body(x2d[:, off:off + csz], 256)
        assert _kernels.quantize_vector_body(torch.zeros(csz), 32)


def test_bucket_sizes_is_the_synchronizers_rule():
    """``sharding.bucket_sizes`` gives the buckets GradientSynchronizer
    issues, for leaves pushed in order under a small cap."""
    from unittest import mock

    from ray_tpu_torch.collective import collective
    from ray_tpu_torch.parallel import GradientSynchronizer, sharding

    sizes = [300, 2048, 100, 5000, 7, 1500, 1500, 9]
    issued = []

    class Done:
        def __init__(self, x):
            self.x = x

        def result(self):
            return self.x

    def record(x, group_name, op, compression):
        issued.append(x.numel())
        return Done(x)

    grads = [torch.ones(n) for n in sizes]
    sync = GradientSynchronizer(compression="int8:min=0", bucket_bytes=8192)
    with mock.patch.object(collective, "allreduce_async", record):
        out = sync(grads)
    assert [t.shape for t in out] == [g.shape for g in grads]
    assert issued == sharding.bucket_sizes(sizes, 8192) == [2348, 5100,
                                                             3007, 9]
