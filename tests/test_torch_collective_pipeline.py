"""The cases of tests/test_collective_pipeline.py that no other port test
holds, on the port's collective layer over two gloo ranks
(tests/_gloo_pool.py).

Covered elsewhere, and not repeated here: the chunk layout, the chunk
validation, ``auto_pipeline_chunks`` and the chunks/bucket spec knobs
(tests/test_torch_quantize.py), the fused reduce-scatter's interpret
path (tests/test_torch_fused_rs.py), the profiled allreduce and its
sub-phases (tests/test_torch_telemetry_parity.py), chunked == monolithic
at worlds 2 and 4 and async handles resolved out of order
(tests/test_torch_collective.py).

Here: a block-multiple payload whose phase 2 runs chunked too, bitwise
the monolithic result; the flight recorder's timeline nesting the
collective's sub-phases inside it (against the JAX package's trace of
the same snapshot); error-feedback residuals kept in the parameter dtype
(bf16 leaves keep bf16 residuals and outputs); and 50 steps of
compressed, bucketed data-parallel training converging to the mean
target, the ranks' weights equal.
"""

import numpy as np
import pytest
import torch

from _gloo_pool import GlooPool

torch.set_num_threads(1)

GROUP = "cpipe"


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(2)
    p.run(_setup)
    yield p
    p.close()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


# -- rank-side bodies (module level: the ranks import them by name) ------


def _setup():
    import torch.distributed as dist

    from ray_tpu_torch.collective import collective as col

    col.init_collective_group(2, dist.get_rank(), backend="gloo",
                              group_name=GROUP)
    return True


def _block_multiple(world_n):
    """(monolithic, chunked 3, exact) mean of a block-multiple payload."""
    import torch.distributed as dist

    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective import nccl_group as ng
    from ray_tpu_torch.collective.compression import CompressionConfig

    rank = dist.get_rank()
    pg = col.get_group_handle(GROUP).pg
    g = np.random.default_rng(9).standard_normal(
        (2, world_n)).astype(np.float32)
    x = torch.from_numpy(g[rank])
    mono = ng.mesh_allreduce(x, pg, op="mean", compression=CompressionConfig(
        min_size=0, pipeline_chunks=1))
    chk = ng.mesh_allreduce(x, pg, op="mean", compression=CompressionConfig(
        min_size=0, pipeline_chunks=3))
    full = ng.mesh_allreduce(x, pg, op="mean")
    return mono.numpy(), chk.numpy(), full.numpy()


def _bf16_residual_probe():
    import torch.distributed as dist

    from ray_tpu_torch.parallel import GradientSynchronizer

    rank = dist.get_rank()
    sync = GradientSynchronizer(group_name=GROUP, compression="int8:min=0")
    outs = []
    for t in range(2):
        g = {
            "wb": torch.from_numpy(np.random.default_rng(10 * t + rank)
                                   .standard_normal(2048)
                                   .astype(np.float32)).bfloat16(),
            "wf": torch.from_numpy(np.random.default_rng(77 * t + rank)
                                   .standard_normal(512)
                                   .astype(np.float32)),
        }
        out = sync(g)
        outs.append({k: v.float().numpy() for k, v in out.items()})
    res_dtypes = sorted(str(v.dtype).split(".")[-1]
                        for v in sync.residuals.values())
    out_dtypes = {k: str(v.dtype).split(".")[-1] for k, v in out.items()}
    return outs, out_dtypes, res_dtypes


def _ef_train_bucketed(steps, dims, bucket_bytes, lr, seed):
    """Quadratic dp training through the BUCKETED synchronizer: rank i
    pulls toward t_i = center + noise_i; the synced mean gradient drives
    w to the mean target."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import GradientSynchronizer

    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(seed)
    center = {k: rng.standard_normal(d).astype(np.float32)
              for k, d in dims.items()}
    # every rank derives ALL targets from the shared seed, uses its own
    noises = [{k: np.random.default_rng(seed + 1 + r)
               .standard_normal(d).astype(np.float32)
               for k, d in dims.items()} for r in range(world)]
    target = {k: torch.from_numpy(center[k] + noises[rank][k])
              for k in dims}
    w = {k: torch.zeros(d) for k, d in dims.items()}
    sync = GradientSynchronizer(group_name=GROUP, compression="int8:min=0",
                                bucket_bytes=bucket_bytes)
    for _ in range(steps):
        g = sync({k: w[k] - target[k] for k in dims})
        w = {k: w[k] - lr * g[k] for k in dims}
    mean_t = {k: center[k] + np.mean([nz[k] for nz in noises], axis=0)
              for k in dims}
    excess = float(sum(0.5 * np.mean((w[k].numpy() - mean_t[k]) ** 2)
                       for k in dims))
    return {k: v.numpy() for k, v in w.items()}, excess


# -- the cases ---------------------------------------------------------------


def test_chunked_block_multiple_boundary(pool):
    """Block-multiple payload (2 * 256 * 3 elements a rank): phase 2 runs
    chunked too (block % rblock == 0), still bitwise-equal to
    monolithic, and near the exact mean."""
    res = pool.run(_block_multiple, 2 * 256 * 3)
    for mono, chk, full in res:
        assert np.array_equal(mono, chk)
        assert _rel(mono, full) < 1e-2
    assert np.array_equal(res[0][0], res[1][0])


def test_timeline_nests_subphases_inside_collective():
    from ray_tpu.telemetry import chrome_trace as ref_chrome_trace
    from ray_tpu_torch.telemetry import chrome_trace, validate_chrome_trace

    snap = {"rank": 0, "incarnation": 0, "trial": "t", "steps": [{
        "step": 0, "ts": 100.0, "dur": 1.0,
        "phases": {"compute": 0.5, "collective": 0.4,
                   "collective.quantize": 0.15,
                   "collective.transfer": 0.1,
                   "collective.dequantize": 0.1},
        "rank": 0, "incarnation": 0}]}
    trace = chrome_trace([snap])
    assert validate_chrome_trace(trace)
    spans = {e["name"]: e for e in trace["traceEvents"] if e["ph"] == "X"}
    parent = spans["collective"]
    for name in ("collective.quantize", "collective.transfer",
                 "collective.dequantize"):
        child = spans[name]
        assert child["ts"] >= parent["ts"] - 1e-6
        assert child["ts"] + child["dur"] <= \
            parent["ts"] + parent["dur"] + 1e-6
    # the same spans as the JAX package's trace of the snapshot
    ref = {e["name"]: (e["ts"], e["dur"])
           for e in ref_chrome_trace([snap])["traceEvents"]
           if e["ph"] == "X"}
    assert {k: (v["ts"], v["dur"]) for k, v in spans.items()} == ref


def test_bf16_residuals_stay_bf16(pool):
    (outs_a, out_dt, res_dt), (outs_b, _, res_dt_b) = pool.run(
        _bf16_residual_probe)
    # error-feedback residuals live in the PARAMETER dtype: bf16 params
    # must not silently double residual memory by upcasting to f32
    assert res_dt == ["bfloat16", "float32"] == res_dt_b
    assert out_dt == {"wb": "bfloat16", "wf": "float32"}
    for t in range(2):
        for k in ("wb", "wf"):
            assert np.array_equal(outs_a[t][k], outs_b[t][k]), (t, k)


def test_bucketed_ef_training_50_steps(pool):
    dims = {"a": 768, "b": 512, "c": 512}
    # bucket_bytes=3000 coalesces (a) into one bucket and (b,c) into a
    # second: several leaves a bucket AND several buckets a step
    (w_a, excess_a), (w_b, _) = pool.run(_ef_train_bucketed, 50, dims,
                                         3000, 0.5, 42)
    for k in dims:
        assert np.array_equal(w_a[k], w_b[k]), k
    # error feedback keeps compressed bucketed training convergent: the
    # distance to the true optimum stays tiny after 50 steps
    assert excess_a < 1e-3, excess_a
