"""Actor-pool compute for Dataset.map_batches (reference:
python/ray/data/_internal/execution/operators/actor_pool_map_operator.py:34
and python/ray/data/tests/test_actor_pool_map_operator.py shapes).

The port's mirror of tests/test_data_actor_pool.py, case by case, on one
cluster of the port's runtime for the module.
"""

import os
import time
import uuid

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.compute import (ActorPoolStrategy,
                                        TaskPoolStrategy,
                                        strategy_from_concurrency)


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


class AddUDF:
    """Class UDF: stamps every batch with its instance id so tests can
    prove __init__ ran once per pool actor, not once per batch."""

    def __init__(self, delta=1):
        self.delta = delta
        self.uid = uuid.uuid4().hex

    def __call__(self, batch):
        return {"id": batch["id"] + self.delta,
                "actor": np.array([self.uid] * len(batch["id"]))}


def test_class_udf_requires_concurrency(ray_cluster):
    ds = rd.range(8)
    with pytest.raises(ValueError, match="concurrency"):
        ds.map_batches(AddUDF)


def test_map_batches_rejects_unknown_kwargs(ray_cluster):
    ds = rd.range(8)
    with pytest.raises(TypeError):
        ds.map_batches(lambda b: b, totally_unknown_kwarg=3)


def test_concurrency_tuple_requires_class(ray_cluster):
    ds = rd.range(8)
    with pytest.raises(ValueError, match="callable-class"):
        ds.map_batches(lambda b: b, concurrency=(1, 2))


def test_strategy_from_concurrency():
    assert isinstance(strategy_from_concurrency(None, False),
                      TaskPoolStrategy)
    s = strategy_from_concurrency(3, True)
    assert isinstance(s, ActorPoolStrategy)
    assert (s.min_size, s.max_size) == (3, 3)
    s = strategy_from_concurrency((1, 4), True)
    assert (s.min_size, s.max_size) == (1, 4)
    assert strategy_from_concurrency(4, False).size == 4
    with pytest.raises(ValueError):
        strategy_from_concurrency((3, 1), True)


def test_actor_pool_init_once_per_actor(ray_cluster):
    """16 blocks through a 2-actor pool: every row is transformed, and the
    number of distinct UDF instances == pool size (warm state is reused
    across batches, THE point of actor compute)."""
    ds = rd.range(160, override_num_blocks=16).map_batches(
        AddUDF, concurrency=2, fn_constructor_kwargs={"delta": 10})
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == [i + 10 for i in range(160)]
    actors = {r["actor"] for r in rows}
    assert len(actors) <= 2          # exactly the pool, not per-batch
    assert len(rows) > len(actors)   # instances were reused


def test_actor_pool_constructor_args(ray_cluster):
    ds = rd.range(10, override_num_blocks=2).map_batches(
        AddUDF, concurrency=1, fn_constructor_args=(100,))
    assert sorted(r["id"] for r in ds.take_all()) == \
        [i + 100 for i in range(10)]


class SlowAddUDF(AddUDF):
    """Holds each batch briefly so the queue stays visibly deep: scale-up
    must trigger on saturation, not on a race against instant batches
    (an instant UDF lets one actor drain the queue before the autoscale
    check runs on a slow/contended box)."""

    def __call__(self, batch):
        time.sleep(0.15)
        return super().__call__(batch)


def test_actor_pool_autoscales(ray_cluster):
    """min=1,max=3 with a deep queue: the pool grows past min while all
    live actors are saturated."""
    from ray_tpu_torch.data.execution import (ActorPoolMapOperator,
                                              build_executor)

    ds = rd.range(240, override_num_blocks=24).map_batches(
        SlowAddUDF, concurrency=(1, 3))
    executor = build_executor(ds._dag)
    pool_ops = [op for op in executor.ops
                if isinstance(op, ActorPoolMapOperator)]
    assert len(pool_ops) == 1
    n = 0
    peak = 0
    for bundle in executor.run():
        n += bundle.metadata.num_rows
        peak = max(peak, pool_ops[0].pool_size())
    assert n == 240
    assert peak > 1, "pool never grew past min_size"


class DieOnceUDF:
    """Kills its own worker process on the first batch it sees unless the
    flag file exists (so exactly one actor dies across the pool)."""

    def __init__(self, flag_path):
        self.flag_path = flag_path

    def __call__(self, batch):
        if not os.path.exists(self.flag_path):
            with open(self.flag_path, "w") as f:
                f.write("died")
            os._exit(1)
        return {"id": batch["id"]}


def test_actor_pool_replaces_dead_actor(ray_cluster, tmp_path):
    """An actor dying mid-block is replaced and the block is retried —
    no rows lost, no exception surfaced (reference:
    ActorPoolMapOperator restarting failed actors)."""
    flag = str(tmp_path / "died_once")
    ds = rd.range(60, override_num_blocks=6).map_batches(
        DieOnceUDF, concurrency=2, fn_constructor_args=(flag,))
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(60))
    assert os.path.exists(flag)


def test_map_row_class_udf(ray_cluster):
    class RowUDF:
        def __init__(self):
            self.n = 0

        def __call__(self, row):
            self.n += 1
            return {"v": row["id"] * 2}

    ds = rd.range(12, override_num_blocks=3).map(RowUDF, concurrency=1)
    assert sorted(r["v"] for r in ds.take_all()) == \
        [2 * i for i in range(12)]


def test_task_pool_cap(ray_cluster):
    """int concurrency for a function caps that operator's in-flight
    tasks (reference: TaskPoolStrategy.size) — the capped stage must NOT
    fuse into the read (fusion would run it at read parallelism)."""
    from ray_tpu_torch.data.execution import MapOperator, build_executor

    ds = rd.range(40, override_num_blocks=8).map_batches(
        lambda b: {"id": b["id"]}, concurrency=2)
    executor = build_executor(ds._dag)
    capped = [op for op in executor.ops
              if isinstance(op, MapOperator)
              and getattr(op, "task_cap", None) == 2]
    assert capped, "capped stage was fused away or lost its cap"
    n = 0
    peak = 0
    for bundle in executor.run():
        n += bundle.metadata.num_rows
        peak = max(peak, capped[0].active)
    assert n == 40
    assert peak <= 2


def test_constructor_args_require_class(ray_cluster):
    with pytest.raises(ValueError, match="callable-class"):
        rd.range(8).map_batches(lambda b: b, fn_constructor_args=(1,))


def test_compute_and_concurrency_conflict(ray_cluster):
    with pytest.raises(ValueError, match="not both"):
        rd.range(8).map_batches(lambda b: b, compute=TaskPoolStrategy(),
                                concurrency=2)
    with pytest.raises(ValueError, match="not both"):
        rd.range(8).map(lambda r: r, compute=TaskPoolStrategy(),
                        concurrency=2)


def _late_head_source(n_blocks, rows, delay_s):
    """-> a Datasource whose block 0 is read `delay_s` late, the others
    at once (defined inside a function, so it ships by value)."""
    from ray_tpu_torch.data.block import BlockMetadata, rows_to_block
    from ray_tpu_torch.data.datasource import Datasource, ReadTask

    class LateHead(Datasource):
        def get_read_tasks(self, parallelism):
            def task(i):
                def read():
                    if i == 0:
                        time.sleep(delay_s)
                    yield rows_to_block([{"id": i * rows + j}
                                         for j in range(rows)])

                return ReadTask(read, BlockMetadata(num_rows=rows,
                                                    size_bytes=None))

            return [task(i) for i in range(n_blocks)]

    return LateHead()


def test_actor_pool_takes_the_head_block_first(ray_cluster):
    """Block 0 reaches the pool after the others are queued: the pool
    takes it next (dataset order), so the order-preserving stream hands
    out its first output while the pool still works.  Taken in arrival
    order (the reference's pool) it runs last, every output waits for the
    pool's shutdown and pool_size() reads 0 at each: the cause of
    test_actor_pool_autoscales's "peak 0" under load (ROADMAP §C)."""
    from ray_tpu_torch.data.execution import (ActorPoolMapOperator,
                                              build_executor)

    ds = rd.read_datasource(_late_head_source(16, 10, 0.5)).map_batches(
        SlowAddUDF, concurrency=2)
    executor = build_executor(ds._dag)
    pool = next(op for op in executor.ops
                if isinstance(op, ActorPoolMapOperator))
    sizes, ids = [], []
    for bundle in executor.run():
        sizes.append(pool.pool_size())
        block = ray_tpu_torch.get(bundle.block_ref, timeout=60)
        ids.extend(block.column("id").to_pylist())
    assert ids == [i + 1 for i in range(160)]
    assert sizes[0] == 2, sizes
