"""ray_tpu_torch.data tests (model: reference python/ray/data/tests/ —
test_map.py, test_sort.py, test_consumption.py shapes).

The port's mirror of tests/test_data.py, case by case.  The
``iter_jax_batches`` cases run on ``device="cpu"`` and hold torch tensors
and dtypes; a mesh layout raises naming ROADMAP A.6, and with no CUDA
device the default device raises when the iterator is built.  The
cross-package oracle is tests/test_torch_data_parity.py.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_range_count_take(ray_cluster):
    ds = rd.range(100, override_num_blocks=4)
    assert ds.count() == 100
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]


def test_from_items_schema(ray_cluster):
    ds = rd.from_items([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}])
    assert ds.count() == 2
    assert set(ds.columns()) == {"a", "b"}


def test_map_batches_numpy(ray_cluster):
    ds = rd.range(64, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"] * 2})
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == [2 * i for i in range(64)]


def test_map_batches_pandas(ray_cluster):
    def add_col(df):
        df = df.copy()
        df["y"] = df["id"] + 1
        return df

    ds = rd.range(10, override_num_blocks=2).map_batches(
        add_col, batch_format="pandas")
    rows = sorted(ds.take_all(), key=lambda r: r["id"])
    assert rows[3]["y"] == 4


def test_map_filter_flat_map_fusion(ray_cluster):
    ds = (rd.range(20, override_num_blocks=2)
          .map(lambda r: {"v": r["id"] + 1})
          .filter(lambda r: r["v"] % 2 == 0)
          .flat_map(lambda r: [{"v": r["v"]}, {"v": -r["v"]}]))
    vals = sorted(r["v"] for r in ds.take_all())
    evens = [v for v in range(1, 21) if v % 2 == 0]
    assert vals == sorted([-v for v in evens] + evens)


def test_batch_size_rebatching(ray_cluster):
    ds = rd.range(100, override_num_blocks=3)
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
    assert sum(sizes) == 100
    assert all(s <= 32 for s in sizes)


def test_iter_batches_drop_last(ray_cluster):
    ds = rd.range(100, override_num_blocks=3)
    sizes = [len(b["id"])
             for b in ds.iter_batches(batch_size=32, drop_last=True)]
    assert all(s == 32 for s in sizes)


def test_limit_streaming(ray_cluster):
    ds = rd.range(1000, override_num_blocks=8).limit(37)
    assert ds.count() == 37


def test_repartition(ray_cluster):
    mat = rd.range(100, override_num_blocks=7).repartition(3).materialize()
    assert mat.num_blocks() == 3
    assert mat.count() == 100


def test_random_shuffle(ray_cluster):
    ds = rd.range(200, override_num_blocks=4).random_shuffle(seed=7)
    vals = [r["id"] for r in ds.take_all()]
    assert sorted(vals) == list(range(200))
    assert vals != list(range(200))


def test_sort(ray_cluster):
    ds = rd.range(150, override_num_blocks=5).random_shuffle(seed=3)
    out = [r["id"] for r in ds.sort("id").take_all()]
    assert out == list(range(150))
    out_desc = [r["id"] for r in ds.sort("id", descending=True).take_all()]
    assert out_desc == list(reversed(range(150)))


def test_global_aggregates(ray_cluster):
    ds = rd.range(100, override_num_blocks=4)
    assert ds.sum("id") == sum(range(100))
    assert ds.min("id") == 0
    assert ds.max("id") == 99
    assert ds.mean("id") == pytest.approx(49.5)
    assert ds.std("id") == pytest.approx(np.std(np.arange(100), ddof=1))


def test_groupby_aggregate(ray_cluster):
    ds = rd.from_items([{"k": i % 3, "v": i} for i in range(30)],
                       override_num_blocks=4)
    out = ds.groupby("k").sum("v").take_all()
    expect = {k: sum(i for i in range(30) if i % 3 == k) for k in range(3)}
    got = {r["k"]: r["sum(v)"] for r in out}
    assert got == expect


def test_groupby_count_mean(ray_cluster):
    ds = rd.from_items([{"k": i % 2, "v": float(i)} for i in range(10)])
    rows = ds.groupby("k").mean("v").take_all()
    got = {r["k"]: r["mean(v)"] for r in rows}
    assert got[0] == pytest.approx(4.0)
    assert got[1] == pytest.approx(5.0)


def test_map_groups(ray_cluster):
    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(8)])
    out = ds.groupby("k").map_groups(
        lambda batch: {"k": batch["k"][:1], "n": [len(batch["v"])]})
    rows = out.take_all()
    assert sorted((r["k"], r["n"]) for r in rows) == [(0, 4), (1, 4)]


def test_union_zip(ray_cluster):
    a = rd.range(10, override_num_blocks=2)
    b = rd.range(10, override_num_blocks=2).map_batches(
        lambda x: {"other": x["id"] + 100})
    assert a.union(a).count() == 20
    z = a.zip(b)
    rows = sorted(z.take_all(), key=lambda r: r["id"])
    assert rows[0]["other"] == 100
    assert rows[9]["other"] == 109


def test_columns_ops(ray_cluster):
    ds = rd.from_items([{"a": 1, "b": 2}, {"a": 3, "b": 4}])
    assert set(ds.select_columns(["a"]).columns()) == {"a"}
    assert set(ds.drop_columns(["a"]).columns()) == {"b"}
    renamed = ds.rename_columns({"a": "alpha"})
    assert set(renamed.columns()) == {"alpha", "b"}
    added = ds.add_column("c", lambda batch: batch["a"] + batch["b"])
    row = sorted(added.take_all(), key=lambda r: r["a"])[0]
    assert row["c"] == 3


def test_parquet_roundtrip(ray_cluster, tmp_path):
    ds = rd.range(50, override_num_blocks=3)
    paths = ds.write_parquet(str(tmp_path / "out"))
    assert len(paths) >= 1
    back = rd.read_parquet(str(tmp_path / "out"))
    assert back.count() == 50
    assert sorted(r["id"] for r in back.take_all()) == list(range(50))


def test_csv_json_roundtrip(ray_cluster, tmp_path):
    ds = rd.from_items([{"x": i, "y": f"s{i}"} for i in range(10)])
    ds.write_csv(str(tmp_path / "csv"))
    assert rd.read_csv(str(tmp_path / "csv")).count() == 10
    ds.write_json(str(tmp_path / "json"))
    back = rd.read_json(str(tmp_path / "json"))
    assert sorted(r["x"] for r in back.take_all()) == list(range(10))


def test_from_pandas_numpy_arrow(ray_cluster):
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"a": [1, 2, 3]})
    assert rd.from_pandas(df).count() == 3
    assert rd.from_numpy(np.arange(5)).count() == 5
    assert rd.from_arrow(pa.table({"z": [1, 2]})).count() == 2


def test_tensor_blocks(ray_cluster):
    ds = rd.range_tensor(8, shape=(2, 2), override_num_blocks=2)
    batch = next(iter(ds.iter_batches(batch_size=8)))
    assert batch["data"].shape == (8, 2, 2)


def test_split(ray_cluster):
    parts = rd.range(90, override_num_blocks=6).split(3)
    counts = [p.count() for p in parts]
    assert sum(counts) == 90
    assert all(c > 0 for c in counts)


def test_random_sample(ray_cluster):
    ds = rd.range(1000, override_num_blocks=2).random_sample(0.5, seed=11)
    n = ds.count()
    assert 350 < n < 650


def test_unique(ray_cluster):
    ds = rd.from_items([{"v": i % 4} for i in range(20)])
    assert ds.unique("v") == [0, 1, 2, 3]


def test_iter_jax_batches(ray_cluster):
    import torch

    from ray_tpu_torch.data import iterator

    ds = rd.range(64, override_num_blocks=2)
    iterator.reset_staging_counts()
    batches = list(ds.iter_jax_batches(batch_size=16, device="cpu"))
    assert len(batches) == 4
    assert all(isinstance(b["id"], torch.Tensor) for b in batches)
    assert all(b["id"].dtype == torch.int64 and b["id"].device.type == "cpu"
               for b in batches)
    total = sum(int(b["id"].sum()) for b in batches)
    assert total == sum(range(64))
    # the host path stages too, through no copy stream; the tensors own
    # writable memory (blocks are read-only shm views)
    assert iterator.staging_counts() == {
        "batches": 4, "bytes": 64 * 8, "copy_stream_batches": 0}
    batches[0]["id"].add_(1)


def test_iter_jax_batches_sharded(ray_cluster):
    """A mesh layout waits for the port's meshes: it raises, naming the
    item, when the iterator is built."""
    ds = rd.range(32, override_num_blocks=2)
    with pytest.raises(NotImplementedError, match="A.6"):
        ds.iter_jax_batches(batch_size=8, sharding=object(), device="cpu")


def test_iter_jax_batches_default_mesh_auto_shard(ray_cluster):
    """With no mesh (the port has none until A.6) batches land whole on
    the device, which is what the reference does when no mesh is
    declared; a short final batch comes out as it is."""
    import torch

    ds = rd.range(36, override_num_blocks=2)   # 36 = 4*8 + short 4
    batches = list(ds.iter_jax_batches(batch_size=8, drop_last=False,
                                       device="cpu"))
    assert len(batches) == 5
    assert all(b["id"].device == torch.device("cpu") for b in batches)
    assert batches[0]["id"].shape == (8,)
    short = batches[-1]["id"]
    assert short.shape[0] == 4
    total = sum(int(b["id"].sum()) for b in batches)
    assert total == sum(range(36))
    # the jit callers' default drops the short batch
    assert len(list(ds.iter_jax_batches(batch_size=8, device="cpu"))) == 4


def test_iter_jax_batches_without_cuda_raises_at_call(ray_cluster,
                                                      monkeypatch):
    """device=None means the current CUDA device, resolved when the
    iterator is built (not at its first next()): with no CUDA device every
    form raises there, and none falls back to the CPU."""
    import torch

    from ray_tpu_torch.data.iterator import iter_jax_batches

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = rd.range(8)
    for call in (lambda: ds.iter_jax_batches(batch_size=4),
                 lambda: ds.iterator().iter_jax_batches(batch_size=4),
                 lambda: iter_jax_batches(iter([{"id": np.arange(4)}])),
                 lambda: ds.iter_jax_batches(batch_size=4, device="cuda"),
                 lambda: ds.iter_torch_batches(batch_size=4,
                                               device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="cuda or cpu"):
        ds.iter_jax_batches(batch_size=4, device="meta")


def test_materialize_reuse(ray_cluster):
    mat = rd.range(40, override_num_blocks=4).materialize()
    assert mat.count() == 40
    # reuse without re-execution
    assert mat.map_batches(lambda b: {"id": b["id"]}).count() == 40
    assert "blocks" in (mat.stats() or "") or mat.stats()


def test_stats_populated(ray_cluster):
    ds = rd.range(10, override_num_blocks=2)
    # count() on a bare read is now a metadata fast path (no execution);
    # materializing populates stats
    assert ds.count() == 10
    assert ds.stats() == "(not executed)"
    ds.take_all()
    assert "Read" in ds.stats()


def test_split_equal_rows(ray_cluster):
    # 10 rows into 3 equal splits: exactly 3/3/3, remainder dropped
    ds = rd.range(10, override_num_blocks=4)
    parts = ds.split(3, equal=True)
    counts = [p.count() for p in parts]
    assert counts == [3, 3, 3]
    seen = sorted(r["id"] for p in parts for r in p.take_all())
    assert len(seen) == 9 and len(set(seen)) == 9


def test_local_shuffle_mixes_across_blocks(ray_cluster):
    # rows must mix across block boundaries with a big buffer
    ds = rd.range(64, override_num_blocks=8)  # blocks of 8
    batches = list(ds.iter_batches(batch_size=16, batch_format="numpy",
                                   local_shuffle_buffer_size=64,
                                   local_shuffle_seed=0))
    ids = np.concatenate([b["id"] for b in batches])
    assert sorted(ids.tolist()) == list(range(64))
    crossing = sum(1 for b in batches
                   if len({int(i) // 8 for i in b["id"]}) > 1)
    assert crossing > 0  # at least one batch spans source blocks


def test_iter_jax_batches_dtypes(ray_cluster):
    import torch

    ds = rd.range(16, override_num_blocks=1)
    batches = list(ds.iter_jax_batches(batch_size=8, device="cpu",
                                       dtypes={"id": torch.bfloat16}))
    assert batches[0]["id"].dtype == torch.bfloat16
    # a numpy dtype is cast by numpy on the host, as the reference's astype
    batches = list(ds.iter_jax_batches(batch_size=8, device="cpu",
                                       dtypes={"id": np.float32}))
    assert batches[0]["id"].dtype == torch.float32
    assert batches[1]["id"].tolist() == [float(i) for i in range(8, 16)]


def test_diamond_dag_consistent(ray_cluster):
    # a shared shuffled subtree must execute once: zip(ds, ds.map) pairs rows
    base = rd.range(32, override_num_blocks=4).random_shuffle()
    left = base
    right = base.map(lambda r: {"id2": r["id"] * 10})
    rows = left.zip(right).take_all()
    assert all(r["id"] * 10 == r["id2"] for r in rows)


def test_map_batches_resources_reach_scheduler(ray_cluster, monkeypatch):
    # per-op resource demands must reach the task submission options
    from ray_tpu_torch.data.execution import (MapOperator, StreamingExecutor,
                                              plan)

    ds = rd.range(4, override_num_blocks=1).map_batches(
        lambda b: b, num_gpus=1)
    _, ops = plan(ds._dag)
    mops = [o for o in ops if isinstance(o, MapOperator)]
    assert mops and mops[0]._resources == {"GPU": 1}

    # and _submit merges them over the context defaults
    seen = {}

    class _FakeRemote:
        def options(self, **kw):
            seen.update(kw)
            return self

        def remote(self, *a):
            return "ref"

    import ray_tpu_torch.data.execution as ex

    se = StreamingExecutor.__new__(StreamingExecutor)
    se.ctx = type("Ctx", (), {"task_resources": {"host": 1}})()
    monkeypatch.setattr(ex.ray_tpu_torch, "remote", lambda fn: _FakeRemote())
    se._submit(lambda: None, (), resources={"GPU": 1})
    assert seen["resources"] == {"host": 1, "GPU": 1}


def test_iter_torch_batches(ray_cluster):
    import torch

    from ray_tpu_torch import data as rd

    ds = rd.range(100)
    seen = 0
    for b in ds.iter_torch_batches(batch_size=32):
        assert isinstance(b["id"], torch.Tensor)
        seen += b["id"].shape[0]
    assert seen == 100
    # dtype casting
    b = next(iter(rd.range(8).iter_torch_batches(
        batch_size=8, dtypes={"id": torch.float32})))
    assert b["id"].dtype == torch.float32


def test_zip_pairs_despite_out_of_order_completion(ray_cluster):
    """Tasks finish out of order under load; zip must align rows by
    logical block order, not arrival order (regression: full-suite flake
    where id 5-9 paired with other 100-104)."""
    import time as _t

    a = rd.range(10, override_num_blocks=2)

    def slow_first(batch):
        if 0 in list(batch["id"]):
            _t.sleep(1.5)  # first block completes last
        return {"other": batch["id"] + 100}

    b = rd.range(10, override_num_blocks=2).map_batches(slow_first)
    rows = sorted(a.zip(b).take_all(), key=lambda r: r["id"])
    assert len(rows) == 10
    assert [r["other"] for r in rows] == [100 + i for i in range(10)]


def test_diamond_zip_out_of_order(ray_cluster):
    import time as _t

    base = rd.range(32, override_num_blocks=4).random_shuffle()

    def jitter(r):
        if r["id"] % 7 == 0:
            _t.sleep(0.05)
        return {"id2": r["id"] * 10}

    rows = base.zip(base.map(jitter)).take_all()
    assert len(rows) == 32
    assert all(r["id"] * 10 == r["id2"] for r in rows)


def test_repartition_zip_out_of_order(ray_cluster):
    """Repartition concatenates input parts in collect order; that must
    be logical order or a downstream zip pairs wrong rows."""
    import time as _t

    def jittered(batch):
        if 0 in list(batch["id"]):
            _t.sleep(1.0)  # first block collected last
        return batch

    a = rd.range(20, override_num_blocks=4).map_batches(
        jittered).repartition(2)
    b = rd.range(20, override_num_blocks=2).map_batches(
        lambda x: {"other": x["id"] + 500})
    rows = sorted(a.zip(b).take_all(), key=lambda r: r["id"])
    assert len(rows) == 20
    assert [r["other"] for r in rows] == [500 + i for i in range(20)]


def test_take_order_with_straggler_block(ray_cluster):
    """take/iter are in DATASET order even when block 0 finishes LAST
    (regression: limit used to keep the first-completed rows, so a busy
    scheduler returned rows 50-54 for take(5))."""
    import time as _t

    ds = rd.range(80, override_num_blocks=4).map(
        lambda row: (_t.sleep(0.4 if row["id"] == 0 else 0.0), row)[1])
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    ds2 = rd.range(80, override_num_blocks=4).map(
        lambda row: (_t.sleep(0.4 if row["id"] == 0 else 0.0), row)[1])
    assert [r["id"] for r in ds2.take_all()] == list(range(80))
