"""Extended Data IO / conversion surface (reference: read_api.py +
dataset.py — tfrecords, sql, images, refs-based constructors, torch/tf
interop, split helpers).

The port's mirror of tests/test_data_io_ext.py, case by case, on one
cluster of the port's runtime for the module.
"""

import os
import sqlite3

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


def test_tfrecords_roundtrip(ray_cluster, tmp_path):
    ds = rd.range(30, override_num_blocks=2).map(
        lambda r: {"id": r["id"], "x": float(r["id"]) * 0.5,
                   "name": f"row{r['id']}".encode()})
    files = ds.write_tfrecords(str(tmp_path / "tfr"))
    assert files and all(f.endswith(".tfrecords") for f in files)
    back = rd.read_tfrecords(str(tmp_path / "tfr"))
    rows = sorted(back.take_all(), key=lambda r: r["id"])
    assert len(rows) == 30
    assert rows[3]["id"] == 3
    assert abs(rows[3]["x"] - 1.5) < 1e-6
    assert bytes(rows[3]["name"]) == b"row3"


def test_tfrecords_tf_cross_read(ray_cluster, tmp_path):
    tf = pytest.importorskip("tensorflow")
    ds = rd.from_items([{"a": 1}, {"a": 2}])
    files = ds.write_tfrecords(str(tmp_path / "tfr2"))
    n = sum(1 for _ in tf.data.TFRecordDataset(files))
    assert n == 2


def test_read_sql(ray_cluster, tmp_path):
    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)",
                     [(i, f"n{i}") for i in range(10)])
    conn.commit()
    conn.close()
    ds = rd.read_sql("SELECT * FROM t ORDER BY id",
                     lambda: sqlite3.connect(db))
    rows = ds.take_all()
    assert [r["id"] for r in rows] == list(range(10))
    assert rows[4]["name"] == "n4"


def test_read_images(ray_cluster, tmp_path):
    from PIL import Image

    for i in range(3):
        Image.new("RGB", (8, 6), color=(i * 10, 0, 0)).save(
            str(tmp_path / f"im{i}.png"))
    ds = rd.read_images(str(tmp_path), include_paths=True)
    rows = ds.take_all()
    assert len(rows) == 3
    assert np.asarray(rows[0]["image"]).shape == (6, 8, 3)
    assert any("im1.png" in str(r["path"]) for r in rows)


def test_from_refs_constructors(ray_cluster):
    import pyarrow as pa

    t = pa.table({"a": [1, 2, 3]})
    ds = rd.from_arrow_refs([ray_tpu_torch.put(t)])
    assert [r["a"] for r in ds.take_all()] == [1, 2, 3]

    import pandas as pd

    df = pd.DataFrame({"b": [4, 5]})
    ds2 = rd.from_pandas_refs([ray_tpu_torch.put(df)])
    assert [r["b"] for r in ds2.take_all()] == [4, 5]

    ds3 = rd.from_numpy_refs([ray_tpu_torch.put(np.arange(4))])
    assert [r["data"] for r in ds3.take_all()] == [0, 1, 2, 3]


def test_to_refs_conversions(ray_cluster):
    ds = rd.range(10, override_num_blocks=2)
    dfs = ray_tpu_torch.get(ds.to_pandas_refs(), timeout=120)
    assert sum(len(d) for d in dfs) == 10
    nps = ray_tpu_torch.get(ds.to_numpy_refs(), timeout=120)
    assert sum(len(d["id"]) for d in nps) == 10
    tables = ray_tpu_torch.get(ds.to_arrow_refs(), timeout=120)
    assert sum(t.num_rows for t in tables) == 10


def test_take_batch_and_splits(ray_cluster):
    ds = rd.range(100, override_num_blocks=4)
    b = ds.take_batch(7, batch_format="numpy")
    assert b["id"].tolist() == list(range(7))

    train, test = ds.train_test_split(0.2)
    assert train.count() == 80 and test.count() == 20
    assert [r["id"] for r in test.take_all()] == list(range(80, 100))

    parts = ds.split_proportionately([0.1, 0.3])
    assert [p.count() for p in parts] == [10, 30, 60]

    assert ds.size_bytes() > 0
    shuffled = ds.randomize_block_order(seed=5)
    assert shuffled.count() == 100


def test_from_torch_and_to_torch(ray_cluster):
    torch = pytest.importorskip("torch")

    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return i * i

    ds = rd.from_torch(DS())
    assert sorted(r["item"] for r in ds.take_all()) == [0, 1, 4, 9, 16, 25]

    ds2 = rd.range(8).map(lambda r: {"x": float(r["id"]), "y": r["id"] % 2})
    it = ds2.to_torch(label_column="y", batch_size=4)
    batches = list(it)
    assert len(batches) == 2
    feats, label = batches[0]
    assert feats.shape[0] == 4 and label.shape[0] == 4


def test_from_tf_and_to_tf(ray_cluster):
    tf = pytest.importorskip("tensorflow")
    src = tf.data.Dataset.from_tensor_slices({"a": [1, 2, 3]})
    ds = rd.from_tf(src)
    assert sorted(r["a"] for r in ds.take_all()) == [1, 2, 3]

    ds2 = rd.range(8).map(lambda r: {"x": float(r["id"]), "y": r["id"] % 2})
    tfds = ds2.to_tf("x", "y", batch_size=4)
    got = list(tfds.as_numpy_iterator())
    assert len(got) == 2
    assert got[0][0].shape == (4,) and got[0][1].shape == (4,)


def test_gated_connectors_raise(ray_cluster):
    # read_bigquery/read_mongo are implemented now (test_data_external);
    # only the still-gated connectors raise at call time
    with pytest.raises(ImportError):
        rd.read_lance("uri")
    with pytest.raises(ImportError):
        rd.from_spark(None)


def test_dataset_iterator(ray_cluster):
    it = rd.range(30, override_num_blocks=3).iterator()
    rows = [r["id"] for r in it.iter_rows()]
    assert rows == list(range(30))
    batches = list(it.iter_batches(batch_size=10, batch_format="numpy"))
    assert len(batches) == 3 and batches[0]["id"].tolist() == list(range(10))


def test_streaming_split_disjoint_union(ray_cluster):
    ds = rd.range(60, override_num_blocks=6)
    its = ds.streaming_split(2)

    @ray_tpu_torch.remote
    def consume(it):
        return [r["id"] for r in it.iter_rows()]

    a, b = ray_tpu_torch.get(
        [consume.remote(its[0]), consume.remote(its[1])], timeout=300)
    assert len(a) + len(b) == 60
    assert sorted(a + b) == list(range(60))
    assert not (set(a) & set(b))


def test_streaming_split_equal(ray_cluster):
    ds = rd.range(45, override_num_blocks=5)
    its = ds.streaming_split(3, equal=True)

    @ray_tpu_torch.remote
    def count_rows(it):
        return sum(1 for _ in it.iter_rows())

    counts = ray_tpu_torch.get([count_rows.remote(i) for i in its],
                               timeout=300)
    assert counts == [15, 15, 15]


def test_streaming_split_multi_epoch(ray_cluster):
    """Re-iterating a shard is a new epoch: the stream re-executes after
    every split finished (regression: epoch 2 used to yield 0 rows)."""
    ds = rd.range(24, override_num_blocks=4)
    its = ds.streaming_split(2, equal=True)

    @ray_tpu_torch.remote
    def epochs(it, n):
        return [sum(1 for _ in it.iter_rows()) for _ in range(n)]

    a, b = ray_tpu_torch.get(
        [epochs.remote(its[0], 3), epochs.remote(its[1], 3)], timeout=300)
    assert a == [12, 12, 12]
    assert b == [12, 12, 12]
