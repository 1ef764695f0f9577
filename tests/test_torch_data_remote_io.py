"""Remote (fsspec) file IO for ray_tpu_torch.data (reference:
python/ray/data/datasource/file_based_datasource.py:65 — every dataset
path resolves through a filesystem abstraction so s3://, gs:// work from
any worker; read_api.py:598 read_parquet(filesystem=...)).

Routed through the registered `mock-remote://` scheme: every byte crosses
the fsspec AbstractFileSystem API (the exact path a real remote scheme
takes) while persisting under a tmp dir the test inspects out-of-band.
This is the multi-host path — hosts of a cluster share no local disk, so
the remote fs is the only place all workers can reach the same data.

The port's mirror of tests/test_data_remote_io.py, case by case, on one
cluster of the port's runtime for the module.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch._private import fileio


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _uri(tmp_path, *parts):
    return "mock-remote://" + str(tmp_path.joinpath(*parts))


def _seed_parquet(tmp_path, n_files=3, rows_per=10):
    """Write parquet shards through fsspec only (no local os calls)."""
    root = _uri(tmp_path, "bucket", "ds")
    fs, p = fileio.fs_for(root)
    fs.makedirs(p, exist_ok=True)
    total = 0
    for i in range(n_files):
        t = pa.table({"x": list(range(total, total + rows_per)),
                      "shard": [i] * rows_per})
        with fileio.open_file(f"{root}/part-{i}.parquet", "wb") as f:
            pq.write_table(t, f)
        total += rows_per
    return root, total


# ---------------------------------------------------------------------------
# path expansion
# ---------------------------------------------------------------------------

def test_expand_paths_remote_dir_and_glob(tmp_path):
    root, _ = _seed_parquet(tmp_path, n_files=3)
    got = fileio.expand_paths(root)
    assert len(got) == 3
    assert all(p.startswith("mock-remote://") for p in got)
    assert [os.path.basename(p) for p in got] == \
        ["part-0.parquet", "part-1.parquet", "part-2.parquet"]
    got_glob = fileio.expand_paths(root + "/part-*.parquet")
    assert got_glob == got
    single = fileio.expand_paths(root + "/part-1.parquet")
    assert len(single) == 1 and single[0].endswith("part-1.parquet")


def test_expand_paths_remote_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        fileio.expand_paths(_uri(tmp_path, "nope") + "/*.parquet")


# ---------------------------------------------------------------------------
# plan-time metadata (parquet footer)
# ---------------------------------------------------------------------------

def test_parquet_plan_metadata_exact_rows(tmp_path):
    root, total = _seed_parquet(tmp_path, n_files=4, rows_per=7)
    ds = rd.ParquetDatasource(root)
    tasks = ds.get_read_tasks(2)
    assert sum(t.metadata.num_rows for t in tasks) == total
    assert all(t.metadata.schema is not None for t in tasks)
    assert all(t.metadata.exec_stats.get("rows_exact") for t in tasks)
    assert all(t.metadata.size_bytes > 0 for t in tasks)


def test_parquet_plan_metadata_extrapolates_past_sample(tmp_path):
    """Beyond the footer-read sample cap, rows AND bytes extrapolate from
    the sampled means (no per-file IO for huge file lists)."""
    n = rd.ParquetDatasource._PLAN_META_SAMPLE + 8
    root, total = _seed_parquet(tmp_path, n_files=n, rows_per=5)
    tasks = rd.ParquetDatasource(root).get_read_tasks(4)
    assert sum(t.metadata.num_rows for t in tasks) == total  # uniform files
    assert all(t.metadata.size_bytes > 0 for t in tasks)
    assert all(t.metadata.schema is not None for t in tasks)
    assert not all(t.metadata.exec_stats.get("rows_exact") for t in tasks)


def test_count_fast_path_from_parquet_footers(ray_cluster, tmp_path):
    """ds.count() on a bare parquet read answers from footers without
    executing read tasks (reference: Dataset.count's metadata shortcut);
    transforms disable the shortcut."""
    root, total = _seed_parquet(tmp_path, n_files=3, rows_per=9)
    ds = rd.read_parquet(root)
    assert ds.count() == total
    assert ds._dag.datasource.plan_row_count() == total
    # a transform means executing (filter changes the count)
    assert ds.filter(lambda r: r["x"] % 2 == 0).count() == \
        sum(1 for i in range(total) if i % 2 == 0)
    # range/items know their counts too
    assert rd.range(123).count() == 123
    assert rd.from_items([{"a": 1}] * 7).count() == 7


def test_csv_plan_metadata_falls_back_to_bytes(tmp_path):
    root = _uri(tmp_path, "csvs")
    fs, p = fileio.fs_for(root)
    fs.makedirs(p, exist_ok=True)
    with fileio.open_file(root + "/a.csv", "wb") as f:
        f.write(b"x,y\n1,2\n3,4\n")
    tasks = rd.CSVDatasource(root).get_read_tasks(1)
    assert tasks[0].metadata.num_rows == 0         # unknown at plan time
    assert tasks[0].metadata.size_bytes > 0        # byte estimate present


# ---------------------------------------------------------------------------
# e2e reads/writes over the remote scheme
# ---------------------------------------------------------------------------

def test_read_parquet_remote_e2e(ray_cluster, tmp_path):
    root, total = _seed_parquet(tmp_path, n_files=3, rows_per=10)
    ds = rd.read_parquet(root)
    rows = ds.take_all()
    assert len(rows) == total
    assert sorted(r["x"] for r in rows) == list(range(total))


def test_read_parquet_remote_sharded_map_workers(ray_cluster, tmp_path):
    """Pod-realistic: N read tasks + map workers, each pulling its own
    shard straight off the remote fs — no shared local path anywhere in
    the dataflow (each access re-resolves the fs from the URI scheme on
    the worker)."""
    root, total = _seed_parquet(tmp_path, n_files=4, rows_per=8)
    ds = rd.read_parquet(root, override_num_blocks=4)
    out = ds.map_batches(lambda b: {"x2": b["x"] * 2}).take_all()
    assert sorted(r["x2"] for r in out) == [2 * i for i in range(total)]


def test_write_parquet_remote_and_read_back(ray_cluster, tmp_path):
    dest = _uri(tmp_path, "out", "written")
    ds = rd.range(50, override_num_blocks=4)
    files = ds.write_parquet(dest)
    assert files and all(f.startswith("mock-remote://") for f in files)
    # bytes really landed (inspect the backing dir out-of-band)
    backing = tmp_path / "out" / "written"
    assert sorted(os.listdir(backing)) == sorted(
        os.path.basename(f) for f in files)
    back = rd.read_parquet(dest).take_all()
    assert sorted(r["id"] for r in back) == list(range(50))


def test_write_json_and_csv_remote(ray_cluster, tmp_path):
    for fmt, writer, reader in [
            ("json", "write_json", rd.read_json),
            ("csv", "write_csv", rd.read_csv)]:
        dest = _uri(tmp_path, "out", fmt)
        ds = rd.range(20, override_num_blocks=2)
        files = getattr(ds, writer)(dest)
        assert files
        back = reader(dest).take_all()
        assert sorted(r["id"] for r in back) == list(range(20)), fmt


def test_read_text_and_binary_remote(ray_cluster, tmp_path):
    root = _uri(tmp_path, "txt")
    fs, p = fileio.fs_for(root)
    fs.makedirs(p, exist_ok=True)
    with fileio.open_file(root + "/a.txt", "wb") as f:
        f.write(b"alpha\nbeta\n\ngamma\n")
    assert [r["text"] for r in rd.read_text(root).take_all()] == \
        ["alpha", "beta", "gamma"]
    got = rd.read_binary_files(root, include_paths=True).take_all()
    assert got[0]["bytes"] == b"alpha\nbeta\n\ngamma\n"
    assert got[0]["path"].startswith("mock-remote://")


def test_read_numpy_remote(ray_cluster, tmp_path):
    root = _uri(tmp_path, "npys")
    arr = np.arange(12).reshape(3, 4)
    with fileio.open_file(root + "/a.npy", "wb") as f:
        np.save(f, arr)
    rows = rd.read_numpy(root).take_all()
    np.testing.assert_array_equal(
        np.stack([r["data"] for r in rows]), arr)
