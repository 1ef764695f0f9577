"""WebDataset tar shards: read_webdataset / write_webdataset.

Reference surface: python/ray/data/read_api.py:1840 read_webdataset and
_internal/datasource/webdataset_datasource.py / webdataset_datasink.py
(which wrap the webdataset library; here the tar format is read and
written directly — a sample is the run of consecutive members sharing a
basename up to its first dot).

The port's mirror of tests/test_data_webdataset.py, case by case, on one
cluster of the port's runtime for the module.
"""
import io
import json
import tarfile

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.datasource import _wds_decode_field, _wds_encode_field

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _make_shard(path, samples):
    with tarfile.open(path, "w") as tf:
        for key, fields in samples:
            for ext, payload in fields.items():
                info = tarfile.TarInfo(name=f"{key}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))


SAMPLES = [
    ("s000", {"txt": b"hello", "cls": b"3",
              "json": json.dumps({"a": 1}).encode()}),
    ("s001", {"txt": b"world", "cls": b"7",
              "json": json.dumps({"a": 2}).encode()}),
]


def test_default_decoder_types(ray_cluster, tmp_path):
    _make_shard(tmp_path / "a.tar", SAMPLES)
    rows = sorted(rd.read_webdataset(str(tmp_path / "a.tar")).take_all(),
                  key=lambda r: r["__key__"])
    assert rows[0]["__key__"] == "s000"
    assert rows[0]["txt"] == "hello" and rows[0]["cls"] == 3
    assert rows[0]["json"] == {"a": 1}
    assert rows[1]["cls"] == 7


def test_raw_bytes_and_include_paths(ray_cluster, tmp_path):
    _make_shard(tmp_path / "a.tar", SAMPLES)
    rows = rd.read_webdataset(str(tmp_path / "a.tar"), decoder=False,
                              include_paths=True).take_all()
    assert rows[0]["txt"] == b"hello"
    assert rows[0]["__url__"].endswith("a.tar")


def test_fileselect_and_filerename(ray_cluster, tmp_path):
    _make_shard(tmp_path / "a.tar", SAMPLES)
    # rename applies BEFORE both selection and decoding (reference order:
    # the tar expander renames, then the sample decoder sees the new ext)
    rows = rd.read_webdataset(str(tmp_path / "a.tar"),
                              fileselect=["txt", "id"],
                              filerename=[("cls", "id")]).take_all()
    assert set(rows[0]) == {"__key__", "txt", "id"}
    assert rows[0]["id"] == 3


def test_callable_decoder_gets_raw_sample(ray_cluster, tmp_path):
    _make_shard(tmp_path / "a.tar", SAMPLES)
    rows = rd.read_webdataset(
        str(tmp_path / "a.tar"),
        decoder=lambda s: {"k": s["__key__"], "n": len(s["txt"])}).take_all()
    assert sorted(r["n"] for r in rows) == [5, 5]


def test_npy_field_roundtrip():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    blob = _wds_encode_field("npy", arr)
    back = _wds_decode_field("npy", blob, True)
    np.testing.assert_array_equal(back, arr)


def test_write_then_read_roundtrip(ray_cluster, tmp_path):
    items = [{"__key__": f"k{i:03d}", "txt": f"t{i}", "cls": i,
              "json": {"i": i}} for i in range(20)]
    files = rd.from_items(items, override_num_blocks=2).write_webdataset(
        str(tmp_path / "out"))
    assert files and all(f.endswith(".tar") for f in files)
    back = sorted(rd.read_webdataset(str(tmp_path / "out")).take_all(),
                  key=lambda r: r["__key__"])
    assert len(back) == 20
    assert back[5]["txt"] == "t5" and back[5]["cls"] == 5
    assert back[5]["json"] == {"i": 5}


def test_webdataset_over_remote_fs(ray_cluster, tmp_path):
    dest = "mock-remote://" + str(tmp_path / "remote_wds")
    rd.from_items([{"__key__": f"r{i}", "txt": f"v{i}"}
                   for i in range(8)]).write_webdataset(dest)
    back = rd.read_webdataset(dest).take_all()
    assert sorted(r["txt"] for r in back) == [f"v{i}" for i in range(8)]


def test_filtered_members_still_delimit_samples(ray_cluster, tmp_path):
    """A member dropped by fileselect still marks the sample boundary —
    two same-key runs separated only by filtered members must NOT merge
    (regression: the filter ran before the key-change check)."""
    _make_shard(tmp_path / "a.tar", [
        ("a", {"txt": b"one"}), ("b", {"json": b"{}"}),
        ("a", {"txt": b"two"})])
    rows = rd.read_webdataset(str(tmp_path / "a.tar"),
                              fileselect=["txt"]).take_all()
    assert sorted(r["txt"] for r in rows) == ["one", "two"]


def test_decoder_list_sees_raw_bytes_like_single_callable(ray_cluster,
                                                          tmp_path):
    _make_shard(tmp_path / "a.tar", SAMPLES)
    fn = lambda s: {"n": len(s["txt"])}          # expects bytes  # noqa: E731
    single = rd.read_webdataset(str(tmp_path / "a.tar"),
                                decoder=fn).take_all()
    chained = rd.read_webdataset(str(tmp_path / "a.tar"),
                                 decoder=[fn]).take_all()
    assert sorted(r["n"] for r in single) == sorted(r["n"] for r in chained)


def test_write_numpy_scalar_columns(ray_cluster, tmp_path):
    """Arrow blocks yield numpy scalars (np.float32/np.bool_); the
    default encoder must accept them (regression: json.dumps TypeError)."""
    items = [{"__key__": f"k{i}", "score": float(i) / 2, "flag": i % 2 == 0,
              "cls": i} for i in range(4)]
    rd.from_items(items).write_webdataset(str(tmp_path / "out"))
    back = sorted(rd.read_webdataset(str(tmp_path / "out")).take_all(),
                  key=lambda r: r["__key__"])
    assert back[1]["cls"] == 1
    assert float(back[1]["score"]) == 0.5


def test_directory_prefix_keeps_samples_distinct(ray_cluster, tmp_path):
    """Subdirectory members reusing a basename are distinct samples —
    the key keeps the dir prefix (reference base_plus_ext semantics)."""
    _make_shard(tmp_path / "a.tar", [
        ("cat/001", {"txt": b"meow", "cls": b"0"}),
        ("dog/001", {"txt": b"woof", "cls": b"1"})])
    rows = sorted(rd.read_webdataset(str(tmp_path / "a.tar")).take_all(),
                  key=lambda r: r["__key__"])
    assert [r["__key__"] for r in rows] == ["cat/001", "dog/001"]
    assert rows[0]["txt"] == "meow" and rows[1]["cls"] == 1


def test_suffix_filter_matches_compound_extensions(ray_cluster, tmp_path):
    _make_shard(tmp_path / "a.tar", [
        ("x", {"seg.npy": _wds_encode_field("npy", np.ones((2,))),
               "txt": b"t"})])
    rows = rd.read_webdataset(str(tmp_path / "a.tar"),
                              suffixes=["npy"]).take_all()
    assert set(rows[0]) == {"__key__", "seg.npy"}
    np.testing.assert_array_equal(rows[0]["seg.npy"], np.ones((2,)))


def test_consecutive_key_grouping(ray_cluster, tmp_path):
    # a key reappearing NON-consecutively is a distinct sample (webdataset
    # semantics: grouping is over consecutive members only)
    _make_shard(tmp_path / "a.tar", [
        ("x", {"txt": b"one"}), ("y", {"txt": b"two"}),
        ("x", {"cls": b"5"})])
    rows = rd.read_webdataset(str(tmp_path / "a.tar")).take_all()
    assert len(rows) == 3
