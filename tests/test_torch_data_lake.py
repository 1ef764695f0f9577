"""Lakehouse table IO: Delta Lake + Iceberg readers (ray_tpu_torch/data/lake.py).

Reference surface: python/ray/data/read_api.py read_delta_sharing_tables /
read_iceberg.  Tables here are hand-crafted byte-for-byte to the open
specs (Delta PROTOCOL.md commits/checkpoints; Iceberg metadata.json ->
manifest-list avro -> manifest avro), so the readers are proven against
the formats themselves, not against our own writer only.

The port's mirror of tests/test_data_lake.py, case by case, on one
cluster of the port's runtime for the module.
"""

import json
import os
import uuid

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data import _avro
from ray_tpu_torch.data.lake import DeltaDatasource, IcebergDatasource


# ---------------------------------------------------------------------------
# Delta helpers: hand-written log
# ---------------------------------------------------------------------------

_SCHEMA_STR = json.dumps({"type": "struct", "fields": [
    {"name": "x", "type": "long", "nullable": True, "metadata": {}},
    {"name": "part", "type": "integer", "nullable": True, "metadata": {}},
]})


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _meta_action(partition_cols=()):
    return {"metaData": {
        "id": uuid.uuid4().hex,
        "format": {"provider": "parquet", "options": {}},
        "schemaString": _SCHEMA_STR,
        "partitionColumns": list(partition_cols), "configuration": {}}}


def _write_part(table, name, xs, with_part_col=None):
    cols = {"x": xs}
    if with_part_col is not None:
        cols["part"] = [with_part_col] * len(xs)
    path = os.path.join(table, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table(cols), path)
    return {"path": name, "partitionValues": {}, "size": os.path.getsize(path),
            "dataChange": True, "stats": json.dumps({"numRecords": len(xs)})}


def _commit(table, version, actions):
    log = os.path.join(table, "_delta_log")
    os.makedirs(log, exist_ok=True)
    with open(os.path.join(log, f"{version:020d}.json"), "w") as f:
        f.write("\n".join(json.dumps(a) for a in actions))


def _mk_delta(tmp_path):
    """v0: protocol+meta+a.parquet{0..4}, b.parquet{5..9};
    v1: remove b, add c.parquet{10..12}."""
    table = str(tmp_path / "tbl")
    a = _write_part(table, "a.parquet", list(range(5)), 0)
    b = _write_part(table, "b.parquet", list(range(5, 10)), 0)
    _commit(table, 0, [{"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}},
                       _meta_action(), {"add": a}, {"add": b}])
    c = _write_part(table, "c.parquet", list(range(10, 13)), 1)
    _commit(table, 1, [{"remove": {"path": "b.parquet",
                                   "deletionTimestamp": 1, "dataChange": True}},
                       {"add": c}])
    return table


def test_delta_read_latest_and_time_travel(ray_cluster, tmp_path):
    table = _mk_delta(tmp_path)
    ds = rd.read_delta(table)
    assert sorted(r["x"] for r in ds.take_all()) == \
        [0, 1, 2, 3, 4, 10, 11, 12]
    # stats numRecords -> exact plan-time count (no data read)
    assert DeltaDatasource(table).plan_row_count() == 8
    assert rd.read_delta(table).count() == 8
    v0 = rd.read_delta(table, version=0)
    assert sorted(r["x"] for r in v0.take_all()) == list(range(10))
    with pytest.raises(ValueError):
        rd.read_delta(table, version=9)


def test_delta_partition_column_graft(ray_cluster, tmp_path):
    """Partition values live in the log, not the files, and must come
    back as typed columns (Delta PROTOCOL.md: partitionValues)."""
    table = str(tmp_path / "ptbl")
    add = _write_part(table, "p=7/d.parquet", [1, 2, 3])  # no part col inside
    add["partitionValues"] = {"part": "7"}
    _commit(table, 0, [{"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}},
                       _meta_action(partition_cols=["part"]), {"add": add}])
    rows = rd.read_delta(table).take_all()
    assert [r["part"] for r in rows] == [7, 7, 7]   # cast via schemaString
    assert sorted(r["x"] for r in rows) == [1, 2, 3]


def test_delta_checkpoint_seeds_replay(ray_cluster, tmp_path):
    """State at the checkpoint version must come from the checkpoint
    parquet alone: the early JSON commits are deleted after
    checkpointing, as VACUUM-ed production tables really look."""
    table = _mk_delta(tmp_path)
    snap = DeltaDatasource(table)._snap
    # checkpoint at version 1: one row per live file + metaData + protocol
    rows = [{"add": {"path": p, "partitionValues": [],
                     "size": a["size"], "stats": a["stats"],
                     "dataChange": False}, "remove": None,
             "metaData": None, "protocol": None}
            for p, a in snap["files"].items()]
    rows.append({"add": None, "remove": None, "protocol": None,
                 "metaData": {"id": "m", "schemaString": _SCHEMA_STR,
                              "partitionColumns": []}})
    rows.append({"add": None, "remove": None, "metaData": None,
                 "protocol": {"minReaderVersion": 1}})
    # partitionValues as a pyarrow map type, as Spark writes checkpoints
    t = pa.Table.from_pylist(rows, schema=pa.schema([
        ("add", pa.struct([("path", pa.string()),
                           ("partitionValues",
                            pa.map_(pa.string(), pa.string())),
                           ("size", pa.int64()), ("stats", pa.string()),
                           ("dataChange", pa.bool_())])),
        ("remove", pa.struct([("path", pa.string())])),
        ("metaData", pa.struct([("id", pa.string()),
                                ("schemaString", pa.string()),
                                ("partitionColumns",
                                 pa.list_(pa.string()))])),
        ("protocol", pa.struct([("minReaderVersion", pa.int32())])),
    ]))
    log = os.path.join(table, "_delta_log")
    pq.write_table(t, os.path.join(log, f"{1:020d}.checkpoint.parquet"))
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        json.dump({"version": 1, "size": len(rows)}, f)
    os.remove(os.path.join(log, f"{0:020d}.json"))
    os.remove(os.path.join(log, f"{1:020d}.json"))
    # a post-checkpoint commit on top
    d = _write_part(table, "d.parquet", [99])
    _commit(table, 2, [{"add": d}])
    assert sorted(r["x"] for r in rd.read_delta(table).take_all()) == \
        [0, 1, 2, 3, 4, 10, 11, 12, 99]
    # time travel to the checkpoint version itself
    assert rd.read_delta(table, version=1).count() == 8


def test_delta_deletion_vectors_rejected(ray_cluster, tmp_path):
    table = str(tmp_path / "dv")
    add = _write_part(table, "a.parquet", [1])
    add["deletionVector"] = {"storageType": "u", "pathOrInlineDv": "x"}
    _commit(table, 0, [{"protocol": {"minReaderVersion": 3,
                                     "readerFeatures": ["deletionVectors"]},
                        "metaData": None},
                       _meta_action(), {"add": add}])
    with pytest.raises(NotImplementedError):
        rd.read_delta(table)


def test_delta_unhonored_reader_features_rejected(ray_cluster, tmp_path):
    """columnMapping/v2Checkpoint change on-disk semantics this reader
    does not implement — reading anyway would return wrong data, so the
    protocol gate must refuse."""
    for feat in ("columnMapping", "v2Checkpoint"):
        table = str(tmp_path / feat)
        add = _write_part(table, "a.parquet", [1])
        _commit(table, 0, [{"protocol": {"minReaderVersion": 3,
                                         "readerFeatures": [feat]}},
                           _meta_action(), {"add": add}])
        with pytest.raises(NotImplementedError):
            rd.read_delta(table)


def test_delta_concurrent_commit_loses_cleanly(ray_cluster, tmp_path,
                                               monkeypatch):
    """Two writers race to the same version: the loser must get a
    RuntimeError from the O_EXCL create, never silently overwrite the
    winner's commit (the TOCTOU the exists()-check alone would have)."""
    from ray_tpu_torch.data import lake

    table = str(tmp_path / "race")
    rd.from_items([{"x": 1}]).write_delta(table)
    _write_part(table, "z.parquet", [2])
    # freeze this writer's snapshot at version 0, then land the rival's
    # commit for version 1 inside the window
    real = lake._delta_snapshot
    monkeypatch.setattr(lake, "_delta_snapshot",
                        lambda t, v: dict(real(t, v), version=0))
    os.link(os.path.join(table, "_delta_log", f"{0:020d}.json"),
            os.path.join(table, "_delta_log", f"{1:020d}.json"))
    before = open(os.path.join(table, "_delta_log",
                               f"{1:020d}.json")).read()
    with pytest.raises(RuntimeError, match="concurrent"):
        lake.commit_delta_write(table, [os.path.join(table, "z.parquet")])
    after = open(os.path.join(table, "_delta_log",
                              f"{1:020d}.json")).read()
    assert after == before                  # winner's commit untouched


def test_delta_write_read_roundtrip(ray_cluster, tmp_path):
    table = str(tmp_path / "w")
    v = rd.from_items([{"x": i, "part": 0} for i in range(20)]) \
        .write_delta(table)
    assert v == 0
    assert sorted(r["x"] for r in rd.read_delta(table).take_all()) == \
        list(range(20))
    # append = new version, union of rows
    v = rd.from_items([{"x": 100, "part": 1}]).write_delta(table)
    assert v == 1
    assert rd.read_delta(table).count() == 21
    assert rd.read_delta(table, version=0).count() == 20
    # overwrite replaces the snapshot but keeps history readable
    v = rd.from_items([{"x": -1, "part": 2}]).write_delta(
        table, mode="overwrite")
    assert v == 2
    assert [r["x"] for r in rd.read_delta(table).take_all()] == [-1]
    assert rd.read_delta(table, version=1).count() == 21


def test_delta_column_projection_with_partitions(ray_cluster, tmp_path):
    table = str(tmp_path / "proj")
    add = _write_part(table, "d.parquet", [1, 2, 3])
    add["partitionValues"] = {"part": "7"}
    _commit(table, 0, [{"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}},
                       _meta_action(partition_cols=["part"]), {"add": add}])
    rows = rd.read_delta(table, columns=["part", "x"]).take_all()
    assert all(set(r) == {"part", "x"} for r in rows)
    # partition-only projection must still yield one row per data row
    only_part = rd.read_delta(table, columns=["part"]).take_all()
    assert [r["part"] for r in only_part] == [7, 7, 7]


def test_delta_empty_create_rejected(ray_cluster, tmp_path):
    from ray_tpu_torch.data.lake import commit_delta_write

    table = str(tmp_path / "empty")
    # zero part files on a nonexistent table: no schema to create it from
    with pytest.raises(ValueError):
        commit_delta_write(table, [])
    # an all-filtered dataset still writes schema-carrying empty parts,
    # so the table IS created (Spark behaves the same way)
    rd.from_items([{"x": 1}]).filter(lambda r: False).write_delta(table)
    assert rd.read_delta(table).count() == 0


def test_delta_over_remote_fs(ray_cluster, tmp_path):
    """The pod-critical path: table root on the fsspec mock-remote
    scheme, no local os calls anywhere in the read."""
    table = "mock-remote://" + str(tmp_path / "r")
    rd.from_items([{"x": i, "part": 0} for i in range(7)]).write_delta(table)
    ds = rd.read_delta(table)
    assert ds.count() == 7
    assert sorted(r["x"] for r in ds.take_all()) == list(range(7))


# ---------------------------------------------------------------------------
# Iceberg: hand-crafted metadata/manifests per spec
# ---------------------------------------------------------------------------

_MANIFEST_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "snapshot_id", "type": ["null", "long"], "default": None},
        {"name": "data_file", "type": {
            "type": "record", "name": "r2", "fields": [
                {"name": "content", "type": "int"},
                {"name": "file_path", "type": "string"},
                {"name": "file_format", "type": "string"},
                {"name": "partition", "type": {
                    "type": "record", "name": "r102", "fields": [
                        {"name": "p", "type": ["null", "long"],
                         "default": None}]}},
                {"name": "record_count", "type": "long"},
                {"name": "file_size_in_bytes", "type": "long"},
            ]}},
    ]}

_MANIFEST_LIST_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "partition_spec_id", "type": "int"},
        {"name": "content", "type": "int"},
        {"name": "added_snapshot_id", "type": "long"},
        # named reference back to r102: exercises the writer/reader
        # named-type registry exactly where Iceberg schemas use it
        {"name": "partitions", "type": {
            "type": "array", "items": {
                "type": "record", "name": "r508", "fields": [
                    {"name": "contains_null", "type": "boolean"}]}}},
    ]}

# original location differs from where the test reads the table from —
# the reader must remap absolute manifest paths (warehouse moved/mounted
# elsewhere), which is how real object-store tables behave
_ORIG_LOC = "file:///warehouse/db/events"


def _mk_iceberg(tmp_path):
    table = str(tmp_path / "iceberg")
    meta_dir = os.path.join(table, "metadata")
    data_dir = os.path.join(table, "data")
    os.makedirs(meta_dir), os.makedirs(data_dir)

    def data_file(name, xs):
        p = os.path.join(data_dir, name)
        pq.write_table(pa.table({"x": xs, "p": [0] * len(xs)}), p)
        return {"content": 0, "file_path": f"{_ORIG_LOC}/data/{name}",
                "file_format": "PARQUET", "partition": {"p": 0},
                "record_count": len(xs),
                "file_size_in_bytes": os.path.getsize(p)}

    def manifest(name, entries):
        blob = _avro.write_container(entries, schema=_MANIFEST_SCHEMA)
        with open(os.path.join(meta_dir, name), "wb") as f:
            f.write(blob)
        return {"manifest_path": f"{_ORIG_LOC}/metadata/{name}",
                "manifest_length": len(blob), "partition_spec_id": 0,
                "content": 0, "added_snapshot_id": 1,
                "partitions": [{"contains_null": False}]}

    def manifest_list(name, manifests):
        blob = _avro.write_container(manifests,
                                     schema=_MANIFEST_LIST_SCHEMA)
        with open(os.path.join(meta_dir, name), "wb") as f:
            f.write(blob)
        return f"{_ORIG_LOC}/metadata/{name}"

    # snapshot 1: files a(3 rows) + b(2 rows)
    m1 = manifest("m1.avro", [
        {"status": 1, "snapshot_id": 1, "data_file": data_file(
            "a.parquet", [0, 1, 2])},
        {"status": 1, "snapshot_id": 1, "data_file": data_file(
            "b.parquet", [3, 4])},
    ])
    ml1 = manifest_list("snap-1.avro", [m1])
    # snapshot 2: b deleted (status=2), c added
    m2 = manifest("m2.avro", [
        {"status": 0, "snapshot_id": 1, "data_file": data_file(
            "a.parquet", [0, 1, 2])},
        {"status": 2, "snapshot_id": 2, "data_file": data_file(
            "b.parquet", [3, 4])},
        {"status": 1, "snapshot_id": 2, "data_file": data_file(
            "c.parquet", [5, 6, 7, 8])},
    ])
    ml2 = manifest_list("snap-2.avro", [m2])
    meta = {"format-version": 2, "table-uuid": str(uuid.uuid4()),
            "location": _ORIG_LOC, "current-snapshot-id": 2,
            "snapshots": [
                {"snapshot-id": 1, "manifest-list": ml1},
                {"snapshot-id": 2, "manifest-list": ml2}]}
    with open(os.path.join(meta_dir, "v2.metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(meta_dir, "version-hint.text"), "w") as f:
        f.write("2")
    # a stale v1 metadata file the version hint must win over
    with open(os.path.join(meta_dir, "v1.metadata.json"), "w") as f:
        json.dump(dict(meta, **{"current-snapshot-id": 1}), f)
    return table


def test_iceberg_read_current_snapshot(ray_cluster, tmp_path):
    table = _mk_iceberg(tmp_path)
    ds = rd.read_iceberg(table)
    assert sorted(r["x"] for r in ds.take_all()) == [0, 1, 2, 5, 6, 7, 8]
    # record_count -> exact plan-time count
    assert IcebergDatasource(table).plan_row_count() == 7
    assert rd.read_iceberg(table).count() == 7


def test_iceberg_snapshot_time_travel(ray_cluster, tmp_path):
    table = _mk_iceberg(tmp_path)
    ds = rd.read_iceberg(table, snapshot_id=1)
    assert sorted(r["x"] for r in ds.take_all()) == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        rd.read_iceberg(table, snapshot_id=77)


def test_iceberg_column_projection(ray_cluster, tmp_path):
    table = _mk_iceberg(tmp_path)
    rows = rd.read_iceberg(table, columns=["p"]).take_all()
    assert all(set(r) == {"p"} for r in rows) and len(rows) == 7


def test_iceberg_no_version_hint_falls_back_to_scan(ray_cluster, tmp_path):
    table = _mk_iceberg(tmp_path)
    os.remove(os.path.join(table, "metadata", "version-hint.text"))
    assert rd.read_iceberg(table).count() == 7   # picks max metadata seq


def test_iceberg_not_a_table(tmp_path):
    with pytest.raises(FileNotFoundError):
        rd.read_iceberg(str(tmp_path / "nope"))


def test_iceberg_field_id_rename_and_add(tmp_path):
    """Spec-correct column resolution: names resolve via field-id, so a
    rename still reads files written under the old name, and a column
    added after a file was written projects as nulls (not an error)."""
    table = str(tmp_path / "ice2")
    meta_dir, data_dir = table + "/metadata", table + "/data"
    os.makedirs(meta_dir), os.makedirs(data_dir)
    sch = pa.schema([
        pa.field("old_name", pa.int64(),
                 metadata={b"PARQUET:field_id": b"1"}),
        pa.field("b", pa.int64(), metadata={b"PARQUET:field_id": b"2"})])
    fpath = data_dir + "/f1.parquet"
    pq.write_table(
        pa.table({"old_name": [1, 2, 3], "b": [4, 5, 6]}).cast(sch), fpath)
    man = _avro.write_container([{"status": 1, "snapshot_id": 1,
        "data_file": {"content": 0, "file_path": fpath,
                      "file_format": "PARQUET", "partition": {"p": 0},
                      "record_count": 3,
                      "file_size_in_bytes": os.path.getsize(fpath)}}],
        schema=_MANIFEST_SCHEMA)
    with open(meta_dir + "/m.avro", "wb") as f:
        f.write(man)
    ml = _avro.write_container([{
        "manifest_path": meta_dir + "/m.avro", "manifest_length": len(man),
        "partition_spec_id": 0, "content": 0, "added_snapshot_id": 1,
        "partitions": [{"contains_null": False}]}],
        schema=_MANIFEST_LIST_SCHEMA)
    with open(meta_dir + "/ml.avro", "wb") as f:
        f.write(ml)
    meta = {"format-version": 2, "location": table,
            "current-snapshot-id": 1, "current-schema-id": 5,
            "schemas": [{"schema-id": 5, "fields": [
                {"id": 1, "name": "new_name", "type": "long"},
                {"id": 2, "name": "b", "type": "long"},
                {"id": 3, "name": "later", "type": "long"}]}],
            "snapshots": [{"snapshot-id": 1, "schema-id": 5,
                           "manifest-list": meta_dir + "/ml.avro"}]}
    with open(meta_dir + "/v1.metadata.json", "w") as f:
        json.dump(meta, f)
    with open(meta_dir + "/version-hint.text", "w") as f:
        f.write("1")
    ds = IcebergDatasource(table, columns=["new_name", "later", "b"])
    tbl = pa.concat_tables(
        blk for t in ds.get_read_tasks(2) for blk in t.read_fn())
    assert tbl.column_names == ["new_name", "later", "b"]
    assert tbl.column("new_name").to_pylist() == [1, 2, 3]
    assert tbl.column("later").to_pylist() == [None, None, None]
    # back-fill nulls carry the TABLE schema's type so these blocks
    # concat cleanly with blocks from post-ADD-COLUMN files
    assert tbl.schema.field("later").type == pa.int64()
    assert tbl.column("b").to_pylist() == [4, 5, 6]
    # a name in neither the table schema nor the file is a loud error,
    # not a silently-null column
    bogus = IcebergDatasource(table, columns=["new_nam"])
    with pytest.raises(KeyError, match="new_nam"):
        [blk for t in bogus.get_read_tasks(1) for blk in t.read_fn()]
    # columns=[] keeps row counts (count()-style reads); asserted per
    # block — pa.concat_tables itself zeroes 0-column tables' num_rows
    empty = IcebergDatasource(table, columns=[])
    blocks0 = [blk for t in empty.get_read_tasks(1) for blk in t.read_fn()]
    assert sum(b.num_rows for b in blocks0) == 3
    assert all(b.num_columns == 0 for b in blocks0)


# ---------------------------------------------------------------------------
# avro named-type registry (what iceberg manifests rely on)
# ---------------------------------------------------------------------------

def test_avro_named_type_reference_roundtrip():
    schema = {"type": "record", "name": "outer", "fields": [
        {"name": "a", "type": {"type": "record", "name": "point",
                               "fields": [{"name": "x", "type": "long"}]}},
        {"name": "b", "type": "point"},                 # bare-name ref
        {"name": "c", "type": ["null", "point"]},       # ref inside union
    ]}
    rows = [{"a": {"x": 1}, "b": {"x": 2}, "c": {"x": 3}},
            {"a": {"x": 4}, "b": {"x": 5}, "c": None}]
    blob = _avro.write_container(rows, schema=schema)
    assert _avro.read_container(blob) == rows
    # the schema EMBEDDED IN THE FILE must keep the reference — dumping
    # the resolved view would redefine "point", which fastavro/Java
    # readers reject as an illegal duplicate named type
    embedded = _avro.container_schema(blob)
    assert embedded["fields"][1]["type"] == "point"
    assert embedded["fields"][2]["type"] == ["null", "point"]
