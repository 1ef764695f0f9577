"""Avro Object Container File IO (reference: read_api.py read_avro —
delegates to fastavro there; here _avro.py implements the container
format + binary encoding from the Avro 1.11 spec, like the TFRecord/
Example codec precedent).

The port's mirror of tests/test_data_avro.py, case by case, on one
cluster of the port's runtime for the module.
"""

import math

import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data._avro import (_infer_schema, read_container,
                                write_container)


# ---------------------------------------------------------------------------
# codec unit tests (no cluster)
# ---------------------------------------------------------------------------

ROWS = [
    {"i": 0, "f": 0.5, "s": "alpha", "b": True, "raw": b"\x00\x01",
     "maybe": None},
    {"i": -1234567890123, "f": -2.25, "s": "βeta", "b": False,
     "raw": b"", "maybe": "present"},
    {"i": 7, "f": math.pi, "s": "", "b": True, "raw": b"xyz",
     "maybe": None},
]


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_round_trip_null_codec():
    blob = write_container(ROWS)
    assert blob[:4] == b"Obj\x01"
    back = read_container(blob)
    assert back == ROWS


def test_round_trip_deflate_codec():
    back = read_container(write_container(ROWS, codec="deflate"))
    assert back == ROWS
    # rows with repeated content compress
    many = [dict(ROWS[0], s="same-string" * 10) for _ in range(200)]
    assert len(write_container(many, codec="deflate")) < \
        len(write_container(many))


def test_nullable_union_coerces_like_plain_columns():
    """Nullable columns accept the same widening the plain writers do:
    int into a ['null','double'] union, anything into ['null','string']."""
    rows = [{"x": None, "y": None}, {"x": 1, "y": [1, 2]}, {"x": 2.5,
                                                           "y": "s"}]
    back = read_container(write_container(rows))
    assert back[1]["x"] == 1.0 and back[2]["x"] == 2.5
    assert back[1]["y"] == "[1, 2]" and back[0]["x"] is None


def test_all_none_column_round_trips():
    """A column that is None everywhere it appears infers the bare
    "null" type; rows missing the key entirely must still serialize
    (regression: the required-field KeyError path fired for bare-null
    and dict-wrapped null-union fields)."""
    back = read_container(write_container([{"a": 1}, {"a": 2, "b": None}]))
    assert back == [{"a": 1, "b": None}, {"a": 2, "b": None}]


def test_dict_wrapped_null_union_is_optional():
    sch = {"type": "record", "name": "r", "fields": [
        {"name": "x", "type": [{"type": "null"}, "string"]}]}
    back = read_container(write_container([{"x": "hi"}, {}], schema=sch))
    assert back == [{"x": "hi"}, {"x": None}]


def test_schema_inference_nullable_union():
    sch = _infer_schema(ROWS)
    by_name = {f["name"]: f["type"] for f in sch["fields"]}
    assert by_name["i"] == "long"
    assert by_name["f"] == "double"
    assert by_name["maybe"] == ["null", "string"]   # saw None + str


def test_explicit_schema_arrays_maps_enums():
    schema = {
        "type": "record", "name": "r", "fields": [
            {"name": "tags", "type": {"type": "array", "items": "string"}},
            {"name": "kv", "type": {"type": "map", "values": "long"}},
            {"name": "color", "type": {"type": "enum", "name": "c",
                                       "symbols": ["RED", "BLUE"]}},
        ]}
    rows = [{"tags": ["a", "b"], "kv": {"x": 1, "y": -2}, "color": "BLUE"},
            {"tags": [], "kv": {}, "color": "RED"}]
    assert read_container(write_container(rows, schema=schema)) == rows


def test_missing_columns_and_mixed_types_flat_union():
    """Rows missing a column write null (absence => nullable), and a
    nullable mixed-type column infers a FLAT union — Avro forbids
    unions nested in unions."""
    rows = [{"a": 1}, {"a": 2, "b": 3}, {"a": None, "b": "s"}]
    sch = _infer_schema(rows)
    by_name = {f["name"]: f["type"] for f in sch["fields"]}
    assert by_name["a"] == ["null", "long"]
    assert by_name["b"] == ["null", "long", "string"]   # flat, not nested
    back = read_container(write_container(rows))
    assert back == [{"a": 1, "b": None}, {"a": 2, "b": 3},
                    {"a": None, "b": "s"}]


def test_required_field_missing_raises():
    """An explicit schema's REQUIRED field missing from a row raises —
    never silently writes 'None'/False through coercion."""
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "a", "type": "string"},
        {"name": "b", "type": "boolean"}]}
    with pytest.raises(KeyError):
        write_container([{"a": "x", "b": True}, {}], schema=schema)


def test_corrupt_sync_marker_rejected():
    blob = bytearray(write_container(ROWS))
    blob[-1] ^= 0xFF                     # trailing sync byte
    with pytest.raises(ValueError, match="sync"):
        read_container(bytes(blob))


# ---------------------------------------------------------------------------
# dataset e2e (incl. remote fs)
# ---------------------------------------------------------------------------

def test_write_then_read_avro_dataset(ray_cluster, tmp_path):
    ds = rd.range(40, override_num_blocks=3)
    files = ds.write_avro(str(tmp_path / "out"))
    assert files and all(f.endswith(".avro") for f in files)
    back = rd.read_avro(str(tmp_path / "out")).take_all()
    assert sorted(r["id"] for r in back) == list(range(40))


def test_avro_over_remote_fs(ray_cluster, tmp_path):
    dest = "mock-remote://" + str(tmp_path / "remote_avro")
    rd.from_items([{"k": i, "v": f"s{i}"} for i in range(12)]).write_avro(
        dest, codec="deflate")
    back = rd.read_avro(dest).take_all()
    assert sorted(r["k"] for r in back) == list(range(12))
    assert back[0]["v"].startswith("s")
