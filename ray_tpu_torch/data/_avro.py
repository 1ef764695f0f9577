"""Dependency-free Avro Object Container File codec.

Reference: python/ray/data/read_api.py read_avro delegates to fastavro;
that library is not bundled here, so — like the TFRecord/Example codec
in datasource.py — the container format and binary encoding are
implemented directly from the Avro 1.11 spec:

  file   = magic "Obj\\x01" + metadata map (avro.schema JSON,
           avro.codec) + 16-byte sync marker + blocks
  block  = long(count) + long(byte_size) + records + sync marker
  codec  = null | deflate (raw zlib, no header)

Binary encoding: zigzag-varint longs, length-prefixed bytes/strings,
IEEE754 LE float/double, 1-byte booleans, block-encoded arrays/maps,
union by branch index, records in field order.

Schema support covers the shapes tabular data actually uses: primitives,
records, arrays, maps, unions (for nullable columns), enums and fixed.

The port's copy of ``ray_tpu/data/_avro.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Tuple

MAGIC = b"Obj\x01"

# ---------------------------------------------------------------------------
# binary primitives


def _w_long(out: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)             # zigzag
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


def _r_long(buf: memoryview, pos: int) -> Tuple[int, int]:
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos  # un-zigzag


def _w_bytes(out: io.BytesIO, b: bytes) -> None:
    _w_long(out, len(b))
    out.write(b)


def _r_bytes(buf: memoryview, pos: int) -> Tuple[bytes, int]:
    n, pos = _r_long(buf, pos)
    return bytes(buf[pos:pos + n]), pos + n


# ---------------------------------------------------------------------------
# schema-driven encode/decode


def _holds_null(schema: Any) -> bool:
    """Whether `schema` admits null: bare "null" (str or dict form — what
    inference emits for all-None columns) or a union with a null branch
    in either spelling."""
    if isinstance(schema, list):
        return any(_holds_null(b) for b in schema)
    t = schema.get("type") if isinstance(schema, dict) else schema
    return t == "null"


def _write_datum(out: io.BytesIO, schema: Any, v: Any) -> None:
    if isinstance(schema, list):             # union: pick the branch
        for i, branch in enumerate(schema):
            if _matches(branch, v):
                _w_long(out, i)
                _write_datum(out, branch, v)
                return
        # coercion pass: the non-union writers widen (double accepts
        # int, string str()-s anything) — the union path must accept the
        # same values or nullable columns crash where plain ones don't
        for i, branch in enumerate(schema):
            if _coercible(branch, v):
                _w_long(out, i)
                _write_datum(out, branch, v)
                return
        raise TypeError(f"value {v!r} matches no union branch {schema}")
    t = schema["type"] if isinstance(schema, dict) else schema
    if isinstance(t, (dict, list)):         # {"type": <schema>} wrapper
        _write_datum(out, t, v)
        return
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif t in ("int", "long"):
        _w_long(out, int(v))
    elif t == "float":
        out.write(struct.pack("<f", float(v)))
    elif t == "double":
        out.write(struct.pack("<d", float(v)))
    elif t == "bytes":
        _w_bytes(out, bytes(v))
    elif t == "string":
        _w_bytes(out, str(v).encode())
    elif t == "record":
        for f in schema["fields"]:
            ft = f["type"]
            if _holds_null(ft):
                # nullable field: a missing key writes null (inference
                # marks absent-anywhere columns nullable)
                _write_datum(out, ft, v.get(f["name"]))
            else:
                # required field: a missing key must RAISE (KeyError),
                # not silently write "None"/False through coercion
                _write_datum(out, ft, v[f["name"]])
    elif t == "array":
        items = list(v)
        if items:
            _w_long(out, len(items))
            for item in items:
                _write_datum(out, schema["items"], item)
        _w_long(out, 0)
    elif t == "map":
        if v:
            _w_long(out, len(v))
            for k, mv in v.items():
                _w_bytes(out, str(k).encode())
                _write_datum(out, schema["values"], mv)
        _w_long(out, 0)
    elif t == "enum":
        _w_long(out, schema["symbols"].index(v))
    elif t == "fixed":
        out.write(bytes(v))
    else:
        raise TypeError(f"unsupported avro type {t!r}")


def _matches(schema: Any, v: Any) -> bool:
    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return v is None
    if t == "boolean":
        return isinstance(v, bool)
    if t in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if t in ("float", "double"):
        return isinstance(v, float)
    if t == "bytes":
        return isinstance(v, (bytes, bytearray))
    if t == "string":
        return isinstance(v, str)
    if t == "record":
        return isinstance(v, dict)
    if t == "array":
        return isinstance(v, (list, tuple))
    if t == "map":
        return isinstance(v, dict)
    return v is not None


def _coercible(schema: Any, v: Any) -> bool:
    t = schema["type"] if isinstance(schema, dict) else schema
    if t in ("float", "double"):
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if t == "string":
        return v is not None
    return False


def _resolve_named(schema: Any, names: Dict[str, Any] = None) -> Any:
    """Replace references to previously defined named types (record/enum/
    fixed, Avro spec §Names) with their definition dicts, in schema-DFS
    order.  Iceberg manifest schemas reference the partition record type
    by name (e.g. "r102"), so the registry is required to read them.
    Replacement is by shared reference, which keeps recursive record
    schemas (linked-list shapes) well-defined."""
    if names is None:
        names = {}
    if isinstance(schema, str):
        return names.get(schema, schema)
    if isinstance(schema, list):
        return [_resolve_named(s, names) for s in schema]
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed", "error"):
            nm = schema.get("name")
            if nm:
                names[nm] = schema
                ns = schema.get("namespace")
                if ns:
                    names[f"{ns}.{nm}"] = schema
            if t == "record":
                for f in schema.get("fields", ()):
                    f["type"] = _resolve_named(f["type"], names)
        elif t == "array":
            schema["items"] = _resolve_named(schema.get("items"), names)
        elif t == "map":
            schema["values"] = _resolve_named(schema.get("values"), names)
        elif isinstance(t, (dict, list, str)):
            schema["type"] = _resolve_named(t, names)
    return schema


def _read_datum(buf: memoryview, pos: int, schema: Any) -> Tuple[Any, int]:
    if isinstance(schema, list):
        i, pos = _r_long(buf, pos)
        return _read_datum(buf, pos, schema[i])
    t = schema["type"] if isinstance(schema, dict) else schema
    if isinstance(t, (dict, list)):   # {"type": <schema>} wrapper
        return _read_datum(buf, pos, t)
    if t == "null":
        return None, pos
    if t == "boolean":
        return buf[pos] != 0, pos + 1
    if t in ("int", "long"):
        return _r_long(buf, pos)
    if t == "float":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if t == "double":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if t == "bytes":
        return _r_bytes(buf, pos)
    if t == "string":
        b, pos = _r_bytes(buf, pos)
        return b.decode(), pos
    if t == "record":
        rec = {}
        for f in schema["fields"]:
            rec[f["name"]], pos = _read_datum(buf, pos, f["type"])
        return rec, pos
    if t == "array":
        items: List[Any] = []
        while True:
            n, pos = _r_long(buf, pos)
            if n == 0:
                return items, pos
            if n < 0:                        # block with byte size
                n = -n
                _, pos = _r_long(buf, pos)
            for _ in range(n):
                item, pos = _read_datum(buf, pos, schema["items"])
                items.append(item)
    if t == "map":
        m: Dict[str, Any] = {}
        while True:
            n, pos = _r_long(buf, pos)
            if n == 0:
                return m, pos
            if n < 0:
                n = -n
                _, pos = _r_long(buf, pos)
            for _ in range(n):
                k, pos = _r_bytes(buf, pos)
                m[k.decode()], pos = _read_datum(buf, pos, schema["values"])
    if t == "enum":
        i, pos = _r_long(buf, pos)
        return schema["symbols"][i], pos
    if t == "fixed":
        n = schema["size"]
        return bytes(buf[pos:pos + n]), pos + n
    raise TypeError(f"unsupported avro type {t!r}")


# ---------------------------------------------------------------------------
# container file


def container_schema(data: bytes) -> Dict[str, Any]:
    """The schema JSON embedded in a container file's header, verbatim."""
    buf = memoryview(data)
    if bytes(buf[:4]) != MAGIC:
        raise ValueError("not an Avro object container file")
    pos = 4
    while True:
        n, pos = _r_long(buf, pos)
        if n == 0:
            break
        if n < 0:
            n = -n
            _, pos = _r_long(buf, pos)
        for _ in range(n):
            k, pos = _r_bytes(buf, pos)
            v, pos = _r_bytes(buf, pos)
            if k == b"avro.schema":
                return json.loads(v)
    raise ValueError("container file has no avro.schema header")


def read_container(data: bytes) -> List[Dict[str, Any]]:
    """All records of one Object Container File."""
    buf = memoryview(data)
    if bytes(buf[:4]) != MAGIC:
        raise ValueError("not an Avro object container file")
    pos = 4
    meta: Dict[str, bytes] = {}
    while True:
        n, pos = _r_long(buf, pos)
        if n == 0:
            break
        if n < 0:
            n = -n
            _, pos = _r_long(buf, pos)
        for _ in range(n):
            k, pos = _r_bytes(buf, pos)
            meta[k.decode()], pos = _r_bytes(buf, pos)
    schema = _resolve_named(json.loads(meta["avro.schema"]))
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = bytes(buf[pos:pos + 16])
    pos += 16
    records: List[Dict[str, Any]] = []
    while pos < len(buf):
        count, pos = _r_long(buf, pos)
        size, pos = _r_long(buf, pos)
        block = bytes(buf[pos:pos + size])
        pos += size
        if bytes(buf[pos:pos + 16]) != sync:
            raise ValueError("avro sync marker mismatch (corrupt file)")
        pos += 16
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bview = memoryview(block)
        bpos = 0
        for _ in range(count):
            rec, bpos = _read_datum(bview, bpos, schema)
            records.append(rec)
    return records


def _infer_schema(rows: List[Dict[str, Any]], name: str = "row") -> Dict:
    """Record schema from sample rows; columns that ever hold None become
    nullable unions."""
    fields = []
    cols: Dict[str, set] = {}
    present: Dict[str, int] = {}
    for r in rows:
        for k, v in r.items():
            cols.setdefault(k, set()).add(_type_of(v))
            present[k] = present.get(k, 0) + 1
    for k, types in cols.items():
        # nullable if any row held None OR lacked the column entirely
        nullable = "null" in types or present[k] < len(rows)
        types.discard("null")
        if not types:
            t: Any = "null"
        elif len(types) == 1:
            t = next(iter(types))
        else:
            # mixed int/float widens to double; else a union
            t = "double" if types <= {"long", "double"} else sorted(types)
        if nullable and t != "null":
            # flatten: unions may not nest unions (Avro spec) — a
            # nullable mixed-type column is ["null", a, b], never
            # ["null", [a, b]]
            t = ["null"] + (t if isinstance(t, list) else [t])
        fields.append({"name": k, "type": t})
    return {"type": "record", "name": name, "fields": fields}


def _type_of(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, int):
        return "long"
    if isinstance(v, float):
        return "double"
    if isinstance(v, (bytes, bytearray)):
        return "bytes"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "string"  # stringified fallback for nested lists
    return "string"


def _plain(v: Any) -> Any:
    """Numpy scalars/arrays -> python values (block rows carry them)."""
    if isinstance(v, (bytes, bytearray, str)) or v is None:
        return v
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 0) == 0:
        return v.item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return v.tolist()
    return v


def write_container(rows: List[Dict[str, Any]], *, schema: Dict = None,
                    codec: str = "null") -> bytes:
    """Rows -> one Object Container File (schema inferred if absent)."""
    rows = [{k: _plain(v) for k, v in r.items()} for r in rows]
    schema = schema or _infer_schema(rows)
    # embed the schema as given (named refs stay refs — re-dumping the
    # resolved form would illegally redefine named types), but encode
    # datums against the resolved view
    schema_json = json.dumps(schema)
    schema = _resolve_named(json.loads(schema_json))
    body = io.BytesIO()
    for r in rows:
        _write_datum(body, schema, r)
    block = body.getvalue()
    if codec == "deflate":
        c = zlib.compressobj(wbits=-15)
        block = c.compress(block) + c.flush()
    elif codec != "null":
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = os.urandom(16)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": schema_json.encode(),
            "avro.codec": codec.encode()}
    _w_long(out, len(meta))
    for k, v in meta.items():
        _w_bytes(out, k.encode())
        _w_bytes(out, v)
    _w_long(out, 0)
    out.write(sync)
    _w_long(out, len(rows))
    _w_long(out, len(block))
    out.write(block)
    out.write(sync)
    return out.getvalue()
