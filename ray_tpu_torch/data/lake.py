"""Native lakehouse table IO: Delta Lake and Apache Iceberg readers.

The reference exposes lakehouse tables through client libraries
(reference: python/ray/data/read_api.py read_delta_sharing_tables,
read_iceberg via pyiceberg, read_databricks_tables); none of those
libraries are bundled here, and a cluster reading training data from
object storage cannot shell out to a JVM.  So the table formats are
implemented directly from their specs, on top of the scheme-dispatched
fileio layer (local paths or any fsspec URI):

Delta Lake (protocol spec: github.com/delta-io/delta/blob/master/PROTOCOL.md)
  table/_delta_log/00000000000000000000.json   commit: JSON action lines
  table/_delta_log/<v>.checkpoint.parquet      state snapshot at version v
  table/_delta_log/_last_checkpoint            pointer to latest checkpoint
  Snapshot = replay adds/removes from the newest usable checkpoint through
  the target version.  Partition values live in the log, NOT the data
  files, so they are grafted onto each block as constant columns.

Iceberg (spec: iceberg.apache.org/spec/)
  table/metadata/v<N>.metadata.json (or <seq>-<uuid>.metadata.json)
    -> snapshots[current-snapshot-id].manifest-list   (avro)
    -> manifest_file.manifest_path                    (avro)
    -> manifest_entry.data_file.file_path             (parquet or avro)
  Manifests are Avro container files read with the dependency-free codec
  in _avro.py (named-type references included).  Iceberg stores partition
  columns inside the data files, so no column grafting is needed.

Both readers surface row counts at plan time (Delta: add.stats numRecords;
Iceberg: data_file.record_count) so the optimizer can size-split reads the
same way the parquet metadata provider does.

The port's copy of ``ray_tpu/data/lake.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

import json
import os
import re
import urllib.parse
from typing import Any, Dict, List, Optional

from .datasource import Datasource, ReadTask
from .block import Block, BlockMetadata

__all__ = ["DeltaDatasource", "IcebergDatasource", "commit_delta_write"]


def _join(base: str, rel: str) -> str:
    return base.rstrip("/") + "/" + rel.lstrip("/")


def _list_dir(path: str) -> List[str]:
    """All files under `path` (non-recursive names not required: callers
    filter by basename), [] when the directory does not exist."""
    from ray_tpu_torch._private import fileio

    try:
        return fileio.expand_paths([path])
    except FileNotFoundError:
        return []


def _read_bytes(path: str) -> bytes:
    from ray_tpu_torch._private import fileio

    with fileio.open_file(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# Delta Lake


_DELTA_COMMIT_RE = re.compile(r"^(\d{20})\.json$")
_DELTA_CKPT_RE = re.compile(r"^(\d{20})\.checkpoint(?:\.\d+\.\d+)?\.parquet$")

# Spark schemaString type name -> converter for partition-value strings
_PARTITION_CASTS = {
    "string": str, "integer": int, "long": int, "short": int, "byte": int,
    "double": float, "float": float, "boolean": lambda s: s == "true",
}


def _delta_log_files(table: str) -> Dict[str, List]:
    log_dir = _join(table, "_delta_log")
    commits: List[tuple] = []
    ckpts: Dict[int, List[str]] = {}
    for p in _list_dir(log_dir):
        base = p.rstrip("/").rsplit("/", 1)[-1]
        m = _DELTA_COMMIT_RE.match(base)
        if m:
            commits.append((int(m.group(1)), p))
            continue
        m = _DELTA_CKPT_RE.match(base)
        if m:
            ckpts.setdefault(int(m.group(1)), []).append(p)
    commits.sort()
    return {"commits": commits, "checkpoints": ckpts}


def _maplike_to_dict(v: Any) -> Dict[str, Any]:
    """partitionValues arrives as a dict (JSON commits) or a list of
    (key, value) pairs (pyarrow map type in checkpoint parquets)."""
    if v is None:
        return {}
    if isinstance(v, dict):
        return dict(v)
    return {k: val for k, val in v}


def _apply_action(state: Dict[str, Any], action: Dict[str, Any]) -> None:
    if "add" in action and action["add"] is not None:
        add = dict(action["add"])
        add["partitionValues"] = _maplike_to_dict(add.get("partitionValues"))
        if add.get("deletionVector"):
            raise NotImplementedError(
                "Delta deletion vectors are not supported; rewrite the "
                "table with `OPTIMIZE`/full rewrite to purge them")
        state["files"][add["path"]] = add
    if "remove" in action and action["remove"] is not None:
        state["files"].pop(action["remove"]["path"], None)
    if "metaData" in action and action["metaData"] is not None:
        state["metaData"] = action["metaData"]
    if "protocol" in action and action["protocol"] is not None:
        state["protocol"] = action["protocol"]


def _delta_snapshot(table: str, version: Optional[int]) -> Dict[str, Any]:
    log = _delta_log_files(table)
    commits, ckpts = log["commits"], log["checkpoints"]
    if not commits and not ckpts:
        raise FileNotFoundError(
            f"{table!r} is not a Delta table (no _delta_log commits)")
    max_version = max([v for v, _ in commits] + list(ckpts))
    target = max_version if version is None else int(version)
    if target > max_version:
        raise ValueError(f"version {target} > latest table version "
                         f"{max_version}")
    state: Dict[str, Any] = {"files": {}, "metaData": None, "protocol": None}
    # newest checkpoint at or below the target version seeds the replay
    usable = [v for v in ckpts if v <= target]
    start = -1
    if usable:
        import pyarrow.parquet as pq
        from ray_tpu_torch._private import fileio

        start = max(usable)
        for part in sorted(ckpts[start]):
            with fileio.open_file(part, "rb") as f:
                rows = pq.read_table(f).to_pylist()
            for row in rows:
                _apply_action(state, row)
    for v, path in commits:
        if start < v <= target:
            for line in _read_bytes(path).decode().splitlines():
                if line.strip():
                    _apply_action(state, json.loads(line))
    proto = state.get("protocol") or {}
    if (proto.get("minReaderVersion") or 1) > 3:
        raise NotImplementedError(
            f"Delta minReaderVersion {proto['minReaderVersion']} > 3")
    for feat in (proto.get("readerFeatures") or []):
        # only features whose semantics this reader actually honors may
        # pass: columnMapping would silently surface physical column
        # names, v2Checkpoint uses UUID checkpoint names + sidecars the
        # discovery regex can't see — both must fail loudly, not read
        # wrong data
        if feat not in ("timestampNtz", "vacuumProtocolCheck"):
            raise NotImplementedError(f"Delta reader feature {feat!r}")
    meta = state.get("metaData") or {}
    schema = json.loads(meta["schemaString"]) if meta.get("schemaString") \
        else {"fields": []}
    state["version"] = target
    state["partition_cols"] = list(meta.get("partitionColumns") or [])
    state["schema_fields"] = {f["name"]: f.get("type")
                              for f in schema.get("fields", [])}
    return state


def _cast_partition(value: Optional[str], sql_type: Any):
    if value is None:
        return None
    cast = _PARTITION_CASTS.get(sql_type) if isinstance(sql_type, str) \
        else None
    return cast(value) if cast else value


class DeltaDatasource(Datasource):
    """Snapshot reads of a Delta Lake table, with `version=` time travel.

    reference: python/ray/data/read_api.py read_delta_sharing_tables (the
    reference's Delta surface goes through the delta-sharing client; here
    the open table protocol is read directly so plain `s3://bucket/table`
    layouts work with no server).
    """

    def __init__(self, table_uri: str, *, version: Optional[int] = None,
                 columns: Optional[List[str]] = None):
        self._table = str(table_uri).rstrip("/")
        self._columns = columns
        self._snap = _delta_snapshot(self._table, version)

    @property
    def version(self) -> int:
        return self._snap["version"]

    def get_name(self) -> str:
        return "Delta"

    def plan_row_count(self) -> Optional[int]:
        total = 0
        for add in self._snap["files"].values():
            stats = add.get("stats")
            if not stats:
                return None
            n = json.loads(stats).get("numRecords")
            if n is None:
                return None
            total += n
        return total

    def estimate_inmemory_data_size(self) -> Optional[int]:
        sizes = [a.get("size") for a in self._snap["files"].values()]
        if any(s is None for s in sizes):
            return None
        return sum(sizes)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        files = sorted(self._snap["files"].values(), key=lambda a: a["path"])
        if not files:
            return []
        table, columns = self._table, self._columns
        part_types = {c: self._snap["schema_fields"].get(c)
                      for c in self._snap["partition_cols"]}
        n_tasks = max(1, min(parallelism, len(files)))
        groups = [files[i::n_tasks] for i in range(n_tasks)]

        def make(group):
            def read() -> List[Block]:
                import pyarrow as pa
                import pyarrow.parquet as pq
                from ray_tpu_torch._private import fileio

                # push the projection into the parquet read; partition
                # columns never exist in the files, so they are grafted
                # afterwards from the log
                # (falls back to a full read when only partition columns
                # are requested: columns=[] would drop the row count)
                file_cols = ([c for c in columns if c not in part_types]
                             or None) if columns else None
                out = []
                for add in group:
                    rel = urllib.parse.unquote(add["path"])
                    path = rel if "://" in rel else _join(table, rel)
                    with fileio.open_file(path, "rb") as f:
                        t = pq.read_table(f, columns=file_cols)
                    # partition columns live only in the log: graft them on
                    for col, sql_type in part_types.items():
                        if col in t.column_names:
                            continue
                        val = _cast_partition(
                            add["partitionValues"].get(col), sql_type)
                        t = t.append_column(
                            col, pa.array([val] * len(t)))
                    if columns:
                        t = t.select(columns)
                    out.append(t)
                return out
            return read

        tasks = []
        for g in groups:
            rows = 0
            for add in g:
                stats = add.get("stats")
                rows += (json.loads(stats).get("numRecords") or 0) \
                    if stats else 0
            meta = BlockMetadata(
                num_rows=rows,
                size_bytes=sum(a.get("size") or 0 for a in g))
            tasks.append(ReadTask(make(g), meta))
        return tasks


# -- Delta write (part files are written by the normal distributed write
#    path; this commits them into the log atomically from the driver) ------

_SPARK_TYPES = {
    "int64": "long", "int32": "integer", "int16": "short", "int8": "byte",
    "double": "double", "float": "float", "string": "string",
    "large_string": "string", "bool": "boolean", "binary": "binary",
    "date32[day]": "date",
}


def _spark_schema_string(arrow_schema) -> str:
    fields = []
    for f in arrow_schema:
        t = _SPARK_TYPES.get(str(f.type))
        if t is None:
            t = "timestamp" if str(f.type).startswith("timestamp") \
                else "string"
        fields.append({"name": f.name, "type": t, "nullable": True,
                       "metadata": {}})
    return json.dumps({"type": "struct", "fields": fields})


def commit_delta_write(table: str, parts, *, mode: str = "append") -> int:
    """Commit already-written parquet part files as one Delta version.

    `parts` is a list of absolute paths/URIs under `table`, or of
    (path, num_rows) pairs — when row counts travel with the paths (as
    Dataset.write_delta sends them) only ONE part's footer is opened
    (for the schema) instead of every part's.  mode='append' adds them;
    mode='overwrite' also removes every file in the current snapshot.
    Creates the table (protocol + metaData actions) when no log exists.
    Returns the committed version.
    """
    import uuid

    import pyarrow.parquet as pq
    from ray_tpu_torch._private import fileio

    table = str(table).rstrip("/")
    if mode not in ("append", "overwrite"):
        raise ValueError(f"mode must be append|overwrite, got {mode!r}")
    log = _delta_log_files(table)
    have_log = bool(log["commits"]) or bool(log["checkpoints"])
    prev = _delta_snapshot(table, None) if have_log else None
    version = (prev["version"] + 1) if prev is not None else 0
    now_ms = int(__import__("time").time() * 1000)

    actions: List[Dict[str, Any]] = []
    arrow_schema = None
    adds = []
    for part in parts:
        p, n_rows = part if isinstance(part, (tuple, list)) else (part, None)
        if n_rows is not None:
            n_rows = int(n_rows)  # arrow scalars are not JSON-encodable
        if n_rows is None or arrow_schema is None:
            with fileio.open_file(p, "rb") as f:
                pf = pq.ParquetFile(f)
                if n_rows is None:
                    n_rows = pf.metadata.num_rows
                if arrow_schema is None:
                    arrow_schema = pf.schema_arrow
        rel = p[len(table):].lstrip("/") if p.startswith(table) else p
        adds.append({"add": {
            "path": urllib.parse.quote(rel),
            "partitionValues": {}, "size": fileio.filesize(p) or 0,
            "modificationTime": now_ms, "dataChange": True,
            "stats": json.dumps({"numRecords": n_rows}),
        }})
    if prev is None and arrow_schema is None:
        raise ValueError(
            "cannot create a Delta table from an empty write (no part "
            "files carry a schema); write at least one row")
    if prev is None:
        actions.append({"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}})
        actions.append({"metaData": {
            "id": uuid.uuid4().hex, "format": {"provider": "parquet",
                                               "options": {}},
            "schemaString": _spark_schema_string(arrow_schema),
            "partitionColumns": [], "configuration": {},
            "createdTime": now_ms,
        }})
    elif mode == "overwrite":
        for path in prev["files"]:
            actions.append({"remove": {
                "path": path, "deletionTimestamp": now_ms,
                "dataChange": True}})
    actions.extend(adds)
    actions.append({"commitInfo": {"timestamp": now_ms,
                                   "operation": "WRITE",
                                   "operationParameters": {"mode": mode}}})
    log_dir = _join(table, "_delta_log")
    fileio.makedirs(log_dir)
    commit_path = _join(log_dir, f"{version:020d}.json")
    payload = "\n".join(json.dumps(a) for a in actions).encode()
    if not fileio.is_uri(commit_path):
        # O_EXCL create: a concurrent writer racing to the same version
        # loses with FileExistsError instead of silently overwriting
        try:
            with open(commit_path, "xb") as f:
                f.write(payload)
        except FileExistsError:
            raise RuntimeError(
                f"concurrent Delta commit at version {version}") from None
        return version
    # object stores: best-effort existence check (put-if-absent is not in
    # the fsspec surface; a true CAS needs the store's conditional put)
    if fileio.exists(commit_path):
        raise RuntimeError(f"concurrent Delta commit at version {version}")
    with fileio.open_file(commit_path, "wb") as f:
        f.write(payload)
    return version


# ---------------------------------------------------------------------------
# Apache Iceberg


_ICEBERG_META_RE = re.compile(r"^(?:v(\d+)|(\d+)-[0-9a-fA-F-]+)\.metadata\.json$")


def _strip_file_scheme(path: str) -> str:
    """file:///x, file://x and file:/x all mean local /x."""
    if path.startswith("file:"):
        path = path[5:]
        while path.startswith("//"):
            path = path[1:]
    return path


def _iceberg_latest_metadata(table: str) -> str:
    meta_dir = _join(table, "metadata")
    from ray_tpu_torch._private import fileio

    hint = _join(meta_dir, "version-hint.text")
    if fileio.exists(hint):
        n = int(_read_bytes(hint).decode().strip())
        cand = _join(meta_dir, f"v{n}.metadata.json")
        if fileio.exists(cand):
            return cand
    best, best_seq = None, -1
    for p in _list_dir(meta_dir):
        base = p.rstrip("/").rsplit("/", 1)[-1]
        m = _ICEBERG_META_RE.match(base)
        if m:
            seq = int(m.group(1) or m.group(2))
            if seq > best_seq:
                best, best_seq = p, seq
    if best is None:
        raise FileNotFoundError(
            f"{table!r} is not an Iceberg table (no metadata/*.metadata.json)")
    return best


def _iceberg_arrow_type(iceberg_type):
    """Iceberg primitive type string -> arrow type, for typing the
    all-null back-fill of ADD-COLUMN evolution (blocks from pre- and
    post-evolution files must carry the same schema or concat fails).
    Unknown/nested types fall back to arrow's null type."""
    import pyarrow as pa

    t = iceberg_type if isinstance(iceberg_type, str) else None
    prim = {"boolean": pa.bool_(), "int": pa.int32(), "long": pa.int64(),
            "float": pa.float32(), "double": pa.float64(),
            "date": pa.date32(), "time": pa.time64("us"),
            "timestamp": pa.timestamp("us"),
            "timestamptz": pa.timestamp("us", tz="UTC"),
            "string": pa.string(), "uuid": pa.binary(16),
            "binary": pa.binary()}
    if t in prim:
        return prim[t]
    if t and t.startswith("decimal("):
        p, s = t[len("decimal("):-1].split(",")
        return pa.decimal128(int(p), int(s))
    if t and t.startswith("fixed("):
        return pa.binary(int(t[len("fixed("):-1]))
    return pa.null()


class IcebergDatasource(Datasource):
    """Snapshot reads of an Iceberg v1/v2 table (parquet or avro data
    files), with `snapshot_id=` time travel.

    reference: python/ray/data/read_api.py read_iceberg (delegates to
    pyiceberg; here the metadata.json -> manifest-list -> manifest chain
    is walked directly with the _avro.py codec).
    """

    def __init__(self, table_uri: str, *, snapshot_id: Optional[int] = None,
                 columns: Optional[List[str]] = None):
        self._table = str(table_uri).rstrip("/")
        self._columns = columns
        meta = json.loads(_read_bytes(_iceberg_latest_metadata(self._table)))
        self._location = _strip_file_scheme(
            (meta.get("location") or self._table).rstrip("/"))
        snap_id = snapshot_id if snapshot_id is not None \
            else meta.get("current-snapshot-id")
        snaps = {s["snapshot-id"]: s for s in meta.get("snapshots", [])}
        if snap_id is None or snap_id == -1 or not snaps:
            self._files: List[Dict[str, Any]] = []
            self._field_ids: Dict[str, int] = {}
            return
        if snap_id not in snaps:
            raise ValueError(f"snapshot {snap_id} not in table "
                             f"({sorted(snaps)})")
        self._field_ids = self._schema_field_ids(meta, snaps[snap_id])
        self._files = self._resolve_snapshot(snaps[snap_id])

    @staticmethod
    def _schema_field_ids(meta: Dict[str, Any],
                          snap: Dict[str, Any]) -> Dict[str, tuple]:
        """Column name -> (field-id, iceberg type) for the snapshot's
        schema.

        The Iceberg spec resolves columns by field-id, not name, so
        renames survive: the name a reader asks for is looked up in the
        TABLE schema, and the id is matched against each data file's
        parquet field_id metadata (get_read_tasks).  The type rides
        along so ADD-COLUMN back-fill nulls are typed consistently with
        blocks from post-evolution files."""
        schemas = meta.get("schemas") or []
        sid = snap.get("schema-id", meta.get("current-schema-id"))
        schema = next((s for s in schemas if s.get("schema-id") == sid),
                      None) or (schemas[-1] if schemas
                                else meta.get("schema") or {})
        out: Dict[str, tuple] = {}
        for f in schema.get("fields", []):
            if "id" in f and "name" in f:
                out[f["name"]] = (int(f["id"]), f.get("type"))
        return out

    def _remap(self, path: str) -> str:
        """Manifest paths are absolute URIs from the writer's vantage;
        remap them under the table URI the caller actually reached."""
        path = _strip_file_scheme(path)
        if path.startswith(self._location):
            return self._table + path[len(self._location):]
        loc_tail = self._location.split("://", 1)[-1]
        i = path.find(loc_tail)
        if i >= 0:
            return self._table + path[i + len(loc_tail):]
        return path

    def _resolve_snapshot(self, snap: Dict[str, Any]) -> List[Dict[str, Any]]:
        from . import _avro

        files: List[Dict[str, Any]] = []
        if snap.get("manifest-list"):
            manifests = _avro.read_container(
                _read_bytes(self._remap(snap["manifest-list"])))
        else:  # v1 tables may inline the manifest paths
            manifests = [{"manifest_path": p} for p in
                         snap.get("manifests", [])]
        for mf in manifests:
            if mf.get("content", 0) == 1:
                raise NotImplementedError(
                    "Iceberg delete manifests (merge-on-read) are not "
                    "supported; compact the table to copy-on-write")
            entries = _avro.read_container(
                _read_bytes(self._remap(mf["manifest_path"])))
            for e in entries:
                if e.get("status") == 2:     # DELETED
                    continue
                df = e["data_file"]
                if df.get("content", 0) != 0:
                    raise NotImplementedError(
                        "Iceberg delete files are not supported")
                files.append(df)
        return files

    def get_name(self) -> str:
        return "Iceberg"

    def plan_row_count(self) -> Optional[int]:
        counts = [f.get("record_count") for f in self._files]
        if any(c is None for c in counts):
            return None
        return sum(counts)

    def estimate_inmemory_data_size(self) -> Optional[int]:
        sizes = [f.get("file_size_in_bytes") for f in self._files]
        if any(s is None for s in sizes):
            return None
        return sum(sizes)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        if not self._files:
            return []
        files = sorted(self._files, key=lambda f: f["file_path"])
        columns = self._columns
        field_ids = self._field_ids
        remap = self._remap
        n_tasks = max(1, min(parallelism, len(files)))
        groups = [files[i::n_tasks] for i in range(n_tasks)]

        def resolve_parquet_columns(file_schema):
            """Requested name -> physical column name in THIS file via
            field-id (spec-correct under renames); falls back to the
            name itself when neither side carries an id.  A TABLE-schema
            column the file predates (ADD COLUMN evolution) resolves to
            None — projected as typed nulls, per the Iceberg spec; a
            name in neither the table schema nor the file is an error
            (typos must not come back as null columns)."""
            by_id: Dict[int, str] = {}
            for field in file_schema:
                fid = (field.metadata or {}).get(b"PARQUET:field_id")
                if fid is not None:
                    by_id[int(fid)] = field.name
            pairs = []
            for c in columns:
                fid, _ = field_ids.get(c, (None, None))
                if fid is not None and fid in by_id:
                    pairs.append((c, by_id[fid]))
                elif c in file_schema.names:
                    pairs.append((c, c))
                elif c in field_ids:
                    pairs.append((c, None))
                else:
                    raise KeyError(
                        f"column {c!r} is in neither the table schema "
                        f"nor the data file (schema columns: "
                        f"{sorted(field_ids)})")
            return pairs

        def make(group):
            paths = [(remap(f["file_path"]),
                      (f.get("file_format") or "PARQUET").upper())
                     for f in group]

            def read() -> List[Block]:
                import pyarrow as pa
                import pyarrow.parquet as pq
                from ray_tpu_torch._private import fileio
                from . import _avro

                out = []
                for path, fmt in paths:
                    if fmt == "PARQUET":
                        with fileio.open_file(path, "rb") as f:
                            pf = pq.ParquetFile(f)
                            if columns is None:
                                t = pf.read()
                            elif not columns:
                                # zero-column projection keeps num_rows
                                # (count()-style reads); a pa.table({})
                                # rebuild would report 0 rows
                                t = pf.read(columns=[])
                            else:
                                pairs = resolve_parquet_columns(
                                    pf.schema_arrow)
                                nrows = pf.metadata.num_rows
                                t = pf.read(columns=[p for _, p in pairs
                                                     if p is not None])
                                t = pa.table(
                                    {c: (t.column(p) if p is not None
                                         else pa.nulls(
                                             nrows,
                                             _iceberg_arrow_type(
                                                 field_ids[c][1])))
                                     for c, p in pairs})
                    elif fmt == "AVRO":
                        rows = _avro.read_container(_read_bytes(path))
                        t = pa.Table.from_pylist(rows)
                        if columns is not None:
                            t = t.select(columns)
                    else:
                        raise NotImplementedError(
                            f"Iceberg data file format {fmt!r}")
                    out.append(t)
                return out
            return read

        tasks = []
        for g in groups:
            meta = BlockMetadata(
                num_rows=sum(f.get("record_count") or 0 for f in g),
                size_bytes=sum(f.get("file_size_in_bytes") or 0 for f in g))
            tasks.append(ReadTask(make(g), meta))
        return tasks
