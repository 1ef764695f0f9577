"""Datasources: how Datasets begin and end.

Reference: python/ray/data/datasource/ (Datasource, ReadTask) and
python/ray/data/read_api.py:334 read_datasource.  A Datasource produces
``ReadTask``s — serializable thunks that each yield one or more blocks on a
worker.  Writes are map tasks that persist blocks and return paths.

The port's copy of ``ray_tpu/data/datasource.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import pyarrow as pa

from .block import Block, BlockMetadata, VALUE_COL, rows_to_block


@dataclass
class ReadTask:
    """A serializable unit of reading; runs on a worker and yields blocks."""

    read_fn: Callable[[], Iterable[Block]]
    metadata: BlockMetadata  # estimate (rows may be None-ish / approximate)

    def __call__(self) -> Iterable[Block]:
        return self.read_fn()


class Datasource:
    """Base datasource (reference: python/ray/data/datasource/datasource.py)."""

    def get_name(self) -> str:
        return type(self).__name__.replace("Datasource", "")

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def plan_row_count(self) -> Optional[int]:
        """EXACT total row count known without executing any read, or
        None (reference: parquet metadata makes `ds.count()` an O(files)
        footer scan instead of a full read).  Only return a number that
        is guaranteed exact — Dataset.count() trusts it."""
        return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError


class RangeDatasource(Datasource):
    def __init__(self, n: int, *, tensor_shape: Optional[tuple] = None):
        self._n = n
        self._tensor_shape = tensor_shape

    def plan_row_count(self) -> Optional[int]:
        return self._n

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = self._n
        parallelism = max(1, min(parallelism, n or 1))
        tasks = []
        chunk = (n + parallelism - 1) // parallelism if n else 0
        shape = self._tensor_shape
        for start in range(0, n, max(chunk, 1)):
            end = min(start + chunk, n)

            def read(start=start, end=end):
                ids = np.arange(start, end, dtype=np.int64)
                if shape:
                    size = int(np.prod(shape))
                    data = (ids[:, None] * size
                            + np.arange(size, dtype=np.int64)[None, :])
                    batch = {"data": data.reshape((end - start,) + shape)}
                else:
                    batch = {"id": ids}
                from .block import batch_to_block

                yield batch_to_block(batch)

            meta = BlockMetadata(num_rows=end - start,
                                 size_bytes=(end - start) * 8)
            tasks.append(ReadTask(read, meta))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: List[Any]):
        self._items = list(items)

    def plan_row_count(self) -> Optional[int]:
        return len(self._items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        items = self._items
        n = len(items)
        parallelism = max(1, min(parallelism, n or 1))
        chunk = (n + parallelism - 1) // parallelism if n else 0
        tasks = []
        for start in range(0, n, max(chunk, 1)):
            part = items[start:start + chunk]

            def read(part=part):
                yield rows_to_block(part)

            meta = BlockMetadata(num_rows=len(part), size_bytes=0)
            tasks.append(ReadTask(read, meta))
        return tasks


class BlocksDatasource(Datasource):
    """From already-materialized in-memory blocks (from_pandas/arrow/numpy)."""

    def __init__(self, blocks: List[Block]):
        self._blocks = blocks

    def plan_row_count(self) -> Optional[int]:
        return sum(b.num_rows for b in self._blocks)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for b in self._blocks:
            def read(b=b):
                yield b

            tasks.append(ReadTask(read, BlockMetadata(
                num_rows=b.num_rows, size_bytes=b.nbytes, schema=b.schema)))
        return tasks


def _expand_paths(paths, suffixes: Optional[List[str]] = None) -> List[str]:
    """Local dirs/globs plus any fsspec scheme (s3://, gs://,
    mock-remote://) — hosts of a cluster share no disk, so remote paths
    are the ONLY way workers on every host can reach the same training data
    (reference: file_based_datasource.py:65 resolves through pyarrow.fs).
    """
    from ray_tpu_torch._private import fileio

    return fileio.expand_paths(paths, suffixes)


class FileBasedDatasource(Datasource):
    """One-or-more files per read task (reference:
    python/ray/data/datasource/file_based_datasource.py).  Paths may be
    local or any fsspec URI; read thunks re-resolve the filesystem on the
    worker from the path's scheme (nothing host-specific is pickled).
    """

    _suffixes: Optional[List[str]] = None

    def __init__(self, paths, **reader_args):
        self._paths = _expand_paths(paths, self._suffixes)
        self._reader_args = reader_args
        # per-path plan-metadata memo: footers are immutable per path,
        # and count() + execution would otherwise fetch each twice
        self._meta_memo: dict = {}

    def _read_file(self, path: str, **kwargs) -> Block:
        raise NotImplementedError

    def _plan_metadata(self, path: str):
        """Optional plan-time (num_rows, size_bytes, schema) for one file
        — parquet reads its footer; other formats return None and the
        plan falls back to byte-size estimates (reference:
        parquet_meta_provider.py vs DefaultFileMetadataProvider)."""
        return None

    def _plan_metadata_memo(self, path: str):
        if path not in self._meta_memo:
            try:
                result = self._plan_metadata(path)
            except Exception:
                # transient IO failure: DON'T cache — the next planning
                # call retries (None-by-design results do cache)
                return None
            self._meta_memo[path] = result
        return self._meta_memo[path]

    # footer reads at plan time are capped: past this many files the
    # per-file row counts are extrapolated from the sampled mean (the
    # reference's meta provider samples similarly for huge file lists)
    _PLAN_META_SAMPLE = 32

    def plan_row_count(self) -> Optional[int]:
        """Exact count from per-file plan metadata (parquet footers) —
        only when EVERY file is inside the sample cap and answers."""
        if len(self._paths) > self._PLAN_META_SAMPLE:
            return None
        total = 0
        for p in self._paths:
            m = self._plan_metadata_memo(p)
            if m is None:
                return None
            total += m[0]
        return total

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        from ray_tpu_torch._private import fileio

        paths = self._paths
        parallelism = max(1, min(parallelism, len(paths)))
        groups: List[List[str]] = [[] for _ in range(parallelism)]
        for i, p in enumerate(paths):
            groups[i % parallelism].append(p)
        read_file = self._read_file
        args = self._reader_args

        meta_by_path = {}
        sample = paths[:self._PLAN_META_SAMPLE]
        for p in sample:
            meta_by_path[p] = self._plan_metadata_memo(p)
        sampled = [m for m in meta_by_path.values() if m is not None]
        mean_rows = (sum(m[0] for m in sampled) / len(sampled)
                     if sampled else None)
        mean_size = (sum(m[1] for m in sampled) / len(sampled)
                     if sampled else None)
        plan_schema = sampled[0][2] if sampled else None

        tasks = []
        for group in groups:
            if not group:
                continue

            def read(group=group):
                for p in group:
                    yield read_file(p, **args)

            rows = 0
            size = 0
            exact = bool(sampled)
            for p in group:
                m = meta_by_path.get(p)
                if m is not None:
                    rows += m[0]
                    size += m[1]
                elif mean_rows is not None:
                    # beyond the sample cap: extrapolate BOTH rows and
                    # bytes from the sampled means (no extra IO at plan
                    # time for 10k-file reads)
                    rows += int(mean_rows)
                    size += int(mean_size)
                    exact = False
                else:
                    exact = False
            if not sampled:
                size = sum(fileio.filesize(p) or 0 for p in group)
            tasks.append(ReadTask(read, BlockMetadata(
                num_rows=rows, size_bytes=size, schema=plan_schema,
                input_files=group, exec_stats={"rows_exact": exact})))
        return tasks


def _open(path: str, mode: str = "rb"):
    from ray_tpu_torch._private import fileio

    return fileio.open_file(path, mode)


class ParquetDatasource(FileBasedDatasource):
    _suffixes = [".parquet"]

    def _read_file(self, path: str, columns=None, **kw) -> Block:
        import pyarrow.parquet as pq

        with _open(path) as f:
            return pq.read_table(f, columns=columns)

    def _plan_metadata(self, path: str):
        """Row count + schema from the parquet footer — a few KB read,
        no data pages touched (reference: parquet_meta_provider.py)."""
        import pyarrow.parquet as pq

        with _open(path) as f:
            pf = pq.ParquetFile(f)
            return (pf.metadata.num_rows,
                    pf.metadata.serialized_size
                    + sum(pf.metadata.row_group(i).total_byte_size
                          for i in range(pf.metadata.num_row_groups)),
                    pf.schema_arrow)


class CSVDatasource(FileBasedDatasource):
    _suffixes = [".csv"]

    def _read_file(self, path: str, **kw) -> Block:
        import pyarrow.csv as pcsv

        with _open(path) as f:
            return pcsv.read_csv(f)


class JSONDatasource(FileBasedDatasource):
    _suffixes = [".json", ".jsonl"]

    def _read_file(self, path: str, **kw) -> Block:
        import pyarrow.json as pjson

        with _open(path) as f:
            return pjson.read_json(f)


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path: str, encoding="utf-8", drop_empty_lines=True,
                   **kw) -> Block:
        with _open(path) as f:
            # splitlines = universal newlines (\n, \r\n, \r) — the bytes
            # come straight off the remote fs with no text-mode layer
            lines = f.read().decode(encoding).splitlines()
        if drop_empty_lines:
            lines = [ln for ln in lines if ln.strip()]
        return pa.table({"text": lines})


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path: str, include_paths=False, **kw) -> Block:
        with _open(path) as f:
            data = f.read()
        cols = {"bytes": [data]}
        if include_paths:
            cols["path"] = [path]
        return pa.table(cols)


class NumpyDatasource(FileBasedDatasource):
    _suffixes = [".npy"]

    def _read_file(self, path: str, **kw) -> Block:
        from .block import batch_to_block

        with _open(path) as f:
            return batch_to_block({"data": np.load(f)})


# ---------------------------------------------------------------------------
# Writers (run inside map tasks; reference: file_datasink.py)

def write_block(block: Block, path: str, file_format: str,
                **writer_args) -> str:
    """Persist one block under `path` (local dir or fsspec URI — pod
    workers write their shard straight to the remote fs; reference:
    file_datasink.py)."""
    from ray_tpu_torch._private import fileio

    fileio.makedirs(path)
    sep = "/" if fileio.is_uri(path) else os.sep
    fname = f"{path.rstrip(sep)}{sep}{uuid.uuid4().hex[:12]}.{file_format}"
    if file_format == "parquet":
        import pyarrow.parquet as pq

        with fileio.open_file(fname, "wb") as f:
            pq.write_table(block, f, **writer_args)
    elif file_format == "csv":
        import pyarrow.csv as pcsv

        with fileio.open_file(fname, "wb") as f:
            pcsv.write_csv(block, f)
    elif file_format == "json":
        df = block.to_pandas()
        text = df.to_json(orient="records", lines=True)
        with fileio.open_file(fname, "wb") as f:
            f.write(text.encode())
    elif file_format == "npy":
        from .block import BlockAccessor

        cols = BlockAccessor(block).to_numpy()
        with fileio.open_file(fname, "wb") as f:
            if len(cols) == 1:
                np.save(f, next(iter(cols.values())))
            else:
                np.save(f, cols, allow_pickle=True)
    elif file_format == "tfrecords":
        from .block import BlockAccessor

        with fileio.open_file(fname, "wb") as f:
            for row in BlockAccessor(block).iter_rows():
                _tfrecord_write(f, _example_encode(row))
    elif file_format == "avro":
        from ._avro import write_container
        from .block import BlockAccessor

        rows = list(BlockAccessor(block).iter_rows())
        with fileio.open_file(fname, "wb") as f:
            f.write(write_container(rows, **writer_args))
    elif file_format == "tar":        # webdataset shard
        import io as _io
        import tarfile

        from .block import BlockAccessor

        encoder = writer_args.get("encoder")
        with fileio.open_file(fname, "wb") as f, \
                tarfile.open(fileobj=f, mode="w") as tf:
            for i, row in enumerate(BlockAccessor(block).iter_rows()):
                if callable(encoder):
                    row = encoder(row)
                key = str(row.get("__key__", f"{i:08d}"))
                for col, v in row.items():
                    if col in ("__key__", "__url__") or v is None:
                        continue
                    payload = (v if isinstance(v, bytes)
                               else _wds_encode_field(col, v))
                    info = tarfile.TarInfo(name=f"{key}.{col}")
                    info.size = len(payload)
                    tf.addfile(info, _io.BytesIO(payload))
    else:
        raise ValueError(f"unknown write format {file_format}")
    return fname


# ---------------------------------------------------------------------------
# TFRecord container format (pure python — the format is tiny: each record
# is len(u64 LE) + masked-crc32c(len) + payload + masked-crc32c(payload)).
# Reference: python/ray/data/datasource/tfrecords_datasource.py (which
# delegates to tf.io); payloads are tf.train.Example protos, which we
# encode/decode with a minimal hand-rolled proto codec (wire format only —
# Example = {1: Features{1: map<string, Feature>}}, Feature is a oneof of
# bytes_list(1)/float_list(2)/int64_list(3)).

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _tfrecord_read(f) -> "Iterable[bytes]":
    import struct as _s

    while True:
        head = f.read(12)
        if not head:
            return
        if len(head) < 12:
            raise ValueError("truncated tfrecord file (partial header)")
        (length,), _ = _s.unpack("<Q", head[:8]), head[8:]
        payload = f.read(length)
        if len(payload) < length:
            raise ValueError(
                f"truncated tfrecord file (record claims {length} bytes, "
                f"got {len(payload)})")
        f.read(4)  # payload crc (not verified on read, like tf by default)
        yield payload


def _tfrecord_write(f, payload: bytes) -> None:
    import struct as _s

    head = _s.pack("<Q", len(payload))
    f.write(head)
    f.write(_s.pack("<I", _masked_crc(head)))
    f.write(payload)
    f.write(_s.pack("<I", _masked_crc(payload)))


# -- minimal protobuf wire helpers for tf.train.Example ---------------------

def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_field(tag: int, payload: bytes) -> bytes:
    return _pb_varint((tag << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _example_encode(row: "Dict[str, Any]") -> bytes:
    import struct as _s

    feats = b""
    for name, value in row.items():
        arr = np.asarray(value)
        if arr.dtype.kind in "SUO" or isinstance(value, (bytes, str)):
            vals = arr.reshape(-1).tolist() if arr.ndim else [arr.item()]
            for v in vals:
                if not isinstance(v, (bytes, str, np.bytes_, np.str_)):
                    # bytes(int) would write zero-filled garbage silently
                    raise ValueError(
                        f"tfrecords column {name!r}: unsupported value "
                        f"{type(v).__name__} (want int/float/bytes/str or "
                        "uniform lists thereof)")
            payload = b"".join(
                _pb_field(1, v.encode() if isinstance(v, str) else bytes(v))
                for v in vals)
            feature = _pb_field(1, payload)          # bytes_list = field 1
        elif arr.dtype.kind == "f":
            # float_list(field 2) { packed floats(field 1) }
            vals = arr.reshape(-1).astype("<f4")
            feature = _pb_field(2, _pb_field(1, vals.tobytes()))
        else:
            # int64_list(field 3) { packed varints(field 1) }
            ints = b"".join(_pb_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                            for v in arr.reshape(-1).tolist() or [])
            feature = _pb_field(3, _pb_field(1, ints))
        entry = _pb_field(1, name.encode()) + _pb_field(2, feature)
        feats += _pb_field(1, entry)                 # map entry
    return _pb_field(1, feats)                        # Example.features


def _example_decode(payload: bytes) -> "Dict[str, Any]":
    def read_fields(buf):
        i = 0
        while i < len(buf):
            key, i = _pb_read_varint(buf, i)
            tag, wire = key >> 3, key & 7
            if wire == 2:
                ln, i = _pb_read_varint(buf, i)
                yield tag, buf[i:i + ln]
                i += ln
            elif wire == 0:
                v, i = _pb_read_varint(buf, i)
                yield tag, v
            elif wire == 5:
                yield tag, buf[i:i + 4]
                i += 4
            elif wire == 1:
                yield tag, buf[i:i + 8]
                i += 8
            else:
                raise ValueError(f"bad wire type {wire}")

    row: Dict[str, Any] = {}
    for tag, features in read_fields(payload):
        if tag != 1:
            continue
        for etag, entry in read_fields(features):
            if etag != 1:
                continue
            name, feature = None, None
            for ftag, fval in read_fields(entry):
                if ftag == 1:
                    name = fval.decode()
                elif ftag == 2:
                    feature = fval
            if name is None or feature is None:
                continue
            for kind, lst in read_fields(feature):
                vals: List[Any] = []
                if kind == 1:      # bytes_list
                    vals = [v for t, v in read_fields(lst) if t == 1]
                elif kind == 2:    # float_list: packed bytes OR repeated
                    for t, v in read_fields(lst):   # fixed32 (unpacked)
                        if t != 1:
                            continue
                        if isinstance(v, (bytes, bytearray)):
                            vals.extend(np.frombuffer(v, "<f4").tolist())
                        else:
                            vals.append(v)
                elif kind == 3:    # int64_list: packed varints OR unpacked
                    for t, v in read_fields(lst):
                        if t != 1:
                            continue
                        if isinstance(v, (bytes, bytearray)):
                            i = 0
                            while i < len(v):
                                n, i = _pb_read_varint(v, i)
                                vals.append(n)
                        else:
                            vals.append(v)
                    vals = [n - (1 << 64) if n >= 1 << 63 else n
                            for n in vals]
                row[name] = vals[0] if len(vals) == 1 else vals
    return row


class TFRecordsDatasource(FileBasedDatasource):
    _suffixes = [".tfrecords", ".tfrecord"]

    def _read_file(self, path: str, **kw) -> Block:
        rows = []
        with _open(path) as f:
            for payload in _tfrecord_read(f):
                rows.append(_example_decode(payload))
        return rows_to_block(rows)


class AvroDatasource(FileBasedDatasource):
    """reference: read_api.py read_avro (delegates to fastavro there;
    here the container format + binary encoding are implemented directly
    — see _avro.py — so the connector needs no third-party library)."""

    _suffixes = [".avro"]

    def _read_file(self, path: str, **kw) -> Block:
        from ._avro import read_container

        with _open(path) as f:
            return rows_to_block(read_container(f.read()))


_WDS_IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp", "gif", "ppm")


def _wds_decode_field(ext: str, data: bytes, decoder):
    """Default per-field decoder (reference:
    _internal/datasource/webdataset_datasource.py default_decoder):
    extension picks the codec; unknown extensions stay raw bytes."""
    if decoder is False or decoder is None:
        return data
    base = ext.rsplit(".", 1)[-1].lower()
    if base in ("txt", "text", "transcript"):
        return data.decode("utf-8")
    if base in ("cls", "cls2", "index", "inx", "id"):
        return int(data.decode("utf-8").strip())
    if base in ("json", "jsn"):
        import json as _json

        return _json.loads(data.decode("utf-8"))
    if base in ("npy", "npz"):
        import io as _io

        return np.load(_io.BytesIO(data), allow_pickle=False)
    if base in _WDS_IMAGE_EXTS:
        try:
            import io as _io

            from PIL import Image
        except ImportError:
            return data            # no PIL: hand back the encoded bytes
        img = Image.open(_io.BytesIO(data))
        img.load()
        return np.asarray(img)
    return data


class WebDatasetDatasource(FileBasedDatasource):
    """WebDataset tar shards (reference: read_api.py:1840 read_webdataset,
    _internal/datasource/webdataset_datasource.py — which wraps the
    webdataset library's tar iterator; here the format is read directly:
    a sample is the run of consecutive tar members sharing a basename up
    to its first dot, fields keyed by the remaining extension)."""

    _suffixes = [".tar"]

    def _read_file(self, path: str, decoder=True, fileselect=None,
                   filerename=None, suffixes=None, include_paths=False,
                   **kw) -> Block:
        import tarfile

        def renamed(ext: str) -> str:
            if callable(filerename):
                return filerename(ext)
            for old, new in filerename or []:
                if ext == old:
                    return new
            return ext

        def keep(ext: str) -> bool:
            for flt in (fileselect, suffixes):
                if flt is None:
                    continue
                if callable(flt) and not flt(ext):
                    return False
                if isinstance(flt, (list, tuple, set)):
                    # suffix-match like the reference: "png" keeps both
                    # "png" and compound extensions like "seg.png"
                    if not any(ext == s or ext.endswith("." + s)
                               for s in flt):
                        return False
            return True

        rows: List[dict] = []

        def flush(key, fields):
            if key is None or not fields:
                return
            row = {"__key__": key}
            if include_paths:
                row["__url__"] = path
            row.update(fields)
            rows.append(row)

        # custom decoders (single callable or a chain) see the RAW bytes
        # sample — default per-extension decoding applies only when
        # decoder is True
        custom = callable(decoder) or isinstance(decoder, (list, tuple))

        with _open(path) as f, tarfile.open(fileobj=f, mode="r|*") as tf:
            cur_key, cur = None, {}
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                name = name[2:] if name.startswith("./") else name
                dirpart, _, base = name.rpartition("/")
                if base.startswith("."):
                    continue
                # the key keeps the directory prefix (reference
                # base_plus_ext: two subdirs may reuse a basename and
                # must stay distinct samples); ext splits at the FIRST
                # dot of the basename only
                stem, _, ext = base.partition(".")
                key = f"{dirpart}/{stem}" if dirpart else stem
                # the key change must be observed BEFORE any field
                # filtering: a filtered-out member still delimits samples
                # (else two same-key runs separated only by filtered
                # members would silently merge)
                if key != cur_key:
                    flush(cur_key, cur)
                    cur_key, cur = key, {}
                ext = renamed(ext)
                if not ext or not keep(ext):
                    continue
                data = tf.extractfile(member).read()
                cur[ext] = (data if custom
                            else _wds_decode_field(ext, data, decoder))
            flush(cur_key, cur)
        if callable(decoder):
            rows = [decoder(r) for r in rows]
        elif isinstance(decoder, (list, tuple)):
            for fn in decoder:
                rows = [fn(r) for r in rows]
        return rows_to_block(rows)


def _wds_encode_field(ext: str, value) -> bytes:
    """Default per-field encoder for write_webdataset (reference:
    _internal/datasource/webdataset_datasink.py default_encoder)."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    base = ext.rsplit(".", 1)[-1].lower()
    if isinstance(value, np.generic) and not isinstance(value, np.ndarray):
        # arrow blocks yield numpy scalars (np.float32/np.bool_/...),
        # which neither the int branch nor json.dumps accepts
        value = value.item()
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, (bool, int)):
        return str(int(value)).encode("utf-8")
    if isinstance(value, np.ndarray) and base in _WDS_IMAGE_EXTS:
        import io as _io

        from PIL import Image

        fmt = {"png": "PNG", "jpg": "JPEG", "jpeg": "JPEG", "bmp": "BMP",
               "ppm": "PPM", "gif": "GIF"}[base]
        buf = _io.BytesIO()
        Image.fromarray(value).save(buf, format=fmt)
        return buf.getvalue()
    if isinstance(value, np.ndarray):
        import io as _io

        buf = _io.BytesIO()
        np.save(buf, value, allow_pickle=False)
        return buf.getvalue()
    import json as _json

    return _json.dumps(value).encode("utf-8")


class ImagesDatasource(FileBasedDatasource):
    """reference: python/ray/data/datasource/image_datasource.py"""

    _suffixes = [".png", ".jpg", ".jpeg", ".bmp", ".gif"]

    def _read_file(self, path: str, size=None, mode=None,
                   include_paths=False, **kw) -> Block:
        from PIL import Image

        from .block import batch_to_block

        with _open(path) as f:
            img = Image.open(f)
            img.load()
        if mode:
            img = img.convert(mode)
        if size:
            img = img.resize((size[1], size[0]))
        arr = np.asarray(img)
        batch = {"image": arr[None]}
        if include_paths:
            batch["path"] = np.array([path])
        return batch_to_block(batch)


class SQLDatasource(Datasource):
    """reference: python/ray/data/datasource/sql_datasource.py — any DB-API
    connection factory (sqlite3, psycopg2, ...)."""

    def __init__(self, sql: str, connection_factory):
        self._sql = sql
        self._factory = connection_factory

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        sql, factory = self._sql, self._factory

        def read():
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(sql)
                cols = [d[0] for d in cur.description]
                rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            finally:
                conn.close()
            yield rows_to_block(rows)

        return [ReadTask(read, BlockMetadata(num_rows=0, size_bytes=0))]
