"""External-service datasources: BigQuery and MongoDB.

reference: python/ray/data/read_api.py read_bigquery (:523) and
read_mongo (:423), python/ray/data/datasource/{bigquery,mongo}_datasource.py.

Both are written against DUCK-TYPED clients injected via
``client_factory`` (the same pattern as the GBDT/W&B shims): production
passes nothing and the real client library is imported lazily; tests
pass a fake with the same method surface and never touch the service.

Client surfaces consumed:

BigQuery (google.cloud.bigquery[_storage] shape):
  * query path:  client.query(sql).to_arrow() -> pyarrow.Table
  * table path:  client.create_read_session(table=..., max_stream_count=N)
                   -> session with .streams (list of objects with .name)
                      and optionally .estimated_row_count
                 client.read_rows(stream_name).to_arrow() -> pyarrow.Table

Mongo (pymongo shape):
  * client_factory(uri) -> client;  client[db][coll]
  * coll.estimated_document_count() -> int (plan-time metadata)
  * coll.aggregate(pipeline) -> iterable of dict rows
    (partitioned reads append $skip/$limit stages per task)

The port's copy of ``ray_tpu/data/external.py``, its imports on the port's
runtime; ROADMAP §C lists what differs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .datasource import (BlockMetadata, Datasource, ReadTask,
                         rows_to_block)


class BigQueryDatasource(Datasource):
    """Table reads fan out over the storage API's read streams (one
    read task per stream, the reference's parallelism unit); query
    reads run the query as one task (BigQuery parallelizes the query
    itself server-side)."""

    def __init__(self, project_id: str, dataset: Optional[str] = None,
                 query: Optional[str] = None,
                 client_factory: Optional[Callable[[], Any]] = None):
        if (dataset is None) == (query is None):
            raise ValueError("read_bigquery: pass exactly one of "
                             "dataset= ('dataset.table') or query=")
        self._project = project_id
        self._dataset = dataset
        self._query = query
        self._factory = client_factory or _default_bigquery_client
        self._session = None

    def _meta_session(self):
        """Lazy plan-time metadata session (one control call, no scan):
        constructing a never-executed lazy Dataset must not hit the
        network."""
        if self._session is None and self._query is None:
            self._session = self._factory().create_read_session(
                table=f"{self._project}.{self._dataset}",
                max_stream_count=0)
        return self._session

    def get_name(self) -> str:
        return "BigQuery"

    def plan_row_count(self) -> Optional[int]:
        # the session's row count is an ESTIMATE; the base contract
        # (datasource.py: "only return a number that is guaranteed
        # exact — Dataset.count() trusts it") forbids returning it
        return None

    def estimated_row_count(self) -> Optional[int]:
        n = getattr(self._meta_session(), "estimated_row_count", None)
        return int(n) if n is not None else None

    def estimate_inmemory_data_size(self) -> Optional[int]:
        n = getattr(self._meta_session(), "estimated_total_bytes", None)
        return int(n) if n is not None else None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory = self._factory
        if self._query is not None:
            query = self._query

            def read_query():
                yield factory().query(query).to_arrow()

            return [ReadTask(read_query,
                             BlockMetadata(num_rows=0, size_bytes=0))]

        client = factory()
        session = client.create_read_session(
            table=f"{self._project}.{self._dataset}",
            max_stream_count=max(1, parallelism))
        streams = list(getattr(session, "streams", []) or [])
        if not streams:
            return []
        est = getattr(session, "estimated_row_count", None)
        per = int(est) // len(streams) if est else 0

        def make(stream_name):
            def read():
                yield factory().read_rows(stream_name).to_arrow()
            return read

        return [ReadTask(make(getattr(s, "name", s)),
                         BlockMetadata(num_rows=per, size_bytes=0))
                for s in streams]


class MongoDatasource(Datasource):
    """Partitioned collection reads: each task runs the caller's
    aggregation pipeline with an appended $skip/$limit window (the
    windows tile the collection; MongoDB executes each server-side)."""

    def __init__(self, uri: str, database: str, collection: str,
                 pipeline: Optional[List[Dict]] = None,
                 client_factory: Optional[Callable[[str], Any]] = None):
        self._uri = uri
        self._db = database
        self._coll = collection
        self._pipeline = list(pipeline or [])
        self._factory = client_factory or _default_mongo_client
        coll = self._factory(uri)[database][collection]
        self._count = int(coll.estimated_document_count())

    def get_name(self) -> str:
        return "Mongo"

    def plan_row_count(self) -> Optional[int]:
        # estimated_document_count is metadata-fast but NOT exact (stale
        # after unclean shutdowns, sharded clusters) — the base contract
        # requires exactness, so planning gets None and count() scans
        return None

    def estimated_row_count(self) -> Optional[int]:
        return self._count if not self._pipeline else None

    #: pipeline stages after which document order is the stage's own
    #: (or undefined) — a leading _id sort no longer pins the windows
    _ORDER_DESTROYING = {"$sort", "$group", "$sample", "$unionWith",
                         "$unwind", "$project", "$unset",
                         "$replaceRoot", "$replaceWith"}

    def _partitionable(self) -> bool:
        return not any(set(st) & self._ORDER_DESTROYING
                       for st in self._pipeline)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        uri, db, coll_name = self._uri, self._db, self._coll
        pipeline, factory = self._pipeline, self._factory

        # Partitioned windows need a stable document order.  A LEADING
        # `$sort: {_id: 1}` walks the _id index (cheap, no in-memory
        # sort) and $match after it preserves order; pipelines with
        # order-destroying or _id-dropping stages can't be windowed
        # safely and fall back to ONE task (correct, not parallel —
        # the reference partitions on _id ranges with the same caveat).
        if not self._partitionable():
            def read_single():
                coll = factory(uri)[db][coll_name]
                rows = [{k: v for k, v in r.items() if k != "_id"}
                        for r in coll.aggregate(list(pipeline))]
                yield rows_to_block(rows)

            return [ReadTask(read_single,
                             BlockMetadata(num_rows=0, size_bytes=0))]

        n_tasks = max(1, min(parallelism, self._count or 1))
        base = (self._count // n_tasks) if self._count else 0
        tasks = []
        for i in range(n_tasks):
            skip = i * base
            # the last window is unbounded: estimated_document_count can
            # undercount a live collection, and rows must not be dropped
            limit = base if i < n_tasks - 1 else None

            def make(skip=skip, limit=limit):
                def read():
                    stages = [{"$sort": {"_id": 1}}, *pipeline,
                              {"$skip": skip}]
                    if limit is not None:
                        stages.append({"$limit": limit})
                    coll = factory(uri)[db][coll_name]
                    rows = [{k: v for k, v in r.items() if k != "_id"}
                            for r in coll.aggregate(stages)]
                    yield rows_to_block(rows)
                return read

            tasks.append(ReadTask(make(), BlockMetadata(
                num_rows=base if limit is not None else 0, size_bytes=0)))
        return tasks


def _default_bigquery_client():
    """Adapt the real google clients to the duck surface this module
    consumes (BigQueryReadClient's native API takes parent/proto args,
    not table strings, and queries live on a different client).  This
    adapter necessarily runs only where the google libraries exist —
    the gated environments the connectors exist for."""
    try:
        from google.cloud import bigquery  # type: ignore
        from google.cloud import bigquery_storage  # type: ignore
    except ImportError as e:
        raise ImportError(
            "read_bigquery requires google-cloud-bigquery[-storage] (not "
            "available in this environment) — or pass client_factory= "
            "with a compatible client") from e

    class _GoogleAdapter:
        def __init__(self):
            self._bq = bigquery.Client()
            self._storage = bigquery_storage.BigQueryReadClient()

        def query(self, sql):
            return self._bq.query(sql).result()   # RowIterator.to_arrow()

        def create_read_session(self, table, max_stream_count=0):
            project, dataset, tbl = table.split(".", 2)
            from google.cloud.bigquery_storage import types

            session = types.ReadSession(
                table=f"projects/{project}/datasets/{dataset}"
                      f"/tables/{tbl}",
                data_format=types.DataFormat.ARROW)
            return self._storage.create_read_session(
                parent=f"projects/{project}", read_session=session,
                max_stream_count=max_stream_count)

        def read_rows(self, stream_name):
            reader = self._storage.read_rows(stream_name)

            class _Rows:
                def to_arrow(self):
                    import pyarrow as pa

                    rows = reader.rows()
                    if hasattr(rows, "to_arrow"):
                        return rows.to_arrow()
                    return pa.Table.from_batches(
                        [p.to_arrow() for p in rows.pages])

            return _Rows()

    return _GoogleAdapter()


def _default_mongo_client(uri: str):
    try:
        import pymongo  # type: ignore
    except ImportError as e:
        raise ImportError(
            "read_mongo requires pymongo (not available in this "
            "environment) — or pass client_factory= with a compatible "
            "client") from e
    return pymongo.MongoClient(uri)
