"""BigQuery / Mongo datasources against duck-typed fake clients
(reference: python/ray/data/tests/test_bigquery.py, test_mongo.py — the
reference mocks the google/pymongo clients the same way).

The fake classes are defined inside factory functions so cloudpickle
ships them BY VALUE into read-task workers (a module-level class would
pickle by reference to this test module, which workers can't import).

The port's mirror of tests/test_data_external.py, case by case, on one
cluster of the port's runtime for the module.
"""

import pyarrow as pa
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.external import BigQueryDatasource, MongoDatasource


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _bq_client_factory():
    """-> zero-arg factory producing a storage-API-shaped fake client
    over three pre-sharded streams of proj.ds.tbl."""

    def make():
        class Stream:
            def __init__(self, name):
                self.name = name

        class Session:
            def __init__(self, streams, rows):
                self.streams = streams
                self.estimated_row_count = rows
                self.estimated_total_bytes = rows * 16

        class RowReader:
            def __init__(self, table):
                self._t = table

            def to_arrow(self):
                return self._t

        class Client:
            shards = {
                "s0": pa.table({"x": [0, 1, 2]}),
                "s1": pa.table({"x": [3, 4]}),
                "s2": pa.table({"x": [5, 6, 7, 8]}),
            }

            def create_read_session(self, table, max_stream_count=0):
                assert table == "proj.ds.tbl"
                names = sorted(self.shards)
                if max_stream_count:
                    names = names[:max_stream_count]
                rows = sum(t.num_rows for t in self.shards.values())
                return Session([Stream(n) for n in names], rows)

            def read_rows(self, stream_name):
                return RowReader(self.shards[stream_name])

            def query(self, sql):
                assert "select" in sql.lower()
                return RowReader(pa.table({"q": [1, 2, 3]}))

        return Client()

    return make


def _mongo_client_factory(n=10):
    """-> uri-arg factory producing a pymongo-shaped fake client over
    an 'appdb.events' collection of n docs."""

    def make(uri):
        class Collection:
            docs = [{"_id": i, "v": i, "parity": i % 2} for i in range(n)]

            def estimated_document_count(self):
                return len(self.docs)

            def aggregate(self, stages):
                import random

                # no $sort stage => no order guarantee, like MongoDB
                rows = list(self.docs)
                random.Random(id(stages) & 0xffff).shuffle(rows)
                for st in stages:
                    if "$match" in st:
                        key, val = next(iter(st["$match"].items()))
                        rows = [r for r in rows if r.get(key) == val]
                    elif "$sort" in st:
                        key, direction = next(iter(st["$sort"].items()))
                        rows = sorted(rows, key=lambda r: r[key],
                                      reverse=direction < 0)
                    elif "$skip" in st:
                        rows = rows[st["$skip"]:]
                    elif "$limit" in st:
                        rows = rows[:st["$limit"]]
                return iter(rows)

        class Client:
            def __getitem__(self, db):
                assert db == "appdb"
                return {"events": Collection()}

        return Client()

    return make


# -- bigquery ----------------------------------------------------------------


def test_bigquery_table_read_parallel(ray_cluster):
    ds = rd.read_bigquery("proj", "ds.tbl",
                          client_factory=_bq_client_factory())
    assert sorted(r["x"] for r in ds.take_all()) == list(range(9))


def test_bigquery_plan_metadata():
    src = BigQueryDatasource("proj", "ds.tbl",
                             client_factory=_bq_client_factory())
    # estimates must NOT flow into plan_row_count (count() trusts it)
    assert src.plan_row_count() is None
    assert src.estimated_row_count() == 9
    assert src.estimate_inmemory_data_size() == 9 * 16
    # one read task per storage stream, capped by parallelism
    assert len(src.get_read_tasks(8)) == 3
    assert len(src.get_read_tasks(2)) == 2


def test_bigquery_query_read(ray_cluster):
    ds = rd.read_bigquery("proj", query="SELECT q FROM t",
                          client_factory=_bq_client_factory())
    assert sorted(r["q"] for r in ds.take_all()) == [1, 2, 3]


def test_bigquery_arg_validation():
    with pytest.raises(ValueError, match="exactly one"):
        BigQueryDatasource("proj")
    with pytest.raises(ValueError, match="exactly one"):
        BigQueryDatasource("proj", "ds.tbl", "SELECT 1")


# -- mongo -------------------------------------------------------------------


def test_mongo_partitioned_read(ray_cluster):
    ds = rd.read_mongo("mongodb://h", "appdb", "events",
                       client_factory=_mongo_client_factory(),
                       override_num_blocks=3)
    rows = ds.take_all()
    assert sorted(r["v"] for r in rows) == list(range(10))
    assert all("_id" not in r for r in rows)       # like the reference


def test_mongo_pipeline_pushdown(ray_cluster):
    ds = rd.read_mongo("mongodb://h", "appdb", "events",
                       pipeline=[{"$match": {"parity": 1}}],
                       client_factory=_mongo_client_factory())
    assert sorted(r["v"] for r in ds.take_all()) == [1, 3, 5, 7, 9]


def test_mongo_plan_metadata():
    src = MongoDatasource("mongodb://h", "appdb", "events",
                          client_factory=_mongo_client_factory())
    # estimated_document_count is not exact -> planning gets None
    assert src.plan_row_count() is None
    assert src.estimated_row_count() == 10
    tasks = src.get_read_tasks(4)
    assert len(tasks) == 4
    # windows tile the collection; last one is unbounded (undercount
    # protection) so blocks re-read nothing and drop nothing
    blocks = [blk for t in tasks for blk in t.read_fn()]
    got = sorted(v for b in blocks for v in b.column("v").to_pylist())
    assert got == list(range(10))


def test_missing_client_libs_raise_importerror():
    # bigquery defers its session (lazy datasets must not hit the
    # network at definition), so the ImportError surfaces on first use
    with pytest.raises(ImportError, match="google-cloud-bigquery"):
        BigQueryDatasource("proj", "ds.tbl").estimated_row_count()
    with pytest.raises(ImportError, match="pymongo"):
        rd.read_mongo("mongodb://h", "appdb", "events")
