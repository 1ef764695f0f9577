"""ray_tpu_torch-on-spark shim: the cases of tests/test_spark_shim.py
against ``ray_tpu_torch.util.spark`` (reference: python/ray/util/spark/
cluster_init.py, tested there against a local-mode Spark session; here
a thread-backed fake session supplies the duck-typed surface since
pyspark isn't a dependency).  A worker node offers cards as ``GPU``
(``num_gpus_worker_node``)."""

import threading

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import spark as spark_shim


class _FakeRDD:
    def __init__(self, sc, n_parts):
        self._sc = sc
        self._n = n_parts

    def mapPartitions(self, fn):
        self._fn = fn
        return self

    def collect(self):
        results = []
        threads = []

        def run(i):
            results.extend(self._fn(iter([i])))

        for i in range(self._n):
            t = threading.Thread(target=run, args=(i,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        return results


class _FakeSparkContext:
    defaultParallelism = 2

    def parallelize(self, seq, n):
        return _FakeRDD(self, n)

    def setJobGroup(self, *a, **k):
        pass

    def cancelJobGroup(self, group):
        pass  # fake spark can't interrupt threads; workers self-terminate


class _FakeSparkSession:
    sparkContext = _FakeSparkContext()


@pytest.fixture()
def fresh_globals():
    from ray_tpu_torch._private import core as core_mod

    prev_core = rt._core
    prev_cur = core_mod._current_core
    rt._core = None
    yield
    cc = rt._core
    if cc is not None and cc is not prev_core:
        try:
            cc.shutdown()
        except Exception:
            pass
    rt._core = prev_core
    core_mod._current_core = prev_cur


def test_setup_and_shutdown_ray_cluster(fresh_globals, tmp_path):
    addr, client_addr = spark_shim.setup_ray_cluster(
        max_worker_nodes=2, num_cpus_worker_node=1,
        ray_temp_root_dir=str(tmp_path), strict_mode=True,
        spark=_FakeSparkSession())
    try:
        assert client_addr.startswith("ray-tpu-torch://")
        # RAY_TPU_ADDRESS exported -> bare init() connects
        info = rt.init()
        assert info.get("client") is True

        @rt.remote
        def where():
            import socket
            return socket.gethostname()

        assert rt.get(where.remote(), timeout=60)
        # both spark "worker nodes" registered (+ head raylet)
        nodes = [n for n in rt.nodes() if n["state"] == "ALIVE"]
        assert len(nodes) == 3
        rt._core.shutdown()
        rt._core = None
    finally:
        spark_shim.shutdown_ray_cluster()
    with pytest.raises(RuntimeError, match="no active"):
        spark_shim.shutdown_ray_cluster()


def test_max_num_worker_nodes_uses_parallelism(fresh_globals, tmp_path):
    addr, _ = spark_shim.setup_ray_cluster(
        max_worker_nodes=spark_shim.MAX_NUM_WORKER_NODES,
        num_cpus_worker_node=1, ray_temp_root_dir=str(tmp_path),
        strict_mode=True, spark=_FakeSparkSession())
    try:
        info = rt.init()
        nodes = [n for n in rt.nodes() if n["state"] == "ALIVE"]
        # defaultParallelism=2 workers + head raylet
        assert len(nodes) == 3
        rt._core.shutdown()
        rt._core = None
    finally:
        spark_shim.shutdown_ray_cluster()


def test_second_cluster_rejected(fresh_globals, tmp_path):
    spark_shim.setup_ray_cluster(
        max_worker_nodes=1, num_cpus_worker_node=1,
        ray_temp_root_dir=str(tmp_path), spark=_FakeSparkSession())
    try:
        with pytest.raises(RuntimeError, match="active"):
            spark_shim.setup_ray_cluster(
                max_worker_nodes=1, spark=_FakeSparkSession())
    finally:
        spark_shim.shutdown_ray_cluster()


def test_bad_args_rejected():
    with pytest.raises(ValueError, match="positive"):
        spark_shim.setup_ray_cluster(max_worker_nodes=0,
                                     spark=_FakeSparkSession())
    with pytest.raises(ValueError, match="min_worker_nodes"):
        spark_shim.setup_ray_cluster(max_worker_nodes=2, min_worker_nodes=5,
                                     spark=_FakeSparkSession())


def test_failed_startup_cleans_up(fresh_globals, tmp_path, monkeypatch):
    """strict_mode timeout must not orphan head daemons or the worker job
    (workers self-terminate once the control plane is gone)."""
    monkeypatch.setattr(spark_shim, "_wait_workers",
                        lambda *a, **k: (_ for _ in ()).throw(
                            TimeoutError("no workers")))
    with pytest.raises(TimeoutError):
        spark_shim.setup_ray_cluster(
            max_worker_nodes=1, num_cpus_worker_node=1,
            ray_temp_root_dir=str(tmp_path), strict_mode=True,
            spark=_FakeSparkSession())
    assert spark_shim._active_cluster is None
    monkeypatch.undo()
    # a fresh cluster can start afterwards (no "active cluster" residue)
    spark_shim.setup_ray_cluster(
        max_worker_nodes=1, num_cpus_worker_node=1,
        ray_temp_root_dir=str(tmp_path), spark=_FakeSparkSession())
    spark_shim.shutdown_ray_cluster()


def test_worker_nodes_offer_gpus(fresh_globals, tmp_path):
    """``num_gpus_worker_node`` (the reference's ``num_tpus_worker_node``)
    becomes each worker raylet's GPU resource; the head offers none."""
    spark_shim.setup_ray_cluster(
        max_worker_nodes=2, num_cpus_worker_node=1, num_gpus_worker_node=1,
        ray_temp_root_dir=str(tmp_path), strict_mode=True,
        spark=_FakeSparkSession())
    try:
        rt.init()
        alive = [n for n in rt.nodes() if n["state"] == "ALIVE"]
        assert sorted(n["total"].get("GPU", 0) for n in alive) == \
            [0, 1.0, 1.0]
        assert rt.cluster_resources().get("GPU") == 2.0
        rt._core.shutdown()
        rt._core = None
    finally:
        spark_shim.shutdown_ray_cluster()
