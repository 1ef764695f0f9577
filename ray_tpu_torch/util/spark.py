"""Run a ray_tpu_torch cluster on a Spark cluster (reference:
python/ray/util/spark/cluster_init.py — setup_ray_cluster starts the head
on the Spark driver and worker nodes inside a background Spark job whose
tasks each host one raylet; shutdown cancels the job).

The head (control plane + optional head raylet + client server) runs in
the driver process's machine as subprocesses.  Worker raylets are started
by a long-running background Spark job: one Spark task per worker node,
each task spawning `ray_tpu_torch._private.node` pointed at the driver's
control address and blocking until the raylet exits (so cancelling the
Spark job group tears the workers down — the reference's
start_ray_node.py does the same).

pyspark is not a dependency: pass any session object with the duck-typed
`sparkContext.parallelize(n, n).mapPartitions(fn).collect()` +
`setJobGroup/cancelJobGroup` surface (tests use a local fake that runs
partitions in threads).

The port's copy of ``ray_tpu/util/spark.py``: it spawns
``ray_tpu_torch._private.control`` and ``.node``, reads
``RAY_TPU_TORCH_SPARK_DRIVER_HOST`` and exports ``RAY_TPU_TORCH_ADDRESS``,
and a worker node offers cards as ``GPU`` (``num_gpus_worker_node``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, Optional, Tuple

MAX_NUM_WORKER_NODES = -1

_active_cluster: Optional["RayClusterOnSpark"] = None
_setup_in_progress = False
_lock = threading.Lock()


def _free_port() -> int:
    from .._private.protocol import free_port

    return free_port()


def _driver_host() -> str:
    # the address spark executors use to reach the driver's machine;
    # single-machine (and fake-spark test) setups resolve to loopback
    return os.environ.get("RAY_TPU_TORCH_SPARK_DRIVER_HOST", "127.0.0.1")


def _make_worker_partition_fn(control_addr: str, resources_json: str,
                              collect_log_to_path: Optional[str]):
    """Build the function each Spark task runs: spawn one raylet against
    the head's control address and block until it exits (reference:
    start_ray_node.py — the task's lifetime IS the node's lifetime)."""

    def start_worker(iterator):
        import json
        import socket as _socket
        import subprocess as _sp
        import sys as _sys
        import tempfile
        import time as _time

        _ = list(iterator)  # consume the partition index
        cmd = [_sys.executable, "-m", "ray_tpu_torch._private.node",
               "--control", control_addr,
               "--host", "127.0.0.1", "--port", "0"]
        if resources_json:
            cmd += ["--resources", resources_json]
        log_dir = collect_log_to_path or tempfile.mkdtemp(
            prefix="ray-tpu-torch-spark-worker-")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(
            log_dir, f"raylet-{_socket.gethostname()}-{os.getpid()}.log")
        chost, cport = control_addr.rsplit(":", 1)
        with open(log_path, "ab") as log:
            proc = _sp.Popen(cmd, stdout=log, stderr=_sp.STDOUT,
                             start_new_session=True)
            try:
                # orphan prevention (reference: start_ray_node.py):
                # if the head's control plane stays unreachable the
                # cluster is gone — stop hosting the raylet.  This also
                # lets the whole job unwind when Spark can't interrupt
                # the task (our thread-based test fake can't).
                misses = 0
                while proc.poll() is None:
                    _time.sleep(1.0)
                    try:
                        s = _socket.create_connection(
                            (chost, int(cport)), timeout=2.0)
                        s.close()
                        misses = 0
                    except OSError:
                        misses += 1
                        if misses >= 3:
                            proc.terminate()
                            break
                proc.wait(timeout=15)
            finally:
                if proc.poll() is None:
                    proc.kill()
        return [json.dumps({"exit": proc.returncode, "log": log_path})]

    return start_worker


class RayClusterOnSpark:
    """Handle on a ray_tpu_torch cluster hosted by a Spark application
    (reference: cluster_init.py:73 RayClusterOnSpark)."""

    def __init__(self, spark, address: str, client_address: str,
                 head_procs, job_group: str, job_thread: threading.Thread):
        self.spark = spark
        self.address = address
        self.client_address = client_address
        self._head_procs = head_procs
        self._job_group = job_group
        self._job_thread = job_thread
        self._shutdown = False

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        try:
            self.spark.sparkContext.cancelJobGroup(self._job_group)
        except Exception:
            pass
        # head down first: workers also self-terminate on control loss,
        # so the job thread unwinds even when cancel can't interrupt it
        for p in reversed(self._head_procs):  # raylet first, control last
            try:
                if p.poll() is None:
                    p.terminate()
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
            except Exception:
                pass
        self._job_thread.join(timeout=30.0)
        # only clear the env we exported: a failed setup (or a user
        # pointing at some other cluster) must not lose their address
        if os.environ.get("RAY_TPU_TORCH_ADDRESS") == self.client_address \
                and self.client_address:
            os.environ.pop("RAY_TPU_TORCH_ADDRESS", None)


def _spawn_head(host: str, num_cpus_head_node: Optional[float],
                temp_root: Optional[str]):
    """Start control (+ a head raylet when the head has resources)."""
    env = dict(os.environ)
    procs = []
    port = _free_port()
    log_dir = temp_root or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), f"ray-tpu-torch-spark-{uuid.uuid4().hex[:8]}")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "control.log"), "ab") as log:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.control",
             "--host", host, "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True))
    control_addr = f"{host}:{port}"
    _wait_control(control_addr)
    # head raylet: 0 CPUs by default, like the reference (head should not
    # run compute tasks unless asked)
    import json as _json

    head_res = {"CPU": float(num_cpus_head_node or 0)}
    with open(os.path.join(log_dir, "raylet-head.log"), "ab") as log:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.node",
             "--control", control_addr, "--host", host, "--port", "0",
             "--resources", _json.dumps(head_res)],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True))
    return procs, control_addr, log_dir


def _wait_control(control_addr: str, timeout: float = 30.0):
    from .._private.protocol import Client

    host, port = control_addr.rsplit(":", 1)
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            c = Client((host, int(port)), name="spark-head-probe",
                       connect_timeout=2.0)
            c.call("ping", timeout=5.0)
            c.close()
            return
        except Exception as e:
            last = e
            time.sleep(0.2)
    raise TimeoutError(f"control plane did not come up at {control_addr}: "
                       f"{last}")


def setup_ray_cluster(
    *,
    max_worker_nodes: int,
    min_worker_nodes: Optional[int] = None,
    num_cpus_worker_node: Optional[float] = None,
    num_cpus_head_node: Optional[float] = None,
    num_gpus_worker_node: Optional[float] = None,
    head_node_options: Optional[Dict] = None,
    worker_node_options: Optional[Dict] = None,
    ray_temp_root_dir: Optional[str] = None,
    strict_mode: bool = False,
    collect_log_to_path: Optional[str] = None,
    spark=None,
) -> Tuple[str, str]:
    """Start a ray_tpu_torch cluster on the Spark application (reference:
    cluster_init.py:1190).  Returns (cluster_address, client_address);
    also exports RAY_TPU_TORCH_ADDRESS so a bare `ray_tpu_torch.init()` connects.

    num_gpus_worker_node (the reference's num_tpus_worker_node, itself
    the analog of Ray's num_gpus_worker_node) becomes each worker
    raylet's GPU resource.
    """
    global _active_cluster, _setup_in_progress
    with _lock:
        if _setup_in_progress or (
                _active_cluster is not None
                and not _active_cluster._shutdown):
            raise RuntimeError(
                "an active ray_tpu_torch-on-spark cluster (or setup in "
                "progress) exists; call shutdown_ray_cluster() first")
        _setup_in_progress = True
    try:
        return _setup_ray_cluster_locked(
            max_worker_nodes=max_worker_nodes,
            min_worker_nodes=min_worker_nodes,
            num_cpus_worker_node=num_cpus_worker_node,
            num_cpus_head_node=num_cpus_head_node,
            num_gpus_worker_node=num_gpus_worker_node,
            head_node_options=head_node_options,
            worker_node_options=worker_node_options,
            ray_temp_root_dir=ray_temp_root_dir,
            strict_mode=strict_mode,
            collect_log_to_path=collect_log_to_path,
            spark=spark)
    finally:
        with _lock:
            _setup_in_progress = False


def _setup_ray_cluster_locked(
    *,
    max_worker_nodes: int,
    min_worker_nodes: Optional[int],
    num_cpus_worker_node: Optional[float],
    num_cpus_head_node: Optional[float],
    num_gpus_worker_node: Optional[float],
    head_node_options: Optional[Dict],
    worker_node_options: Optional[Dict],
    ray_temp_root_dir: Optional[str],
    strict_mode: bool,
    collect_log_to_path: Optional[str],
    spark,
) -> Tuple[str, str]:
    global _active_cluster
    if spark is None:
        try:
            from pyspark.sql import SparkSession

            spark = SparkSession.getActiveSession()
        except ImportError as e:
            raise ImportError(
                "setup_ray_cluster needs a Spark session: install pyspark "
                "or pass spark=<session-like object>") from e
        if spark is None:
            raise RuntimeError("no active SparkSession found")

    n_workers = max_worker_nodes
    if n_workers == MAX_NUM_WORKER_NODES:
        n_workers = int(spark.sparkContext.defaultParallelism)
    if n_workers <= 0:
        raise ValueError(f"max_worker_nodes must be positive or "
                         f"MAX_NUM_WORKER_NODES, got {max_worker_nodes}")
    if min_worker_nodes is not None and not (
            0 <= min_worker_nodes <= n_workers):
        raise ValueError("min_worker_nodes must be in [0, max_worker_nodes]")

    host = _driver_host()
    head_procs, control_addr, log_dir = _spawn_head(
        host, num_cpus_head_node, ray_temp_root_dir)

    import json as _json

    res = {}
    if num_cpus_worker_node is not None:
        res["CPU"] = float(num_cpus_worker_node)
    if num_gpus_worker_node is not None:
        res["GPU"] = float(num_gpus_worker_node)
    resources_json = _json.dumps(res) if res else ""

    job_group = f"ray-tpu-torch-cluster-{uuid.uuid4().hex[:12]}"
    partition_fn = _make_worker_partition_fn(
        control_addr, resources_json, collect_log_to_path)

    def run_job():
        sc = spark.sparkContext
        try:
            sc.setJobGroup(job_group,
                           "ray_tpu_torch worker nodes (long-running)", True)
            sc.parallelize(list(range(n_workers)), n_workers) \
                .mapPartitions(partition_fn).collect()
        except Exception:
            pass  # cancelled at shutdown — expected

    t = threading.Thread(target=run_job, daemon=True,
                         name="ray-tpu-torch-spark-job")
    t.start()

    # wait for the workers to register (strict_mode: all of them;
    # otherwise min_worker_nodes — 0 means don't wait — defaulting to 1)
    want = n_workers if strict_mode else (
        min_worker_nodes if min_worker_nodes is not None else 1)
    try:
        if want > 0:
            _wait_workers(control_addr, want)

        client_port = _free_port()
        from .client import ClientServer

        chost, cport = control_addr.rsplit(":", 1)
        srv = ClientServer((chost, int(cport)), host=host, port=client_port)
        srv.start()
    except BaseException:
        # failed startup must not orphan the head daemons or leave the
        # background job hosting raylets (they self-terminate once the
        # control plane is gone)
        RayClusterOnSpark(spark, control_addr, "", head_procs,
                          job_group, t).shutdown()
        raise
    client_address = f"ray-tpu-torch://{host}:{client_port}"

    cluster = RayClusterOnSpark(spark, control_addr, client_address,
                                head_procs, job_group, t)
    cluster._client_server = srv
    with _lock:
        _active_cluster = cluster
    os.environ["RAY_TPU_TORCH_ADDRESS"] = client_address
    return control_addr, client_address


def _wait_workers(control_addr: str, want: int, timeout: float = 60.0):
    from .._private.protocol import Client

    host, port = control_addr.rsplit(":", 1)
    deadline = time.monotonic() + timeout
    c = Client((host, int(port)), name="spark-worker-wait")
    try:
        while time.monotonic() < deadline:
            nodes = c.call("get_nodes", timeout=10.0)
            # head raylet has 0 CPUs; count the worker raylets
            alive = [n for n in nodes if n["state"] == "ALIVE"]
            if len(alive) >= want + 1:  # +1: head raylet
                return
            time.sleep(0.3)
    finally:
        c.close()
    raise TimeoutError(
        f"{want} spark worker node(s) did not register within {timeout}s")


def setup_global_ray_cluster(*, max_worker_nodes: int,
                             is_blocking: bool = True, **kwargs):
    """Shared-mode cluster (reference: cluster_init.py:1357): same as
    setup_ray_cluster but intended to outlive the calling notebook; with
    is_blocking the call parks until interrupted."""
    addrs = setup_ray_cluster(max_worker_nodes=max_worker_nodes, **kwargs)
    if is_blocking:
        try:
            while _active_cluster is not None and not _active_cluster._shutdown:
                time.sleep(1.0)
        except KeyboardInterrupt:
            shutdown_ray_cluster()
    return addrs


def shutdown_ray_cluster() -> None:
    """Tear down the active cluster (reference: cluster_init.py:1659)."""
    global _active_cluster
    with _lock:
        cluster = _active_cluster
        _active_cluster = None
    if cluster is None:
        raise RuntimeError("no active ray_tpu_torch-on-spark cluster")
    srv = getattr(cluster, "_client_server", None)
    if srv is not None:
        try:
            srv.stop()
        except Exception:
            pass
    cluster.shutdown()
