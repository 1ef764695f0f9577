"""Cluster bootstrap: start/stop control plane + raylet processes.

Analog of the reference's node bootstrap (reference:
python/ray/_private/node.py:1354 start_head_processes,
services.py:1442 start_gcs_server, :1507 start_raylet).

The port's copy of ``ray_tpu/_private/bootstrap.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from . import common
from .protocol import Client, free_port

_SESSION_ROOT = "/dev/shm/ray_tpu_torch"


# how many fresh ports a daemon is started on before its failure to bind
# one is raised: free_port() releases the port it found, and under load
# another process can take it before the daemon binds it
BIND_ATTEMPTS = 3


class DaemonExited(RuntimeError):
    """A daemon process ended before it came up.  ``port_in_use`` when it
    could not bind its port."""

    def __init__(self, msg: str, port_in_use: bool):
        super().__init__(msg)
        self.port_in_use = port_in_use


def _log_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _check_alive(proc: Optional[subprocess.Popen], log: Tuple[str, int],
                 what: str, addr):
    """Raise ``DaemonExited`` with what the process wrote to its log
    since ``log``'s offset, if it has ended."""
    if proc is None or proc.poll() is None:
        return
    path, start = log
    try:
        with open(path, "rb") as f:
            f.seek(start)
            tail = f.read().decode(errors="replace")[-2000:]
    except OSError:
        tail = ""
    raise DaemonExited(
        f"{what} at {addr} exited with {proc.returncode} before it came "
        f"up: {tail}", port_in_use="Address already in use" in tail)


def _wait_ping(addr: Tuple[str, int], timeout: float = 30.0, what: str = "daemon",
               proc: Optional[subprocess.Popen] = None,
               log: Tuple[str, int] = ("", 0)):
    """Wait until ``addr`` answers a ping.  Given the daemon's ``proc``
    (and its log with the offset its output starts at), its end raises
    ``DaemonExited`` at once.  Another process that holds the port may
    answer the ping: a caller that must know it reached this daemon
    checks that another way (the control's addr-file, a raylet's
    registration)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        _check_alive(proc, log, what, addr)
        try:
            cli = Client(addr, connect_timeout=2.0)
            cli.call("ping", timeout=5.0)
            cli.close()
            return
        except Exception as e:
            last = e
            time.sleep(0.05)
    raise RuntimeError(f"{what} at {addr} did not come up: {last}")


class NodeHandle:
    def __init__(self, proc: subprocess.Popen, addr, node_id, session_dir):
        self.proc = proc
        self.addr = addr
        self.node_id = node_id
        self.session_dir = session_dir

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def terminate(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def _package_pythonpath() -> str:
    """PYTHONPATH entry that makes ray_tpu_torch importable in child processes
    even when the driver found it via sys.path manipulation."""
    import ray_tpu_torch

    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    parts = [pkg_parent] + ([existing] if existing else [])
    return os.pathsep.join(parts)


def _spawn(cmd: List[str], log_path: str, env: Optional[Dict[str, str]] = None):
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    out = open(log_path, "ab")
    proc = subprocess.Popen(
        cmd, stdout=out, stderr=out,
        env={**os.environ, "PYTHONPATH": _package_pythonpath(), **(env or {})},
        start_new_session=True)
    out.close()
    return proc


class Cluster:
    """A local cluster: one control server + N raylets (each its own
    process).  The workhorse for tests, like the reference's
    ray.cluster_utils.Cluster (reference: python/ray/cluster_utils.py:135)."""

    def __init__(self, session_name: Optional[str] = None):
        self.session_name = session_name or f"session-{int(time.time()*1000)}-{os.getpid()}"
        self.session_dir = os.path.join(_SESSION_ROOT, self.session_name)
        os.makedirs(self.session_dir, exist_ok=True)
        self.log_dir = os.path.join(self.session_dir, "logs")
        self.control_proc: Optional[subprocess.Popen] = None
        self.standby_proc: Optional[subprocess.Popen] = None
        self.control_addr: Optional[Tuple[str, int]] = None
        self.nodes: List[NodeHandle] = []
        self._n = 0

    def start_control(self) -> Tuple[str, int]:
        log = os.path.join(self.log_dir, "control.log")
        for attempt in range(BIND_ATTEMPTS):
            port = free_port()
            start = _log_size(log)
            self._spawn_control(port)
            self.control_addr = ("127.0.0.1", port)
            try:
                # the control names its address in the addr-file once it
                # has bound it: only then is a ping answered by this one
                deadline = time.monotonic() + 30.0
                while common.read_addr_file(self.control_addr_file) \
                        != self.control_addr:
                    _check_alive(self.control_proc, (log, start),
                                 "control plane", self.control_addr)
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"control plane at {self.control_addr} did not "
                            f"write {self.control_addr_file}")
                    time.sleep(0.05)
                _wait_ping(self.control_addr, what="control plane",
                           proc=self.control_proc, log=(log, start))
                return self.control_addr
            except DaemonExited as e:
                if not e.port_in_use or attempt + 1 == BIND_ATTEMPTS:
                    raise

    @property
    def control_addr_file(self) -> str:
        return os.path.join(self.session_dir, "control_addr")

    def _spawn_control(self, port: int):
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.control",
               "--host", "127.0.0.1", "--port", str(port),
               "--addr-file", self.control_addr_file]
        # RAY_TPU_TORCH_CONTROL_PERSIST also works via inherited env; the flag
        # keeps the subprocess's configuration visible in `ps`
        persist = os.environ.get("RAY_TPU_TORCH_CONTROL_PERSIST")
        if persist:
            cmd += ["--persist", persist]
        self.control_proc = _spawn(
            cmd, os.path.join(self.log_dir, "control.log"))

    def start_standby(self) -> "subprocess.Popen":
        """Spawn a warm-standby controller: it watches the primary and,
        when the primary stops answering, loads the persisted state,
        starts serving on its own port, and rewrites the addr-file —
        raylets and drivers re-home to it on their next reconnect
        (reference analog: Redis-backed GCS fault tolerance, promoted
        to an active standby)."""
        assert self.control_addr is not None, "start_control() first"
        persist = os.environ.get("RAY_TPU_TORCH_CONTROL_PERSIST")
        assert persist, "standby needs RAY_TPU_TORCH_CONTROL_PERSIST"
        self.standby_port = free_port()
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.control",
               "--host", "127.0.0.1", "--port", str(self.standby_port),
               "--persist", persist,
               "--addr-file", self.control_addr_file,
               "--standby-of",
               f"{self.control_addr[0]}:{self.control_addr[1]}"]
        self.standby_proc = _spawn(
            cmd, os.path.join(self.log_dir, "control-standby.log"))
        return self.standby_proc

    def kill_control(self):
        """Hard-kill the control daemon (GCS failure injection)."""
        if self.control_proc is not None and self.control_proc.poll() is None:
            self.control_proc.kill()
            self.control_proc.wait(timeout=10)

    def restart_control(self):
        """Bring the control daemon back on the same address (reference:
        GCS restart under fault tolerance — ha_integration tests)."""
        assert self.control_addr is not None, "start_control() first"
        self.kill_control()
        self._spawn_control(self.control_addr[1])
        _wait_ping(self.control_addr, what="control plane")
        return self.control_addr

    def add_node(self, resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 wait: bool = True,
                 control_addr: Optional[Tuple[str, int]] = None,
                 use_addr_file: bool = True) -> NodeHandle:
        """control_addr/use_addr_file let partition tests route a raylet
        through a fault-injection proxy (test_utils.SocketProxy): the
        proxy address replaces the real control address, and the addr
        file is withheld so reconnects can't re-home around the fault."""
        assert self.control_addr is not None, "start_control() first"
        self._n += 1
        nid = common.node_id()
        node_session = os.path.join(self.session_dir, f"node-{self._n}")
        ctrl = tuple(control_addr) if control_addr else self.control_addr
        env = {}
        if labels:
            env["RAY_TPU_TORCH_NODE_LABELS"] = json.dumps(labels)
        log = os.path.join(self.log_dir, f"raylet-{self._n}.log")
        for attempt in range(BIND_ATTEMPTS):
            port = free_port()
            cmd = [sys.executable, "-m", "ray_tpu_torch._private.node",
                   "--control", f"{ctrl[0]}:{ctrl[1]}",
                   "--host", "127.0.0.1", "--port", str(port),
                   "--node-id", nid, "--session-dir", node_session]
            if use_addr_file:
                cmd += ["--addr-file", self.control_addr_file]
            if resources is not None:
                cmd += ["--resources", json.dumps(resources)]
            start = _log_size(log)
            proc = _spawn(cmd, log, env)
            h = NodeHandle(proc, ("127.0.0.1", port), nid, node_session)
            self.nodes.append(h)
            if not wait:
                break
            try:
                _wait_ping(h.addr, what="raylet", proc=proc,
                           log=(log, start))
                # The raylet answers ping before its register_node
                # round-trip completes; callers doing
                # get_nodes/report_draining right after add_node raced
                # that window.  Wait for the control plane's view too
                # (skipped for proxy-routed raylets, whose registration
                # may be deliberately severed mid-flight); it also shows
                # that the ping was answered by this raylet.
                if control_addr is None:
                    self._wait_registered(nid, proc=proc, log=(log, start))
                break
            except DaemonExited as e:
                if not e.port_in_use or attempt + 1 == BIND_ATTEMPTS:
                    raise
                self.nodes.remove(h)
        return h

    def _wait_registered(self, nid: str, timeout_s: float = 30.0,
                         proc: Optional[subprocess.Popen] = None,
                         log: Tuple[str, int] = ("", 0)):
        deadline = time.monotonic() + timeout_s
        last: object = None
        while time.monotonic() < deadline:
            _check_alive(proc, log, f"raylet {nid}", self.control_addr)
            try:
                cli = Client(self.control_addr, connect_timeout=2.0)
                nodes = cli.call("get_nodes", timeout=5.0)
                cli.close()
                if any(n.get("node_id") == nid for n in nodes):
                    return
            except Exception as e:
                last = e
            time.sleep(0.05)
        raise RuntimeError(
            f"raylet {nid} never appeared in control get_nodes: {last}")

    def remove_node(self, h: NodeHandle, graceful: bool = False):
        if graceful:
            h.terminate()
        else:
            h.kill()
        if h in self.nodes:
            self.nodes.remove(h)

    def shutdown(self):
        for h in list(self.nodes):
            h.terminate()
        self.nodes.clear()
        if self.standby_proc is not None and self.standby_proc.poll() is None:
            self.standby_proc.kill()
            try:
                self.standby_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        self.standby_proc = None
        if self.control_proc is not None and self.control_proc.poll() is None:
            self.control_proc.terminate()
            try:
                self.control_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.control_proc.kill()
        self.control_proc = None
        if os.environ.get("RAY_TPU_TORCH_KEEP_SESSION"):
            return  # debugging: leave logs + store on disk
        import shutil

        shutil.rmtree(self.session_dir, ignore_errors=True)


# global session for ray_tpu_torch.init()
_cluster: Optional[Cluster] = None


def start_local(num_cpus=None, num_gpus=None, resources=None) -> Tuple[Cluster, NodeHandle]:
    global _cluster
    c = Cluster()
    res = None
    if num_cpus is not None or num_gpus is not None or resources is not None:
        from . import accelerators

        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus if num_cpus is not None
                                    else (os.cpu_count() or 1)))
        gpus = num_gpus if num_gpus is not None else accelerators.num_gpus()
        if gpus:
            res.setdefault(common.GPU, float(gpus))
    try:
        c.start_control()
        node = c.add_node(resources=res)
    except BaseException:
        c.shutdown()    # a failed start leaves no daemon running
        raise
    _cluster = c
    return c, node
