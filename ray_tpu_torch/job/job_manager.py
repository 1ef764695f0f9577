"""Job submission: per-job supervisor actor driving a subprocess.

Analog of the reference's job subsystem (reference:
python/ray/dashboard/modules/job/job_manager.py,
job_supervisor.py): ``submit_job`` creates a detached ``JobSupervisor``
actor that Popens the entrypoint with the cluster address injected, streams
its output into a bounded in-actor log buffer, and records status
transitions (PENDING -> RUNNING -> SUCCEEDED | FAILED | STOPPED) in the
control-plane KV store under the ``_jobs`` namespace so any client can read
them without touching the supervisor.

The port's copy of ``ray_tpu/job/job_manager.py``: the job's driver finds
its cluster through ``RAY_TPU_TORCH_ADDRESS`` and its id in
``RAY_TPU_TORCH_SUBMISSION_ID``.  The HTTP mode
(``JobSubmissionClient("http://host:port")``) talks to the dashboard's
job routes (``dashboard/head.py``).
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

JOB_NS = "_jobs"
MAX_LOG_LINES = 20_000


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def _kv_put_job(core, submission_id: str, info: Dict[str, Any]):
    core.control.call("kv_put", {
        "ns": JOB_NS, "key": submission_id,
        "val": json.dumps(info).encode(),
    })


def _kv_get_job(core, submission_id: str) -> Optional[Dict[str, Any]]:
    raw = core.control.call("kv_get", {"ns": JOB_NS, "key": submission_id})
    return json.loads(raw) if raw else None


@ray_tpu_torch.remote
class JobSupervisor:
    """Owns one job subprocess (reference: job_supervisor.py).

    Detached so it outlives the submitting client; 0 CPU so it never
    competes with the job's own tasks for slots.
    """

    def __init__(self, submission_id: str, entrypoint: str,
                 control_address: str,
                 runtime_env: Optional[Dict[str, Any]] = None,
                 metadata: Optional[Dict[str, str]] = None):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.control_address = control_address
        self.runtime_env = runtime_env or {}
        self.metadata = metadata or {}
        self.proc: Optional[subprocess.Popen] = None
        self.logs: List[str] = []
        self.stopped = False
        self._lock = threading.Lock()

    def _core(self):
        from .._private.api import current_core

        return current_core()

    def _set_status(self, status: str, message: str = ""):
        info = _kv_get_job(self._core(), self.submission_id) or {}
        info.update(status=status, message=message)
        if status == JobStatus.RUNNING:
            info["start_time"] = time.time()
        if status in JobStatus.TERMINAL:
            info["end_time"] = time.time()
        _kv_put_job(self._core(), self.submission_id, info)
        try:
            # structured cluster event per transition (reference: the
            # job manager's event emission, dashboard event module)
            self._core().control.notify("report_event", {
                "severity": ("ERROR" if status == JobStatus.FAILED
                             else "INFO"),
                "source": "job", "event_type": status.lower(),
                "entity_id": self.submission_id,
                "message": (f"job {self.submission_id} {status}"
                            + (f": {message[:200]}" if message else "")),
            })
        except Exception:
            pass

    def run(self) -> str:
        """Run the entrypoint to completion; returns the terminal status."""
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self.control_address
        env["RAY_TPU_TORCH_SUBMISSION_ID"] = self.submission_id
        env.update(self.runtime_env.get("env_vars") or {})
        cwd = self.runtime_env.get("working_dir") or None
        self._set_status(JobStatus.RUNNING)
        try:
            with self._lock:
                if self.stopped:
                    self._set_status(JobStatus.STOPPED)
                    return JobStatus.STOPPED
                self.proc = subprocess.Popen(
                    self.entrypoint, shell=True, cwd=cwd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, start_new_session=True)
            for line in self.proc.stdout:
                self.logs.append(line)
                if len(self.logs) > MAX_LOG_LINES:
                    del self.logs[: MAX_LOG_LINES // 10]
            rc = self.proc.wait()
        except Exception as e:
            self._set_status(JobStatus.FAILED, f"supervisor error: {e}")
            return JobStatus.FAILED
        if self.stopped:
            status = JobStatus.STOPPED
        elif rc == 0:
            status = JobStatus.SUCCEEDED
        else:
            status = JobStatus.FAILED
        self._set_status(status, f"exit code {rc}")
        return status

    def stop(self) -> bool:
        with self._lock:
            self.stopped = True
            if self.proc is not None and self.proc.poll() is None:
                try:
                    os.killpg(os.getpgid(self.proc.pid), 15)
                except ProcessLookupError:
                    pass
                return True
        return False

    def get_logs(self) -> str:
        return "".join(self.logs)

    def ping(self) -> bool:
        return True


class JobSubmissionClient:
    """Submit and manage jobs (reference: python/ray/dashboard/modules/job/
    sdk.py JobSubmissionClient).  ``address`` is the control-plane address;
    with None, uses the already-initialized driver connection."""

    def __init__(self, address: Optional[str] = None):
        self._http: Optional[str] = None
        if address and address.startswith("http"):
            # REST mode against the dashboard job API (reference:
            # JobSubmissionClient("http://...") -> job_head.py routes)
            self._http = address.rstrip("/")
            return
        if not ray_tpu_torch.is_initialized():
            # tolerate a concurrent initializer (dashboard handler
            # threads race on first job request)
            ray_tpu_torch.init(address=address, ignore_reinit_error=True)
        from .._private.api import current_core

        self._core = current_core()
        info = ray_tpu_torch.connection_info()
        self._control_address = info["control_address"]

    def _rest(self, method: str, path: str, body=None):
        import json as _json
        from urllib.request import Request, urlopen

        data = _json.dumps(body).encode() if body is not None else None
        req = Request(self._http + path, data=data, method=method,
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=60) as resp:
            return _json.loads(resp.read().decode())

    # -- API ---------------------------------------------------------------

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        if self._http:
            return self._rest("POST", "/api/jobs", {
                "entrypoint": entrypoint, "runtime_env": runtime_env,
                "submission_id": submission_id, "metadata": metadata,
            })["submission_id"]
        submission_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        _kv_put_job(self._core, submission_id, {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": JobStatus.PENDING,
            "submit_time": time.time(),
            "metadata": metadata or {},
        })
        # max_concurrency: run() blocks for the job's lifetime; stop()/
        # get_logs() must interleave (reference: async JobSupervisor)
        sup = JobSupervisor.options(
            name=f"_job_supervisor_{submission_id}", lifetime="detached",
            num_cpus=0, max_concurrency=4,
        ).remote(submission_id, entrypoint, self._control_address,
                 runtime_env, metadata)
        # fire-and-forget; the ref is owned by the supervisor's run itself
        sup.run.remote()
        self._supervisor_cache = getattr(self, "_supervisor_cache", {})
        self._supervisor_cache[submission_id] = sup
        return submission_id

    def _supervisor(self, submission_id: str):
        cache = getattr(self, "_supervisor_cache", {})
        if submission_id in cache:
            return cache[submission_id]
        return ray_tpu_torch.get_actor(f"_job_supervisor_{submission_id}")

    def get_job_status(self, submission_id: str) -> str:
        info = self.get_job_info(submission_id)
        return info["status"] if info else None

    def get_job_info(self, submission_id: str) -> Optional[Dict[str, Any]]:
        if self._http:
            from urllib.error import HTTPError

            try:
                return self._rest("GET", f"/api/jobs/{submission_id}")
            except HTTPError as e:
                if e.code == 404:
                    return None
                raise
        return _kv_get_job(self._core, submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        if self._http:
            return self._rest("GET",
                              f"/api/jobs/{submission_id}/logs")["logs"]
        try:
            return ray_tpu_torch.get(
                self._supervisor(submission_id).get_logs.remote(),
                timeout=30.0)
        except Exception:
            return ""

    def stop_job(self, submission_id: str) -> bool:
        if self._http:
            return self._rest("POST",
                              f"/api/jobs/{submission_id}/stop")["stopped"]
        try:
            return ray_tpu_torch.get(
                self._supervisor(submission_id).stop.remote(), timeout=30.0)
        except Exception:
            return False

    def list_jobs(self) -> List[Dict[str, Any]]:
        if self._http:
            return self._rest("GET", "/api/jobs")
        keys = self._core.control.call("kv_keys", {"ns": JOB_NS, "prefix": ""})
        out = []
        for k in keys:
            info = _kv_get_job(self._core, k)
            if info:
                out.append(info)
        return sorted(out, key=lambda j: j.get("submit_time", 0))

    def wait_until_finish(self, submission_id: str,
                          timeout: float = 300.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(submission_id)
            if st in JobStatus.TERMINAL:
                return st
            time.sleep(0.25)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")
