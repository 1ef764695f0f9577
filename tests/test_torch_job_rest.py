"""Job submission over HTTP on the port: the cases of tests/test_job_rest.py
against ``ray_tpu_torch``'s dashboard and the http-mode
``JobSubmissionClient`` (reference: dashboard/modules/job/job_head.py REST
routes + sdk.py).  Polls carry deadlines; no fixed sleeps."""

import json
import time
import urllib.request

import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch.job.job_manager import JobStatus, JobSubmissionClient


@pytest.fixture(scope="module")
def ray_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def dashboard(ray_cluster):
    from ray_tpu_torch.dashboard.head import DashboardHead

    info = ray_tpu_torch.connection_info()
    head = DashboardHead(info["control_address"], port=0)
    head.start()
    yield head
    head.stop()


def test_submit_status_logs_over_rest(dashboard):
    client = JobSubmissionClient(dashboard.url)
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('REST-JOB-RAN')\"")
    assert sid.startswith("raysubmit_")

    deadline = time.time() + 120
    status = None
    while time.time() < deadline:
        status = client.get_job_status(sid)
        if status in JobStatus.TERMINAL:
            break
        time.sleep(0.5)
    assert status == JobStatus.SUCCEEDED, status
    assert "REST-JOB-RAN" in client.get_job_logs(sid)
    assert any(j["submission_id"] == sid for j in client.list_jobs())


def test_stop_job_over_rest(dashboard):
    client = JobSubmissionClient(dashboard.url)
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(60)\"")
    deadline = time.time() + 60
    while time.time() < deadline:
        if client.get_job_status(sid) == JobStatus.RUNNING:
            break
        time.sleep(0.25)
    assert client.stop_job(sid)
    deadline = time.time() + 60
    while time.time() < deadline:
        if client.get_job_status(sid) in JobStatus.TERMINAL:
            break
        time.sleep(0.5)
    assert client.get_job_status(sid) == JobStatus.STOPPED


def test_rest_errors(dashboard):
    # unknown job -> 404 -> None
    client = JobSubmissionClient(dashboard.url)
    assert client.get_job_info("raysubmit_nope") is None
    # missing entrypoint -> 400
    req = urllib.request.Request(
        dashboard.url + "/api/jobs", data=json.dumps({}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
