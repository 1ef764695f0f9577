"""Job submission + CLI on the port's runtime: the cases of
tests/test_job_cli.py against ``ray_tpu_torch.job`` and
``python -m ray_tpu_torch`` (reference: dashboard/modules/job,
scripts.py), plus what the port adds: ``job submit``,
``init(address="auto")`` against the CLI-started head, the flight
recorder's subcommands, and ``analyze`` against the port's own
baseline.  One cluster of the port's own per module; the CLI's head writes its cluster file under
the test's temporary directory."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.job import JobStatus, JobSubmissionClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_job_submit_success(cluster):
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job ran ok')\"")
    status = client.wait_until_finish(sid, timeout=60)
    assert status == JobStatus.SUCCEEDED
    assert "job ran ok" in client.get_job_logs(sid)
    info = client.get_job_info(sid)
    assert info["entrypoint"].endswith("\"print('job ran ok')\"")
    assert info["end_time"] >= info["start_time"]


def test_job_failure_reported(cluster):
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import sys; sys.exit(3)\"")
    assert client.wait_until_finish(sid, timeout=60) == JobStatus.FAILED
    assert "exit code 3" in client.get_job_info(sid)["message"]


def test_job_env_vars_and_listing(cluster):
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c "
                   "\"import os; print('VAL=' + os.environ['MY_TEST_VAR'])\"",
        runtime_env={"env_vars": {"MY_TEST_VAR": "hello42"}})
    assert client.wait_until_finish(sid, timeout=60) == JobStatus.SUCCEEDED
    assert "VAL=hello42" in client.get_job_logs(sid)
    jobs = client.list_jobs()
    assert any(j["submission_id"] == sid for j in jobs)


def test_job_uses_cluster(cluster):
    """The submitted driver connects back via RAY_TPU_TORCH_ADDRESS."""
    client = JobSubmissionClient()
    script = (
        "import os, ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"  # picks up RAY_TPU_TORCH_ADDRESS
        "@ray_tpu_torch.remote\n"
        "def f(x): return x * 2\n"
        "print('answer', ray_tpu_torch.get(f.remote(21)),"
        " os.environ['RAY_TPU_TORCH_SUBMISSION_ID'])\n"
    )
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"{script.replace(chr(34), chr(39))}\"")
    status = client.wait_until_finish(sid, timeout=120)
    logs = client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, logs
    assert f"answer 42 {sid}" in logs


def test_job_stop(cluster):
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(60)\"")
    # wait for RUNNING then stop
    deadline = time.time() + 30
    while time.time() < deadline:
        if client.get_job_status(sid) == JobStatus.RUNNING:
            break
        time.sleep(0.2)
    assert client.stop_job(sid)
    deadline = time.time() + 30
    while time.time() < deadline:
        if client.get_job_status(sid) in JobStatus.TERMINAL:
            break
        time.sleep(0.2)
    assert client.get_job_status(sid) == JobStatus.STOPPED


# -- CLI ---------------------------------------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture
def cluster_file(tmp_path, monkeypatch):
    path = str(tmp_path / "ray_current_cluster.json")
    monkeypatch.setenv("RAY_TPU_TORCH_CLUSTER_FILE", path)
    return path


def _cli(*args, check=True, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    if check and r.returncode != 0:
        raise AssertionError(
            f"CLI {args} failed rc={r.returncode}\n{r.stdout}\n{r.stderr}")
    return r


_AUTO_DRIVER = r"""
import ray_tpu_torch as rt
info = rt.init(address="auto")
@rt.remote
def f(x):
    return x + 1
print("AUTO", info["control_address"], rt.get(f.remote(41), timeout=60),
      rt.cluster_resources().get("GPU", 0.0))
rt.shutdown()
"""


def test_cli_start_status_stop(cluster_file):
    import ray_tpu_torch.scripts.cli as cli_mod

    assert cli_mod.cluster_file() == cluster_file
    port = _free_port()
    r = _cli("start", "--head", "--num-cpus", "2", "--num-gpus", "0",
             "--port", str(port))
    assert "started" in r.stdout
    try:
        info = json.load(open(cluster_file))
        assert info["control_address"] == f"127.0.0.1:{port}"
        r = _cli("status")
        assert "1 alive" in r.stdout
        # driver connects via auto
        r = _cli("list", "nodes", "--format", "json")
        nodes = json.loads(r.stdout)
        assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"

        # end-to-end submit through the CLI, both spellings
        r = _cli("submit", "--timeout", "90", "--",
                 sys.executable, "-c", "print(11*3)")
        assert "33" in r.stdout
        assert "SUCCEEDED" in r.stdout
        r = _cli("job", "submit", "--timeout", "90", "--",
                 sys.executable, "-c", "print(12*3)")
        assert "36" in r.stdout and "SUCCEEDED" in r.stdout
        sid = r.stdout.split("submitted job ", 1)[1].split()[0]
        assert _cli("job", "status", sid).stdout.strip() == "SUCCEEDED"
        assert "36" in _cli("job", "logs", sid).stdout

        # a driver finds the head through the cluster file
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("RAY_TPU_TORCH_ADDRESS", None)
        out = subprocess.run([sys.executable, "-c", _AUTO_DRIVER],
                             capture_output=True, text=True, timeout=120,
                             env=env, cwd="/")
        assert out.returncode == 0, out.stderr[-3000:]
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("AUTO ")][-1].split()
        assert line[1:] == [f"127.0.0.1:{port}", "42", "0.0"]
    finally:
        r = _cli("stop")
        assert "stopped" in r.stdout
    assert not os.path.exists(cluster_file)


@pytest.mark.parametrize("argv,item", [
    (("timeline", "--job", "trial"), "wrote"),
    (("trace", "--summary"), "trace(s), mean wall"),
    (("remediations", "trial"), "no remediation records for trial 'trial'"),
    (("device-stats",), "program ledger:"),
    (("analyze",), "analyze: 0 new"),
])
def test_unported_subcommands_name_their_item(cluster, cluster_file,
                                              tmp_path, argv, item):
    """The subcommands that came last to the port run: the flight
    recorder's (``timeline --job``, ``trace``, ``remediations``,
    ``device-stats``) against a live cluster, ``analyze`` (ROADMAP A.9)
    over ``ray_tpu_torch/`` against the port's own baseline, with no new
    finding."""
    if argv[0] == "analyze":
        r = _cli(*argv, timeout=180)
        assert item in r.stdout, (r.stdout, r.stderr)
        return
    addr = rt.connection_info()["control_address"]
    extra = ["-o", str(tmp_path / "t.json")] if argv[0] == "timeline" else []
    r = _cli(*argv, "--address", addr, *extra, timeout=60)
    assert item in r.stdout, (r.stdout, r.stderr)
    if argv[0] == "timeline":
        with open(tmp_path / "t.json") as f:
            assert json.load(f)["traceEvents"] == []


def test_auto_without_a_cluster_file_raises(cluster_file):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    out = subprocess.run(
        [sys.executable, "-c", "import ray_tpu_torch as rt; "
         "rt.init(address='auto')"], capture_output=True, text=True,
        timeout=60, env=env, cwd="/")
    assert out.returncode != 0
    assert "no running cluster found" in out.stderr
