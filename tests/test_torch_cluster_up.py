"""`python -m ray_tpu_torch up <yaml>` / `down` on the port: the case of
tests/test_cluster_up.py (reference: scripts.py:1337 `ray up` +
autoscaler/_private/commands.py), the cluster launcher driving the
port's LocalNodeProvider.  The worker type offers a card as ``GPU`` (its
raylet takes it through ``--resources``); the driver's task asks for
none, so it runs here without one."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, *argv, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["RAY_TPU_TORCH_CLUSTER_FILE"] = str(tmp_path / "cluster.json")
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
        capture_output=True, text=True, timeout=timeout, env=env)


def test_up_and_down(tmp_path):
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text("""
cluster_name: testup
provider:
  type: local
  port: 0
head_node:
  resources: {CPU: 2}
worker_nodes:
  count: 1
  resources: {CPU: 1, GPU: 1}
  labels: {pool: extra}
""")
    up = _cli(tmp_path, "up", str(cfg))
    assert up.returncode == 0, up.stderr[-2000:]
    assert "1 head + 1 workers" in up.stdout

    info = json.loads((tmp_path / "cluster.json").read_text())
    addr = info["control_address"]
    try:
        # the launched cluster serves work, and its worker offers a card
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        drv = subprocess.run(
            [sys.executable, "-c", f"""
import ray_tpu_torch
ray_tpu_torch.init(address={addr!r})

@ray_tpu_torch.remote
def f():
    return "up-works"

assert ray_tpu_torch.get(f.remote(), timeout=90) == "up-works"
alive = [n for n in ray_tpu_torch.nodes() if n["state"] == "ALIVE"]
assert len(alive) == 2
assert sorted(n["total"].get("GPU", 0) for n in alive) == [0, 1.0], alive
ray_tpu_torch.shutdown()
print("OK")
"""],
            capture_output=True, text=True, timeout=150, env=env)
        assert drv.returncode == 0, drv.stderr[-2000:]
        assert "OK" in drv.stdout
    finally:
        down = _cli(tmp_path, "down")
        assert down.returncode == 0, down.stderr[-2000:]
    assert not (tmp_path / "cluster.json").exists()
