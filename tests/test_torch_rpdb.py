"""Distributed debugger on the port's runtime: the case of
tests/test_rpdb.py — set_trace() in a task serves pdb over a socket
registered in the control KV (reference: python/ray/util/rpdb.py +
`ray debug`) — and ``python -m ray_tpu_torch debug`` attaching to it."""

import os
import socket
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import rpdb


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _recv_until(conn, marker: bytes, timeout: float = 30.0) -> bytes:
    conn.settimeout(timeout)
    buf = b""
    while marker not in buf:
        chunk = conn.recv(4096)
        if not chunk:
            break
        buf += chunk
    return buf


def test_breakpoint_in_task(cluster):
    @rt.remote
    def buggy():
        x = 41
        from ray_tpu_torch.util import rpdb as _rpdb

        _rpdb.set_trace()
        return x + 1

    ref = buggy.remote()

    core = rt._require()
    deadline = time.time() + 60
    bps = []
    while time.time() < deadline:
        bps = rpdb.list_breakpoints(core.control)
        if bps:
            break
        time.sleep(0.2)
    assert bps, "breakpoint never registered"

    conn = socket.create_connection(tuple(bps[0]["addr"]), timeout=10)
    try:
        out = _recv_until(conn, b"(Pdb)")
        assert b"(Pdb)" in out
        conn.sendall(b"p x\n")
        out = _recv_until(conn, b"(Pdb)")
        assert b"41" in out
        conn.sendall(b"c\n")
    finally:
        conn.close()

    assert rt.get(ref, timeout=60) == 42
    # deregistered once a client attached
    assert not rpdb.list_breakpoints(core.control)


def test_cli_debug_attaches_to_the_breakpoint(cluster):
    """``python -m ray_tpu_torch debug --address`` lists the breakpoint,
    attaches the terminal (here its stdin) and continues the task."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    core = rt._require()
    address = "%s:%d" % tuple(core.control.addr)

    def debug(stdin):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "debug", "--address",
             address], input=stdin, capture_output=True, text=True,
            timeout=120, env=env, cwd="/")

    r = debug("")
    assert r.returncode == 0, r.stderr
    assert "no active breakpoints" in r.stdout

    @rt.remote
    def paused():
        y = 99
        from ray_tpu_torch.util import rpdb as _rpdb

        _rpdb.set_trace()
        return y

    ref = paused.remote()
    deadline = time.time() + 60
    while time.time() < deadline and not rpdb.list_breakpoints(core.control):
        time.sleep(0.2)
    assert rpdb.list_breakpoints(core.control), "breakpoint never registered"
    r = debug("p y\nc\n")
    assert r.returncode == 0, r.stderr
    assert "[0] bp-" in r.stdout and "attaching to bp-" in r.stdout
    assert "99" in r.stdout.split("attaching to", 1)[1]
    assert rt.get(ref, timeout=60) == 99
    assert not rpdb.list_breakpoints(core.control)
