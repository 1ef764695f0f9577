"""The port's local cluster starts its daemons on ports that ``free_port``
found and released: under load another process can take such a port
before the daemon binds it.  The control plane and a raylet that could
not bind their port start again on another one; a daemon that ended for
any other reason fails the start at once, with what it wrote.  The mesh
tests' gloo pool (``tests/_gloo_pool.py``) takes its rendezvous port the
same way and starts again on another one too."""

import os
import socket
import time

import pytest

from ray_tpu_torch._private import bootstrap
from ray_tpu_torch._private.protocol import Client


@pytest.fixture
def held_port():
    """A port some other process holds: it listens and answers nothing."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    s.listen(8)
    yield s.getsockname()[1]
    s.close()


def test_daemons_whose_port_was_taken_start_on_another(monkeypatch,
                                                       held_port):
    real = bootstrap.free_port
    # the control plane's first port and the raylet's first are taken
    ports = iter([held_port, real(), held_port, real()])
    monkeypatch.setattr(bootstrap, "free_port", lambda: next(ports))
    c = bootstrap.Cluster()
    try:
        c.start_control()
        h = c.add_node(resources={"CPU": 1.0})
        assert c.control_addr[1] != held_port
        assert h.addr[1] != held_port
        assert c.nodes == [h]
        cli = Client(c.control_addr, connect_timeout=2.0)
        nodes = cli.call("get_nodes", timeout=5.0)
        cli.close()
        assert [n["node_id"] for n in nodes] == [h.node_id]
        with open(f"{c.log_dir}/raylet-1.log") as f:
            assert "Address already in use" in f.read()
    finally:
        c.shutdown()


def test_a_daemon_that_ends_otherwise_fails_the_start_at_once(monkeypatch):
    """A raylet that ends for another reason than its port fails the
    start at once, and the failed start leaves no daemon running."""
    raylets, procs = [], []
    real_spawn = bootstrap._spawn

    def spawn(cmd, log_path, env=None):
        if "ray_tpu_torch._private.node" in cmd:
            cmd = [a.replace("_private.node", "_private.no_such_node")
                   for a in cmd]
            raylets.append(cmd)
        procs.append(real_spawn(cmd, log_path, env))
        return procs[-1]

    monkeypatch.setattr(bootstrap, "_spawn", spawn)
    t0 = time.monotonic()
    with pytest.raises(bootstrap.DaemonExited) as e:
        bootstrap.start_local(num_cpus=1)
    assert time.monotonic() - t0 < 20.0
    assert not e.value.port_in_use
    assert "no_such_node" in str(e.value)
    assert len(raylets) == 1 and len(procs) == 2
    for p in procs:
        assert p.wait(timeout=10) is not None


def test_the_gloo_pool_starts_on_another_port_when_its_first_is_taken(
        monkeypatch, held_port):
    import _gloo_pool

    real = _gloo_pool._free_port
    ports = iter([held_port, real()])
    monkeypatch.setattr(_gloo_pool, "_free_port", lambda: next(ports))
    pool = _gloo_pool.GlooPool(2)
    try:
        pids = pool.run(os.getpid)
        assert len(set(pids)) == 2 and os.getpid() not in pids
    finally:
        pool.close()
