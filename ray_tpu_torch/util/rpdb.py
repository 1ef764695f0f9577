"""Distributed pdb: breakpoints inside remote tasks/actors.

Reference: python/ray/util/rpdb.py + the `ray debug` CLI — a task calls
``set_trace()``, which opens a TCP socket, registers the active
breakpoint in the control KV, and serves a pdb session over the socket;
``python -m ray_tpu_torch debug`` lists active breakpoints and attaches
the terminal.  The port's copy of ``ray_tpu/util/rpdb.py``.
"""

from __future__ import annotations

import json
import os
import pdb
import socket
import sys
import time
import uuid
from typing import Any, Dict, List, Optional

KV_NS = "_breakpoints"


def set_trace() -> None:
    """Block until a debugger client attaches, then drop into pdb in the
    caller's frame, with I/O over the socket."""
    from .._private.core import current_core

    core = current_core()
    # bind the interface this worker serves RPC on, not loopback — the
    # attaching CLI may run on another node (reference rpdb binds the
    # node ip)
    host = core.addr[0] if getattr(core, "addr", None) else "127.0.0.1"
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind((host, 0))
    srv.listen(1)
    bp_id = f"bp-{uuid.uuid4().hex[:10]}"
    info = {
        "id": bp_id,
        "addr": list(srv.getsockname()),
        "pid": os.getpid(),
        "worker_id": core.worker_id,
        "ts": time.time(),
    }
    core.control.call("kv_put", {
        "ns": KV_NS, "key": bp_id,
        "val": json.dumps(info).encode(), "overwrite": True,
    }, timeout=30.0)
    try:
        conn, _ = srv.accept()
    finally:
        try:
            core.control.call("kv_del", {"ns": KV_NS, "key": bp_id},
                              timeout=10.0)
        except Exception:
            pass
        srv.close()
    fh = conn.makefile("rw", buffering=1)
    debugger = pdb.Pdb(stdin=fh, stdout=fh)
    debugger.use_rawinput = False
    debugger.set_trace(sys._getframe().f_back)


def list_breakpoints(control) -> List[Dict[str, Any]]:
    out = []
    try:
        keys = control.call("kv_keys", {"ns": KV_NS, "prefix": ""},
                            timeout=10.0)
        for k in keys:
            raw = control.call("kv_get", {"ns": KV_NS, "key": k},
                               timeout=10.0)
            if raw:
                out.append(json.loads(
                    raw.decode() if isinstance(raw, bytes) else raw))
    except Exception:
        pass
    return sorted(out, key=lambda b: b.get("ts", 0))


def attach(addr, stdin=None, stdout=None) -> None:
    """Bridge the local terminal to a breakpoint's pdb socket."""
    import threading

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    conn = socket.create_connection(tuple(addr), timeout=10)

    def pump_out():
        while True:
            data = conn.recv(4096)
            if not data:
                return
            stdout.write(data.decode(errors="replace"))
            stdout.flush()

    t = threading.Thread(target=pump_out, daemon=True)
    t.start()
    try:
        for line in stdin:
            conn.sendall(line.encode())
            if line.strip() in ("c", "continue", "q", "quit", "exit"):
                break
    finally:
        try:
            conn.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        t.join(timeout=2.0)
        conn.close()
