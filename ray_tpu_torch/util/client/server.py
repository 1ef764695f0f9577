"""ClientServer: hosts a server-side proxied driver for remote clients
(reference: python/ray/util/client/server/ — proxier + server-side
specific drivers; see its ARCHITECTURE.md).

One CoreWorker driver serves all clients (objects it owns are pinned
per-client and released on c_release / disconnect); blocking operations
(get/wait/control) run on a worker pool so the RPC loop stays live.

The port's copy of ``ray_tpu/util/client/server.py``.  The server passes
values through: it deserializes what a client sends before it submits it,
and what the cluster returns before it serializes it for the client.  A
tensor staged from a card stays a host-side stand-in in this process
(its loads pass ``keep_stand_ins=True``) and is serialized again as what
it was, so it comes back to life on the card of the process that finally
reads it, bitwise, while the server imports no torch for it and opens no
CUDA context.  CPU tensors pass as the object plane passes them.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional, Tuple

import cloudpickle

from ..._private import serialization
from ..._private.common import GetTimeoutError
from ..._private.core import CoreWorker, ObjectRef
from ..._private.protocol import (Client, DaemonPool, Deferred, Server,
                                  ServerConn)

logger = logging.getLogger(__name__)


def _wire(ref: ObjectRef):
    return (ref.id, ref.owner_addr, ref.owner_id)


def _error_reply(e: BaseException):
    try:
        blob = cloudpickle.dumps(e)
    except Exception:
        blob = cloudpickle.dumps(RuntimeError(f"{type(e).__name__}: {e}"))
    return {"__client_error__": True, "error_blob": blob}


class ClientServer:
    """Accepts ray-tpu-torch:// clients and proxies them onto the
    cluster."""

    def __init__(self, control_addr: Tuple[str, int],
                 host: str = "127.0.0.1", port: int = 10001,
                 raylet_addr: Optional[Tuple[str, int]] = None):
        self.control_addr = tuple(control_addr)
        # locate a raylet + store like a normal driver would
        node_id = None
        store_root = None
        if raylet_addr is None:
            probe = Client(self.control_addr, name="client-server-probe")
            nodes = probe.call("get_nodes", timeout=30.0)
            probe.close()
            alive = [n for n in nodes if n["state"] == "ALIVE"]
            if alive:
                raylet_addr = tuple(alive[0]["addr"])
        if raylet_addr is not None:
            import os

            probe = Client(tuple(raylet_addr), name="client-server-probe2")
            info = probe.call("node_info", timeout=30.0)
            probe.close()
            node_id = info["node_id"]
            if os.path.isdir(info["store_root"]):
                store_root = info["store_root"]
        # a CUDA tensor passing through stays a stand-in in this server
        self.core = CoreWorker(self.control_addr, raylet_addr, mode="driver",
                               node_id=node_id, store_root=store_root,
                               keep_device_stand_ins=True)
        self.pool = DaemonPool(max_workers=32, name="client-server")
        self.lock = threading.Lock()
        # conn -> {object_id: ObjectRef} pins keeping client refs alive
        self.pins: Dict[ServerConn, Dict[str, ObjectRef]] = {}
        # conn -> {task_id: ObjectRefGenerator} live proxied streams
        self.streams: Dict[ServerConn, Dict[str, Any]] = {}

        s = self.server = Server(host, port, name="client-server")
        s.handle("c_hello", self.h_hello)
        s.handle("c_bye", lambda c, p: self._drop_conn(c))
        s.handle("c_put", self.h_put, deferred=True)
        s.handle("c_get", self.h_get, deferred=True)
        s.handle("c_wait", self.h_wait, deferred=True)
        s.handle("c_submit_task", self.h_submit_task, deferred=True)
        s.handle("c_create_actor", self.h_create_actor, deferred=True)
        s.handle("c_submit_actor_task", self.h_submit_actor_task,
                 deferred=True)
        s.handle("c_kill_actor", self.h_kill_actor, deferred=True)
        s.handle("c_get_actor_by_name", self.h_get_actor_by_name,
                 deferred=True)
        s.handle("c_release", self.h_release)
        s.handle("c_stream_next", self.h_stream_next, deferred=True)
        s.handle("c_stream_done", self.h_stream_done)
        s.handle("c_stream_release", self.h_stream_release)
        # cross-language surface (C++ client, cpp/): descriptor-named
        # functions, plain-value args/results — the same restriction the
        # reference places on cross-language calls (cross_language.py)
        s.handle("c_xput", self.h_xput, deferred=True)
        s.handle("c_xget", self.h_xget, deferred=True)
        s.handle("c_xsubmit_task", self.h_xsubmit_task, deferred=True)
        s.handle("c_xcreate_actor", self.h_xcreate_actor, deferred=True)
        s.handle("c_xsubmit_actor_task", self.h_xsubmit_actor_task,
                 deferred=True)
        s.handle("c_xwait", self.h_xwait, deferred=True)
        s.handle("c_xkill_actor", self.h_xkill_actor, deferred=True)
        s.handle("c_control", self.h_control, deferred=True)
        s.handle("c_control_notify", self.h_control_notify)
        s.on_disconnect(self._drop_conn)

    # -- lifecycle ---------------------------------------------------------

    def start(self, block: bool = False):
        self.server.start(thread=not block)

    @property
    def addr(self):
        return self.server.addr

    def stop(self):
        self.server.stop()
        self.core.shutdown()
        self.pool.shutdown()  # or its 32 worker threads outlive the server

    def _drop_conn(self, conn: ServerConn):
        with self.lock:
            self.pins.pop(conn, None)  # refs GC -> server releases objects
            gens = self.streams.pop(conn, None)
        if gens:
            for gen in gens.values():
                try:
                    self.core._release_stream(gen.task_id)
                except Exception:
                    pass

    def _pin(self, conn: ServerConn, refs):
        with self.lock:
            table = self.pins.setdefault(conn, {})
            for r in refs:
                table[r.id] = r

    def _deferred(self, d: Deferred, fn):
        def run():
            try:
                d.resolve(fn())
            except BaseException as e:
                d.resolve(_error_reply(e))

        self.pool.submit(run)

    # -- handlers ----------------------------------------------------------

    def h_hello(self, conn, p):
        with self.lock:
            self.pins.setdefault(conn, {})
        return {"job_id": self.core.job_id,
                "control_addr": self.core.control.addr}

    def h_put(self, conn, p, d: Deferred):
        def run():
            value = serialization.loads_inline(p["blob"], keep_stand_ins=True)
            ref = self.core.put(value)
            self._pin(conn, [ref])
            return _wire(ref)

        self._deferred(d, run)

    def _refs_from_ids(self, conn, ids):
        """Resolve client-sent ids to pinned ObjectRefs (an unpinned id can
        still be fetched by id if the object is alive server-side)."""
        with self.lock:
            table = self.pins.get(conn, {})
            out = []
            for oid in ids:
                r = table.get(oid)
                if r is None:
                    r = ObjectRef(oid, self.core.addr, self.core.worker_id)
                out.append(r)
            return out

    def h_get(self, conn, p, d: Deferred):
        def run():
            refs = self._refs_from_ids(conn, p["ids"])
            try:
                values = self.core.get(refs, timeout=p.get("timeout"))
            except GetTimeoutError as e:
                return {"timeout": True, "error": str(e)}
            return {"blob": serialization.dumps_inline(values)}

        self._deferred(d, run)

    def h_wait(self, conn, p, d: Deferred):
        def run():
            refs = self._refs_from_ids(conn, p["ids"])
            ready, _ = self.core.wait(refs,
                                      num_returns=p.get("num_returns", 1),
                                      timeout=p.get("timeout"))
            return {"ready": [r.id for r in ready]}

        self._deferred(d, run)

    def h_submit_task(self, conn, p, d: Deferred):
        def run():
            fn = cloudpickle.loads(p["fn_blob"])
            args, kwargs = serialization.loads_inline(
                p["args_blob"], keep_stand_ins=True)
            refs = self.core.submit_task(
                fn, args, kwargs,
                num_returns=p.get("num_returns", 1),
                resources=p.get("resources"),
                max_retries=p.get("max_retries", 3),
                strategy=p.get("strategy"), pg=p.get("pg"),
                bundle_index=p.get("bundle_index", -1),
                name=p.get("name", ""),
                runtime_env=p.get("runtime_env"),
                generator_backpressure=p.get("generator_backpressure", 0))
            if p.get("num_returns") == "streaming":
                return self._register_stream(conn, refs[0])
            self._pin(conn, refs)
            return [_wire(r) for r in refs]

        self._deferred(d, run)

    def _register_stream(self, conn, gen):
        with self.lock:
            self.streams.setdefault(conn, {})[gen.task_id] = gen
        return {"streaming": gen.task_id}

    def h_create_actor(self, conn, p, d: Deferred):
        def run():
            cls = cloudpickle.loads(p["cls_blob"])
            args, kwargs = serialization.loads_inline(
                p["args_blob"], keep_stand_ins=True)
            return self.core.create_actor(
                cls, args, kwargs,
                resources=p.get("resources"), name=p.get("name"),
                max_restarts=p.get("max_restarts", 0),
                max_task_retries=p.get("max_task_retries", 0),
                max_concurrency=p.get("max_concurrency", 1),
                pg=p.get("pg"), bundle_index=p.get("bundle_index", -1),
                detached=p.get("detached", False),
                runtime_env=p.get("runtime_env"),
                namespace=p.get("namespace"),
                strategy=p.get("strategy"))

        self._deferred(d, run)

    def h_submit_actor_task(self, conn, p, d: Deferred):
        def run():
            args, kwargs = serialization.loads_inline(
                p["args_blob"], keep_stand_ins=True)
            refs = self.core.submit_actor_task(
                p["actor_id"], p["method"], args, kwargs,
                num_returns=p.get("num_returns", 1),
                generator_backpressure=p.get("generator_backpressure", 0))
            if p.get("num_returns") == "streaming":
                return self._register_stream(conn, refs[0])
            self._pin(conn, refs)
            return [_wire(r) for r in refs]

        self._deferred(d, run)

    def h_stream_next(self, conn, p, d: Deferred):
        """One bounded poll for the next stream item: {"ref": wire} |
        {"done": True} | {"timeout": True}.  Runs on a dedicated thread
        (not the shared DaemonPool): a stream's 30 s wait slices would
        otherwise occupy pool workers at ~100% steady state and starve
        get/wait/submit deferreds once streams ≈ pool size."""

        def run():
            try:
                with self.lock:
                    gen = self.streams.get(conn, {}).get(p["task_id"])
                if gen is None:
                    d.resolve({"done": True})
                    return
                try:
                    ref = gen.next_ready(timeout=p.get("timeout", 30.0))
                except StopIteration:
                    with self.lock:
                        self.streams.get(conn, {}).pop(p["task_id"], None)
                    d.resolve({"done": True})
                    return
                except GetTimeoutError:
                    d.resolve({"timeout": True})
                    return
                self._pin(conn, [ref])
                d.resolve({"ref": _wire(ref)})
            except BaseException as e:
                d.resolve(_error_reply(e))

        threading.Thread(target=run, daemon=True,
                         name="client-stream-next").start()

    def h_stream_done(self, conn, p):
        """Non-consuming completed() check (direct-mode semantics: True
        once the task finished and the buffer drained)."""
        with self.lock:
            gen = self.streams.get(conn, {}).get(p["task_id"])
        return True if gen is None else gen.completed()

    def h_stream_release(self, conn, p):
        with self.lock:
            gen = self.streams.get(conn, {}).pop(p["task_id"], None)
        if gen is not None:
            try:
                self.core._release_stream(gen.task_id)
            except Exception:
                pass
        return True

    def h_kill_actor(self, conn, p, d: Deferred):
        self._deferred(d, lambda: self.core.kill_actor(
            p["actor_id"], no_restart=p.get("no_restart", True)))

    def h_get_actor_by_name(self, conn, p, d: Deferred):
        self._deferred(d, lambda: self.core.get_actor_by_name(
            p["name"], namespace=p.get("namespace")))

    def h_release(self, conn, p):
        with self.lock:
            table = self.pins.get(conn)
            if table:
                for oid in p.get("ids", ()):
                    table.pop(oid, None)
        return True

    # -- cross-language handlers (C++ user API, cpp/) ----------------------

    def _xdeferred(self, d: Deferred, fn):
        """Like _deferred but errors travel as protocol-level ERROR
        frames (plain strings) — foreign clients can't unpickle an
        exception blob."""

        def run():
            try:
                d.resolve(fn())
            except BaseException as e:
                d.reject(f"{type(e).__name__}: {e}")

        self.pool.submit(run)

    @staticmethod
    def _resolve_descriptor(descriptor: str):
        """ "pkg.mod:qualname" (or dotted fallback) -> Python object."""
        import importlib

        if ":" in descriptor:
            mod_name, qual = descriptor.split(":", 1)
        else:
            mod_name, _, qual = descriptor.rpartition(".")
            if not mod_name:
                raise ValueError(
                    f"bad cross-language descriptor {descriptor!r}; "
                    f"expected 'pkg.mod:qualname'")
        obj = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
        return obj

    @staticmethod
    def _check_plain(value, where: str):
        """Cross-language values must survive a foreign decoder."""
        if value is None or isinstance(value, (bool, int, float, str,
                                               bytes)):
            return
        if isinstance(value, (list, tuple, set)):
            for v in value:
                ClientServer._check_plain(v, where)
            return
        if isinstance(value, dict):
            for k, v in value.items():
                ClientServer._check_plain(k, where)
                ClientServer._check_plain(v, where)
            return
        raise TypeError(
            f"cross-language {where} must be plain "
            f"(None/bool/int/float/str/bytes/list/tuple/dict), "
            f"got {type(value).__name__}")

    def h_xput(self, conn, p, d: Deferred):
        def run():
            self._check_plain(p["value"], "put value")
            ref = self.core.put(p["value"])
            self._pin(conn, [ref])
            return _wire(ref)

        self._xdeferred(d, run)

    def h_xget(self, conn, p, d: Deferred):
        def run():
            refs = self._refs_from_ids(conn, p["ids"])
            try:
                values = self.core.get(refs, timeout=p.get("timeout"))
            except GetTimeoutError:
                return {"timeout": True}
            self._check_plain(values, "task result")
            return {"values": values}

        self._xdeferred(d, run)

    def h_xsubmit_task(self, conn, p, d: Deferred):
        def run():
            fn = self._resolve_descriptor(p["descriptor"])
            args = tuple(p.get("args") or ())
            self._check_plain(list(args), "task args")
            resources = p.get("resources")
            refs = self.core.submit_task(
                fn, args, {},
                num_returns=p.get("num_returns", 1),
                resources=dict(resources) if resources else None,
                max_retries=p.get("max_retries", 3),
                name=p.get("name") or "")
            self._pin(conn, refs)
            return [_wire(r) for r in refs]

        self._xdeferred(d, run)

    def h_xcreate_actor(self, conn, p, d: Deferred):
        def run():
            cls = self._resolve_descriptor(p["descriptor"])
            args = tuple(p.get("args") or ())
            self._check_plain(list(args), "actor args")
            resources = p.get("resources")
            return self.core.create_actor(
                cls, args, {},
                resources=dict(resources) if resources else None,
                name=p.get("name") or None)

        self._xdeferred(d, run)

    def h_xsubmit_actor_task(self, conn, p, d: Deferred):
        def run():
            args = tuple(p.get("args") or ())
            self._check_plain(list(args), "actor task args")
            refs = self.core.submit_actor_task(
                p["actor_id"], p["method"], args, {})
            self._pin(conn, refs)
            return [_wire(r) for r in refs]

        self._xdeferred(d, run)

    def h_xwait(self, conn, p, d: Deferred):
        """Like c_wait, but failures travel as ERROR frames a foreign
        client can read (c_wait's _error_reply is an unpicklable-to-C++
        blob that would read as an empty ready list)."""

        def run():
            refs = self._refs_from_ids(conn, p["ids"])
            num_returns = p.get("num_returns", 1)
            if num_returns > len(refs):
                raise ValueError("num_returns > len(refs)")
            ready, _ = self.core.wait(refs, num_returns=num_returns,
                                      timeout=p.get("timeout"))
            return {"ready": [r.id for r in ready]}

        self._xdeferred(d, run)

    def h_xkill_actor(self, conn, p, d: Deferred):
        self._xdeferred(d, lambda: self.core.kill_actor(
            p["actor_id"], no_restart=p.get("no_restart", True)))

    def h_control(self, conn, p, d: Deferred):
        self._deferred(d, lambda: self.core.control.call(
            p["method"], p.get("payload"), timeout=p.get("timeout") or 60.0))

    def h_control_notify(self, conn, p):
        try:
            self.core.control.notify(p["method"], p.get("payload"))
        except OSError:
            pass
        return True


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--control", required=True, help="host:port of control")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=10001)
    args = ap.parse_args()
    host, port = args.control.rsplit(":", 1)
    srv = ClientServer((host, int(port)), host=args.host, port=args.port)
    logger.info("client server on %s", srv.addr)
    srv.start(block=True)


if __name__ == "__main__":
    main()
