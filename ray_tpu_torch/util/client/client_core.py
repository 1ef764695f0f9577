"""ClientCore: a CoreWorker stand-in that proxies every operation to a
ClientServer over one TCP connection (reference: python/ray/util/client/
worker.py — the client-side Worker speaking the ray_client protocol).

Duck-types the subset of CoreWorker the API layer and libraries touch:
submit_task / create_actor / submit_actor_task / get / put / wait /
kill_actor / get_actor_by_name / as_future / the serialization ref hooks,
plus a forwarding `control` handle so control-plane consumers (placement
groups, collectives, state API, internal KV) work transparently.

The port's copy of ``ray_tpu/util/client/client_core.py``, with the
scheme ``ray-tpu-torch://``.  A CUDA tensor the server proxies arrives
as the object plane delivers it to any process: on this process's card
when it sees one (``serialization._receiving_device``).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ..._private import common, serialization
from ..._private.common import GetTimeoutError, RayTpuError
from ..._private.core import ObjectRef
from ..._private.protocol import Client, ConnectionLost

CLIENT_SCHEME = "ray-tpu-torch://"

_STREAM_POLL_SLICE = 30.0  # server-side bounded wait per poll


class ClientObjectRefGenerator:
    """Client-mode stand-in for ObjectRefGenerator: each item is fetched
    with bounded server polls (c_stream_next) so a silent stream never
    wedges a server pool thread.  Mirrors the direct-mode surface:
    __next__/next_ready/completed/async iteration/task_id."""

    def __init__(self, cc: "ClientCore", task_id: str):
        self._cc = cc
        self._task_id = task_id
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        ref = self._next(timeout=None)
        if ref is None:
            raise StopIteration
        return ref

    def next_ready(self, timeout: Optional[float] = None) -> ObjectRef:
        ref = self._next(timeout=timeout)
        if ref is None:
            raise StopIteration
        return ref

    def _next(self, timeout: Optional[float]) -> Optional[ObjectRef]:
        if self._done:
            return None
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        first = True
        while True:
            remaining = None if deadline is None \
                else deadline - _time.monotonic()
            if remaining is not None and remaining <= 0:
                # poll at least once: next_ready(0) must return an
                # already-buffered item (direct-mode _next_stream_item
                # checks st.ready before the deadline)
                if not first:
                    raise GetTimeoutError(
                        f"streaming task {self._task_id} produced no item "
                        f"in time")
                remaining = 0.0
            first = False
            poll = _STREAM_POLL_SLICE if remaining is None \
                else min(_STREAM_POLL_SLICE, remaining)
            r = self._cc._call(
                "c_stream_next",
                {"task_id": self._task_id, "timeout": poll},
                timeout=poll + 30.0)
            if r.get("done"):
                self._done = True
                return None
            if r.get("timeout"):
                continue
            return self._cc._mk_ref(r["ref"])

    def completed(self) -> bool:
        if self._done:
            return True
        # non-consuming server check: direct-mode completed() is True as
        # soon as the task is done and the buffer drained, even before
        # the user observes StopIteration
        try:
            return bool(self._cc._call(
                "c_stream_done", {"task_id": self._task_id}, timeout=30.0))
        except Exception:
            return self._done

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio

        loop = asyncio.get_running_loop()
        ref = await loop.run_in_executor(None, self._next, None)
        if ref is None:
            raise StopAsyncIteration
        return ref

    @property
    def task_id(self) -> str:
        return self._task_id

    def __del__(self):
        cc = self._cc
        if cc is not None and not self._done and not cc._shutdown:
            try:
                cc._client.notify("c_stream_release",
                                  {"task_id": self._task_id})
            except Exception:  # incl. ConnectionLost; never raise in __del__
                pass


def parse_client_address(address: str) -> Tuple[str, int]:
    hostport = address[len(CLIENT_SCHEME):]
    host, port = hostport.rsplit(":", 1)
    return host, int(port)


def _to_wire_ref(ref: ObjectRef):
    return (ref.id, ref.owner_addr, ref.owner_id)


class _ControlProxy:
    """Forwarding stand-in for CoreWorker.control (a protocol Client)."""

    def __init__(self, cc: "ClientCore"):
        self._cc = cc

    @property
    def addr(self):
        return self._cc._server_control_addr

    def call(self, method: str, payload: Any = None,
             timeout: Optional[float] = None):
        return self._cc._call("c_control", {"method": method,
                                            "payload": payload,
                                            "timeout": timeout},
                              timeout=(timeout or 60.0) + 30.0)

    def call_async(self, method: str, payload: Any = None):
        return self._cc._client.call_async(
            "c_control", {"method": method, "payload": payload,
                          "timeout": 60.0})

    def notify(self, method: str, payload: Any = None):
        try:
            self._cc._client.notify(
                "c_control_notify", {"method": method, "payload": payload})
        except OSError:
            pass

    @property
    def closed(self):
        return self._cc._shutdown


class ClientCore:
    mode = "client"

    def __init__(self, address: str, connect_timeout: float = 30.0):
        host, port = parse_client_address(address)
        self.worker_id = f"client-{uuid.uuid4().hex[:16]}"
        self.addr = None
        self.node_id = None  # client drivers live outside every node
        self._shutdown = False
        self.lock = threading.RLock()
        self._client = Client((host, port), name="ray-tpu-torch-client",
                              connect_timeout=connect_timeout,
                              on_disconnect=self._on_disconnect)
        hello = self._client.call("c_hello", {"client_id": self.worker_id},
                                  timeout=connect_timeout)
        self.job_id = hello["job_id"]
        self._server_control_addr = tuple(hello["control_addr"])
        self.control = _ControlProxy(self)

    # -- plumbing ----------------------------------------------------------

    def _on_disconnect(self):
        self._shutdown = True

    def _call(self, method: str, payload: Dict[str, Any],
              timeout: Optional[float] = None):
        if self._shutdown:
            raise RayTpuError("client connection closed")
        try:
            r = self._client.call(method, payload, timeout=timeout)
        except ConnectionLost as e:
            self._shutdown = True
            raise RayTpuError(f"client connection lost: {e}") from e
        if isinstance(r, dict) and r.get("__client_error__"):
            raise cloudpickle.loads(r["error_blob"])
        return r

    def _mk_ref(self, wire) -> ObjectRef:
        return ObjectRef(wire[0], wire[1], wire[2])

    # -- serialization hooks (duck-typed from CoreWorker) ------------------

    def _on_borrowed_ref(self, ref: ObjectRef):
        pass  # the server pins on our behalf

    def _pin_for_serialization(self, ref: ObjectRef):
        pass

    def _remove_local_ref(self, ref: ObjectRef):
        if self._shutdown:
            return
        try:
            self._client.notify("c_release", {"ids": [ref.id]})
        except OSError:
            pass

    # -- core API ----------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        blob = serialization.dumps_inline(value)
        wire = self._call("c_put", {"blob": blob}, timeout=300.0)
        return self._mk_ref(wire)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRefs, got {type(r)}")
        r = self._call("c_get", {"ids": [x.id for x in ref_list],
                                 "timeout": timeout},
                       timeout=None if timeout is None else timeout + 30.0)
        if r.get("timeout"):
            raise GetTimeoutError(r.get("error") or "get() timed out")
        values = serialization.loads_inline(r["blob"])
        return values[0] if single else values

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        r = self._call("c_wait", {"ids": [x.id for x in refs],
                                  "num_returns": num_returns,
                                  "timeout": timeout},
                       timeout=None if timeout is None else timeout + 30.0)
        ready_ids = set(r["ready"])
        ready = [x for x in refs if x.id in ready_ids]
        not_ready = [x for x in refs if x.id not in ready_ids]
        return ready, not_ready

    def as_future(self, ref: ObjectRef):
        from concurrent.futures import Future

        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.get(ref))
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def submit_task(self, fn, args, kwargs, *, num_returns=1, resources=None,
                    max_retries=3, strategy=None, pg=None, bundle_index=-1,
                    name="", runtime_env=None,
                    generator_backpressure=0) -> List[ObjectRef]:
        common._ensure_picklable_by_value(fn)
        if runtime_env:
            # package local dirs on the CLIENT machine; the server only
            # ever sees content-addressed pkg: URIs
            from ..._private import runtime_env as rtenv

            runtime_env = rtenv.prepare(runtime_env, self.control)
        payload = {
            "fn_blob": cloudpickle.dumps(fn),
            "args_blob": serialization.dumps_inline((args, kwargs)),
            "num_returns": num_returns,
            "resources": resources,
            "max_retries": max_retries,
            "strategy": strategy,
            "pg": pg,
            "bundle_index": bundle_index,
            "name": name,
            "runtime_env": runtime_env,
            "generator_backpressure": generator_backpressure,
        }
        wires = self._call("c_submit_task", payload, timeout=120.0)
        if isinstance(wires, dict) and "streaming" in wires:
            return [ClientObjectRefGenerator(self, wires["streaming"])]
        return [self._mk_ref(w) for w in wires]

    def create_actor(self, cls, args, kwargs, *, resources=None, name=None,
                     max_restarts=0, max_task_retries=0, max_concurrency=1,
                     pg=None, bundle_index=-1, detached=False,
                     runtime_env=None, namespace=None,
                     strategy=None) -> str:
        common._ensure_picklable_by_value(cls)
        if runtime_env:
            from ..._private import runtime_env as rtenv

            runtime_env = rtenv.prepare(runtime_env, self.control)
        payload = {
            "cls_blob": cloudpickle.dumps(cls),
            "args_blob": serialization.dumps_inline((args, kwargs)),
            "resources": resources,
            "name": name,
            "max_restarts": max_restarts,
            "max_task_retries": max_task_retries,
            "max_concurrency": max_concurrency,
            "pg": pg,
            "bundle_index": bundle_index,
            "detached": detached,
            "runtime_env": runtime_env,
            "namespace": namespace,
            "strategy": strategy,
        }
        return self._call("c_create_actor", payload, timeout=120.0)

    def submit_actor_task(self, actor_id: str, method_name: str, args,
                          kwargs, num_returns: int = 1,
                          generator_backpressure: int = 0
                          ) -> List[ObjectRef]:
        # the reference's copy takes no generator_backpressure, which its
        # api layer passes: every actor call through a client raised there
        payload = {
            "actor_id": actor_id,
            "method": method_name,
            "args_blob": serialization.dumps_inline((args, kwargs)),
            "num_returns": num_returns,
            "generator_backpressure": generator_backpressure,
        }
        wires = self._call("c_submit_actor_task", payload, timeout=120.0)
        if isinstance(wires, dict) and "streaming" in wires:
            return [ClientObjectRefGenerator(self, wires["streaming"])]
        return [self._mk_ref(w) for w in wires]

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        self._call("c_kill_actor", {"actor_id": actor_id,
                                    "no_restart": no_restart}, timeout=60.0)

    def get_actor_by_name(self, name: str, namespace=None):
        return self._call("c_get_actor_by_name",
                          {"name": name, "namespace": namespace},
                          timeout=60.0)

    def available_resources(self) -> Dict[str, float]:
        r = self.control.call("cluster_resources", {}, timeout=30.0)
        return r["available"]

    def cluster_resources(self) -> Dict[str, float]:
        r = self.control.call("cluster_resources", {}, timeout=30.0)
        return r["total"]

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        try:
            self._client.notify("c_bye", {})
        except OSError:
            pass
        self._client.close()
