"""Real gRPC ingress for Serve (reference: serve/_private/proxy.py:558
gRPCProxy + grpc_util.py gRPCServer/DummyServicer).

Users register their OWN generated proto services: each entry of
`servicer_functions` is a standard `add_<Service>Servicer_to_server`
callable.  It is invoked against a pass-through dummy servicer, and the
server subclass rewrites every registered method handler to route into
Serve instead — the request still travels as the user's proto message,
the reply as raw serialized bytes — so ANY grpc client (any language)
that speaks the user's proto can call a deployment.

Routing: the target application comes from the `application` request
metadata (falling back to the single deployed app); the deployment
method is the RPC method name (falling back to __call__).  Requires
grpcio; `serve.start_grpc` raises ImportError without it.

The port's copy of ``ray_tpu/serve/_grpc.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Any, Dict, List, Optional

import ray_tpu_torch

from ._proxy import _ControllerTableCache
from ._router import get_router

logger = logging.getLogger("ray_tpu_torch.serve.grpc")


class _DummyServicer:
    """Accepts any method lookup (reference: grpc_util.py:73) — user
    add_*_to_server functions read handler callables off the servicer,
    which the server subclass discards and replaces with the router."""

    def __getattr__(self, attr):
        return None


def _set_unimplemented(context):
    import grpc

    context.set_code(grpc.StatusCode.UNIMPLEMENTED)
    context.set_details("client-streaming RPCs are not supported by the "
                        "serve gRPC ingress")


async def _unimplemented_unary(request_iter, context):
    _set_unimplemented(context)


async def _unimplemented_stream(request_iter, context):
    _set_unimplemented(context)
    return
    yield  # pragma: no cover - makes this an async generator


def _make_server(handler_factory):
    """grpc.aio server whose add_generic_rpc_handlers rewrites every
    user method handler onto the Serve router (reference:
    grpc_util.py:9 gRPCServer)."""
    from grpc.aio._server import Server

    class _ServeGrpcServer(Server):
        def add_generic_rpc_handlers(self, generic_rpc_handlers):
            for gh in generic_rpc_handlers:
                handlers = getattr(gh, "_method_handlers", None)
                if not handlers:
                    continue
                replaced = {}
                for service_method, mh in handlers.items():
                    replaced[service_method] = mh._replace(
                        # reply bytes pass through un-reserialized: the
                        # deployment returns the user's proto (or bytes)
                        response_serializer=None,
                        unary_unary=handler_factory(service_method,
                                                    stream=False),
                        unary_stream=handler_factory(service_method,
                                                     stream=True),
                        # client-streaming RPCs are not routed (yet):
                        # answer UNIMPLEMENTED instead of invoking the
                        # dummy servicer's None
                        stream_unary=_unimplemented_unary,
                        stream_stream=_unimplemented_stream,
                    )
                gh._method_handlers = replaced
            super().add_generic_rpc_handlers(generic_rpc_handlers)

    return _ServeGrpcServer(None, (), (), (), None, None)


def _to_wire(out: Any) -> bytes:
    if isinstance(out, (bytes, bytearray)):
        return bytes(out)
    ser = getattr(out, "SerializeToString", None)
    if ser is not None:
        return ser()
    raise TypeError(
        f"gRPC deployment replies must be proto messages or bytes, "
        f"got {type(out).__name__}")


class GrpcProxy:
    """Serve's gRPC ingress actor; `ready()` returns (host, port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 servicer_functions: Optional[List[Any]] = None,
                 servicer_blob: Optional[bytes] = None):
        import grpc

        if servicer_blob is not None:
            # pickled in the driver, opened HERE (the controller passes
            # the blob through untouched — no double deserialization)
            import cloudpickle

            servicer_functions = cloudpickle.loads(servicer_blob)

        self._table = _ControllerTableCache(
            "get_app_table", lambda t: dict(t["apps"]))
        self._loop = asyncio.new_event_loop()
        self._host = host
        self._bound_port: Optional[int] = None
        self._started = threading.Event()
        self._grpc = grpc
        self._server = None
        self._init_error: Optional[BaseException] = None

        def run():
            # grpc.aio server construction needs the thread's event loop
            # in place — build everything on the serving thread
            asyncio.set_event_loop(self._loop)
            try:
                server = _make_server(self._handler_factory)
                for fn in servicer_functions or []:
                    fn(_DummyServicer(), server)
                self._server = server
                self._bound_port = self._loop.run_until_complete(
                    self._start(port))
            except BaseException as e:
                self._init_error = e
                self._started.set()
                return
            self._started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serve-grpc")
        self._thread.start()

    async def _start(self, port: int) -> int:
        bound = self._server.add_insecure_port(f"{self._host}:{port}")
        await self._server.start()
        return bound

    def ready(self):
        if not self._started.wait(timeout=30.0):
            raise RuntimeError("grpc proxy did not start within 30s")
        if self._init_error is not None:
            raise RuntimeError(
                f"grpc proxy failed to start: {self._init_error}")
        return (self._host, self._bound_port)

    # -- routing --------------------------------------------------------

    # the gRPC ingress routes RPC METHOD names: deployments exposing
    # only __call__ still serve them (opt-in resolution fallback flag;
    # handle callers keep strict AttributeError semantics)
    _CALL_META = {"_method_fallback": True}

    def _executor(self):
        # a DEDICATED pool: cancelled calls can pin a thread for up to
        # one ray_tpu_torch.get timeout; on the loop's default executor that
        # would starve every other handler in the process
        pool = getattr(self, "_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = self._pool = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="serve-grpc")
        return pool

    def _router_for(self, service_method: str, metadata):
        """(router, method) or KeyError with the user-facing message."""
        app = dict(metadata or {}).get("application")

        def pick(apps):
            return (apps.get(app) if app
                    else (next(iter(apps.values())) if len(apps) == 1
                          else apps.get("default")))

        target = pick(self._table.get())
        if target is None:
            # a just-deployed app may postdate the cached table: refetch
            # once before answering NOT_FOUND (deploys are rare; the
            # refetch is one controller call)
            self._table.invalidate()
            target = pick(self._table.get())
        if target is None:
            raise KeyError(
                "no serve application matched; set the 'application' "
                "request metadata")
        return (get_router(target["app"], target["deployment"]),
                service_method.rsplit("/", 1)[-1])

    def _call_blocking(self, service_method: str, request: Any, metadata):
        router, method = self._router_for(service_method, metadata)
        ref, done = router.assign(method, (request,), {},
                                  dict(self._CALL_META))
        try:
            return ray_tpu_torch.get(ref, timeout=300.0)
        finally:
            done()

    def _stream_blocking_iter(self, service_method: str, request: Any,
                              metadata):
        router, method = self._router_for(service_method, metadata)
        gen, done = router.assign_streaming(method, (request,), {},
                                            dict(self._CALL_META))
        try:
            for ref in gen:
                yield ray_tpu_torch.get(ref, timeout=300.0)
        finally:
            done()

    def _set_error(self, context, e, service_method):
        grpc = self._grpc

        if isinstance(e, KeyError):
            context.set_code(grpc.StatusCode.NOT_FOUND)
            context.set_details(str(e))
        else:
            logger.exception("grpc %s failed", service_method)
            context.set_code(grpc.StatusCode.INTERNAL)
            context.set_details(f"{type(e).__name__}: {e}")

    def _handler_factory(self, service_method: str, stream: bool):
        async def unary_unary(request, context):
            loop = asyncio.get_event_loop()
            try:
                out = await loop.run_in_executor(
                    self._executor(), self._call_blocking, service_method,
                    request, dict(context.invocation_metadata()))
                return _to_wire(out)
            except Exception as e:
                self._set_error(context, e, service_method)

        async def unary_stream(request, context):
            loop = asyncio.get_event_loop()
            meta = dict(context.invocation_metadata())
            it = iter(self._stream_blocking_iter(service_method, request,
                                                 meta))
            sentinel = object()

            def nxt():
                try:
                    return next(it)
                except StopIteration:
                    return sentinel

            def safe_close(_f=None):
                try:
                    it.close()
                except Exception:
                    pass

            cf = None
            finished = False
            try:
                while True:
                    # submit() + wrap_future, NOT run_in_executor: the
                    # cleanup callback must attach to the CONCURRENT
                    # future, which completes only when nxt() really
                    # returns — a cancelled asyncio wrapper is "done"
                    # immediately, and closing then raises ValueError
                    # (generator still executing) and leaks the slot
                    cf = self._executor().submit(nxt)
                    item = await asyncio.wrap_future(cf)
                    if item is sentinel:
                        finished = True
                        break
                    yield _to_wire(item)
            except Exception as e:
                # nxt returned (by raising): the generator is idle, the
                # inline close runs its finally -> router done() fires
                self._set_error(context, e, service_method)
                finished = True
                safe_close()
            finally:
                if not finished and cf is not None:
                    # client cancellation abandoned the await mid-nxt:
                    # close the generator the moment the blocked next()
                    # returns — no polling thread, no extra pool task on
                    # the happy path
                    cf.add_done_callback(safe_close)

        return unary_stream if stream else unary_unary
