"""HTTP proxy actor: the cluster's HTTP ingress.

Reference: python/ray/serve/_private/proxy.py (HTTPProxy :779, proxy_request
:446) — accepts HTTP, matches the longest route prefix from the
controller's routing table, wraps the request, routes it through the p2c
router to a replica, and converts the return value to an HTTP response
(dict/list -> JSON, str -> text, bytes -> raw, Response for full control).

Built on aiohttp (in-image) running inside the actor on a dedicated event
loop thread; replica calls resolve via an executor so the accept loop never
blocks.

The port's copy of ``ray_tpu/serve/_proxy.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch

from ._common import CONTROLLER_NAME, NoCapacityError
from ._router import get_router

logger = logging.getLogger(__name__)

_ROUTES_TTL_S = 1.0


def _shed_retry_after(e: BaseException) -> Optional[float]:
    """Retry-After seconds when `e` is a load-shed signal, else None.
    Local router sheds arrive typed (NoCapacityError); replica-side
    engine rejections cross the task boundary as a wrapped error whose
    text carries the exception name."""
    if isinstance(e, NoCapacityError):
        return e.retry_after_s
    txt = str(e)
    if "AdmissionRejected" in txt or "NoCapacityError" in txt:
        try:
            from .._private.config import cfg as _cfg

            return _cfg().serve_retry_after_s
        except Exception:
            return 1.0
    return None


class Response:
    """Explicit HTTP response (reference: starlette Response usage)."""

    def __init__(self, body: Any = b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})


class Request:
    """Minimal request facade handed to HTTP ingress callables."""

    def __init__(self, method: str, path: str, route_path: str,
                 query_params: Dict[str, str], headers: Dict[str, str],
                 body: bytes, query_string: bytes = b"",
                 header_pairs: Optional[List[Tuple[str, str]]] = None):
        self.method = method
        self.path = path            # full path
        self.route_path = route_path  # path with route prefix stripped
        self.query_params = query_params
        # raw percent-encoded query string verbatim: repeated keys
        # (?tag=a&tag=b) and escapes (%C3%A9, 1+2) survive here even
        # though the query_params dict keeps only decoded last values
        self.query_string = query_string
        # ordered (name, value) pairs: repeated headers (Set-Cookie,
        # X-Forwarded-For) survive here; the dict keeps only the last
        self.header_pairs = (header_pairs if header_pairs is not None
                             else list(headers.items()))
        self.headers = headers
        self._body = body

    async def body(self) -> bytes:
        return self._body

    async def json(self) -> Any:
        return json.loads(self._body or b"null")

    def __repr__(self):
        return f"Request({self.method} {self.path})"


class _ControllerTableCache:
    """TTL-cached controller table fetch shared by the ingress proxies.

    Resets the cached actor handle on failure so a restarted controller
    (new actor, same name) is re-resolved instead of bricking refreshes.
    """

    def __init__(self, method: str, extract):
        self._method = method
        self._extract = extract
        self._controller = None
        self._value: Dict[str, Any] = {}
        self._ts = 0.0

    def invalidate(self):
        self._ts = 0.0

    def fresh(self) -> bool:
        return time.monotonic() - self._ts <= _ROUTES_TTL_S

    def get(self) -> Dict[str, Any]:
        """Blocking controller RPC on miss — callers on an event loop must
        run this in an executor."""
        if time.monotonic() - self._ts > _ROUTES_TTL_S:
            try:
                if self._controller is None:
                    self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                table = ray_tpu_torch.get(
                    getattr(self._controller, self._method).remote(),
                    timeout=10.0)
                self._value = self._extract(table)
                self._ts = time.monotonic()
            except Exception:
                self._controller = None  # re-resolve after restarts
                logger.exception("%s refresh failed", self._method)
        return self._value


def _request_id(headers: Dict[str, str]) -> str:
    """Honor a caller-supplied x-request-id (so one id threads client ->
    proxy -> handle -> replica -> engine stats and the router's replay
    log lines); mint one otherwise."""
    for k, v in headers.items():
        if k.lower() == "x-request-id" and v:
            return str(v)[:128]
    return uuid.uuid4().hex[:16]


def _chunk_bytes(item: Any) -> bytes:
    """Wire form of one streamed item: bytes pass through, strings encode
    (SSE framing is the deployment's own `yield "data: ...\\n\\n"`),
    anything else is one JSON line."""
    if isinstance(item, (bytes, bytearray)):
        return bytes(item)
    if isinstance(item, str):
        return item.encode()
    return (json.dumps(item, default=str) + "\n").encode()


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._host = host
        self._port = port
        self._actual_port = None
        self._table = _ControllerTableCache(
            "get_routing_table", lambda t: t["routes"])
        self._started = threading.Event()
        self._start_err: Optional[str] = None
        self._thread = threading.Thread(target=self._serve_thread,
                                        name="serve-http", daemon=True)
        self._thread.start()

    # -- actor API ----------------------------------------------------------

    def ready(self):
        if not self._started.wait(timeout=15.0):
            raise RuntimeError("http proxy failed to start (timeout)")
        if self._start_err:
            raise RuntimeError(f"http proxy failed: {self._start_err}")
        return (self._host, self._actual_port)

    # -- server -------------------------------------------------------------

    def _serve_thread(self):
        try:
            from aiohttp import web

            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            app = web.Application(client_max_size=256 * 1024 * 1024)
            app.router.add_route("*", "/{tail:.*}", self._handle)
            runner = web.AppRunner(app, access_log=None)
            loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, self._host, self._port)
            loop.run_until_complete(site.start())
            self._actual_port = site._server.sockets[0].getsockname()[1]
            self._started.set()
            loop.run_forever()
        except BaseException as e:
            self._start_err = f"{type(e).__name__}: {e}"
            self._started.set()

    async def _route_for(self, path: str) -> Optional[Dict[str, str]]:
        if self._table.fresh():
            routes = self._table._value  # hot path: no executor hop
        else:
            routes = await asyncio.get_event_loop().run_in_executor(
                None, self._table.get)
        best = None
        for prefix, target in routes.items():
            if path == prefix or path.startswith(
                    prefix if prefix.endswith("/") else prefix + "/") \
                    or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, target)
        return best and {"prefix": best[0], **best[1]}

    async def _handle(self, request):
        from aiohttp import web

        path = request.path
        if path == "/-/healthz":
            return web.Response(text="ok")
        if path == "/-/routes":
            self._table.invalidate()
            await self._route_for(path)
            return web.json_response(self._table._value)
        target = await self._route_for(path)
        if target is None:
            return web.Response(status=404,
                                text=f"no serve app matches {path!r}")
        prefix = target["prefix"]
        route_path = path[len(prefix):] if prefix != "/" else path
        body = await request.read()
        req = Request(request.method, path, route_path or "/",
                      dict(request.query), dict(request.headers), body,
                      query_string=(
                          request.rel_url.raw_query_string.encode()),
                      header_pairs=list(request.headers.items()))
        router = get_router(target["app"], target["deployment"])
        loop = asyncio.get_event_loop()
        rid = _request_id(req.headers)

        if target.get("streaming") or target.get("asgi"):
            return await self._handle_streaming(request, req, target,
                                                router, rid)

        def call():
            sub = router.submit(None, (req,), {}, {"request_id": rid})
            return router.call(sub, timeout_s=300.0)

        try:
            out = await loop.run_in_executor(None, call)
        except Exception as e:
            retry = _shed_retry_after(e)
            if retry is not None:
                # overload is not an error: tell the client when to come
                # back instead of letting queues collapse into timeouts
                return web.Response(
                    status=503, text=f"overloaded: {e}",
                    headers={"Retry-After": f"{max(0.0, retry):g}",
                             "x-request-id": rid})
            logger.exception("request %s to %s failed", rid, path)
            return web.Response(status=500,
                                text=f"{type(e).__name__}: {e}",
                                headers={"x-request-id": rid})
        resp = self._to_http(out)
        resp.headers.setdefault("x-request-id", rid)
        return resp

    # long-lived streams pin a thread per in-flight item wait; a
    # dedicated pool keeps ~32 SSE clients from starving the loop's
    # default executor (which the non-streaming path also rides)
    _stream_pool = None
    _stream_pool_lock = threading.Lock()

    @classmethod
    def _stream_executor(cls):
        with cls._stream_pool_lock:
            if cls._stream_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                cls._stream_pool = ThreadPoolExecutor(
                    max_workers=64, thread_name_prefix="proxy-stream")
            return cls._stream_pool

    async def _handle_streaming(self, aio_req, req, target, router,
                                rid: str):
        """Chunked-transfer path for generator/ASGI ingress (reference:
        proxy.py:864 streaming plumbing): each item the deployment yields
        goes onto the wire as soon as its ref resolves — first-token
        latency is one item's production time, not the whole response's.

        A plain-generator deployment may yield a serve.Response FIRST to
        set status/headers (e.g. content_type="text/event-stream" for
        EventSource clients); its body (if any) becomes the first chunk.
        """
        from aiohttp import web

        from ._asgi import ASGI_META

        loop = asyncio.get_event_loop()
        pool = self._stream_executor()
        try:
            sub = await loop.run_in_executor(
                pool, lambda: router.submit(
                    None, (req,), {}, {"request_id": rid},
                    streaming=True))
        except Exception as e:
            retry = _shed_retry_after(e)
            if retry is not None:
                return web.Response(
                    status=503, text=f"overloaded: {e}",
                    headers={"Retry-After": f"{max(0.0, retry):g}",
                             "x-request-id": rid})
            logger.exception("streaming submit %s to %s failed", rid,
                             req.path)
            return web.Response(status=500,
                                text=f"{type(e).__name__}: {e}",
                                headers={"x-request-id": rid})
        # iter_stream resolves items AND replays on replica death; its
        # finally releases the in-flight slot even on client disconnect
        it = router.iter_stream(sub)
        sentinel = object()

        def nxt():
            return next(it, sentinel)

        resp = None
        try:
            first = await loop.run_in_executor(pool, nxt)
            pending = None
            if (target.get("asgi") and isinstance(first, tuple)
                    and first and first[0] == ASGI_META):
                from multidict import CIMultiDict

                # multidict: duplicate names (several Set-Cookie) survive
                headers = CIMultiDict(
                    (k, v) for k, v in first[2]
                    if k.lower() != "content-length")  # chunked
                resp = web.StreamResponse(status=first[1], headers=headers)
            elif isinstance(first, Response):
                from multidict import CIMultiDict

                headers = CIMultiDict(
                    (k, v) for k, v in first.headers.items()
                    if k.lower() != "content-length")  # chunked
                headers["Content-Type"] = first.content_type
                resp = web.StreamResponse(status=first.status,
                                          headers=headers)
                if first.body:
                    pending = first.body
            else:
                resp = web.StreamResponse(
                    status=200,
                    headers={"Content-Type": "text/plain; charset=utf-8"})
                pending = first
            resp.headers.setdefault("x-request-id", rid)
            await resp.prepare(aio_req)
            if pending is not None and pending is not sentinel:
                await resp.write(_chunk_bytes(pending))
            if first is not sentinel:
                while True:
                    item = await loop.run_in_executor(pool, nxt)
                    if item is sentinel:
                        break
                    await resp.write(_chunk_bytes(item))
            await resp.write_eof()
            return resp
        except Exception as e:
            logger.exception("streaming request %s to %s failed", rid,
                             req.path)
            if resp is None or not resp.prepared:
                # nothing hit the wire yet (including prepare() itself
                # failing): a plain 500/503 is still deliverable
                retry = _shed_retry_after(e)
                if retry is not None:
                    return web.Response(
                        status=503, text=f"overloaded: {e}",
                        headers={"Retry-After": f"{max(0.0, retry):g}",
                                 "x-request-id": rid})
                return web.Response(status=500,
                                    text=f"{type(e).__name__}: {e}",
                                    headers={"x-request-id": rid})
            # headers already sent: abort the connection rather than
            # emitting the normal chunked terminator — a clean write_eof
            # would make the truncated body indistinguishable from a
            # complete response for SSE/chunked consumers
            try:
                if aio_req.transport is not None:
                    aio_req.transport.close()
            except Exception:
                pass
            resp.force_close()
            return resp
        finally:
            # closing the iterator runs iter_stream's finally (releases
            # the router's in-flight slot) — including on client abandon
            try:
                it.close()
            except Exception:
                pass

    def _to_http(self, out: Any):
        from aiohttp import web

        if isinstance(out, Response):
            body = out.body
            if isinstance(body, str):
                body = body.encode()
            elif not isinstance(body, (bytes, bytearray)):
                body = json.dumps(body, default=str).encode()
            return web.Response(body=body, status=out.status,
                                content_type=out.content_type,
                                headers=out.headers)
        if isinstance(out, (bytes, bytearray)):
            return web.Response(body=bytes(out))
        if isinstance(out, str):
            return web.Response(text=out)
        return web.json_response(out, dumps=lambda o: json.dumps(
            o, default=str))


class RpcProxy:
    """Binary RPC ingress: the reference's gRPC proxy analog
    (reference: serve/_private/proxy.py gRPCProxy :558) on the framework's
    native frame protocol instead of grpc — one `serve_call` method routes
    {app, method, payload} through the same p2c router as HTTP.  Serves
    every app, including ones without an HTTP route_prefix.

    Clients use serve.RpcClient (or any protocol.Client):
        RpcClient(addr).call("my_app", payload, method="predict")
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch._private.protocol import DaemonPool, Server

        self._table = _ControllerTableCache(
            "get_app_table", lambda t: dict(t["apps"]))
        self._pool = DaemonPool(max_workers=16, name="serve-rpc")
        self._server = Server(host, port, name="serve-rpc")
        self._server.handle("serve_call", self._handle_call, deferred=True)
        # table fetch blocks on the controller: never on the loop thread
        self._server.handle("serve_routes", self._handle_routes,
                            deferred=True)
        self._server.handle("ping", lambda c, p: "pong")
        self._server.start()

    def ready(self):
        return self._server.addr

    def _handle_routes(self, conn, p, d):
        self._pool.submit(lambda: d.resolve(self._table.get()))

    def _handle_call(self, conn, p, d):
        def run():
            try:
                app = p.get("app") or "default"
                target = self._table.get().get(app)
                if target is None:
                    d.reject(f"no serve app named {app!r}")
                    return
                router = get_router(target["app"], target["deployment"])
                args = p.get("args", ())
                kwargs = p.get("kwargs", {})
                # named-method ingress routes RPC method names: keep the
                # __call__ fallback (same contract as the gRPC ingress);
                # handle callers stay strict
                meta = {"_method_fallback": True}
                if p.get("request_id"):
                    meta["request_id"] = str(p["request_id"])[:128]
                sub = router.submit(p.get("method"), tuple(args),
                                    dict(kwargs), meta)
                d.resolve(router.call(sub, timeout_s=300.0))
            except BaseException as e:
                d.reject(f"{type(e).__name__}: {e}")

        self._pool.submit(run)


class RpcClient:
    """Client for the serve RPC ingress.

    `method` and `timeout` are client-side options; a deployment method
    whose own kwargs collide with those names receives them via
    `call_kwargs`.
    """

    def __init__(self, addr, connect_timeout: float = 30.0):
        from ray_tpu_torch._private.protocol import Client

        self._client = Client(tuple(addr), name="serve-rpc-client",
                              connect_timeout=connect_timeout)

    def call(self, app: str, *args, method: Optional[str] = None,
             timeout: float = 300.0, request_id: Optional[str] = None,
             call_kwargs: Optional[Dict[str, Any]] = None, **kwargs):
        merged = {**(call_kwargs or {}), **kwargs}
        payload = {"app": app, "method": method,
                   "args": args, "kwargs": merged}
        if request_id:
            payload["request_id"] = request_id
        return self._client.call("serve_call", payload, timeout=timeout)

    def routes(self) -> Dict[str, Any]:
        return self._client.call("serve_routes", {}, timeout=30.0)

    def close(self):
        self._client.close()
