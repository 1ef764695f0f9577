"""ASGI ingress: serve a FastAPI/Starlette/any-ASGI app as a deployment.

Reference: python/ray/serve/api.py:164 @serve.ingress + the proxy's ASGI
plumbing (serve/_private/proxy.py:864 receive_asgi_messages).  The ASGI
app executes INSIDE the replica; its response events stream back to the
HTTP proxy through the framework's streaming-generator plane, so chunked
and SSE responses reach the client as the app produces them.

Protocol between replica and proxy: the wrapped deployment's __call__
yields ("__asgi_meta__", status, headers) first, then raw body chunks.

The port's copy of ``ray_tpu/serve/_asgi.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import threading
import time
import urllib.parse
from typing import Any

ASGI_META = "__asgi_meta__"


# max seconds between ASGI events before the stream is declared wedged;
# per-event (an active SSE stream with regular frames never trips it)
IDLE_TIMEOUT_S = 300.0
# bounded send queue: backpressure for apps producing faster than the
# consumer drains (send() blocks the app until the wire catches up)
QUEUE_DEPTH = 64


def run_asgi(app, request):
    """Generator driving one ASGI request; yields meta then body chunks.

    The app runs on a private event loop in a side thread; `send` events
    flow through a bounded queue so a chunk yielded by the app is emitted
    here (and on the wire) before the app finishes.  ASGI semantics
    honored: `receive` delivers the body once then blocks until
    disconnect (so `request.is_disconnected()` loops work); abandoning
    this generator (client gone) signals http.disconnect and unblocks a
    full send queue, so the app thread exits instead of leaking."""
    events: "_queue.Queue" = _queue.Queue(maxsize=QUEUE_DEPTH)
    stop_evt = threading.Event()
    body = request._body or b""
    body_sent = [False]

    async def receive():
        if not body_sent[0]:
            body_sent[0] = True
            return {"type": "http.request", "body": body,
                    "more_body": False}
        while not stop_evt.is_set():
            await asyncio.sleep(0.1)
        return {"type": "http.disconnect"}

    async def send(message):
        while True:
            if stop_evt.is_set():
                raise ConnectionError("client disconnected")
            try:
                events.put(message, timeout=0.25)
                return
            except _queue.Full:
                continue

    scope = {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "path": request.route_path,
        "raw_path": request.route_path.encode(),
        "root_path": "",
        "scheme": "http",
        "query_string": (getattr(request, "query_string", b"")
                         or urllib.parse.urlencode(
                             request.query_params).encode()),
        "headers": [(k.lower().encode(), str(v).encode())
                    for k, v in getattr(request, "header_pairs", None)
                    or request.headers.items()],
        "client": None,
        "server": None,
    }

    def run():
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(app(scope, receive, send))
            events.put({"type": "__done__"}, timeout=IDLE_TIMEOUT_S)
        except BaseException as e:
            try:
                events.put({"type": "__error__",
                            "error": f"{type(e).__name__}: {e}"},
                           timeout=1.0)
            except _queue.Full:
                pass
        finally:
            loop.close()

    t = threading.Thread(target=run, daemon=True, name="serve-asgi")
    t.start()
    started = False
    try:
        while True:
            try:
                ev = events.get(timeout=IDLE_TIMEOUT_S)
            except _queue.Empty:
                raise TimeoutError(
                    "ASGI app produced no event within the idle "
                    "timeout") from None
            typ = ev.get("type")
            if typ == "http.response.start":
                headers = [
                    (k.decode() if isinstance(k, bytes) else str(k),
                     v.decode() if isinstance(v, bytes) else str(v))
                    for k, v in ev.get("headers", [])]
                started = True
                yield (ASGI_META, int(ev.get("status", 200)), headers)
            elif typ == "http.response.body":
                b = ev.get("body", b"")
                if b:
                    yield bytes(b)
                if not ev.get("more_body"):
                    break
            elif typ == "__done__":
                break
            elif typ == "__error__":
                if not started:
                    yield (ASGI_META, 500,
                           [("content-type", "text/plain")])
                yield f"ASGI app failed: {ev['error']}".encode()
                break
    finally:
        # normal end, error, OR abandoned generator (GeneratorExit when
        # the client disconnects): tell the app, unblock its sends
        stop_evt.set()
        t.join(timeout=5)


def ingress(asgi_app):
    """Class decorator: the deployment serves `asgi_app` over HTTP
    (reference: serve/api.py:164 @serve.ingress(app)).

    The replica's instance is published as ``asgi_app.state.serve_deployment``
    (when the app has a ``state``, as FastAPI/Starlette do) so route
    functions can reach warm per-replica state.
    """

    def decorator(cls):
        if not isinstance(cls, type):
            raise TypeError("@serve.ingress decorates a class; for a bare "
                            "ASGI app use serve.ingress(app)(object)")

        class _ASGIIngress(cls):
            __serve_asgi__ = True

            def __init__(self, *args: Any, **kwargs: Any):
                super().__init__(*args, **kwargs)
                state = getattr(asgi_app, "state", None)
                if state is not None:
                    state.serve_deployment = self

            def __call__(self, request):
                return run_asgi(asgi_app, request)

        _ASGIIngress.__name__ = cls.__name__
        _ASGIIngress.__qualname__ = getattr(cls, "__qualname__",
                                            cls.__name__)
        # the wrapper is defined HERE, so its __module__ would be this
        # framework module — keep the user's module so the by-value
        # pickling registration in serve.run sees driver-only code; the
        # app object itself may live in yet another driver-only module,
        # register its class too (FastAPI etc. are installed libs and
        # skipped by the helper)
        _ASGIIngress.__module__ = getattr(cls, "__module__",
                                          _ASGIIngress.__module__)
        from ray_tpu_torch._private.common import _ensure_picklable_by_value

        # the app itself, not type(app): instances resolve __module__
        # through their class, and function-style ASGI apps carry their
        # defining module directly (type() would say builtins.function)
        _ensure_picklable_by_value(asgi_app)
        return _ASGIIngress

    return decorator
