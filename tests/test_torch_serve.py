"""The port's Serve layer on the CPU: the cases of tests/test_serve.py,
test_serve_streaming.py, test_serve_schema.py and test_serve_grpc.py,
run on a cluster of ``ray_tpu_torch``'s own runtime (deploy, compose,
handles, batching, multiplexing, autoscaling, HTTP, SSE, ASGI, the RPC
and gRPC ingresses, the declarative schema), plus one parity test: a
user script runs under ``ray_tpu.serve`` and ``ray_tpu_torch.serve``,
each in its own subprocess, and their outputs are equal.

One cluster per module (``rt.init(num_cpus=4)``); each test starts Serve
and shuts it down, as the reference's ``serve_instance`` does.  The
reference's FastAPI case is left out: FastAPI is not installed here.
"""

import asyncio
import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve.schema import (ServeApplicationSchema,
                                        ServeDeploySchema, build_app,
                                        deploy_config)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    serve.shutdown()
    rt.shutdown()


@pytest.fixture
def serve_instance(cluster):
    serve.start()
    yield
    serve.shutdown()


# -- handles / deployment basics (test_serve.py) -----------------------------


def test_function_deployment(serve_instance):
    @serve.deployment
    def double(x: int) -> int:
        return x * 2

    h = serve.run(double.bind(), name="fn_app", route_prefix=None)
    assert h.remote(21).result(timeout_s=60) == 42
    serve.delete("fn_app")


def test_class_deployment_and_methods(serve_instance):
    @serve.deployment
    class Counter:
        def __init__(self, start: int):
            self.n = start

        def __call__(self):
            return self.n

        def incr(self, by: int = 1):
            self.n += by
            return self.n

    h = serve.run(Counter.bind(10), name="cls_app", route_prefix=None)
    assert h.remote().result(timeout_s=60) == 10
    assert h.incr.remote(5).result(timeout_s=60) == 15
    assert h.options(method_name="incr").remote().result(timeout_s=60) == 16
    serve.delete("cls_app")


def test_num_replicas_and_status(serve_instance):
    @serve.deployment(num_replicas=2)
    class D:
        def __call__(self):
            return os.getpid()

    serve.run(D.bind(), name="rep_app", route_prefix=None)
    st = serve.status()
    dep = st["rep_app"].deployments["D"]
    assert dep.target_num_replicas == 2
    assert len(dep.replicas) == 2
    h = serve.get_app_handle("rep_app")
    pids = {h.remote().result(timeout_s=60) for _ in range(20)}
    assert len(pids) == 2  # p2c spread requests over both replicas
    serve.delete("rep_app")


def test_composition_with_handles(serve_instance):
    @serve.deployment
    class Adder:
        def __init__(self, inc):
            self.inc = inc

        def __call__(self, x):
            return x + self.inc

    @serve.deployment
    class Ingress:
        def __init__(self, a, b):
            self.a = a  # DeploymentHandles
            self.b = b

        async def __call__(self, x):
            y = await self.a.remote(x)
            z = await self.b.remote(y)
            return z

    app = Ingress.bind(Adder.options(name="A1").bind(1),
                       Adder.options(name="A2").bind(10))
    h = serve.run(app, name="comp_app", route_prefix=None)
    assert h.remote(5).result(timeout_s=60) == 16
    serve.delete("comp_app")


def test_reconfigure_user_config(serve_instance):
    @serve.deployment(user_config={"threshold": 1})
    class Configurable:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, cfg):
            self.threshold = cfg["threshold"]

        def __call__(self):
            return self.threshold

    h = serve.run(Configurable.bind(), name="cfg_app", route_prefix=None)
    assert h.remote().result(timeout_s=60) == 1
    serve.delete("cfg_app")


def test_replica_failure_recovery(serve_instance):
    @serve.deployment
    class Fragile:
        def __call__(self):
            return "alive"

        def die(self):
            os._exit(1)

    h = serve.run(Fragile.bind(), name="frag_app", route_prefix=None)
    assert h.remote().result(timeout_s=60) == "alive"
    try:
        h.die.remote().result(timeout_s=30)
    except Exception:
        pass
    # the controller replaces the dead replica
    deadline = time.time() + 60
    ok = False
    while time.time() < deadline:
        try:
            if h.remote().result(timeout_s=10) == "alive":
                ok = True
                break
        except Exception:
            time.sleep(0.3)
    assert ok, "replica was not replaced after crash"
    serve.delete("frag_app")


# -- batching / multiplex ----------------------------------------------------


def test_serve_batch(serve_instance):
    @serve.deployment
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        async def __call__(self, x):
            return await self.handle(x)

        def sizes(self):
            return self.batch_sizes

    h = serve.run(Batcher.bind(), name="batch_app", route_prefix=None)
    responses = [h.remote(i) for i in range(16)]
    out = [r.result(timeout_s=60) for r in responses]
    assert out == [i * 2 for i in range(16)]
    sizes = h.sizes.remote().result(timeout_s=60)
    assert max(sizes) > 1, f"no batching happened: {sizes}"
    serve.delete("batch_app")


def test_multiplex(serve_instance):
    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return {"id": model_id, "weights": model_id.upper()}

        async def __call__(self):
            mid = serve.get_multiplexed_model_id()
            model = await self.get_model(mid)
            return model["weights"]

    h = serve.run(Multi.bind(), name="mux_app", route_prefix=None)
    r = h.options(multiplexed_model_id="alpha").remote().result(timeout_s=60)
    assert r == "ALPHA"
    r = h.options(multiplexed_model_id="beta").remote().result(timeout_s=60)
    assert r == "BETA"
    serve.delete("mux_app")


# -- autoscaling -------------------------------------------------------------


def test_autoscaling_up(serve_instance):
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0, "upscale_delay_s": 0.0,
        "downscale_delay_s": 3600.0})
    class Slow:
        async def __call__(self):
            await asyncio.sleep(1.0)
            return "done"

    h = serve.run(Slow.bind(), name="auto_app", route_prefix=None)
    st = serve.status()
    assert st["auto_app"].deployments["Slow"].target_num_replicas == 1
    # flood with concurrent requests -> the controller scales up
    responses = [h.remote() for _ in range(12)]
    deadline = time.time() + 45
    scaled = False
    while time.time() < deadline:
        st = serve.status()
        if st["auto_app"].deployments["Slow"].target_num_replicas > 1:
            scaled = True
            break
        time.sleep(0.25)
    for r in responses:
        r.result(timeout_s=120)
    assert scaled, "deployment did not scale up under load"
    serve.delete("auto_app")


# -- HTTP proxy and the RPC ingress ------------------------------------------


def _http_get(url: str, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _http_post(url: str, data: bytes, timeout=30):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def test_http_ingress(serve_instance):
    @serve.deployment
    class Echo:
        async def __call__(self, request: serve.Request):
            if request.method == "POST":
                body = await request.json()
                return {"got": body}
            return {"path": request.route_path,
                    "q": request.query_params.get("q")}

    host, port = serve.start(proxy=True)
    serve.run(Echo.bind(), name="http_app", route_prefix="/echo")
    base = f"http://{host}:{port}"

    status_code, body = _http_get(f"{base}/echo/sub/path?q=hi")
    assert status_code == 200
    assert json.loads(body) == {"path": "/sub/path", "q": "hi"}

    status_code, body = _http_post(f"{base}/echo", json.dumps(
        {"x": 1}).encode())
    assert json.loads(body) == {"got": {"x": 1}}

    status_code, _ = _http_get(f"{base}/-/healthz")
    assert status_code == 200

    with pytest.raises(urllib.error.HTTPError):
        _http_get(f"{base}/nomatch")
    serve.delete("http_app")


def test_rpc_ingress(serve_instance):
    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return {"echo": payload}

        def shout(self, payload):
            return {"echo": str(payload).upper()}

    serve.run(Echo.bind(), name="rpc-echo", route_prefix="/rpc-echo")
    addr = serve.start_rpc_proxy()
    cli = serve.RpcClient(addr)
    try:
        assert cli.routes()  # app table visible
        assert cli.call("rpc-echo", "hello") == {"echo": "hello"}
        assert cli.call("rpc-echo", "hello", method="shout") == \
            {"echo": "HELLO"}
    finally:
        cli.close()
        serve.delete("rpc-echo")


def test_rpc_ingress_serves_prefixless_apps(serve_instance):
    @serve.deployment
    def ident(x):
        return x

    serve.run(ident.bind(), name="rpc-only", route_prefix=None)
    addr = serve.start_rpc_proxy()
    cli = serve.RpcClient(addr)
    try:
        assert cli.call("rpc-only", 42) == 42
    finally:
        cli.close()
        serve.delete("rpc-only")


# -- response streaming and ASGI (test_serve_streaming.py) -------------------


def _http_get_stream(url, timeout=60):
    """Read a chunked response incrementally; returns [(t, chunk), ...]."""
    out = []
    with urllib.request.urlopen(url, timeout=timeout) as r:
        while True:
            chunk = r.read1(65536)
            if not chunk:
                break
            out.append((time.monotonic(), chunk))
    return r.status, out


def test_handle_streaming(serve_instance):
    @serve.deployment
    def tokens(n: int):
        for i in range(n):
            yield f"tok{i}"

    h = serve.run(tokens.bind(), name="stream_h", route_prefix=None)
    assert list(h.options(stream=True).remote(4)) == \
        ["tok0", "tok1", "tok2", "tok3"]
    serve.delete("stream_h")


def test_handle_streaming_items_arrive_early(serve_instance):
    @serve.deployment
    def slow(n: int):
        for i in range(n):
            yield i
            time.sleep(0.4)

    h = serve.run(slow.bind(), name="stream_early", route_prefix=None)
    t0 = time.monotonic()
    times = []
    for _ in h.options(stream=True).remote(3):
        times.append(time.monotonic() - t0)
    # the first item long before the full response (3 x 0.4 s) completes
    assert times[0] < times[-1] - 0.5, times
    serve.delete("stream_early")


def test_http_sse_streaming(serve_instance):
    @serve.deployment
    def sse(request):
        for i in range(4):
            yield f"data: tok{i}\n\n"
            time.sleep(0.35)

    serve.run(sse.bind(), name="sse_app", route_prefix="/sse")
    addr = serve.start(proxy=True)
    status, chunks = _http_get_stream(f"http://{addr[0]}:{addr[1]}/sse")
    assert status == 200
    body = b"".join(c for _, c in chunks).decode()
    assert body == "".join(f"data: tok{i}\n\n" for i in range(4))
    first, last = chunks[0][0], chunks[-1][0]
    assert last - first > 0.6, \
        f"all chunks arrived together ({last - first:.3f}s spread): the " \
        "response was buffered, not streamed"
    serve.delete("sse_app")


def test_streaming_async_generator(serve_instance):
    @serve.deployment
    class AsyncGen:
        async def __call__(self, request):
            for i in range(3):
                await asyncio.sleep(0.01)
                yield f"{i},"

    serve.run(AsyncGen.bind(), name="agen", route_prefix="/agen")
    addr = serve.start(proxy=True)
    status, chunks = _http_get_stream(f"http://{addr[0]}:{addr[1]}/agen")
    assert status == 200
    assert b"".join(c for _, c in chunks) == b"0,1,2,"
    serve.delete("agen")


class _MiniASGI:
    """Hand-rolled ASGI app: /hello echoes; /stream sends chunks with
    more_body pacing — the protocol without framework dependencies."""

    def __init__(self):
        self.state = type("S", (), {})()

    async def __call__(self, scope, receive, send):
        assert scope["type"] == "http"
        path = scope["path"]
        if path.startswith("/stream"):
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type",
                                     b"text/event-stream")]})
            for i in range(3):
                await send({"type": "http.response.body",
                            "body": f"data: {i}\n\n".encode(),
                            "more_body": True})
                await asyncio.sleep(0.25)
            await send({"type": "http.response.body", "body": b"",
                        "more_body": False})
            return
        msg = await receive()
        body = msg.get("body", b"")
        dep = getattr(self.state, "serve_deployment", None)
        payload = {"path": path,
                   "method": scope["method"],
                   "query": scope["query_string"].decode(),
                   "body": body.decode(),
                   "dep_state": getattr(dep, "tag", None),
                   "multi": [v.decode() for k, v in scope["headers"]
                             if k == b"x-multi"]}
        await send({"type": "http.response.start", "status": 201,
                    "headers": [(b"content-type", b"application/json")]})
        await send({"type": "http.response.body",
                    "body": json.dumps(payload).encode(),
                    "more_body": False})


_mini_app = _MiniASGI()


def test_asgi_ingress(serve_instance):
    @serve.deployment
    @serve.ingress(_mini_app)
    class App:
        def __init__(self):
            self.tag = "warm"

    serve.run(App.bind(), name="asgi_app", route_prefix="/api")
    addr = serve.start(proxy=True)
    url = f"http://{addr[0]}:{addr[1]}/api/hello?x=1"
    with urllib.request.urlopen(url, timeout=60) as r:
        assert r.status == 201
        assert r.headers["content-type"] == "application/json"
        got = json.loads(r.read())
    assert got["path"] == "/hello"
    assert got["query"] == "x=1"
    assert got["dep_state"] == "warm"   # instance published to app.state
    serve.delete("asgi_app")


def test_asgi_multivalue_query_and_headers(serve_instance):
    """scope['query_string'] is the raw percent-encoded string with
    repeated keys intact, and repeated request headers all reach the
    ASGI app."""
    @serve.deployment
    @serve.ingress(_mini_app)
    class App:
        pass

    serve.run(App.bind(), name="asgi_multi", route_prefix="/m")
    addr = serve.start(proxy=True)
    import http.client

    # http.client lets the same header name go on the wire twice
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=60)
    conn.putrequest("GET", "/m/echo?tag=a&tag=b&name=Jos%C3%A9&s=1+2")
    conn.putheader("X-Multi", "one")
    conn.putheader("X-Multi", "two")
    conn.endheaders()
    r = conn.getresponse()
    got = json.loads(r.read())
    conn.close()
    assert got["query"] == "tag=a&tag=b&name=Jos%C3%A9&s=1+2"
    assert got["multi"] == ["one", "two"]
    serve.delete("asgi_multi")


def test_asgi_ingress_streaming(serve_instance):
    @serve.deployment
    @serve.ingress(_mini_app)
    class App:
        pass

    serve.run(App.bind(), name="asgi_stream", route_prefix="/s")
    addr = serve.start(proxy=True)
    status, chunks = _http_get_stream(f"http://{addr[0]}:{addr[1]}/s/stream")
    assert status == 200
    assert b"".join(c for _, c in chunks) == \
        b"data: 0\n\ndata: 1\n\ndata: 2\n\n"
    assert chunks[-1][0] - chunks[0][0] > 0.3, "ASGI stream was buffered"
    serve.delete("asgi_stream")


# -- the gRPC ingress (test_serve_grpc.py) -----------------------------------


def add_EchoServicer_to_server(servicer, server):
    """Hand-written equivalent of grpcio-tools codegen output (the API
    surface generated _pb2_grpc.py files expose); bytes-passthrough
    serializers stand in for proto classes."""
    import grpc

    rpc_method_handlers = {
        "Predict": grpc.unary_unary_rpc_method_handler(
            servicer.Predict,
            request_deserializer=None, response_serializer=None),
        "StreamPredict": grpc.unary_stream_rpc_method_handler(
            servicer.StreamPredict,
            request_deserializer=None, response_serializer=None),
    }
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("test.Echo",
                                             rpc_method_handlers),))


@pytest.fixture(scope="module")
def grpc_serve(cluster):
    @serve.deployment
    class Echo:
        def Predict(self, request: bytes) -> bytes:
            payload = json.loads(request)
            return json.dumps({"echo": payload["x"] * 2}).encode()

        def StreamPredict(self, request: bytes):
            n = json.loads(request)["n"]
            for i in range(n):
                yield json.dumps({"i": i}).encode()

    serve.run(Echo.bind(), name="echo_app", route_prefix=None)
    addr = serve.start_grpc([add_EchoServicer_to_server])
    yield addr
    serve.shutdown()


def _grpc():
    import grpc

    return grpc


def test_plain_grpc_client_calls_deployment(grpc_serve):
    host, port = grpc_serve
    with _grpc().insecure_channel(f"{host}:{port}") as ch:
        reply = ch.unary_unary("/test.Echo/Predict")(
            json.dumps({"x": 21}).encode(),
            metadata=(("application", "echo_app"),), timeout=60)
    assert json.loads(reply) == {"echo": 42}


def test_grpc_single_app_needs_no_metadata(grpc_serve):
    host, port = grpc_serve
    with _grpc().insecure_channel(f"{host}:{port}") as ch:
        reply = ch.unary_unary("/test.Echo/Predict")(
            json.dumps({"x": 5}).encode(), timeout=60)
    assert json.loads(reply) == {"echo": 10}


def test_grpc_streaming(grpc_serve):
    host, port = grpc_serve
    with _grpc().insecure_channel(f"{host}:{port}") as ch:
        stream = ch.unary_stream("/test.Echo/StreamPredict")(
            json.dumps({"n": 4}).encode(),
            metadata=(("application", "echo_app"),), timeout=60)
        items = [json.loads(m)["i"] for m in stream]
    assert items == [0, 1, 2, 3]


def test_grpc_unknown_app_is_not_found(grpc_serve):
    grpc = _grpc()
    host, port = grpc_serve
    with grpc.insecure_channel(f"{host}:{port}") as ch:
        with pytest.raises(grpc.RpcError) as e:
            ch.unary_unary("/test.Echo/Predict")(
                b"{}", metadata=(("application", "nope"),), timeout=60)
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


def test_grpc_call_only_deployment_serves_named_rpc(grpc_serve):
    """A deployment exposing only __call__ still serves named RPC methods
    (opt-in fallback on the gRPC path), as does the binary RPC ingress;
    handles stay strict."""
    @serve.deployment
    class CallOnly:
        def __call__(self, request: bytes) -> bytes:
            return b"from-call:" + request

    serve.run(CallOnly.bind(), name="call_only", route_prefix=None)
    host, port = grpc_serve
    with _grpc().insecure_channel(f"{host}:{port}") as ch:
        reply = ch.unary_unary("/test.Echo/Predict")(
            b"hi", metadata=(("application", "call_only"),), timeout=60)
    assert reply == b"from-call:hi"
    cli = serve.RpcClient(serve.start_rpc_proxy())
    try:
        assert cli.call("call_only", b"yo", method="Predict") == \
            b"from-call:yo"
    finally:
        cli.close()
    h = serve.get_app_handle("call_only")
    with pytest.raises(Exception, match="Predcit|attribute"):
        h.Predcit.remote(b"x").result(timeout_s=60)
    serve.delete("call_only")


def test_grpc_bad_payload_is_internal(grpc_serve):
    grpc = _grpc()
    host, port = grpc_serve
    with grpc.insecure_channel(f"{host}:{port}") as ch:
        with pytest.raises(grpc.RpcError) as e:
            ch.unary_unary("/test.Echo/Predict")(
                b"not json", metadata=(("application", "echo_app"),),
                timeout=60)
    assert e.value.code() == grpc.StatusCode.INTERNAL


# -- declarative config (test_serve_schema.py) -------------------------------


def test_schema_validation():
    with pytest.raises(ValueError, match="applications"):
        ServeDeploySchema.parse({})
    with pytest.raises(ValueError, match="import_path"):
        ServeDeploySchema.parse({"applications": [{"name": "x"}]})
    with pytest.raises(ValueError, match="duplicate"):
        ServeDeploySchema.parse({"applications": [
            {"name": "a", "import_path": "m:x"},
            {"name": "a", "import_path": "m:y"}]})
    with pytest.raises(ValueError, match="unknown deployment fields"):
        ServeDeploySchema.parse({"applications": [
            {"name": "a", "import_path": "m:x",
             "deployments": [{"name": "d", "nope": 1}]}]})


def _install_module(tmp_path, monkeypatch):
    mod = tmp_path / "my_torch_serve_app.py"
    mod.write_text(textwrap.dedent("""
        from ray_tpu_torch import serve

        @serve.deployment
        class Doubler:
            async def __call__(self, request):
                return {"doubled": 2 * int(await request.body() or b"0")}

        app = Doubler.bind()

        def app_builder(factor=3):
            @serve.deployment(name="Scaler")
            class Scaler:
                async def __call__(self, request):
                    return {"scaled": factor * int(await request.body()
                                                   or b"0")}
            return Scaler.bind()
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    sys.modules.pop("my_torch_serve_app", None)


def test_build_app_overrides(tmp_path, monkeypatch):
    _install_module(tmp_path, monkeypatch)
    app = build_app(ServeApplicationSchema.parse({
        "name": "a", "import_path": "my_torch_serve_app:app",
        "deployments": [{"name": "Doubler", "num_replicas": 2}]}))
    assert app._deployment.num_replicas == 2

    with pytest.raises(ValueError, match="unknown deployments"):
        build_app(ServeApplicationSchema.parse({
            "name": "a", "import_path": "my_torch_serve_app:app",
            "deployments": [{"name": "Missing", "num_replicas": 2}]}))

    # a builder function with args
    app2 = build_app(ServeApplicationSchema.parse({
        "name": "b", "import_path": "my_torch_serve_app:app_builder",
        "args": {"factor": 5}}))
    assert app2.name == "Scaler"


def test_deploy_config_e2e(cluster, tmp_path, monkeypatch):
    _install_module(tmp_path, monkeypatch)
    try:
        names = deploy_config({
            "applications": [
                {"name": "doubling", "import_path": "my_torch_serve_app:app",
                 "route_prefix": "/double"},
            ]})
        assert names == ["doubling"]
        h = serve.get_app_handle("doubling")
        out = h.remote(serve.Request("POST", "/", "/", {}, {}, b"21")
                       ).result(timeout_s=60)
        assert out == {"doubled": 42}
        assert "doubling" in serve.status()
    finally:
        serve.shutdown()


# -- one user script under both runtimes -------------------------------------

_USER_SCRIPT = r"""
import importlib, json, os, sys, time
rt = importlib.import_module(sys.argv[1])
serve = importlib.import_module(sys.argv[1] + ".serve")
rt.init(num_cpus=4)
out = {}

@serve.deployment
def double(x):
    return x * 2

@serve.deployment
class Counter:
    def __init__(self, start):
        self.n = start
    def __call__(self):
        return self.n
    def incr(self, by=1):
        self.n += by
        return self.n

@serve.deployment
class Adder:
    def __init__(self, inc):
        self.inc = inc
    def __call__(self, x):
        return x + self.inc

@serve.deployment
class Ingress:
    def __init__(self, a, b):
        self.a, self.b = a, b
    async def __call__(self, x):
        return await self.b.remote(await self.a.remote(x))

@serve.deployment
class Batcher:
    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    async def handle(self, items):
        return [[i * 10, len(items) > 0] for i in items]
    async def __call__(self, x):
        return await self.handle(x)

@serve.deployment
def tokens(n):
    for i in range(n):
        yield f"tok{i}"

@serve.deployment
class Failing:
    def __call__(self):
        raise ValueError("bad request payload")

h = serve.run(double.bind(), name="fn", route_prefix=None)
out["fn"] = h.remote(21).result(timeout_s=60)
h = serve.run(Counter.bind(10), name="cls", route_prefix=None)
out["cls"] = [h.remote().result(timeout_s=60),
              h.incr.remote(5).result(timeout_s=60),
              h.options(method_name="incr").remote().result(timeout_s=60)]
h = serve.run(Ingress.bind(Adder.options(name="A1").bind(1),
                           Adder.options(name="A2").bind(10)),
              name="comp", route_prefix=None)
out["comp"] = h.remote(5).result(timeout_s=60)
h = serve.run(Batcher.bind(), name="batch", route_prefix=None)
rs = [h.remote(i) for i in range(8)]
out["batch"] = [r.result(timeout_s=60) for r in rs]
h = serve.run(tokens.bind(), name="stream", route_prefix=None)
out["stream"] = list(h.options(stream=True).remote(4))
h = serve.run(Failing.bind(), name="err", route_prefix=None)
try:
    h.remote().result(timeout_s=60)
    out["err"] = None
except Exception as e:
    out["err"] = "bad request payload" in str(e)
cli = serve.RpcClient(serve.start_rpc_proxy())
out["rpc"] = cli.call("fn", 4)
cli.close()
st = serve.status()
out["status"] = {a: [str(s.status),
                     sorted((d, s.deployments[d].target_num_replicas)
                            for d in s.deployments)]
                 for a, s in sorted(st.items())}
serve.delete("err")
out["after_delete"] = sorted(serve.status())
serve.shutdown()
rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
"""


def _run_user_script(package: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("RAY_TPU_ADDRESS", None)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    out = subprocess.run([sys.executable, "-c", _USER_SCRIPT, package],
                         cwd="/", env=env, capture_output=True, text=True,
                         timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_serve_user_script_same_under_both_runtimes():
    ref = _run_user_script("ray_tpu")
    port = _run_user_script("ray_tpu_torch")
    assert port == ref
    assert ref["fn"] == 42 and ref["comp"] == 16 and ref["err"] is True
    assert ref["stream"] == ["tok0", "tok1", "tok2", "tok3"]
