"""Framed RPC layer: the TPU-native equivalent of the reference's gRPC wrappers.

The reference wraps async gRPC in `GrpcServer`/`GrpcClient`/`ClientCallManager`
(reference: src/ray/rpc/grpc_server.h:85, grpc_client.h:93, client_call.h:189).
We provide the same capability — async request/reply with correlation ids,
server push (for pubsub), connection-death notification — over plain TCP
sockets with pickle framing.  This keeps the control plane dependency-free and
fast enough for the control path; the data plane (tensors) never moves through
this layer: device arrays travel via compiled XLA collectives (ICI) and large
host objects via the shared-memory store.

Wire format: 4-byte header (<I: payload length) + pickled
(msg_id, kind, method, payload[, meta]).  kind: 0=request 1=reply 2=error
3=push.  The optional 5th element is a small dict of frame metadata —
"tp" (W3C traceparent for cross-process span nesting), "ts" (publisher
wall-clock stamp for pubsub fan-out latency), "re" (reply served from
the idempotency replay cache) — attached only when non-empty so the
common frame stays byte-identical to the 4-tuple format.

The port's copy of ``ray_tpu/_private/protocol.py``: imports renamed,
variables ``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
import selectors
import socket
import struct
import threading
import time
import traceback
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private.rpc_stats import (LatencyHist, MethodStats, budget_ms,
                                        record_pubsub_delivery)

logger = logging.getLogger(__name__)

# lazily-bound tracing module (None = not yet imported, False = unavailable)
_tracing: Any = None


def _trace_mod():
    global _tracing
    if _tracing is None:
        try:
            from ray_tpu_torch.util import tracing as t
            _tracing = t
        except Exception:  # pragma: no cover - partial-install guard
            _tracing = False
    return _tracing

_HEADER = struct.Struct("<I")
REQUEST, REPLY, ERROR, PUSH = 0, 1, 2, 3

# Big frames allowed (object transfer fallback path), but the data plane
# should use the shm store instead.
MAX_FRAME = 1 << 31


class RpcError(Exception):
    """Remote handler raised; carries the remote traceback string."""


def _invoke(cb, value, exc) -> None:
    try:
        cb(value, exc)
    except Exception:
        logger.exception("reply callback failed")


class ConnectionLost(Exception):
    """Peer went away before replying."""


# Reserved payload key for idempotent requests: a caller stamps a dict
# payload with a unique token and the Server records the first reply under
# it, replaying the recording for duplicates.  This is what makes blind
# retries after a reconnect safe — a re-sent request_lease whose original
# reply was lost to the partition cannot place a second lease.
IDEM_KEY = "_idem"


def idem_token() -> str:
    """Globally-unique idempotency token (96 random bits)."""
    return os.urandom(12).hex()


class Backoff:
    """Jittered exponential backoff for reconnect/retry loops.

    Attempt n sleeps uniform(d/2, d) with d = min(cap, base * 2**n): the
    mean still doubles per attempt but a fleet of raylets re-homing after
    a control restart decorrelates instead of stampeding in lockstep.
    """

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 rng: Optional[random.Random] = None):
        self.base = max(1e-4, float(base))
        self.cap = max(self.base, float(cap))
        self.attempt = 0
        self._rng = rng or random.Random()

    def next_delay(self) -> float:
        d = min(self.cap, self.base * (2 ** min(self.attempt, 32)))
        self.attempt += 1
        return self._rng.uniform(d / 2, d)

    def sleep(self, max_s: Optional[float] = None) -> float:
        d = self.next_delay()
        if max_s is not None:
            d = max(0.0, min(d, max_s))
        time.sleep(d)
        return d

    def reset(self) -> None:
        self.attempt = 0


def _dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=5)


def _pack_frame(msg_id: int, kind: int, method: str, payload: Any,
                meta: Optional[Dict[str, Any]] = None) -> bytes:
    """Serialize one frame; the meta element rides only when non-empty."""
    if meta:
        return _dumps((msg_id, kind, method, payload, meta))
    return _dumps((msg_id, kind, method, payload))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionLost("socket closed")
        got += r
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HEADER.pack(len(payload)) + payload)


if hasattr(socket.socket, "sendmsg"):

    def send_vec(sock: socket.socket, bufs: list) -> None:
        """Scatter-gather send of a buffer list: one syscall per ~1MB of
        frames instead of one per frame, and no join() copy."""
        views = [memoryview(b) for b in bufs]
        i = 0
        while i < len(views):
            n = sock.sendmsg(views[i:])
            while i < len(views) and n >= len(views[i]):
                n -= len(views[i])
                i += 1
            if i < len(views) and n:
                views[i] = views[i][n:]
else:  # pragma: no cover - non-POSIX fallback

    def send_vec(sock: socket.socket, bufs: list) -> None:
        sock.sendall(b"".join(bufs))


def recv_frame(sock: socket.socket) -> bytes:
    (n,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if n > MAX_FRAME:
        raise RpcError(f"frame too large: {n}")
    return _recv_exact(sock, n)


def free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class DaemonPool:
    """Minimal thread pool with daemon threads (so a wedged handler can
    never block interpreter exit, unlike concurrent.futures)."""

    def __init__(self, max_workers: int, name: str = "pool"):
        import queue as _q

        self._q: "_q.Queue" = _q.Queue()
        self._name = name
        self._threads = []
        for i in range(max_workers):
            t = threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def submit(self, fn, *args, **kwargs) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, args, kwargs))
        return fut

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args, kwargs = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:
                fut.set_exception(e)

    def shutdown(self, wait: bool = False):
        for _ in self._threads:
            self._q.put(None)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class Client:
    """Thread-safe RPC client: concurrent in-flight calls over one socket.

    A single reader thread demultiplexes replies to per-call futures and
    dispatches server pushes to `on_push`.  Mirrors the role of the
    reference's ClientCallManager (client_call.h:189).
    """

    def __init__(
        self,
        addr: Tuple[str, int],
        on_push: Optional[Callable[[str, Any], None]] = None,
        on_disconnect: Optional[Callable[[], None]] = None,
        connect_timeout: float = 30.0,
        name: str = "",
    ):
        self.addr = tuple(addr)
        self.name = name
        self._on_push = on_push
        self._on_disconnect = on_disconnect
        self._lock = threading.Lock()
        self._next_id = 0
        self._inflight: Dict[int, Tuple[Callable, str]] = {}
        # per-method counters, guarded by _lock:
        # [calls, bytes_out, replies, errors, bytes_in, replays]
        self._cstats: Dict[str, list] = {}
        self._closed = False
        deadline = time.monotonic() + connect_timeout
        last_err: Optional[Exception] = None
        while True:
            try:
                # per-attempt socket timeout must not exceed the overall
                # budget: a host-down peer (SYN dropped) blocks the whole
                # attempt, and a caller asking for a 0.5s bound must not
                # wait 5s for it
                self._sock = socket.create_connection(
                    self.addr, timeout=min(5.0, connect_timeout))
                break
            except OSError as e:  # daemon may still be booting
                last_err = e
                if time.monotonic() > deadline:
                    raise ConnectionLost(
                        f"cannot connect to {self.addr}: {last_err}"
                    ) from e
                time.sleep(0.05)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        # Combining writer: callers enqueue framed payloads and a dedicated
        # thread drains the queue with one scatter-gather sendmsg per
        # batch.  Under bursts (pipelined task pushes) dozens of frames
        # ride one syscall; a lone sync call costs one ~15us handoff in
        # place of its ~40us sendall.  Order is strictly FIFO — actor-task
        # ordering depends on per-connection frame order.
        import collections

        self._outq: "collections.deque" = collections.deque()
        self._out_cv = threading.Condition()
        self._writer = threading.Thread(
            target=self._write_loop, name=f"rpc-client-writer-{name}", daemon=True
        )
        self._writer.start()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"rpc-client-reader-{name}", daemon=True
        )
        self._reader.start()

    # -- public ------------------------------------------------------------

    def call(self, method: str, payload: Any = None, timeout: Optional[float] = None) -> Any:
        t = _trace_mod()
        if t and t.is_enabled() and t.frame_traceparent() is not None:
            # CLIENT span around the round trip; the traceparent rides
            # the frame meta (call_cb) so the server handler nests under
            with t.rpc_client_span(method, peer=f"{self.addr[0]}:"
                                                f"{self.addr[1]}"):
                return self.call_async(method, payload).result(
                    timeout=timeout)
        fut = self.call_async(method, payload)
        return fut.result(timeout=timeout)

    def call_async(self, method: str, payload: Any = None) -> Future:
        fut: Future = Future()

        def fill(value, exc):
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)

        self.call_cb(method, payload, fill)
        return fut

    def call_cb(self, method: str, payload: Any,
                cb: Callable[[Any, Optional[BaseException]], None]) -> None:
        """Request whose reply invokes cb(payload, exc) directly on the
        read thread — the task-push hot path uses this to skip a Future
        allocation + lock round + done-callback machinery per task.

        Exactly-once delivery: every completion path (reply, error frame,
        send failure, teardown) pops the slot from _inflight first, so a
        send failure racing reader teardown cannot invoke cb twice."""
        closed = False
        with self._lock:
            if self._closed:
                closed = True  # invoke outside the lock: cb may re-enter
            else:
                self._next_id += 1
                msg_id = self._next_id
                self._inflight[msg_id] = (cb, method)
        if closed:
            _invoke(cb, None, ConnectionLost(f"client to {self.addr} closed"))
            return
        meta = None
        t = _trace_mod()
        if t and t.is_enabled():
            # sampled contexts only: suppressed requests skip the meta
            # dict + traceparent formatting (and the server-side parse)
            tp = t.frame_traceparent()
            if tp:
                meta = {"tp": tp}
        try:
            data = _pack_frame(msg_id, REQUEST, method, payload, meta)
        except BaseException:
            with self._lock:
                self._inflight.pop(msg_id, None)
            raise
        with self._lock:
            st = self._cstats.get(method)
            if st is None:
                st = self._cstats[method] = [0, 0, 0, 0, 0, 0]
            st[0] += 1
            st[1] += len(data)
        try:
            self._enqueue(data)
        except ConnectionLost as e:
            with self._lock:
                slot = self._inflight.pop(msg_id, None)
            if slot is not None:  # teardown may have delivered it already
                _invoke(cb, None, e)

    def notify(self, method: str, payload: Any = None) -> None:
        """One-way message; no reply expected (msg_id 0)."""
        data = _dumps((0, REQUEST, method, payload))
        with self._lock:
            st = self._cstats.get(method)
            if st is None:
                st = self._cstats[method] = [0, 0, 0, 0, 0, 0]
            st[0] += 1
            st[1] += len(data)
        self._enqueue(data)

    def stats_raw(self) -> Dict[str, list]:
        """Per-method raw counters
        [calls, bytes_out, replies, errors, bytes_in, replays]."""
        with self._lock:
            return {m: list(s) for m, s in self._cstats.items()}

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Client-side per-method stats (mirror of the server's view)."""
        return {m: {"calls": s[0], "bytes_out": s[1], "replies": s[2],
                    "errors": s[3], "bytes_in": s[4], "replays": s[5]}
                for m, s in self.stats_raw().items()}

    def _enqueue(self, data: bytes) -> None:
        # after close/teardown the writer is gone — surface the failure
        # like the old synchronous send did instead of queueing forever
        if self._closed:
            raise ConnectionLost(f"client to {self.addr} closed")
        with self._out_cv:
            self._outq.append(data)
            self._out_cv.notify()

    def _write_loop(self) -> None:
        # 2 iovecs per frame, UIO_MAXIOV=1024 → cap well below it
        MAX_BATCH, MAX_BYTES = 256, 1 << 20
        sent_error = False
        try:
            while True:
                with self._out_cv:
                    while not self._outq and not self._closed:
                        self._out_cv.wait()
                    # graceful close: drain everything already enqueued
                    # (one-shot clients notify() then close() immediately —
                    # dropping those frames loses lease returns / object
                    # frees); a dead socket aborts us via OSError instead
                    if self._closed and not self._outq:
                        return
                    batch, nbytes = [], 0
                    while self._outq and len(batch) < MAX_BATCH \
                            and nbytes < MAX_BYTES:
                        d = self._outq.popleft()
                        batch.append(d)
                        nbytes += len(d)
                bufs = []
                for d in batch:
                    bufs.append(_HEADER.pack(len(d)))
                    bufs.append(d)
                send_vec(self._sock, bufs)
        except OSError:
            sent_error = True
        finally:
            if sent_error:
                # the reader owns teardown; make it notice
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        with self._out_cv:
            self._out_cv.notify_all()
        if threading.current_thread() is not self._writer:
            # let queued frames flush before tearing the socket down;
            # one-way frames here can be resource releases (lease
            # returns, object frees, actor_del_ref) whose silent loss
            # leaks the resource on the peer — extend the drain while
            # frames remain and say so if we give up on a stalled peer
            self._writer.join(timeout=5.0)
            if self._writer.is_alive() and self._outq:
                self._writer.join(timeout=10.0)
                if self._writer.is_alive() and self._outq:
                    logging.getLogger(__name__).warning(
                        "client %s: dropping %d queued frame(s) at close "
                        "(peer stalled) — peer-side resources they "
                        "release may leak until reclaimed by liveness "
                        "checks", self.name, len(self._outq))
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- internals ---------------------------------------------------------

    def _read_loop(self) -> None:
        # Buffered framing: one recv per kernel burst instead of two per
        # frame (header + payload) — syscalls dominate small-RPC cost on
        # virtualized kernels, and reply bursts arrive coalesced anyway.
        buf = bytearray()
        want = -1  # payload length being assembled; -1 = reading header
        hsize = _HEADER.size
        try:
            while True:
                chunk = self._sock.recv(1 << 20)
                if not chunk:
                    raise ConnectionLost("socket closed")
                buf += chunk
                while True:
                    if want < 0:
                        if len(buf) < hsize:
                            break
                        (want,) = _HEADER.unpack(bytes(buf[:hsize]))
                        if want > MAX_FRAME:
                            raise RpcError(f"frame too large: {want}")
                        del buf[:hsize]
                    if len(buf) < want:
                        break
                    frame = bytes(buf[:want])
                    del buf[:want]
                    want = -1
                    self._handle_frame(frame)
        except (ConnectionLost, OSError, EOFError, pickle.UnpicklingError,
                RpcError):
            pass
        finally:
            with self._lock:
                self._closed = True
                inflight, self._inflight = self._inflight, {}
            with self._out_cv:
                self._out_cv.notify_all()  # release the writer thread
            lost = ConnectionLost(f"connection to {self.addr} lost")
            for cb, _method in inflight.values():
                _invoke(cb, None, lost)
            if self._on_disconnect is not None:
                try:
                    self._on_disconnect()
                except Exception:
                    logger.exception("disconnect handler failed")

    def _handle_frame(self, frame: bytes) -> None:
        rec = pickle.loads(frame)
        msg_id, kind, method, payload = rec[0], rec[1], rec[2], rec[3]
        meta = rec[4] if len(rec) > 4 else None
        if kind in (REPLY, ERROR):
            slot = self._inflight.pop(msg_id, None)
            if slot is None:
                return
            cb, m = slot
            with self._lock:
                st = self._cstats.get(m)
                if st is None:
                    st = self._cstats[m] = [0, 0, 0, 0, 0, 0]
                st[4] += len(frame)
                st[2 if kind == REPLY else 3] += 1
                if meta and meta.get("re"):
                    st[5] += 1
            if kind == REPLY:
                _invoke(cb, payload, None)
            else:
                _invoke(cb, None, RpcError(payload))
        elif kind == PUSH:
            if meta and "ts" in meta:
                topic = method[4:] if method.startswith("pub:") else method
                record_pubsub_delivery(topic, time.time() - meta["ts"])
            if self._on_push is not None:
                try:
                    self._on_push(method, payload)
                except Exception:
                    logger.exception("push handler failed for %s", method)


class ResilientClient:
    """Self-healing RPC client: a Client that survives connection loss.

    Three guarantees on top of the raw Client:

    * reconnect with jittered exponential backoff (Backoff), re-resolving
      the peer address via ``addr_source`` on every attempt so a failover
      to a promoted standby is followed automatically;
    * per-call deadlines: ``timeout`` bounds the WHOLE call — connect
      time, reconnect retries and the in-flight wait all draw from one
      budget;
    * idempotent replay: ``call(..., idempotent=True)`` stamps the payload
      with an IDEM_KEY token, so a blind retry after a reconnect is
      answered from the server's replay cache instead of re-executing.

    Non-idempotent calls never retry once the request may have been sent:
    they surface ConnectionLost exactly like a plain Client.
    """

    def __init__(self, addr: Tuple[str, int], *,
                 addr_source: Optional[Callable[[], Any]] = None,
                 on_push: Optional[Callable[[str, Any], None]] = None,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 seed: Optional[int] = None, name: str = ""):
        self._addr = tuple(addr)
        self._addr_source = addr_source
        self._on_push = on_push
        self.name = name
        self._backoff_args = (backoff_base_s, backoff_cap_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._cli: Optional[Client] = None
        self._closed = False
        # flap-cost accounting (see client_stats): per-method
        # [attempts, retries]; plus stats carried over from replaced
        # Client instances so reconnects don't zero the byte counters
        self._rstats: Dict[str, list] = {}
        self._reconnects = 0
        self._backoff_s = 0.0
        self._prev_cstats: Dict[str, list] = {}

    @property
    def addr(self) -> Tuple[str, int]:
        return self._addr

    @property
    def closed(self) -> bool:
        return self._closed

    def _current_addr(self) -> Tuple[str, int]:
        if self._addr_source is not None:
            try:
                a = self._addr_source()
                if a:
                    self._addr = tuple(a)
            except Exception:
                pass
        return self._addr

    def _ensure(self, deadline: float) -> Client:
        with self._lock:
            if self._closed:
                raise ConnectionLost(f"{self.name or 'client'} closed")
            cli = self._cli
        if cli is not None and not cli.closed:
            return cli
        bo = Backoff(*self._backoff_args, rng=self._rng)
        last: Optional[Exception] = None
        while True:
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise ConnectionLost(
                    f"{self.name or 'client'}: could not (re)connect to "
                    f"{self._addr} before deadline: {last}")
            try:
                cli = Client(self._current_addr(), on_push=self._on_push,
                             connect_timeout=min(2.0, max(0.1, budget)),
                             name=f"{self.name}~resilient")
            except Exception as e:
                last = e
                bo.sleep(max_s=max(0.0, deadline - time.monotonic()))
                continue
            with self._lock:
                if self._closed:
                    cli.close()
                    raise ConnectionLost(f"{self.name or 'client'} closed")
                old, self._cli = self._cli, cli
            if old is not None and old is not cli:
                from ray_tpu_torch._private.rpc_stats import merge_client_stats

                prev = old.stats_raw()
                old.close()
                with self._lock:
                    self._reconnects += 1
                    merge_client_stats(self._prev_cstats, prev)
            return cli

    def call(self, method: str, payload: Any = None,
             timeout: float = 30.0, idempotent: bool = False) -> Any:
        deadline = time.monotonic() + timeout
        if idempotent and isinstance(payload, dict) \
                and IDEM_KEY not in payload:
            payload = {**payload, IDEM_KEY: idem_token()}
        bo = Backoff(*self._backoff_args, rng=self._rng)
        while True:
            cli = self._ensure(deadline)
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise ConnectionLost(
                    f"deadline exceeded calling {method!r}")
            with self._lock:
                rs = self._rstats.get(method)
                if rs is None:
                    rs = self._rstats[method] = [0, 0]
                rs[0] += 1
            try:
                return cli.call(method, payload, timeout=budget)
            except (ConnectionLost, OSError) as e:
                # the request may or may not have executed; only a
                # tokened (idempotent) call is safe to blind-retry
                if not idempotent or self._closed:
                    raise
                if time.monotonic() >= deadline:
                    raise ConnectionLost(
                        f"deadline exceeded retrying {method!r}: {e}")
                slept = bo.sleep(max_s=max(0.0,
                                           deadline - time.monotonic()))
                with self._lock:
                    rs[1] += 1
                    self._backoff_s += slept

    def notify(self, method: str, payload: Any = None,
               timeout: float = 5.0) -> None:
        cli = self._ensure(time.monotonic() + timeout)
        cli.notify(method, payload)

    def client_stats(self) -> Dict[str, Any]:
        """Partition-flap cost view: per-method wire counters (summed
        across every connection epoch) plus attempts/retries from the
        resilient retry loop, reconnect count and total backoff sleep."""
        from ray_tpu_torch._private.rpc_stats import merge_client_stats

        with self._lock:
            cli = self._cli
            agg = {m: list(s) for m, s in self._prev_cstats.items()}
            rstats = {m: list(v) for m, v in self._rstats.items()}
            reconnects, backoff_s = self._reconnects, self._backoff_s
        if cli is not None:
            merge_client_stats(agg, cli.stats_raw())
        methods = {}
        for m in set(agg) | set(rstats):
            s = agg.get(m, [0] * 6)
            r = rstats.get(m, [0, 0])
            methods[m] = {"calls": s[0], "bytes_out": s[1],
                          "replies": s[2], "errors": s[3],
                          "bytes_in": s[4], "replays": s[5],
                          "attempts": r[0], "retries": r[1]}
        return {"methods": methods, "reconnects": reconnects,
                "backoff_s": round(backoff_s, 3)}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            cli, self._cli = self._cli, None
        if cli is not None:
            cli.close()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class ServerConn:
    """Per-connection server-side handle; used to push messages (pubsub)."""

    def __init__(self, server: "Server", sock: socket.socket, peer: Tuple[str, int]):
        self.server = server
        self.sock = sock
        self.peer = peer
        self.send_lock = threading.Lock()
        self.meta: Dict[str, Any] = {}  # handlers stash identity here
        self.alive = True
        self._buf = bytearray()
        self._want = -1  # payload size being assembled, -1 = reading header

    def push(self, topic: str, payload: Any,
             meta: Optional[Dict[str, Any]] = None) -> bool:
        try:
            data = _pack_frame(0, PUSH, topic, payload, meta)
            with self.send_lock:
                send_frame(self.sock, data)
            return True
        except OSError:
            return False

    def send_raw(self, data: bytes) -> bool:
        """Send an already-serialized frame (fan-out paths pickle the
        frame once and send it to N subscribers)."""
        try:
            with self.send_lock:
                send_frame(self.sock, data)
            return True
        except OSError:
            return False

    def reply(self, msg_id: int, payload: Any,
              meta: Optional[Dict[str, Any]] = None) -> int:
        if msg_id == 0:
            return 0
        data = _pack_frame(msg_id, REPLY, "", payload, meta)
        with self.send_lock:
            send_frame(self.sock, data)
        return len(data)

    def reply_error(self, msg_id: int, err: str,
                    meta: Optional[Dict[str, Any]] = None) -> int:
        if msg_id == 0:
            return 0
        data = _pack_frame(msg_id, ERROR, "", err, meta)
        with self.send_lock:
            send_frame(self.sock, data)
        return len(data)


class Deferred:
    """Return from a handler to defer the reply; call resolve/reject later."""

    def __init__(self, conn: ServerConn, msg_id: int,
                 server: Optional["Server"] = None,
                 method: Optional[str] = None,
                 t0: Optional[float] = None):
        self._conn = conn
        self._msg_id = msg_id
        self._server = server
        self._method = method
        self._t0 = t0
        self._done = False

    def _finish(self, err: bool, nbytes: int) -> None:
        # deferred replies are the true request latency for long-polls:
        # record handle-time (and close the in-flight slot) at resolve
        if self._done or self._server is None or self._t0 is None:
            return
        self._done = True
        self._server._observe_done(
            self._method, time.perf_counter() - self._t0, err, nbytes)

    def resolve(self, payload: Any = None) -> None:
        nbytes = 0
        try:
            nbytes = self._conn.reply(self._msg_id, payload)
        except OSError:
            pass
        self._finish(False, nbytes)

    def reject(self, err: str) -> None:
        nbytes = 0
        try:
            nbytes = self._conn.reply_error(self._msg_id, err)
        except OSError:
            pass
        self._finish(True, nbytes)


class _ReplayEntry:
    """One recorded (or in-flight) idempotent execution (see IDEM_KEY)."""

    __slots__ = ("done", "value", "is_error", "waiters")

    def __init__(self):
        self.done = False
        self.value: Any = None
        self.is_error = False
        # (conn, msg_id) of duplicate callers parked until the first
        # execution resolves — a retry can race the original in flight
        self.waiters: list = []


class _RecordingDeferred(Deferred):
    """Deferred that records its outcome in the server's replay cache
    (releasing parked duplicate callers) before replying."""

    def __init__(self, server: "Server", token: str, conn: ServerConn,
                 msg_id: int, method: Optional[str] = None,
                 t0: Optional[float] = None):
        super().__init__(conn, msg_id, server=server, method=method, t0=t0)
        self._token = token

    def resolve(self, payload: Any = None) -> None:
        self._server._replay_finish(self._token, payload)
        super().resolve(payload)

    def reject(self, err: str) -> None:
        self._server._replay_fail(self._token, err)
        super().reject(err)


class Server:
    """Selector-based RPC server.

    Handlers: fn(conn: ServerConn, payload) -> result | Deferred-sentinel.
    A handler that needs to reply later returns `server.DEFER`; it then gets
    a `Deferred` via `conn.meta['_deferred']`... simpler: handlers may accept
    a third positional arg `deferred` by declaring `needs_deferred=True` at
    registration.  Runs its event loop in a dedicated thread.  Handler
    execution happens on the event-loop thread — handlers must not block; long
    work goes to executor threads owned by the embedding daemon.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, name: str = "rpc"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(512)
        self._listen.setblocking(False)
        self.addr: Tuple[str, int] = self._listen.getsockname()
        self._handlers: Dict[str, Tuple[Callable, bool]] = {}
        self._on_disconnect: Optional[Callable[[ServerConn], None]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns: Dict[socket.socket, ServerConn] = {}
        # per-handler flight recorder (reference: event_stats.h asio
        # handler instrumentation): method -> MethodStats with count,
        # in-flight, bytes, queue-wait and handle-time histograms.
        # Handlers run ON the loop thread, so a slow one stalls every
        # connection — these numbers find it.  _stats_lock is a leaf
        # lock (nothing is called while holding it): the loop thread and
        # off-loop Deferred completions both write here.
        self._stats_lock = threading.Lock()
        self._mstats: Dict[str, MethodStats] = {}
        # event-loop health: scheduled-vs-actual tick delta (a stalled
        # loop shows up as lag even when no RPC is in flight) and
        # frames-per-drain batching depth
        self._loop_lag = LatencyHist()
        self._loop_tick_s = 0.02
        self._drain_stats = [0, 0, 0]  # [drains, frames, max_batch]
        # Idempotency replay cache: token -> _ReplayEntry.  Bounded LRU;
        # a duplicate of a still-running execution is parked, a duplicate
        # of a finished one gets the recorded reply without re-executing.
        self._replay: "OrderedDict[str, _ReplayEntry]" = OrderedDict()
        self._replay_cap = 4096
        self._replay_lock = threading.Lock()
        self.handle("rpc_stats", lambda c, p: self.stats())
        self.handle("loop_stats", lambda c, p: self.loop_stats())

    def handle(self, method: str, fn: Callable, deferred: bool = False) -> None:
        self._handlers[method] = (fn, deferred)

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-handler flight-recorder snapshot: every REGISTERED method
        gets a row (zeros until first call) so consumers see the full
        handler surface, not just the hot set."""
        with self._stats_lock:
            for m in self._handlers:
                if m not in self._mstats:
                    self._mstats[m] = MethodStats(budget_ms(m))
            return {m: st.snapshot() for m, st in self._mstats.items()}

    def loop_stats(self) -> Dict[str, Any]:
        """Event-loop health: tick lag + dispatch batching depth."""
        with self._stats_lock:
            drains, frames, max_batch = self._drain_stats
            return {
                "lag_ms": self._loop_lag.snapshot(),
                "tick_s": self._loop_tick_s,
                "drains": drains,
                "frames": frames,
                "max_drain_batch": max_batch,
                "connections": len(self._conns),
            }

    def _observe_done(self, method: Optional[str], dt: float, err: bool,
                      nbytes: int, st: Optional[MethodStats] = None) -> None:
        """Close one request's accounting (sync reply, error reply, or a
        Deferred resolving later from an executor thread)."""
        if st is None:
            if method is None:
                return
            with self._stats_lock:
                st = self._mstats.get(method)
            if st is None:
                return
        warn_over = None
        with self._stats_lock:
            st.inflight -= 1
            st.handle.observe(dt)
            st.bytes_out += nbytes
            if err:
                st.errors += 1
            b = st.budget_ms
            if b is not None and dt * 1e3 > b:
                st.budget_exceeded += 1
                now = time.monotonic()
                if now - st.last_warn > 30.0:
                    st.last_warn = now
                    warn_over = (b, st.budget_exceeded)
        if warn_over is not None:
            logger.warning(
                "%s: handler %r took %.1fms (budget %.1fms, %d "
                "over-budget so far) — it runs on the event loop and "
                "stalls every connection", self.name, method, dt * 1e3,
                warn_over[0], warn_over[1])

    def on_disconnect(self, fn: Callable[[ServerConn], None]) -> None:
        self._on_disconnect = fn

    def start(self, thread: bool = True) -> None:
        self._sel.register(self._listen, selectors.EVENT_READ, None)
        if thread:
            self._thread = threading.Thread(
                target=self._loop, name=f"rpc-server-{self.name}", daemon=True
            )
            self._thread.start()
        else:
            self._loop()

    def stop(self) -> None:
        self._stop.set()
        try:
            # poke the selector awake
            s = socket.create_connection(self.addr, timeout=1.0)
            s.close()
        except OSError:
            pass
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    # -- loop --------------------------------------------------------------

    def _loop(self) -> None:
        # loop-lag probe: schedule a tick every _loop_tick_s; any handler
        # that wedges the loop shows up as (actual - scheduled) lateness
        tick = self._loop_tick_s
        next_tick = time.perf_counter() + tick
        while not self._stop.is_set():
            timeout = min(0.5, max(0.0, next_tick - time.perf_counter()))
            events = self._sel.select(timeout=timeout)
            for key, _ in events:
                if key.fileobj is self._listen:
                    self._accept()
                else:
                    self._read(key.fileobj)
            now = time.perf_counter()
            if now >= next_tick:
                with self._stats_lock:
                    self._loop_lag.observe(now - next_tick)
                next_tick = now + tick
        for sock in list(self._conns):
            self._drop(sock)
        self._sel.close()
        self._listen.close()

    def _accept(self) -> None:
        try:
            sock, peer = self._listen.accept()
        except OSError:
            return
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Socket stays BLOCKING: the selector only fires _read when data is
        # available (recv returns what's there without blocking), and writes
        # (replies/pushes, possibly multi-MB, possibly from worker threads)
        # need sendall semantics — a non-blocking sendall can partial-write
        # and desync the frame stream.
        conn = ServerConn(self, sock, peer)
        self._conns[sock] = conn
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _read(self, sock: socket.socket) -> None:
        conn = self._conns.get(sock)
        if conn is None:
            return
        try:
            data = sock.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            self._drop(sock)
            return
        conn._buf += data
        self._drain(conn, time.perf_counter())

    def _drain(self, conn: ServerConn, t_arr: Optional[float] = None) -> None:
        buf = conn._buf
        nframes = 0
        while True:
            if conn._want < 0:
                if len(buf) < _HEADER.size:
                    break
                (conn._want,) = _HEADER.unpack(bytes(buf[: _HEADER.size]))
                del buf[: _HEADER.size]
            if len(buf) < conn._want:
                break
            frame = bytes(buf[: conn._want])
            del buf[: conn._want]
            conn._want = -1
            nframes += 1
            # t_arr is the recv time for the whole burst: frame N's
            # queue-wait includes the handle time of frames 1..N-1 ahead
            # of it in this drain batch — that IS the dispatch queue
            self._dispatch(conn, frame, t_arr)
        if nframes:
            with self._stats_lock:
                ds = self._drain_stats
                ds[0] += 1
                ds[1] += nframes
                if nframes > ds[2]:
                    ds[2] = nframes

    def _dispatch(self, conn: ServerConn, frame: bytes,
                  t_arr: Optional[float] = None) -> None:
        try:
            rec = pickle.loads(frame)
            msg_id, kind, method, payload = rec[0], rec[1], rec[2], rec[3]
            meta = rec[4] if len(rec) > 4 else None
        except Exception:
            logger.exception("%s: bad frame from %s", self.name, conn.peer)
            return
        if kind != REQUEST:
            return
        entry = self._handlers.get(method)
        if entry is None:
            conn.reply_error(msg_id, f"no handler for {method!r}")
            return
        t0 = time.perf_counter()
        with self._stats_lock:
            st = self._mstats.get(method)
            if st is None:
                st = self._mstats[method] = MethodStats(budget_ms(method))
            st.count += 1
            st.bytes_in += len(frame)
            if t_arr is not None:
                st.qwait.observe(t0 - t_arr)
        fn, wants_deferred = entry
        token = payload.get(IDEM_KEY) if isinstance(payload, dict) else None
        if token is not None and msg_id != 0:
            if self._replay_begin(conn, msg_id, token):
                with self._stats_lock:
                    st.replays += 1
                return  # duplicate: answered from the cache or parked
        with self._stats_lock:
            st.inflight += 1
        span_cm = None
        if meta is not None and meta.get("tp"):
            t = _trace_mod()
            if t and t.is_enabled():
                span_cm = t.rpc_server_span(
                    method, {"traceparent": meta["tp"]}, server=self.name)
                span_cm.__enter__()
        d: Optional[Deferred] = None
        try:
            if wants_deferred:
                d = (Deferred(conn, msg_id, server=self, method=method,
                              t0=t0) if token is None
                     else _RecordingDeferred(self, token, conn, msg_id,
                                             method=method, t0=t0))
                fn(conn, payload, d)
            else:
                result = fn(conn, payload)
                if token is not None:
                    self._replay_finish(token, result)
                nbytes = conn.reply(msg_id, result)
                self._observe_done(method, time.perf_counter() - t0,
                                   False, nbytes, st=st)
        except Exception as e:
            tb = traceback.format_exc()
            logger.debug("%s: handler %s raised: %s", self.name, method, e)
            err = f"{type(e).__name__}: {e}\n{tb}"
            if token is not None:
                self._replay_fail(token, err)
            if d is not None:
                # the deferred may never resolve after a raise — close
                # its accounting here (unless it already resolved before
                # raising) and make a late resolve a no-op
                if not d._done:
                    d._done = True
                    self._observe_done(method, time.perf_counter() - t0,
                                       True, 0, st=st)
            else:
                self._observe_done(method, time.perf_counter() - t0,
                                   True, 0, st=st)
            try:
                conn.reply_error(msg_id, err)
            except OSError:
                self._drop(conn.sock)
        finally:
            if span_cm is not None:
                span_cm.__exit__(None, None, None)

    # -- idempotency replay (see IDEM_KEY) ----------------------------------

    def _replay_begin(self, conn: ServerConn, msg_id: int,
                      token: str) -> bool:
        """Returns True if this request was handled from the cache (the
        caller must NOT execute the handler)."""
        with self._replay_lock:
            entry = self._replay.get(token)
            if entry is None:
                entry = _ReplayEntry()
                self._replay[token] = entry
                while len(self._replay) > self._replay_cap:
                    old_tok, old = next(iter(self._replay.items()))
                    if not old.done:
                        break  # never evict an in-flight execution
                    self._replay.pop(old_tok)
                return False
            self._replay.move_to_end(token)
            if not entry.done:
                entry.waiters.append((conn, msg_id))
                return True
            value, is_error = entry.value, entry.is_error
        try:
            if is_error:
                conn.reply_error(msg_id, value, meta={"re": 1})
            else:
                conn.reply(msg_id, value, meta={"re": 1})
        except OSError:
            pass
        return True

    def _replay_finish(self, token: str, value: Any) -> None:
        with self._replay_lock:
            entry = self._replay.get(token)
            if entry is None:
                return
            entry.done = True
            entry.value = value
            entry.is_error = False
            waiters, entry.waiters = entry.waiters, []
        for conn, msg_id in waiters:
            try:
                conn.reply(msg_id, value, meta={"re": 1})
            except OSError:
                pass

    def _replay_fail(self, token: str, err: str) -> None:
        """A failed execution is NOT cached — the error may be transient
        and a retry should re-execute; parked duplicates still get it."""
        with self._replay_lock:
            entry = self._replay.pop(token, None)
            waiters = entry.waiters if entry is not None else []
        for conn, msg_id in waiters:
            try:
                conn.reply_error(msg_id, err, meta={"re": 1})
            except OSError:
                pass

    def _drop(self, sock: socket.socket) -> None:
        conn = self._conns.pop(sock, None)
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        try:
            sock.close()
        except OSError:
            pass
        if conn is not None:
            conn.alive = False
            if self._on_disconnect is not None:
                try:
                    self._on_disconnect(conn)
                except Exception:
                    logger.exception("%s: disconnect callback failed", self.name)
