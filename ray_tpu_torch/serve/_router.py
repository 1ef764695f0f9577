"""Router: picks a replica for each request and replays on failure.

Reference: python/ray/serve/_private/router.py:313 Router +
replica_scheduler/pow_2_scheduler.py:52 PowerOfTwoChoicesReplicaScheduler —
pick two random candidates, route to the one with the shorter queue.  Queue
lengths come from the controller's metrics probes (cached replica table)
plus a local in-flight count per replica, so the hot path makes NO extra
RPCs.  Multiplexed requests prefer replicas that already hold the model.

Fault tolerance lives here too: every request is a `_Submission` that
remembers how to re-issue itself.  When the assigned replica dies
mid-call (actor-died / worker-crashed / object-lost, or an optional
per-attempt deadline expires), the router ejects the replica from its
table and replays the request on a survivor, bounded by
``serve_replay_budget``; exhausting the budget surfaces the ORIGINAL
error.  Streaming requests resume by continuation: a deployment that
registers a continuation (``metadata["resume"]``) gets its remaining
call rewritten from the items already yielded — the built-in
``llm_tokens`` continuation replays ``prompt + tokens_so_far`` with the
sampling-key schedule offset, so greedy AND sampled decode continue
bitwise-identically and the client stream never restarts from token 0.

The port's copy of ``ray_tpu/serve/_router.py``: imports renamed, variables
``RAY_TPU_TORCH_*``; what else differs is in ROADMAP §C.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Set

import ray_tpu_torch

from .._private.config import cfg as _config
from ._common import CONTROLLER_NAME, NoCapacityError

logger = logging.getLogger(__name__)

_TABLE_TTL_S = 1.0
# a replay must not wait the full cold-start pick deadline: if no
# survivor appears quickly the caller wants the original error back
_REPLAY_PICK_TIMEOUT_S = 5.0

_FAILURE_TYPES = (ray_tpu_torch.ActorDiedError,
                  ray_tpu_torch.WorkerCrashedError,
                  ray_tpu_torch.ObjectLostError)
_FAILURE_NAMES = ("ActorDiedError", "WorkerCrashedError", "ObjectLostError")


def replica_failure(e: BaseException) -> bool:
    """True when `e` means the REPLICA is gone/unreachable (replayable),
    as opposed to the request itself failing (app exception, shed).
    Replica-side deaths can cross the task boundary wrapped, so the text
    match backstops the isinstance check."""
    if isinstance(e, _FAILURE_TYPES):
        return True
    if isinstance(e, (NoCapacityError, ValueError, TypeError)):
        return False
    txt = str(e)
    return any(name in txt for name in _FAILURE_NAMES)


# -- continuations -----------------------------------------------------------
# resume functions for streaming requests: (args, kwargs, yielded_items)
# -> (new_args, new_kwargs) for the remainder of the stream, or None when
# the yielded items already complete it.  Keyed by metadata["resume"].

_CONTINUATIONS: Dict[str, Callable] = {}


def register_continuation(name: str, fn: Callable) -> None:
    _CONTINUATIONS[name] = fn


def _resume_llm_tokens(args, kwargs, yielded):
    """Continuation for llm.stream_tokens(tokens, max_new_tokens,
    temperature, seed, top_k, eos_id, key_offset): fold the tokens the
    client already received into the prompt and offset the sampling-key
    schedule so the resumed decode draws the SAME keys the interrupted
    one would have — bitwise-identical continuation, greedy or sampled."""
    names = ("tokens", "max_new_tokens", "temperature", "seed", "top_k",
             "eos_id", "key_offset")
    bound = dict(zip(names, args))
    bound.update(kwargs)
    done = [int(t) for t in yielded]
    eos = bound.get("eos_id")
    if eos is not None and done and done[-1] == int(eos):
        return None                      # stream had already finished
    remaining = int(bound.get("max_new_tokens", 16)) - len(done)
    if remaining < 1:
        return None
    bound["tokens"] = list(bound.get("tokens") or ()) + done
    bound["max_new_tokens"] = remaining
    bound["key_offset"] = int(bound.get("key_offset") or 0) + len(done)
    return (), bound


register_continuation("llm_tokens", _resume_llm_tokens)


class _Submission:
    """One logical request: everything needed to re-issue it after the
    assigned replica dies.  `ref`/`rid`/`_done` describe the CURRENT
    attempt; `yielded` holds streamed items not yet folded into the args
    by a continuation."""

    __slots__ = ("method", "method_name", "args", "kwargs", "metadata",
                 "streaming", "request_id", "rid", "ref", "_done",
                 "attempts", "first_error", "failed_rids",
                 "yielded_count", "yielded")

    def __init__(self, method: str, method_name: Optional[str], args,
                 kwargs, metadata: Optional[Dict[str, Any]],
                 streaming: bool):
        self.method = method
        self.method_name = method_name
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.metadata = dict(metadata or {})
        self.metadata.setdefault("request_id", uuid.uuid4().hex[:16])
        self.streaming = streaming
        self.request_id: str = self.metadata["request_id"]
        self.rid: Optional[str] = None
        self.ref = None
        self._done: Optional[Callable] = None
        self.attempts = 0
        self.first_error: Optional[BaseException] = None
        self.failed_rids: Set[str] = set()
        self.yielded_count = 0
        self.yielded: list = []

    def fire_done(self):
        """Release the current attempt's in-flight slot (idempotent)."""
        cb, self._done = self._done, None
        if cb is not None:
            cb()


class Router:
    def __init__(self, app_name: str, deployment_name: str, controller=None):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self._controller = controller
        self._lock = threading.Lock()
        # signaled whenever _refresh lands a new replica table, so _pick
        # waiters wake immediately instead of polling on a sleep
        self._table_cv = threading.Condition(self._lock)
        self._replicas: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._max_ongoing = 100
        self._inflight: Dict[str, int] = {}             # guarded-by: _lock
        self._last_refresh = 0.0

    def _get_controller(self):
        if self._controller is None:
            self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return self._controller

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < _TABLE_TTL_S:
            return
        table = ray_tpu_torch.get(
            self._get_controller().get_replica_table.remote(
                self.app_name, self.deployment_name), timeout=30.0)
        with self._lock:
            self._replicas = {r["replica_id"]: r
                              for r in table["replicas"]}
            self._max_ongoing = table.get("max_ongoing_requests", 100)
            for rid in list(self._inflight):
                if rid not in self._replicas:
                    del self._inflight[rid]
            self._last_refresh = now
            self._table_cv.notify_all()

    def eject(self, rid: str, request_id: str = "", reason: str = ""):
        """Drop a replica the caller observed failing: it leaves the
        local table immediately (don't route more requests into a dead
        actor while the controller converges) and the next pick re-pulls
        the authoritative table."""
        with self._lock:
            existed = self._replicas.pop(rid, None) is not None
            self._inflight.pop(rid, None)
            self._last_refresh = 0.0
        if existed:
            logger.warning("serve replay: ejected replica %s (%s) "
                           "request=%s", rid, reason or "failure",
                           request_id)

    def _pick(self, model_id: Optional[str] = None,
              timeout_s: float = 30.0,
              exclude: Optional[Set[str]] = None) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout_s
        exclude = exclude or set()
        while True:
            self._refresh()
            with self._lock:
                cands = [c for c in self._replicas.values()
                         if c["replica_id"] not in exclude]
                if cands:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"no RUNNING replicas of "
                        f"{self.app_name}:{self.deployment_name}")
                self._last_refresh = 0.0  # force re-pull next loop
                # wake as soon as any thread's _refresh lands replicas
                # (the timeout only bounds the controller re-poll cadence)
                self._table_cv.wait(timeout=min(0.25, remaining))
        if model_id is not None:
            warm = [c for c in cands if model_id in c.get("model_ids", ())]
            if warm:
                cands = warm
        # admission control on engine headroom: replicas whose decode
        # engine reports accepting=False (queue past the shed watermark)
        # are skipped; with NOBODY accepting, shed the request here —
        # the proxy turns NoCapacityError into 503 + Retry-After
        accepting = [c for c in cands
                     if not isinstance(c.get("engine"), dict)
                     or c["engine"].get("accepting", True)]
        if not accepting:
            retry = max((c["engine"].get("retry_after_s", 1.0)
                         for c in cands
                         if isinstance(c.get("engine"), dict)),
                        default=1.0)
            raise NoCapacityError(
                f"all {len(cands)} replicas of "
                f"{self.app_name}:{self.deployment_name} are shedding "
                f"(engine queues past watermark)", retry_after_s=retry)
        cands = accepting
        # drain preference, NOT refusal: a replica on a draining node
        # keeps serving as the fallback (zero-drop guarantee on a
        # single-node cluster) but loses traffic whenever a healthy
        # replica exists
        fresh = [c for c in cands if not c.get("draining")]
        if fresh:
            cands = fresh
        if len(cands) == 1:
            return cands[0]
        a, b = random.sample(cands, 2)
        with self._lock:
            qa = self._inflight.get(a["replica_id"], 0)
            qb = self._inflight.get(b["replica_id"], 0)
        return a if qa <= qb else b

    # -- submission / replay core -------------------------------------------

    def submit(self, method_name: Optional[str], args, kwargs,
               metadata: Optional[Dict[str, Any]] = None,
               streaming: bool = False) -> _Submission:
        """Pick a replica and submit; returns the `_Submission` that
        `call()` / `iter_stream()` consume (and replay on failure)."""
        sub = _Submission(
            "handle_request_streaming" if streaming else "handle_request",
            method_name, args, kwargs, metadata, streaming)
        return self._submit_attempt(sub)

    def _submit_attempt(self, sub: _Submission,
                        timeout_s: float = 30.0) -> _Submission:
        model_id = sub.metadata.get("multiplexed_model_id")
        replica = self._pick(model_id, timeout_s=timeout_s,
                             exclude=sub.failed_rids)
        rid = replica["replica_id"]
        with self._lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + 1

        def done():
            with self._lock:
                n = self._inflight.get(rid, 1)
                self._inflight[rid] = max(0, n - 1)

        try:
            m = getattr(replica["handle"], sub.method)
            if sub.streaming:
                m = m.options(num_returns="streaming")
            ref = m.remote(sub.method_name, sub.args, sub.kwargs,
                           sub.metadata)
        except BaseException:
            # a submission that never produced a ref must not count
            # against the replica forever (it would skew power-of-two
            # choice until the replica left the table)
            done()
            raise
        sub.rid = rid
        sub.ref = ref
        sub.attempts += 1
        sub._done = done
        return sub

    def _replay(self, sub: _Submission, err: BaseException) -> None:
        """Account one failed attempt and resubmit to a survivor.
        Raises the ORIGINAL error when the replay budget is exhausted or
        no surviving replica takes the request."""
        if sub.first_error is None:
            sub.first_error = err
        sub.fire_done()
        if sub.rid is not None:
            sub.failed_rids.add(sub.rid)
            self.eject(sub.rid, request_id=sub.request_id,
                       reason=type(err).__name__)
        budget = _config().serve_replay_budget
        if sub.attempts > budget:
            logger.error(
                "serve replay: request %s exhausted replay budget "
                "(%d attempts); raising original error", sub.request_id,
                sub.attempts)
            raise sub.first_error
        logger.warning(
            "serve replay: request %s replaying (attempt %d) after %s "
            "on replica %s", sub.request_id, sub.attempts + 1,
            type(err).__name__, sub.rid)
        try:
            self._submit_attempt(sub, timeout_s=_REPLAY_PICK_TIMEOUT_S)
        except (RuntimeError, NoCapacityError) as e2:
            # nobody left to replay on: the replica failure is the story,
            # not the empty table it caused
            raise sub.first_error from e2

    def call(self, sub: _Submission,
             timeout_s: Optional[float] = 300.0) -> Any:
        """Resolve a unary submission, replaying across replica deaths.
        With ``serve_call_deadline_s`` set, an attempt that produces no
        answer within the deadline is treated as a dead replica too."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            per_call = _config().serve_call_deadline_s
            t = None
            if deadline is not None:
                t = max(0.0, deadline - time.monotonic())
            if per_call > 0:
                t = per_call if t is None else min(t, per_call)
            try:
                out = ray_tpu_torch.get(sub.ref, timeout=t)
                sub.fire_done()
                return out
            except ray_tpu_torch.GetTimeoutError:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if per_call > 0 and (left is None or left > 0):
                    err = ray_tpu_torch.GetTimeoutError(
                        f"replica {sub.rid} unresponsive after "
                        f"{per_call:g}s (request {sub.request_id})")
                    self._replay(sub, err)
                    continue
                sub.fire_done()
                raise
            except Exception as e:
                if not replica_failure(e):
                    sub.fire_done()
                    raise
                self._replay(sub, e)

    def iter_stream(self, sub: _Submission,
                    item_timeout_s: float = 300.0):
        """Iterate a streaming submission's items, replaying/resuming
        across replica deaths.  Closing the generator early (client
        abandoned the stream) still releases the in-flight slot."""
        resume_key = sub.metadata.get("resume")
        cont = _CONTINUATIONS.get(resume_key) if resume_key else None
        try:
            while True:
                per = _config().serve_call_deadline_s
                t = min(item_timeout_s, per) if per > 0 else item_timeout_s
                try:
                    for ref in sub.ref:
                        item = ray_tpu_torch.get(ref, timeout=t)
                        sub.yielded_count += 1
                        if cont is not None:
                            sub.yielded.append(item)
                        yield item
                    return
                except Exception as e:
                    timed_out = (per > 0 and isinstance(
                        e, ray_tpu_torch.GetTimeoutError))
                    if not (replica_failure(e) or timed_out):
                        raise
                    if sub.yielded_count and cont is None:
                        # items already reached the client and nothing
                        # knows how to resume: replaying from scratch
                        # would re-send them
                        raise
                    if cont is not None and sub.yielded:
                        rewritten = cont(sub.args, sub.kwargs, sub.yielded)
                        if rewritten is None:
                            return       # stream was already complete
                        sub.args, sub.kwargs = rewritten
                        sub.yielded = []   # folded into args now
                    self._replay(sub, e)
                    logger.info(
                        "serve replay: request %s stream resumed at "
                        "item %d on replica %s", sub.request_id,
                        sub.yielded_count, sub.rid)
        finally:
            sub.fire_done()

    # -- legacy one-shot API (no replay) ------------------------------------

    def assign(self, method_name: Optional[str], args, kwargs,
               metadata: Optional[Dict[str, Any]] = None):
        """Submit to a chosen replica; returns (ObjectRef, done_cb)."""
        sub = self.submit(method_name, args, kwargs, metadata,
                          streaming=False)
        return sub.ref, sub.fire_done

    def assign_streaming(self, method_name: Optional[str], args, kwargs,
                         metadata: Optional[Dict[str, Any]] = None):
        """Streaming submit; returns (ObjectRefGenerator, done_cb) — one
        ref per item the deployment yields."""
        sub = self.submit(method_name, args, kwargs, metadata,
                          streaming=True)
        return sub.ref, sub.fire_done


_routers: Dict[Any, Router] = {}
_routers_lock = threading.Lock()


def get_router(app_name: str, deployment_name: str) -> Router:
    key = (app_name, deployment_name)
    with _routers_lock:
        r = _routers.get(key)
        if r is None:
            r = Router(app_name, deployment_name)
            _routers[key] = r
        return r


def reset_routers():
    with _routers_lock:
        _routers.clear()
