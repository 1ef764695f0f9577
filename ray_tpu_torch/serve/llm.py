"""LLM serving: a continuous-batching inference engine behind Serve.

Counterpart of ``ray_tpu/serve/llm.py``, on the port's GPT
(``models/gpt.py``) and its continuous-batching engine
(``serve/_engine.py``).  By default each replica hosts the engine over a
**paged KV cache**: one decode step over a fixed batch of slots,
sequences joining at prefill and leaving at EOS/max-tokens at every
step, pages refcounted with live prompt-prefix sharing and
copy-on-write.  Both the request/response route and token streaming ride
the same engine, so a short request never waits behind a long one.

Engine selection (``RAY_TPU_TORCH_SERVE_ENGINE`` or ``engine=`` at bind
time):

  * ``paged`` (default) — continuous batching, paged KV arena;
  * ``contiguous`` — continuous batching over per-slot contiguous
    caches (the bitwise-parity baseline for the paged path);
  * ``static`` — ``serve.batch`` micro-batching: requests grouped by
    (prompt_len, max_new, sampling params, seed), each group one
    ``gpt.generate`` call; streaming runs one request's prefill and
    decode loop (``gpt.generate_tokens``).

Where the reference differs: every model-facing step here is eager
PyTorch, so there is no compiled program per shape and no program cache
(the reference's ``_cached`` and its ``serve_gen_cache_cap`` flag); the
engine takes no ``prefill_bucket`` (prefill takes the unpadded prompt),
and the port has no ``serve_prefill_bucket`` flag.
A replica computes on ``device`` (default ``cuda``): a replica that
finds no card raises rather than serve from the CPU, so a deployment
meant for the card asks for it with ``ray_actor_options={"num_gpus":
1}``, without which the runtime spawns its worker with no card visible.

All engine sizing knobs (slots, page size, arena pages, admission
watermarks) are the ``RAY_TPU_TORCH_SERVE_*`` flags in
_private/config.py.  Prompts and completions are token-id lists:
tokenizers are out of scope.

Importing this module loads no torch: the model code loads in the
replica, when the deployment is constructed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .._private.config import cfg as _config
from ._deployment import deployment
from .api import run
from .batching import batch

__all__ = ["LLMServer", "build_llm_app"]


def _bucket(n: int, step: int = 128) -> int:
    return ((n + step - 1) // step) * step


def _on_device(tree, device):
    """The param tree with every tensor on ``device`` (no copy where it
    already lies there)."""
    return {k: (_on_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}


class _LLMServerImpl:
    """Deployment body.  cfg_kwargs are GPTConfig fields (or pass
    `preset="gpt2_small"`); params_loader() runs ON THE REPLICA (the
    driver never materializes the weights) and may return either a
    params dict of tensors, or a (GPTConfig, params) pair; its tensors
    are moved to the replica's device.  ``device`` is where the replica
    computes: ``None`` means ``cuda``, which raises without a card."""

    def __init__(self, preset: str = "nano", cfg_kwargs: Optional[dict] = None,
                 params_loader=None, max_seq: int = 512,
                 engine: Optional[str] = None,
                 engine_kwargs: Optional[dict] = None, device=None):
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.models import gpt

        self._gpt = gpt
        self.device = resolve_device(device)
        user_cfg_kwargs = dict(cfg_kwargs or {})
        cfg_kwargs = dict(user_cfg_kwargs)
        cfg_kwargs.setdefault("max_seq", max_seq)
        self._cfg = getattr(gpt.GPTConfig, preset)(**cfg_kwargs)
        loaded = params_loader() if params_loader is not None else None
        if params_loader is not None and loaded is None:
            raise ValueError("params_loader returned None (missing "
                             "return?) — refusing to serve random "
                             "weights in its place")
        if isinstance(loaded, tuple):
            self._cfg, params = loaded
            if user_cfg_kwargs:
                # user overrides still apply on top of the loaded config
                import dataclasses

                self._cfg = dataclasses.replace(self._cfg,
                                                **user_cfg_kwargs)
        elif loaded is not None:
            params = loaded
        else:
            params = gpt.init(self._cfg, seed=0, device=self.device)
        self._params = _on_device(params, self.device)
        self._engine_mode = engine or _config().serve_engine
        if self._engine_mode not in ("paged", "contiguous", "static"):
            raise ValueError(f"unknown engine {self._engine_mode!r}")
        self._engine_kwargs = dict(engine_kwargs or {})
        self._engine = None   # built lazily: direct construction (tests,
        #                       tooling) must not allocate the KV arena

    def _get_engine(self):
        if self._engine is None:
            from ._engine import ContinuousEngine

            c = _config()
            kw = dict(cache=self._engine_mode,
                      max_slots=c.serve_max_slots,
                      page_size=c.serve_page_size,
                      num_pages=c.serve_num_pages,
                      max_total=c.serve_max_total,
                      queue_cap=c.serve_queue_cap,
                      shed_queue_depth=c.serve_shed_queue_depth,
                      retry_after_s=c.serve_retry_after_s,
                      stall_s=c.serve_engine_stall_s)
            kw.update(self._engine_kwargs)
            self._engine = ContinuousEngine(self._gpt, self._cfg,
                                            self._params, device=self.device,
                                            **kw)
        return self._engine

    def engine_stats(self) -> Optional[Dict[str, Any]]:
        """Scheduler snapshot for the replica metrics poll (None until
        the engine has processed its first request, or in static mode)."""
        if self._engine is None:
            return None
        return self._engine.engine_stats()

    def check_health(self):
        """Engine-level liveness probe (controller health loop): a hung
        decode step or dead scheduler thread raises here, which gets this
        replica restarted instead of timing out every request forever."""
        if self._engine is not None:
            self._engine.check_health()

    def prepare_shutdown(self, drain_s: float = 5.0) -> bool:
        """Graceful drain: stop admitting and let active decode slots
        finish before the controller kills the actor."""
        if self._engine is not None:
            return self._engine.drain(drain_s)
        return True

    @staticmethod
    def _request_id() -> Optional[str]:
        """Per-request id from the replica request context (proxy/handle
        propagate it via metadata) — threads it into engine stats so a
        replayed request is traceable across replicas."""
        from ._replica import _request_context

        ctx = _request_context.get()
        return (ctx or {}).get("request_id") if isinstance(ctx, dict) \
            else None

    def _check_capacity(self, plen: int, max_new: int):
        if self._cfg.pos == "learned" and plen + max_new > self._cfg.max_seq:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) exceeds "
                f"the model's learned-position capacity "
                f"({self._cfg.max_seq})")

    async def generate_batch(self, requests: List[Dict[str, Any]]
                             ) -> List[Dict[str, Any]]:
        """Group by (prompt_len, max_new, temperature, top_k, seed): each
        group is one stacked generate() call."""
        groups: Dict[tuple, List[int]] = {}
        for i, r in enumerate(requests):
            key = (len(r["tokens"]), int(r.get("max_new_tokens", 16)),
                   float(r.get("temperature", 0.0)),
                   r.get("top_k"), int(r.get("seed", 0)))
            groups.setdefault(key, []).append(i)
        out: List[Optional[Dict[str, Any]]] = [None] * len(requests)
        for (plen, max_new, temp, top_k, seed), idxs in groups.items():
            self._check_capacity(plen, max_new)
            prompts = [list(requests[i]["tokens"]) for i in idxs]
            toks = self._gpt.generate(
                self._params, self._cfg, prompts, max_new,
                temperature=temp, top_k=top_k, seed=seed,
                max_seq=_bucket(plen + max_new), device=self.device)
            toks = toks.tolist()
            for row, i in enumerate(idxs):
                out[i] = {"tokens": toks[row],
                          "completion": toks[row][plen:],
                          "batch_size": len(idxs)}
        return out

    def stream_tokens(self, tokens: List[int], max_new_tokens: int = 16,
                      temperature: float = 0.0, seed: int = 0,
                      top_k: Optional[int] = None,
                      eos_id: Optional[int] = None,
                      key_offset: int = 0):
        """Yield one sampled token id at a time (generator => Serve
        streams it as SSE/chunked over HTTP, itemwise over handles).
        Under the continuous engine the stream is fed by the shared
        slot-batch step loop (tokens appear as the scheduler emits
        them); in static mode it is one request's own prefill and decode
        loop, the batched route's code at B = 1.  Token i is drawn with
        ``gpt.token_key(seed, key_offset + i)`` either way, so a resumed
        stream (router continuation: the delivered tokens folded into
        the prompt, ``key_offset`` past them) continues the uninterrupted
        run's noise exactly."""
        if self._engine_mode != "static":
            eng = self._get_engine()
            seq = eng.submit(tokens, max_new_tokens, temperature, seed,
                             top_k, eos_id=eos_id, stream=True,
                             request_id=self._request_id(),
                             key_offset=key_offset)
            yield from eng.stream(seq)
            return
        if not tokens:
            raise ValueError("empty prompt: stream_tokens needs at "
                             "least one prompt token")
        self._check_capacity(len(tokens), max_new_tokens)
        # the batched route's cache length for the same request: a resumed
        # stream (prompt longer, max_new shorter by as much) keeps it too
        total = _bucket(len(tokens) + max_new_tokens)
        for tok in self._gpt.generate_tokens(
                self._params, self._cfg, [list(tokens)], max_new_tokens,
                temperature=temperature, top_k=top_k, seed=seed,
                key_offset=key_offset, max_seq=total, device=self.device):
            yield int(tok[0])

    async def _engine_generate(self, body: Dict[str, Any]
                               ) -> Dict[str, Any]:
        """Request/response through the continuous engine: submit is a
        queue append; the result future resolves on the engine thread
        when the sequence leaves its slot."""
        import asyncio

        seq = self._get_engine().submit(
            body["tokens"], int(body.get("max_new_tokens", 16)),
            float(body.get("temperature", 0.0)),
            int(body.get("seed", 0)), body.get("top_k"),
            eos_id=body.get("eos_id"), request_id=self._request_id())
        return await asyncio.wrap_future(seq.result)

    async def __call__(self, request):
        # handle calls pass the body dict directly; HTTP passes a Request
        is_http = not isinstance(request, dict)
        body = await request.json() if is_http else request
        if body.get("stream"):
            if is_http:
                # the HTTP proxy streams only ingresses whose __call__
                # is itself a generator function — that is the dedicated
                # stream app build_llm_app deploys next door
                raise ValueError(
                    "token streaming over HTTP lives on the companion "
                    "'<route>-stream' endpoint; this route is the "
                    "micro-batched JSON API")
            return self.stream_tokens(
                body["tokens"], int(body.get("max_new_tokens", 16)),
                float(body.get("temperature", 0.0)),
                int(body.get("seed", 0)), body.get("top_k"),
                body.get("eos_id"))
        if self._engine_mode != "static":
            return await self._engine_generate(body)
        return await self.generate_batch(body)


def _server_class(max_batch_size: int = 8,
                  batch_wait_timeout_s: float = 0.02) -> type:
    """The class an LLMServer replica instantiates: _LLMServerImpl with
    generate_batch wrapped by serve.batch (a class of its own per
    deployment, so the wrap happens once)."""
    cls = type("LLMServer", (_LLMServerImpl,), {})
    cls.generate_batch = batch(_LLMServerImpl.generate_batch,
                               max_batch_size=max_batch_size,
                               batch_wait_timeout_s=batch_wait_timeout_s)
    return cls


def LLMServer(**deployment_kwargs):
    """`LLMServer().bind(preset=..., ...)`-style factory: returns the
    deployment (decorate-once so serve.batch wraps generate_batch).  A
    replica meant for the card asks for it:
    `LLMServer(ray_actor_options={"num_gpus": 1})`."""
    cls = _server_class(
        max_batch_size=deployment_kwargs.pop("max_batch_size", 8),
        batch_wait_timeout_s=deployment_kwargs.pop(
            "batch_wait_timeout_s", 0.02))
    return deployment(cls, **deployment_kwargs) \
        if deployment_kwargs else deployment(cls)


class _LLMStreamIngress:
    """HTTP token-streaming ingress: an async-GENERATOR __call__ (the
    proxy streams chunked/SSE only for generator ingresses), relaying
    the shared engine's stream_tokens through a streaming handle —
    weights live once, in the engine deployment."""

    def __init__(self, engine_app: str):
        self._engine_app = engine_app
        self._h = None

    async def __call__(self, request):
        import json as _json

        from .api import get_app_handle

        body = request if isinstance(request, dict) else \
            await request.json()
        if self._h is None:
            self._h = get_app_handle(self._engine_app)
        # resume="llm_tokens": if the engine replica dies mid-stream the
        # router replays prompt+tokens_so_far on a survivor, so the
        # client stream continues instead of restarting from token 0
        gen = self._h.options(
            stream=True, resume="llm_tokens").stream_tokens.remote(
            body["tokens"], int(body.get("max_new_tokens", 16)),
            float(body.get("temperature", 0.0)),
            int(body.get("seed", 0)), body.get("top_k"),
            body.get("eos_id"))
        async for tok in gen:
            yield _json.dumps({"token": int(tok)}) + "\n"


def build_llm_app(preset: str = "nano", *, route_prefix: str = "/llm",
                  name: str = "llm", stream: bool = True,
                  deployment_options: Optional[dict] = None, **init_kwargs):
    """Deploy a generation endpoint: POST {tokens, max_new_tokens, ...}
    -> {tokens, completion} at `route_prefix` (micro-batched), plus a
    token-streaming endpoint at `route_prefix`-stream.
    ``deployment_options`` go to ``LLMServer`` (e.g. ``{"ray_actor_options":
    {"num_gpus": 1}, "num_replicas": 2}``); ``init_kwargs`` to the
    replica's constructor."""
    dep = LLMServer(**dict(deployment_options or {}))
    h = run(dep.bind(preset=preset, **init_kwargs), name=name,
            route_prefix=route_prefix)
    if stream:
        run(deployment(_LLMStreamIngress).bind(name),
            name=f"{name}-stream", route_prefix=f"{route_prefix}-stream")
    return h
