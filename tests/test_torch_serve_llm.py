"""The port's LLM deployment (``ray_tpu_torch/serve/llm.py``) on the CPU,
the cases of tests/test_serve_llm.py and more, on the nano GPT in f32
with ``device="cpu"``:

* greedy completions through the port's Serve — handle, HTTP, the
  ``-stream`` route, a streaming handle and the RPC ingress — equal the
  JAX package's ``gpt.generate`` on the same weights, token for token
  (the weights cross with ``models.convert.from_jax_params`` inside a
  ``params_loader`` that runs on the replica);
* the three engine modes agree: static == paged == contiguous, batched
  and streamed, greedy and sampled (sampled decodes are held port against
  port: JAX's PRNG cannot be matched);
* a resumed static stream (the router's continuation: delivered tokens
  folded into the prompt, ``key_offset`` past them) continues the
  uninterrupted stream;
* a replica bound without ``device`` on a worker that was granted no GPU
  fails to deploy, with the no-CUDA message: nothing falls back to the
  CPU;
* a static replica keeps no state per request shape (the reference's
  bounded compile cache has nothing to hold in eager PyTorch).
"""

import asyncio
import json
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch as rt
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import serve
from ray_tpu_torch.models import gpt
from ray_tpu_torch.serve.llm import (LLMServer, _LLMServerImpl,
                                     build_llm_app)

torch.set_num_threads(1)

MAX_SEQ = 128
PROMPTS = [[3, 14, 15, 92, 6, 5], [1, 2, 3], [7, 7, 7, 7, 9, 11, 13, 200, 4],
           [250]]
F32 = {"dtype": torch.float32}
T = 180


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jgpt.GPTConfig.nano(max_seq=MAX_SEQ, dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams


def _jax_greedy(jax_model, prompt, n_new):
    jcfg, jparams = jax_model
    out = jgpt.generate(jparams, jcfg, jnp.asarray([prompt]), n_new,
                        max_seq=MAX_SEQ)
    return np.asarray(out)[0].tolist()


def _loader_of(jparams):
    """A params_loader carrying the JAX package's weights as numpy: it
    runs on the replica, which imports no JAX."""
    tree = jax.tree.map(np.asarray, jparams)

    def load():
        from ray_tpu_torch.models import convert
        from ray_tpu_torch.models import gpt as tgpt

        cfg = tgpt.GPTConfig.nano(max_seq=MAX_SEQ, dtype=torch.float32)
        return convert.from_jax_params(tree, cfg, device="cpu")

    return load


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    serve.shutdown()
    rt.shutdown()


@pytest.fixture(scope="module")
def jax_app(cluster, jax_model):
    """build_llm_app on the JAX package's weights: the paged engine
    behind a handle, HTTP and the -stream route."""
    h = build_llm_app("nano", name="llm_jax", route_prefix="/llmj",
                      cfg_kwargs=F32, max_seq=MAX_SEQ, device="cpu",
                      params_loader=_loader_of(jax_model[1]))
    host, port = serve.start(proxy=True)
    yield h, f"http://{host}:{port}"
    serve.delete("llm_jax")
    serve.delete("llm_jax-stream")


def test_handle_greedy_matches_jax_generate(jax_app, jax_model):
    h, _ = jax_app
    rs = [h.remote({"tokens": p, "max_new_tokens": 8}) for p in PROMPTS]
    for p, r in zip(PROMPTS, rs):
        got = r.result(timeout_s=T)
        assert got["tokens"] == _jax_greedy(jax_model, p, 8)
        assert got["completion"] == got["tokens"][len(p):]


def test_http_and_stream_route_match_jax_generate(jax_app, jax_model):
    _, base = jax_app
    for p in PROMPTS[:2]:
        want = _jax_greedy(jax_model, p, 5)[len(p):]
        body = json.dumps({"tokens": p, "max_new_tokens": 5}).encode()
        req = urllib.request.Request(
            f"{base}/llmj", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=T) as r:
            assert json.loads(r.read().decode())["completion"] == want
        # the companion stream route: newline-delimited token JSON
        req = urllib.request.Request(
            f"{base}/llmj-stream", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=T) as r:
            lines = [json.loads(ln) for ln in r.read().decode().splitlines()]
        assert [d["token"] for d in lines] == want


def test_stream_and_rpc_match_jax_generate(jax_app, jax_model):
    h, _ = jax_app
    p = PROMPTS[0]
    want = _jax_greedy(jax_model, p, 6)[len(p):]
    assert list(h.options(stream=True).stream_tokens.remote(p, 6)) == want
    assert list(h.options(stream=True).remote(
        {"stream": True, "tokens": p, "max_new_tokens": 6})) == want
    cli = serve.RpcClient(serve.start_rpc_proxy())
    try:
        out = cli.call("llm_jax", {"tokens": p, "max_new_tokens": 6})
    finally:
        cli.close()
    assert out["completion"] == want


def test_static_concurrent_requests_batch_together(cluster):
    h = serve.run(LLMServer().bind(preset="nano", cfg_kwargs=F32,
                                   max_seq=MAX_SEQ, engine="static",
                                   device="cpu"),
                  name="llm_b", route_prefix=None)
    p = PROMPTS[0]
    first = h.remote({"tokens": p, "max_new_tokens": 4}).result(timeout_s=T)
    rs = [h.remote({"tokens": p, "max_new_tokens": 4}) for _ in range(6)]
    results = [r.result(timeout_s=T) for r in rs]
    # same shape and sampling params fired together: at least one was
    # micro-batched with a peer
    assert max(r["batch_size"] for r in results) >= 2
    assert all(r["tokens"] == first["tokens"] for r in results)
    # streamed greedy tokens == the batched completion
    toks = list(h.options(stream=True).remote(
        {"stream": True, "tokens": p, "max_new_tokens": 4}))
    assert toks == first["completion"]
    serve.delete("llm_b")


def _servers():
    return {mode: _LLMServerImpl(preset="nano", cfg_kwargs=F32,
                                 max_seq=MAX_SEQ, engine=mode, device="cpu",
                                 engine_kwargs={"max_slots": 4,
                                                "page_size": 8})
            for mode in ("static", "paged", "contiguous")}


def _batched(srv, body):
    if srv._engine_mode == "static":
        return asyncio.run(srv.generate_batch([body]))[0]
    return srv._get_engine().collect(srv._get_engine().submit(
        body["tokens"], body["max_new_tokens"], body["temperature"],
        body["seed"], body["top_k"]), timeout=T)


@pytest.mark.parametrize("sampling", [(0.0, None, 0), (0.7, 8, 5),
                                      (1.0, None, 11)],
                         ids=["greedy", "t0.7-top8", "t1.0"])
def test_static_paged_contiguous_agree(sampling):
    temperature, top_k, seed = sampling
    servers = _servers()
    try:
        for p in PROMPTS:
            body = {"tokens": p, "max_new_tokens": 7,
                    "temperature": temperature, "top_k": top_k,
                    "seed": seed}
            want = gpt.generate(servers["static"]._params,
                                servers["static"]._cfg, [p], 7,
                                temperature=temperature, top_k=top_k,
                                seed=seed, device="cpu")[0, len(p):].tolist()
            for mode, srv in servers.items():
                got = _batched(srv, body)["completion"]
                assert got == want, (mode, p)
                streamed = list(srv.stream_tokens(p, 7, temperature, seed,
                                                  top_k))
                assert streamed == want, (mode, p, "stream")
    finally:
        for srv in servers.values():
            if srv._engine is not None:
                srv._engine.stop()


def test_static_stream_resumes_by_continuation():
    """The router's llm_tokens continuation on the static path: the
    delivered tokens folded into the prompt, key_offset past them, the
    remaining count — the resumed stream continues the uninterrupted one
    exactly (sampled)."""
    from ray_tpu_torch.serve._router import _resume_llm_tokens

    srv = _servers()["static"]
    args = (PROMPTS[0], 10, 0.7, 5, 8)
    full = list(srv.stream_tokens(*args))
    for k in (1, 3, 9):
        _, kw = _resume_llm_tokens(args, {}, full[:k])
        assert full[:k] + list(srv.stream_tokens(**kw)) == full
    assert _resume_llm_tokens(args, {}, full) is None


def test_params_loader_none_refused_and_pair_accepted():
    with pytest.raises(ValueError, match="params_loader returned None"):
        _LLMServerImpl(preset="nano", params_loader=lambda: None,
                       device="cpu")
    cfg = gpt.GPTConfig.nano(max_seq=64, dtype=torch.float32)
    params = gpt.init(cfg, seed=3, device="cpu")
    srv = _LLMServerImpl(preset="nano", params_loader=lambda: (cfg, params),
                         cfg_kwargs={"max_seq": 32}, device="cpu")
    assert srv._cfg.max_seq == 32 and srv._cfg.dtype == torch.float32
    assert srv._params["embed"] is params["embed"]


def test_replica_without_device_or_gpus_fails_to_deploy(cluster):
    """No ``device`` and no ``num_gpus``: the runtime spawns the replica's
    worker with no card visible (CUDA_VISIBLE_DEVICES=""), the replica's
    device resolution raises, and the deploy fails with that message in
    the deployment's status — no fallback to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        serve.run(LLMServer().bind(preset="nano", max_seq=MAX_SEQ),
                  name="llm_nodev", route_prefix=None)
    st = serve.status()["llm_nodev"]
    assert "DEPLOY_FAILED" in str(st.status)
    assert "no CUDA device available" in \
        st.deployments["LLMServer"].message
    serve.delete("llm_nodev")


def test_static_replica_keeps_no_state_per_shape():
    """In place of the reference's test_llm_compile_cache_is_bounded:
    eager PyTorch compiles nothing per (max_new, temperature, top_k)
    shape, so a static replica answering many distinct shapes holds
    exactly the state it started with."""
    srv = _LLMServerImpl(preset="nano", cfg_kwargs=F32, max_seq=MAX_SEQ,
                         engine="static", device="cpu")
    before = {k: (type(v), len(v) if hasattr(v, "__len__") else None)
              for k, v in vars(srv).items()}
    for i in range(24):                    # 24 distinct shapes
        body = {"tokens": PROMPTS[i % len(PROMPTS)],
                "max_new_tokens": 2 + i % 5,
                "temperature": 0.5 + i, "top_k": 1 + i % 4, "seed": i}
        assert len(asyncio.run(srv.generate_batch([body]))[0]
                   ["completion"]) == body["max_new_tokens"]
        list(srv.stream_tokens(body["tokens"], 2, body["temperature"], i,
                               body["top_k"]))
    after = {k: (type(v), len(v) if hasattr(v, "__len__") else None)
             for k, v in vars(srv).items()}
    assert after == before
