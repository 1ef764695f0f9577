"""Fault-tolerant serving on the port's runtime: the cases of
tests/test_serve_fault.py on a cluster of ``ray_tpu_torch``'s own
control plane, raylet and workers, the LLM replicas on the nano GPT in
f32 with ``device="cpu"``.

- kill the replica mid-stream: the llm_tokens continuation resumes the
  decode bitwise on a survivor (sampled, not just greedy), equal to an
  uninterrupted run of the same request and to ``gpt.generate``
- drain advisory on the only node: zero dropped requests
- a replica whose check_health fails gets restarted by the controller
- exhausting the replay budget surfaces the ORIGINAL replica error
- an application error is not replayed
- abandoning a stream releases the router's in-flight slot
- delete_app with an already-dead replica returns without burning the
  full drain timeout
- chaos: kill one of two replicas under concurrent load, every request
  still succeeds
"""

import threading
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.models import gpt
from ray_tpu_torch.serve._router import get_router

torch.set_num_threads(1)

PROMPT = [3, 14, 15, 92, 6, 5]
MAX_SEQ = 256
F32 = {"dtype": torch.float32}


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


def _expected_tokens(n_new, temperature=0.0, seed=0, top_k=None):
    cfg = gpt.GPTConfig.nano(max_seq=MAX_SEQ, dtype=torch.float32)
    params = gpt.init(cfg, seed=0, device="cpu")
    out = gpt.generate(params, cfg, [PROMPT], n_new, temperature=temperature,
                       top_k=top_k, seed=seed, device="cpu")
    return out[0, len(PROMPT):].tolist()


# -- mid-stream replica death: bitwise resume via the llm_tokens continuation


def test_stream_kill_midway_resumes_bitwise(serve_instance):
    from ray_tpu_torch.serve.llm import LLMServer

    h = serve.run(LLMServer(num_replicas=2).bind(
        preset="nano", cfg_kwargs=F32, max_seq=MAX_SEQ, device="cpu"),
        name="ft_llm", route_prefix=None)
    hs = h.options(stream=True, resume="llm_tokens")
    # sampled decode (temperature + top_k): the resume must replay the
    # SAME key schedule, offset past the delivered tokens — greedy-only
    # parity would hide a key-offset bug
    whole = list(hs.stream_tokens.remote(PROMPT, 10, 0.7, 5, 8))
    assert whole == _expected_tokens(10, temperature=0.7, seed=5, top_k=8)
    gen = hs.stream_tokens.remote(PROMPT, 10, 0.7, 5, 8)
    it = iter(gen)
    got = [next(it) for _ in range(3)]
    router = get_router("ft_llm", h.deployment_name)
    victim = router._replicas[gen._sub.rid]["handle"]
    victim_rid = gen._sub.rid
    rt.kill(victim)
    got += list(it)
    assert got == whole
    # the stream really moved: its later attempt ran on the survivor
    assert gen._sub.attempts >= 2 and gen._sub.rid != victim_rid
    serve.delete("ft_llm")


# -- preemption drain: zero drops while the only node drains -----------------


def test_drain_notice_zero_drops(serve_instance):
    from ray_tpu_torch._private.api import current_core

    @serve.deployment
    class Echo:
        def __call__(self, x):
            time.sleep(0.02)
            return x

    h = serve.run(Echo.bind(), name="ft_drain", route_prefix=None)
    core = current_core()
    nid = core.control.call("get_nodes", timeout=10.0)[0]["node_id"]
    oks, errs = [], []
    stop = threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            try:
                assert h.remote(i).result(timeout_s=30) == i
                oks.append(i)
            except Exception as e:  # noqa: BLE001 - every drop is a fail
                errs.append(e)
            i += 1

    t = threading.Thread(target=client)
    t.start()
    try:
        time.sleep(0.5)
        # preempt the ONLY node: the replica keeps serving as the fallback
        # (draining deprioritizes, never refuses) and the controller does
        # not spawn-loop replacements it cannot place
        core.control.call("report_draining", {
            "node_id": nid, "grace_s": 8.0, "reason": "preemption"},
            timeout=10.0)
        time.sleep(2.0)
    finally:
        stop.set()
        t.join()
        core.control.call("report_draining",
                          {"node_id": nid, "cancel": True}, timeout=10.0)
    assert not errs, errs[:3]
    assert len(oks) > 10
    serve.delete("ft_drain")


# -- wedged replica: the controller's health loop restarts it ----------------


def test_wedged_replica_restarted(serve_instance):
    @serve.deployment
    class Wedgy:
        def __init__(self):
            self._wedged = False

        def __call__(self):
            import os

            return os.getpid()

        def wedge(self):
            self._wedged = True
            return True

        def check_health(self):
            if self._wedged:
                raise RuntimeError("engine wedged: step counter stalled")

    h = serve.run(Wedgy.bind(), name="ft_wedge", route_prefix=None)
    pid0 = h.remote().result(timeout_s=60)
    assert h.wedge.remote().result(timeout_s=60) is True
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if h.remote().result(timeout_s=10) != pid0:
                break
        except Exception:
            pass
        time.sleep(0.3)
    else:
        pytest.fail("wedged replica was never restarted")
    serve.delete("ft_wedge")


# -- replay budget: the ORIGINAL error surfaces, in-flight stays balanced ----


class _FakeHandle:
    class handle_request:
        @staticmethod
        def remote(*a, **k):
            return object()


def _fake_router(table):
    from ray_tpu_torch.serve._router import Router

    r = Router("app", "dep", controller=object())
    r._refresh = lambda force=False: None
    r._replicas = {row["replica_id"]: row for row in table}
    return r


def test_replay_budget_exhausted_surfaces_original_error(monkeypatch):
    import ray_tpu_torch.serve._router as rtr

    r = _fake_router([{"replica_id": f"r{i}", "handle": _FakeHandle}
                      for i in range(4)])
    raised = []

    def dead_get(ref, timeout=None):
        e = rt.ActorDiedError(f"replica gone #{len(raised)}")
        raised.append(e)
        raise e

    monkeypatch.setattr(rtr.ray_tpu_torch, "get", dead_get)
    sub = r.submit(None, (), {}, {})
    with pytest.raises(rt.ActorDiedError) as ei:
        r.call(sub, timeout_s=30.0)
    budget = rtr._config().serve_replay_budget
    assert sub.attempts == budget + 1
    assert ei.value is raised[0]      # the first failure, not the last
    assert all(v == 0 for v in r._inflight.values())


def test_app_error_is_not_replayed(serve_instance):
    @serve.deployment(num_replicas=2)
    class Flaky:
        def __call__(self):
            raise ValueError("bad request payload")

    h = serve.run(Flaky.bind(), name="ft_apperr", route_prefix=None)
    router = get_router("ft_apperr", "Flaky")
    resp = h.remote()
    with pytest.raises(Exception, match="bad request payload"):
        resp.result(timeout_s=60)
    assert resp._sub.attempts == 1
    assert all(v == 0 for v in router._inflight.values())
    serve.delete("ft_apperr")


# -- abandoned stream: the in-flight slot comes back -------------------------


def test_abandoned_stream_releases_inflight(serve_instance):
    @serve.deployment
    class Slow:
        def __call__(self):
            for i in range(500):
                time.sleep(0.01)
                yield i

    h = serve.run(Slow.bind(), name="ft_leak", route_prefix=None)
    router = get_router("ft_leak", "Slow")
    gen = h.options(stream=True).remote()
    it = iter(gen)
    assert next(it) == 0
    assert any(v > 0 for v in router._inflight.values())
    gen.close()   # abandon mid-stream: break/disconnect, not exhaustion
    assert all(v == 0 for v in router._inflight.values())
    serve.delete("ft_leak")


# -- delete_app with dead replicas: no full drain-timeout burn ---------------


def test_delete_app_with_dead_replica_is_fast(serve_instance):
    @serve.deployment
    class D:
        def __call__(self):
            return "ok"

    h = serve.run(D.bind(), name="ft_dead", route_prefix=None)
    assert h.remote().result(timeout_s=60) == "ok"
    router = get_router("ft_dead", "D")
    router._refresh(force=True)
    for row in router._replicas.values():
        rt.kill(row["handle"])
    t0 = time.monotonic()
    serve.delete("ft_dead")
    # waiting on prepare_shutdown refs a dead replica can never answer
    # would take drain_s + 2.0 (= 4 s)
    assert time.monotonic() - t0 < 4.0


# -- chaos: kill a replica under concurrent load, zero failed requests -------


def test_chaos_kill_under_load_no_failures(serve_instance):
    @serve.deployment(num_replicas=2)
    class Work:
        def __call__(self, x):
            time.sleep(0.01)
            return x * 2

    h = serve.run(Work.bind(), name="ft_chaos", route_prefix=None)
    router = get_router("ft_chaos", "Work")
    router._refresh(force=True)
    victim = next(iter(router._replicas.values()))["handle"]
    oks, errs = [], []

    def client():
        for i in range(25):
            try:
                assert h.remote(i).result(timeout_s=60) == i * 2
                oks.append(i)
            except Exception as e:  # noqa: BLE001 - any drop fails the test
                errs.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    rt.kill(victim)  # mid-load: in-flight requests must replay
    for t in threads:
        t.join()
    assert not errs, errs[:3]
    assert len(oks) == 100
    serve.delete("ft_chaos")
