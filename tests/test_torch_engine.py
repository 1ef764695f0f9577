"""PyTorch port of the continuous-batching engine: paged == contiguous
== generate (the port's and the JAX reference's, greedy, f32), seeded
sampling and continuation resume (port against port: torch and JAX draw
different random numbers), scheduling, the page allocator, prefix
sharing with copy-on-write, admission control and shutdown.  Mirrors
tests/test_serve_continuous.py on a nano model on the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt
from ray_tpu_torch.serve import (AdmissionRejected, ContinuousEngine,
                                 PageAllocator)

torch.set_num_threads(1)

MAX_SEQ = 64
PROMPT = [3, 14, 15, 92, 6, 5]


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig.nano(max_seq=MAX_SEQ, dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    cfg = gpt.GPTConfig.nano(max_seq=MAX_SEQ, dtype=torch.float32)
    params = convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return cfg, params, jcfg, jparams


def _make_engine(model, cache="paged", **kw):
    cfg, params = model[:2]
    defaults = dict(cache=cache, max_slots=4, page_size=8, device="cpu")
    defaults.update(kw)
    return ContinuousEngine(gpt, cfg, params, **defaults)


def _expected(model, prompt, max_new, temperature=0.0, seed=0,
              top_k=None):
    cfg, params = model[:2]
    out = gpt.generate(params, cfg, [prompt], max_new,
                       temperature=temperature, top_k=top_k, seed=seed,
                       max_seq=MAX_SEQ, device="cpu")
    return out[0, len(prompt):].tolist()


def _expected_jax(model, prompt, max_new):
    jcfg, jparams = model[2:]
    out = jgpt.generate(jparams, jcfg, jnp.asarray([prompt]), max_new,
                        max_seq=MAX_SEQ)
    return np.asarray(out)[0, len(prompt):].tolist()


def _wait(pred, timeout=60):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline
        time.sleep(0.002)


# ---------------------------------------------------------------------------
# parity


def test_paged_matches_contiguous_and_generate_greedy(model):
    prompts = [PROMPT, [7, 9, 2], list(range(1, 18))]
    outs = {}
    for mode in ("paged", "contiguous"):
        eng = _make_engine(model, cache=mode)
        try:
            seqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            outs[mode] = [eng.collect(s, timeout=120)["completion"]
                          for s in seqs]
        finally:
            eng.stop()
    assert outs["paged"] == outs["contiguous"]
    for p, got in zip(prompts, outs["paged"]):
        assert got == _expected(model, p, 6)
        assert got == _expected_jax(model, p, 6)


def test_sampled_decode_matches_generate(model):
    eng = _make_engine(model)
    try:
        s = eng.submit(PROMPT, max_new_tokens=8, temperature=0.8,
                       seed=123, top_k=16)
        got = eng.collect(s, timeout=120)["completion"]
    finally:
        eng.stop()
    assert got == _expected(model, PROMPT, 8, temperature=0.8, seed=123,
                            top_k=16)
    assert got != _expected(model, PROMPT, 8, temperature=0.8, seed=124,
                            top_k=16)


def test_resume_with_key_offset_matches_uninterrupted(model):
    """A continuation (prompt + delivered tokens, key_offset = their
    count) draws exactly the uninterrupted run's remaining tokens."""
    eng = _make_engine(model)
    try:
        full = eng.collect(eng.submit(PROMPT, max_new_tokens=10,
                                      temperature=1.0, seed=7),
                           timeout=120)["completion"]
        rest = eng.collect(eng.submit(PROMPT + full[:4], max_new_tokens=6,
                                      temperature=1.0, seed=7,
                                      key_offset=4),
                           timeout=120)["completion"]
    finally:
        eng.stop()
    assert rest == full[4:]


# ---------------------------------------------------------------------------
# scheduling


def test_join_and_evict_mid_step(model):
    eng = _make_engine(model, max_slots=2)
    try:
        long = eng.submit(PROMPT, max_new_tokens=40)
        _wait(lambda: eng.engine_stats()["active"] > 0)
        short = eng.submit([7, 9, 2], max_new_tokens=3)
        r_short = eng.collect(short, timeout=120)
        r_long = eng.collect(long, timeout=120)
        assert r_short["completion"] == _expected(model, [7, 9, 2], 3)
        assert r_long["completion"] == _expected(model, PROMPT, 40)
        assert r_short["batch_size"] >= 2
        st = eng.engine_stats()
        assert st["active"] == 0
        assert st["free_pages"] == st["num_pages"] - 1
    finally:
        eng.stop()


def test_eos_evicts_early(model):
    ref = _expected(model, PROMPT, 8)
    eos = ref[2]
    eng = _make_engine(model)
    try:
        got = eng.collect(eng.submit(PROMPT, max_new_tokens=8, eos_id=eos),
                          timeout=120)["completion"]
    finally:
        eng.stop()
    assert got == ref[:ref.index(eos) + 1]


def test_streaming_interleaved_order(model):
    eng = _make_engine(model, max_slots=4)
    try:
        prompts = [PROMPT, [11, 4, 8, 2]]
        seqs = [eng.submit(p, max_new_tokens=10, stream=True)
                for p in prompts]
        got = [[] for _ in prompts]

        def drain(i):
            for tok in eng.stream(seqs[i]):
                got[i].append(tok)

        threads = [threading.Thread(target=drain, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for p, g in zip(prompts, got):
            assert g == _expected(model, p, 10)
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# paged allocator: prefix sharing + copy-on-write


def test_page_allocator_share_and_release():
    a = PageAllocator(num_pages=8, page_size=4)
    toks = list(range(100, 110))
    plan = a.plan(toks, 3)
    assert plan["shared_len"] == 0 and not plan["copies"]
    assert len(plan["pages"]) == 3
    for i in range(2):
        a.register_prefix(tuple(toks[:(i + 1) * 4]), plan["pages"][i])
    plan2 = a.plan(toks[:8] + [7, 7], 3)
    assert plan2["shared_len"] == 8 and plan2["n_shared"] == 2
    assert plan2["pages"][:2] == plan["pages"][:2]
    assert not plan2["copies"]
    assert a.refcount(plan["pages"][0]) == 2
    a.release(plan2["pages"])
    assert a.refcount(plan["pages"][0]) == 1
    a.release(plan["pages"])
    assert a.free_pages == 7
    assert a.lookup_prefix(tuple(toks[:4])) is None
    assert a.occupancy()["used"] == 0


def test_page_allocator_cow_on_exact_match():
    a = PageAllocator(num_pages=8, page_size=4)
    toks = list(range(50, 58))
    plan = a.plan(toks, 3)
    for i in range(2):
        a.register_prefix(tuple(toks[:(i + 1) * 4]), plan["pages"][i])
    plan2 = a.plan(toks, 3)
    assert plan2["shared_len"] == 7
    assert len(plan2["copies"]) == 1
    src, dst = plan2["copies"][0]
    assert src == plan["pages"][1] and dst == plan2["pages"][1]
    assert plan2["pages"][1] != plan["pages"][1]
    assert a.refcount(src) == 1


def test_page_allocator_starved_plan_takes_no_refs():
    a = PageAllocator(num_pages=4, page_size=4)
    p1 = a.plan([1] * 8, 3)
    assert p1 is not None and a.free_pages == 0
    assert a.plan([2] * 8, 2) is None
    a.release(p1["pages"])
    assert a.free_pages == 3
    with pytest.raises(ValueError):
        PageAllocator(num_pages=1, page_size=4)


def test_prefix_sharing_cow_end_to_end(model):
    prompt = list(range(40, 56))           # 16 tokens = 2 pages of 8
    eng = _make_engine(model, max_slots=4)
    try:
        a = eng.submit(prompt, max_new_tokens=40)
        _wait(lambda: eng.engine_stats()["prefills"] >= 1)
        b = eng.submit(prompt, max_new_tokens=5)
        c = eng.submit([9, 9, 1], max_new_tokens=5)
        rb = eng.collect(b, timeout=120)
        rc = eng.collect(c, timeout=120)
        ra = eng.collect(a, timeout=120)
        st = eng.engine_stats()
        assert eng.check_health()
    finally:
        eng.stop()
    assert ra["completion"] == _expected(model, prompt, 40)
    assert ra["completion"] == _expected_jax(model, prompt, 40)
    assert rb["completion"] == ra["completion"][:5]
    assert rc["completion"] == _expected(model, [9, 9, 1], 5)
    assert st["shared_pages"] >= 1
    assert st["cow_copies"] >= 1
    assert st["free_pages"] == st["num_pages"] - 1


# ---------------------------------------------------------------------------
# admission control


def test_oversized_request_rejected_up_front(model):
    eng = _make_engine(model, num_pages=3)    # 2 usable pages = 16 toks
    try:
        with pytest.raises(ValueError, match="pages"):
            eng.submit(list(range(20)), max_new_tokens=8)
        with pytest.raises(ValueError, match="capacity"):
            eng.submit(PROMPT, max_new_tokens=MAX_SEQ)
        s = eng.submit(PROMPT, max_new_tokens=4)
        assert len(eng.collect(s, timeout=120)["completion"]) == 4
    finally:
        eng.stop()


def test_queue_cap_sheds_with_retry_after(model):
    eng = _make_engine(model, max_slots=1, queue_cap=2, shed_queue_depth=1,
                       retry_after_s=2.5)
    try:
        first = eng.submit(PROMPT, max_new_tokens=56)
        _wait(lambda: eng.engine_stats()["active"] >= 1)
        q1 = eng.submit(PROMPT, max_new_tokens=4)
        q2 = eng.submit(PROMPT, max_new_tokens=4)
        with pytest.raises(AdmissionRejected) as ei:
            eng.submit(PROMPT, max_new_tokens=4)
        assert ei.value.retry_after_s == 2.5
        st = eng.engine_stats()
        assert st["rejected"] >= 1
        assert st["accepting"] is False
        for s in (first, q1, q2):
            eng.collect(s, timeout=300)
    finally:
        eng.stop()


def test_page_starved_request_waits_not_fails(model):
    eng = _make_engine(model, max_slots=2, num_pages=5)  # 4 usable
    try:
        a = eng.submit(list(range(10)), max_new_tokens=10)
        b = eng.submit(list(range(20, 28)), max_new_tokens=10)
        rb = eng.collect(b, timeout=300)
        ra = eng.collect(a, timeout=300)
    finally:
        eng.stop()
    assert ra["completion"] == _expected(model, list(range(10)), 10)
    assert rb["completion"] == _expected(model, list(range(20, 28)), 10)


def test_engine_stats_shape(model):
    eng = _make_engine(model)
    try:
        eng.collect(eng.submit(PROMPT, max_new_tokens=4), timeout=120)
        st = eng.engine_stats()
    finally:
        eng.stop()
    for key in ("cache", "active", "free_slots", "queue_depth",
                "free_pages", "num_pages", "accepting", "retry_after_s",
                "ttft_p50_s", "ttft_p99_s", "tokens_per_s", "requests",
                "tokens", "steps", "prefills", "cow_copies",
                "shared_pages"):
        assert key in st, key
    assert st["cache"] == "paged"
    assert st["requests"] == 1 and st["tokens"] == 4
    assert st["ttft_p99_s"] > 0
    assert eng.phase_ring()


def test_drain_sheds_new_requests(model):
    eng = _make_engine(model)
    try:
        s = eng.submit(PROMPT, max_new_tokens=6)
        assert eng.drain(timeout_s=60)
        assert len(eng.collect(s, timeout=10)["completion"]) == 6
        with pytest.raises(AdmissionRejected):
            eng.submit(PROMPT)
        assert eng.engine_stats()["draining"]
    finally:
        eng.stop()


def test_stop_fails_waiting_requests(model):
    eng = _make_engine(model, max_slots=1)
    running = eng.submit(PROMPT, max_new_tokens=8)
    waiting = eng.submit(PROMPT, max_new_tokens=8)
    eng.stop()
    with pytest.raises(RuntimeError):
        eng.collect(waiting, timeout=10)
    with pytest.raises(RuntimeError):
        eng.submit(PROMPT)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.check_health()
    del running


def test_engine_rejects_params_on_another_device(model):
    cfg, params = model[:2]
    with pytest.raises(ValueError, match="device"):
        ContinuousEngine(gpt, cfg, params, device="meta")


# ---------------------------------------------------------------------------
# liveness


class _SlowPrefill:
    """The gpt module with prefill slowed by ``delay`` s per prompt
    position, as on the card, where each position is a decode step."""

    def __init__(self, delay):
        self.delay = delay

    def __getattr__(self, name):
        return getattr(gpt, name)

    def paged_prefill(self, params, cache, toks, *args, **kwargs):
        time.sleep(self.delay * toks.shape[0])
        return gpt.paged_prefill(params, cache, toks, *args, **kwargs)

    def slot_prefill(self, params, cache, toks, *args, **kwargs):
        time.sleep(self.delay * toks.shape[0])
        return gpt.slot_prefill(params, cache, toks, *args, **kwargs)


def _probe_while(eng, seq, period=0.02):
    """check_health every ``period`` s until seq finishes: the errors."""
    errors = []
    while not seq.result.done():
        try:
            eng.check_health()
        except RuntimeError as e:
            errors.append(str(e))
        time.sleep(period)
    return errors


@pytest.mark.parametrize("cache", ["paged", "contiguous"])
def test_long_prefill_is_progress_not_a_stall(model, cache):
    # 40 prompt positions at 0.05 s each, in chunks of 8: the admission
    # takes 2 s, twice stall_s, with no decode step
    cfg, params = model[:2]
    prompt = list(range(1, 41))
    eng = ContinuousEngine(_SlowPrefill(0.05), cfg, params, cache=cache,
                           max_slots=4, page_size=8, stall_s=1.0,
                           device="cpu")
    eng.prefill_chunk = 8
    try:
        seq = eng.submit(prompt, max_new_tokens=6)
        errors = _probe_while(eng, seq)
        res = eng.collect(seq, timeout=60)
    finally:
        eng.stop()
    assert errors == []
    # the chunked prefill changes no bit
    assert res["completion"] == _expected(model, prompt, 6)


def test_prefill_chunk_stuck_past_stall_s_fails_health(model):
    cfg, params = model[:2]
    # one chunk of 6 positions at 0.5 s each: 3 s without progress
    eng = ContinuousEngine(_SlowPrefill(0.5), cfg, params, cache="paged",
                           max_slots=4, page_size=8, stall_s=1.0,
                           device="cpu")
    try:
        seq = eng.submit(PROMPT, max_new_tokens=2)
        errors = _probe_while(eng, seq)
        eng.collect(seq, timeout=60)
    finally:
        eng.stop()
    assert errors and all("stalled" in e for e in errors)


def test_stall_check_needs_no_probe_while_idle(model):
    # the last probe came long before the request: a stall is measured
    # from the admission, not from that probe
    cfg, params = model[:2]
    eng = ContinuousEngine(_SlowPrefill(0.05), cfg, params, cache="paged",
                           max_slots=4, page_size=8, stall_s=1.0,
                           device="cpu")
    try:
        assert eng.check_health()
        time.sleep(1.5)
        seq = eng.submit(PROMPT, max_new_tokens=4)
        # the first probe after the request lands during its prefill
        _wait(lambda: eng.engine_stats()["active"] == 1)
        errors = _probe_while(eng, seq)
        res = eng.collect(seq, timeout=60)
    finally:
        eng.stop()
    assert errors == []
    assert res["completion"] == _expected(model, PROMPT, 4)
