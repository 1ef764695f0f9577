"""The port's static analyzer (``python -m ray_tpu_torch analyze``):
``tests/test_analysis.py`` mirrored case by case on ``ray_tpu_torch``, plus
parity with the reference's passes on the shared fixtures, the torch lint
against the reference's ``jax_purity`` rule by rule, the default scopes,
and the self-scan's cost.

Pure AST analysis: no cluster, no JAX program.  Each pass is driven
against its seeded-violation fixture (parsed, never imported), the
baseline machinery is round-tripped, and the port is self-scanned against
its own checked-in ``analysis_baseline_torch.json``.
"""

import json
import os
import threading
import time
import types

import pytest

from ray_tpu_torch import analysis
from ray_tpu_torch.analysis import baseline as bl

pytestmark = [pytest.mark.quick, pytest.mark.analysis]

FIXDIR = os.path.join(os.path.dirname(analysis.__file__), "fixtures")
# the port's copies of the reference's JAX-free passes
COPIED_PASSES = ("lock_order", "guarded_by", "blocking_async")
SHARED_FIXTURES = ("fx_lock_order.py", "fx_budget_blocking.py",
                   "fx_guarded_by.py", "fx_blocking_async.py")
# the reference's jax_purity rule -> the torch lint's counterpart
RULE_MAP = {"side-effect": "side-effect", "host-call": "host-sync",
            "nondeterminism": "nondeterminism",
            "unhashable-static": "unhashable-static",
            "jit-per-call": "build-per-call"}
# CPU seconds the whole self-scan may take (it is interprocedural over a
# package larger than the reference's; ~10 s on a quiet core)
SCAN_CPU_LIMIT_S = 30.0


def _scan(fixture):
    return analysis.run_analysis([os.path.join(FIXDIR, fixture)])


def _keys(findings):
    return [f.key for f in findings]


@pytest.fixture(scope="module")
def repo_scan():
    """One self-scan of ``ray_tpu_torch/`` for every test that reads it,
    with its CPU time (robust to the other test workers' load)."""
    c0, w0 = time.process_time(), time.monotonic()
    findings = analysis.run_analysis()
    return {"findings": findings, "cpu_s": time.process_time() - c0,
            "wall_s": time.monotonic() - w0}


# -- per-pass fixture seeds ---------------------------------------------------

def test_lock_order_fixture():
    fs = _scan("fx_lock_order.py")
    by_rule = {}
    for f in fs:
        by_rule.setdefault(f.rule, []).append(f)
    cycles = by_rule.get("lock-order-cycle", [])
    assert len(cycles) == 1
    assert cycles[0].detail == "Widget.a<->Widget.b"
    held = sorted(f.detail for f in by_rule.get("lock-held-blocking", []))
    assert held == ["Widget.a:.recv", "Widget.a:call:slow_io",
                    "Widget.a:time.sleep"]
    re = by_rule.get("lock-self-reacquire", [])
    assert [f.detail for f in re] == ["Widget.a"]
    assert not any(f.func == "Widget.clean" for f in fs)
    assert len(_keys(fs)) == len(set(_keys(fs)))


def test_budget_promotion_fixture():
    fs = _scan("fx_budget_blocking.py")
    held = sorted(f.func for f in fs if f.rule == "lock-held-blocking")
    assert held == ["MiniServer.h_kv_put", "MiniServer.h_wait_thing"]
    # kv_put is in the port's rpc_stats.HANDLER_BUDGETS_MS as well
    promoted = [f for f in fs if f.rule == "budget-held-blocking"]
    assert [(f.func, f.detail) for f in promoted] == [
        ("MiniServer.h_kv_put", "kv_put:MiniServer.lock:time.sleep")]
    assert not any(f.func == "MiniServer.h_clean" for f in fs)


def test_budget_promotion_repo_clean(repo_scan):
    """The port's budget table excludes the long-poll handlers owning the
    baselined lock-held-blocking findings, as the reference's does."""
    assert [f.render() for f in repo_scan["findings"]
            if f.rule == "budget-held-blocking"] == []


def test_guarded_by_fixture():
    fs = _scan("fx_guarded_by.py")
    mine = [f for f in fs if f.pass_id == "guarded_by"]
    assert len(mine) == 1
    f = mine[0]
    assert f.rule == "unguarded-access"
    assert f.func == "Counter.bad" and f.detail == "n"
    assert not any(x.func in ("Counter.good", "Counter.helper",
                              "Counter.peek", "Counter.__init__")
                   for x in mine)


def test_blocking_async_fixture():
    fs = _scan("fx_blocking_async.py")
    mine = [f for f in fs if f.pass_id == "blocking_async"]
    assert sorted((f.func, f.detail) for f in mine) == [
        ("bad_recv", ".recv"), ("bad_sleep", "time.sleep")]
    assert not any(f.func.startswith("good") for f in mine)


def test_torch_purity_fixture():
    """The counterpart of ``test_jax_purity_fixture``: every seeded case
    of ``fx_torch_purity.py``, the Triton ``kernel`` that ``run_kernel``
    launches among them."""
    fs = _scan("fx_torch_purity.py")
    mine = [f for f in fs if f.pass_id == "torch_purity"]
    got = sorted((f.rule, f.func, f.detail) for f in mine)
    assert got == [
        ("build-per-call", "load_per_item", "loop:CDLL"),
        ("build-per-call", "loop_jit", "loop:<lambda>"),
        ("build-per-call", "per_call_closure", "closure:inner"),
        ("build-per-call", "per_call_decorated", "closure:inner2"),
        ("host-sync", "captured", ".cpu"),
        ("host-sync", "captured", ".nonzero"),
        ("host-sync", "compiled", "torch.cuda.synchronize"),
        ("host-sync", "compiled", "torch.unique"),
        ("host-sync", "helper", ".tolist"),
        ("host-sync", "host_pull", ".item"),
        ("host-sync", "host_pull", "np.asarray"),
        ("nondeterminism", "draws", "torch.rand"),
        ("nondeterminism", "nondet", "random.random"),
        ("nondeterminism", "nondet", "time.time"),
        ("side-effect", "bump", "global"),
        ("side-effect", "impure_print", "print"),
        ("side-effect", "kernel", "print"),
        ("unhashable-static", "bad_static", "default:cfg"),
        ("unhashable-static", "caller", "call:bad_static:cfg"),
    ]
    # negative controls: the cold clean(), the factory that RETURNS its
    # wrapper, the launcher itself, the dynamic argument's literal
    assert not any(f.func in ("clean", "jit_factory", "run_kernel",
                              "dyn", "dyn_caller", "uses_helper")
                   for f in mine)


# -- baseline round-trip ------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    fs = _scan("fx_lock_order.py")
    assert fs
    path = str(tmp_path / "bl.json")
    bl.save(path, fs)
    known = bl.load(path)
    assert set(known) == set(_keys(fs))
    new, suppressed, stale = bl.diff(fs, known)
    assert new == [] and len(suppressed) == len(fs) and stale == []
    extra = _scan("fx_guarded_by.py")
    new, _, _ = bl.diff(fs + extra, known)
    assert _keys(new) == _keys(extra)
    new, _, stale = bl.diff(fs[1:], known)
    assert new == [] and stale == [fs[0].key]


def test_baseline_version_check(tmp_path):
    path_obj = tmp_path / "bl.json"
    path_obj.write_text(json.dumps({"version": 99, "findings": {}}))
    with pytest.raises(ValueError):
        bl.load(str(path_obj))
    assert bl.load(str(tmp_path / "missing.json")) == {}
    # the port's baseline is its own file, never the reference's
    assert os.path.basename(bl.default_path()) \
        == "analysis_baseline_torch.json"


# -- CLI ----------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    from ray_tpu_torch.scripts import cli

    fx = os.path.join(FIXDIR, "fx_blocking_async.py")
    blpath = str(tmp_path / "bl.json")
    with pytest.raises(SystemExit) as ei:
        cli.main(["analyze", fx, "--baseline", blpath])
    assert ei.value.code == 1
    cli.main(["analyze", fx, "--baseline", blpath, "--update-baseline"])
    cli.main(["analyze", fx, "--baseline", blpath])
    out = capsys.readouterr().out
    assert "0 new" in out
    cli.main(["analyze", fx, "--baseline", blpath, "--format", "json"])
    data = json.loads(capsys.readouterr().out)
    assert data["new"] == [] and data["suppressed"] == 2
    cli.main(["analyze", fx, "--baseline", blpath, "-v"])
    assert capsys.readouterr().out.count("[baselined]") == 2


# -- repo self-scan -----------------------------------------------------------

def test_repo_self_scan_is_clean(repo_scan):
    """``analyze`` over ``ray_tpu_torch/`` reports zero unbaselined
    findings against the port's baseline, and none of it is stale."""
    known = bl.load(bl.default_path())
    new, _, stale = bl.diff(repo_scan["findings"], known)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"


def test_fixtures_excluded_from_directory_scan(repo_scan):
    assert not any("analysis/fixtures" in f.file
                   for f in repo_scan["findings"])


# -- satellite regressions (the port's copies of the same code) ---------------

def test_generator_item_ack_sent_outside_cv():
    """h_generator_item must not hold st.cv across the producer ack."""
    from ray_tpu_torch._private import core as core_mod

    spec = types.SimpleNamespace(generator_backpressure=None)
    st = core_mod.StreamState(spec)
    tid = "task1234"

    owner = types.SimpleNamespace(
        streams={tid: st},
        _released_streams=set(),
        lock=threading.Lock(),
        objects={},
        local_ref_counts={},
        task_records={},
    )
    owner._new_entry = lambda oid: owner.objects.setdefault(
        oid, types.SimpleNamespace(pins=0, lineage=None, ready=False))
    owner._store_one = lambda e, result: setattr(e, "ready", True)

    acks = []

    class Ack:
        def resolve(self, payload):
            got_it = st.cv.acquire(blocking=False)
            assert got_it, "producer ack sent while holding st.cv"
            st.cv.release()
            acks.append(payload)

    core_mod.CoreWorker.h_generator_item(
        owner, None, {"task_id": tid, "index": 0, "result": "r0"}, Ack())
    assert acks == [{"ok": True}]
    assert st.produced == 1 and list(st.ready) == [0]
    core_mod.CoreWorker.h_generator_item(
        owner, None, {"task_id": tid, "index": 0, "result": "r0"}, Ack())
    assert acks == [{"ok": True}, {"ok": True}]

    spec.generator_backpressure = 1
    core_mod.CoreWorker.h_generator_item(
        owner, None, {"task_id": tid, "index": 1, "result": "r1"}, Ack())
    assert len(acks) == 2 and len(st.waiters) == 1


def _wait(pred, what, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(what)
        time.sleep(0.005)


def test_reply_batcher_survives_push_exception():
    """A non-OSError failure inside one push must not wedge the sender."""
    from ray_tpu_torch._private.worker_proc import _ReplyBatcher

    class FlakyConn:
        alive = True

        def __init__(self):
            self.pushed = []
            self.fail_next = False

        def push(self, kind, batch):
            if self.fail_next:
                self.fail_next = False
                raise ValueError("serialization exploded")
            self.pushed.append((kind, list(batch)))
            return True

    conn = FlakyConn()
    b = _ReplyBatcher(conn)
    b.add("t0", {"status": "ok"})
    _wait(lambda: conn.pushed, "ack never shipped")
    assert conn.pushed[-1][1] == [("t0", {"status": "ok"})]
    conn.fail_next = True
    b.add("t1", {"status": "ok"})
    _wait(lambda: not conn.fail_next, "poisoned push never attempted")
    b.add("t2", {"status": "ok"})
    _wait(lambda: conn.pushed and conn.pushed[-1][1][-1][0] == "t2",
          "ack after a failed push never shipped")


def test_reply_batcher_lingers_only_under_backlog():
    from ray_tpu_torch._private.worker_proc import _ReplyBatcher

    sent = []
    busy = {"backlog": True}
    b = _ReplyBatcher(send=lambda batch: sent.append(list(batch)),
                      backlog=lambda: busy["backlog"])
    b.add("t0", {"status": "ok"})
    b.add("t1", {"status": "ok"})
    busy["backlog"] = False
    b.add("t2", {"status": "ok"})
    _wait(lambda: sum(len(x) for x in sent) >= 3,
          f"acks never shipped: {sent}")
    flat = [tid for batch in sent for tid, _ in batch]
    assert flat == ["t0", "t1", "t2"]


def test_router_pick_wakes_on_refresh(monkeypatch):
    """_pick blocks on the table condition and wakes when another
    thread's refresh lands replicas — no time.sleep polling."""
    from ray_tpu_torch.serve import _router as rmod

    table = {"replicas": [], "max_ongoing_requests": 100}

    class FakeMethod:
        def remote(self, app, dep):
            return dict(table)

    class FakeController:
        get_replica_table = FakeMethod()

    monkeypatch.setattr(rmod.ray_tpu_torch, "get",
                        lambda ref, timeout=None: ref)
    real_sleep = time.sleep

    def _no_sleep(_):
        raise AssertionError("router _pick used time.sleep polling")
    monkeypatch.setattr(rmod.time, "sleep", _no_sleep)

    r = rmod.Router("app", "dep", controller=FakeController())
    picked = []
    err = []

    def worker():
        try:
            picked.append(r._pick())
        except BaseException as e:    # pragma: no cover - failure path
            err.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    real_sleep(0.35)
    table["replicas"] = [{"replica_id": "r1", "handle": object()}]
    t_flip = time.monotonic()
    r._refresh(force=True)
    t.join(timeout=2.0)
    assert not err, err
    assert picked and picked[0]["replica_id"] == "r1"
    assert time.monotonic() - t_flip < 1.0


# -- beyond the mirror --------------------------------------------------------

def _strip(findings, prefix):
    """Each finding with the package's path prefix taken out of its file,
    message and key (a cycle's message names both sites' paths)."""
    return sorted((f.pass_id, f.rule, f.file[len(prefix):], f.func,
                   f.detail, f.message.replace(prefix, ""), f.line,
                   f.key.replace(prefix, ""))
                  for f in findings)


@pytest.mark.parametrize("fixture", SHARED_FIXTURES)
def test_copied_passes_match_the_reference(fixture):
    """The reference's passes and the port's copies, on the same
    JAX-free fixture, find the same rules, qualnames, details, messages
    and lines; only the path prefix differs."""
    from ray_tpu import analysis as ref_analysis

    ref_fx = os.path.join(os.path.dirname(ref_analysis.__file__),
                          "fixtures", fixture)
    ref = ref_analysis.run_analysis([ref_fx], passes=COPIED_PASSES)
    got = analysis.run_analysis([os.path.join(FIXDIR, fixture)],
                                passes=COPIED_PASSES)
    assert ref, fixture
    with open(ref_fx) as a, open(os.path.join(FIXDIR, fixture)) as b:
        assert a.read() == b.read()
    assert _strip(got, "ray_tpu_torch/") == _strip(ref, "ray_tpu/")


@pytest.mark.parametrize("ref_rule", sorted(RULE_MAP))
def test_torch_purity_covers_the_reference_rule(ref_rule):
    """Each rule of the reference's ``jax_purity`` has its counterpart:
    every site the reference flags in ``fx_jax_purity.py`` under
    ``ref_rule`` has a same-named seed in ``fx_torch_purity.py`` that the
    torch lint flags under the counterpart rule (``run_kernel``'s Pallas
    kernel printing is a Triton kernel printing)."""
    from ray_tpu import analysis as ref_analysis

    ref_fx = os.path.join(os.path.dirname(ref_analysis.__file__),
                          "fixtures", "fx_jax_purity.py")
    ref = {(f.func, f.detail)
           for f in ref_analysis.run_analysis([ref_fx],
                                              passes=("jax_purity",))
           if f.rule == ref_rule}
    got = {(f.func, f.detail) for f in _scan("fx_torch_purity.py")
           if f.pass_id == "torch_purity" and f.rule == RULE_MAP[ref_rule]}
    assert ref, ref_rule
    assert ref <= got, (ref_rule, sorted(ref - got))
    if ref_rule == "side-effect":
        assert ("kernel", "print") in got


@pytest.mark.parametrize("name", [n for n, (_, scope)
                                  in analysis.PASSES.items()
                                  if scope is not None])
def test_default_scopes_name_port_files(name):
    """A scope naming no file would make its pass find nothing and say
    nothing: every entry of each default scope exists in the port."""
    root = analysis.repo_root()
    _, scope = analysis.PASSES[name]
    for entry in scope:
        assert entry.startswith("ray_tpu_torch/"), entry
        path = os.path.join(root, entry)
        if entry.endswith("/"):
            assert os.path.isdir(path) and any(
                fn.endswith(".py") for _, _, fns in os.walk(path)
                for fn in fns), entry
        else:
            assert os.path.isfile(path), entry


def test_hot_bodies_reach_the_main_paths():
    """The torch lint sees the programs the ledger records and what they
    call: the train step reaches the GPT loss through ``model_of``, the
    engine's programs through its ``gpt_mod`` parameter, Anakin's loop
    the env's rollout and the learner's update through the factory that
    builds it, the collectives their bodies."""
    from ray_tpu_torch.analysis import _model, torch_purity

    root = analysis.repo_root()
    index = _model.Index(_model.collect_modules(
        [os.path.join(root, "ray_tpu_torch")], root))
    res = torch_purity._Resolver(index)
    hot, regions, programs = torch_purity._discover(index, res)
    closure = torch_purity._closure(index, res, hot, regions)
    for key in [("models/training.py", "make_train_step.step"),
                ("models/gpt.py", "_loss"),
                ("ops/attention.py", "attention"),
                ("models/gpt.py", "paged_decode_step"),
                ("rl/podracer.py", "run_anakin.train"),
                ("rl/env/jax_env.py", "rollout"),
                ("rl/core/learner.py", "Learner._update"),
                ("rl/algorithms/impala.py", "ImpalaLearner.compute_loss"),
                ("collective/nccl_group.py", "_q_allreduce")]:
        assert (f"ray_tpu_torch/{key[0]}", key[1]) in closure, key
    assert ("ray_tpu_torch/serve/_engine.py", "ContinuousEngine.__init__") \
        not in closure


def test_analyzers_import_neither_jax_nor_the_reference(tmp_path):
    """``analyze`` runs where JAX is not installed: the package and the
    CLI's scan load no JAX, no ``ray_tpu`` and no torch."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from ray_tpu_torch.scripts import cli\n"
            "fx, out = sys.argv[1:]\n"
            "cli.main(['analyze', fx, '--baseline', out, "
            "'--update-baseline'])\n"
            "cli.main(['analyze', fx, '--baseline', out])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'torch', 'triton')]\n"
            "assert not bad, bad\n")
    root = analysis.repo_root()
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.join(FIXDIR, "fx_torch_purity.py"),
                        str(tmp_path / "bl.json")], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "analyze: 0 new, 19 baselined" in r.stdout, r.stdout


def test_self_scan_cost(repo_scan):
    """The whole self-scan (four passes, the torch lint interprocedural
    over the package) stays within its CPU budget; CPU seconds, not wall
    seconds, so the other test workers' load does not decide it."""
    assert repo_scan["cpu_s"] < SCAN_CPU_LIMIT_S, repo_scan
