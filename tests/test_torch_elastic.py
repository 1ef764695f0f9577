"""The port's elastic training (``ray_tpu_torch.elastic``) on the CPU: the
cases of tests/test_elastic.py that need no telemetry, on the port's
runtime, with tensors where the reference's train state is a pytree:

* preemption notices — watcher edge-detection, file/fake sources, the
  raylet->control ``report_draining`` path (view fields, pubsub
  advisory, scheduler avoidance, cancel);
* emergency checkpoints — a snapshot copies a tree of tensors to the
  host, peer replication through the KV mailbox, quorum selection over
  survivor vaults, shard folding;
* elastic resume — shrink-to-fit width math, exact global-batch
  resplitting, and the executor's and the trainer's recovery: after a
  worker's death or a drain notice the gang resumes at reduced width
  from replicated shards, with no storage restart, on the uninterrupted
  weight trajectory.
"""

import os
import pickle
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.elastic import (ElasticConfig, InsufficientWorkersError,
                                   batch_offsets, fold_shards,
                                   per_replica_batches, select_quorum,
                                   shrink_to_fit)
from ray_tpu_torch.elastic.emergency import EmergencyCheckpoint
from ray_tpu_torch.elastic.preemption import (FakePreemptionSource,
                                              FilePreemptionSource,
                                              PreemptionWatcher)
from ray_tpu_torch.train import JaxConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  TrainingFailedError,
                                                  TrainingWorkerError)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture
def private_runtime():
    """For a test that connects this process to a cluster of its own:
    the module's cluster is shut down for it and started again after."""
    was = rt.is_initialized()
    rt.shutdown()
    yield
    rt.shutdown()
    if was:
        rt.init(num_cpus=4)


# ---------------------------------------------------------------------------
# Pure units (no cluster)
# ---------------------------------------------------------------------------


def test_elastic_config_validation():
    ElasticConfig()  # defaults are valid
    with pytest.raises(ValueError):
        ElasticConfig(min_workers=0)
    with pytest.raises(ValueError):
        ElasticConfig(min_workers=4, max_workers=2)
    with pytest.raises(ValueError):
        ElasticConfig(replication_factor=-1)
    with pytest.raises(ValueError):
        ElasticConfig(min_workers=3, workers_per_replica=2)
    ec = ElasticConfig(min_workers=2, replication_factor=1)
    ec.validate_for(4)
    with pytest.raises(ValueError):
        ec.validate_for(1)       # below min_workers
    with pytest.raises(ValueError):
        ElasticConfig(replication_factor=3).validate_for(3)  # K >= n


def test_shrink_to_fit():
    assert shrink_to_fit(7, 2) == 7
    assert shrink_to_fit(7, 2, max_workers=4) == 4
    # whole model replicas only (tp/sp unit preserved)
    assert shrink_to_fit(7, 2, workers_per_replica=2) == 6
    assert shrink_to_fit(5, 4, workers_per_replica=4) == 4
    with pytest.raises(InsufficientWorkersError):
        shrink_to_fit(1, 2)
    with pytest.raises(InsufficientWorkersError):
        shrink_to_fit(3, 2, workers_per_replica=4)  # no whole replica fits


def test_per_replica_batches_exact():
    for g in (12, 13, 1, 7):
        for w in (1, 2, 3, 5):
            b = per_replica_batches(g, w)
            assert sum(b) == g and len(b) == w
            assert max(b) - min(b) <= 1
    assert batch_offsets([5, 4, 4]) == [0, 5, 9]


def test_fold_shards_partitions_old_world():
    for old in (3, 5, 8):
        for new in (1, 2, 3):
            if new > old:
                continue
            folded = [fold_shards(old, r, new) for r in range(new)]
            flat = sorted(s for part in folded for s in part)
            assert flat == list(range(old))  # every shard, exactly once


def test_select_quorum_prefers_freshest_full_coverage():
    inv = {
        0: [{"step": 3, "world": 2, "shards": [0]},
            {"step": 4, "world": 2, "shards": [0]}],
        1: [{"step": 3, "world": 2, "shards": [0, 1]},
            {"step": 4, "world": 2, "shards": [1]}],
    }
    step, world, holders = select_quorum(inv)
    assert (step, world) == (4, 2)          # fresh AND fully covered
    assert set(holders) == {0, 1}
    inv[1][1]["shards"] = []
    step, world, holders = select_quorum(inv)
    assert step == 3
    assert select_quorum({0: []}) is None


def test_preemption_watcher_edge_detection():
    src = FakePreemptionSource()
    fired = []
    w = PreemptionWatcher(src, fired.append, poll_interval_s=0.01)
    assert not w.poll_once()                 # healthy: nothing fires
    src.trigger("spot-reclaim", grace_s=7.0)
    assert w.poll_once()                     # edge: fires once
    assert not w.poll_once()                 # level-held: no refire
    assert fired[0].reason == "spot-reclaim" and fired[0].grace_s == 7.0
    src.clear()
    assert not w.poll_once()                 # re-arms on clear
    src.trigger("again")
    assert w.poll_once() and w.notices_fired == 2


def test_file_preemption_source(tmp_path):
    p = tmp_path / "preempt"
    src = FilePreemptionSource(str(p))
    assert src.poll() is None
    p.write_text("")
    assert src.poll().reason == "preemption"  # empty sentinel still drains
    p.write_text('{"reason": "maintenance", "grace_s": 12}')
    n = src.poll()
    assert n.reason == "maintenance" and n.grace_s == 12.0


def test_preemption_replay_not_refired_into_fresh_incarnation(tmp_path):
    """A re-armed source still holding an already-consumed notice is a
    replay, not a new edge; a genuinely new event with the same content
    still fires (identity is per event, not per content)."""
    p = tmp_path / "preempt"
    src = FilePreemptionSource(str(p))
    fired = []
    w = PreemptionWatcher(src, fired.append, poll_interval_s=0.01)
    p.write_text('{"reason": "spot-reclaim"}')
    assert w.poll_once() and len(fired) == 1
    assert not w.poll_once()
    os.rename(p, tmp_path / "stash")
    assert not w.poll_once()
    os.rename(tmp_path / "stash", p)
    assert not w.poll_once()
    assert not w.poll_once()
    assert len(fired) == 1 and w.notices_fired == 1
    assert w.notices_suppressed == 1
    time.sleep(0.01)  # ensure mtime_ns advances
    p.write_text('{"reason": "spot-reclaim"}')
    assert w.poll_once()
    assert len(fired) == 2 and fired[1].reason == "spot-reclaim"


def test_preemption_fake_source_retriggers_same_content():
    src = FakePreemptionSource()
    fired = []
    w = PreemptionWatcher(src, fired.append, poll_interval_s=0.01)
    src.trigger("spot-reclaim", grace_s=5.0)
    assert w.poll_once()
    src.clear()
    assert not w.poll_once()
    src.trigger("spot-reclaim", grace_s=5.0)    # same content, new event
    assert w.poll_once()
    assert w.notices_fired == 2 and w.notices_suppressed == 0


def test_emergency_checkpoint_roundtrip():
    a = {"w": torch.arange(6, dtype=torch.float32).view(2, 3),
         "step": torch.tensor(5)}
    b = {"w": torch.full((2, 3), -1.5, dtype=torch.bfloat16),
         "step": torch.tensor(5)}
    ck = EmergencyCheckpoint(step=5, source_world_size=3,
                             shards={0: pickle.dumps(a), 2: pickle.dumps(b)})
    assert ck.shard_ids() == [0, 2]
    for got, want in zip(ck.load(), (a, b)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k])
    assert ck.get_metadata()["tier"] == "emergency"
    with pytest.raises(NotImplementedError):
        ck.to_directory()
    # survives a pickle round-trip (it rides through start_session)
    ck2 = pickle.loads(pickle.dumps(ck))
    assert ck2.step == 5
    assert torch.equal(ck2.load()[1]["w"], b["w"])


def test_snapshot_copies_the_tensors_off_the_step():
    """snapshot() takes a host copy of a tree of tensors, detached: the
    step that follows updates the live tensors in place, and the
    snapshot must not see it (``.cpu()`` alone would alias a CPU
    tensor)."""
    from ray_tpu_torch.elastic.emergency import _to_host

    w = torch.ones(4, requires_grad=True)
    state = {"params": {"w": w}, "opt": [torch.zeros(2)],
             "pair": (torch.ones(1), 3), "step": 7}
    snap = _to_host(state)
    with torch.no_grad():
        w.add_(1.0)
        state["opt"][0].fill_(9.0)
    assert torch.equal(snap["params"]["w"], torch.ones(4))
    assert not snap["params"]["w"].requires_grad
    assert torch.equal(snap["opt"][0], torch.zeros(2))
    assert isinstance(snap["pair"], tuple) and snap["pair"][1] == 3
    assert snap["step"] == 7


# ---------------------------------------------------------------------------
# Control plane: report_draining (multi-node cluster, no trainer)
# ---------------------------------------------------------------------------


@pytest.fixture
def multi_node_cluster():
    from ray_tpu_torch._private.bootstrap import Cluster

    clusters = []

    def make():
        c = Cluster()
        c.start_control()
        clusters.append(c)
        return c

    yield make
    for c in clusters:
        c.shutdown()


def _driver(cluster, node):
    from ray_tpu_torch._private.core import CoreWorker
    from ray_tpu_torch._private.protocol import Client

    probe = Client(node.addr)
    info = probe.call("node_info", timeout=30.0)
    probe.close()
    return CoreWorker(cluster.control_addr, node.addr, mode="driver",
                      node_id=info["node_id"],
                      store_root=info["store_root"])


def test_report_draining_view_pubsub_and_scheduling(private_runtime,
                                                    multi_node_cluster):
    c = multi_node_cluster()
    n1 = c.add_node(resources={"CPU": 2})
    n2 = c.add_node(resources={"CPU": 2})
    core = _driver(c, n1)
    try:
        events = []
        core.add_push_handler("pub:node", events.append)
        r = core.control.call("report_draining", {
            "node_id": n2.node_id, "grace_s": 5.0,
            "reason": "maintenance"}, timeout=10.0)
        assert r["ok"]
        nodes = core.control.call("get_nodes", timeout=10.0)
        rec = [n for n in nodes if n["node_id"] == n2.node_id][0]
        assert rec["draining"] and rec["draining_reason"] == "maintenance"
        assert 0 < rec["draining_remaining_s"] <= 5.0
        assert not core.control.call(
            "report_draining", {"node_id": "nope"}, timeout=10.0)["ok"]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(e.get("event") == "draining"
                   and (e.get("node") or {}).get("node_id") == n2.node_id
                   for e in events):
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"no draining advisory received: {events}")

        # the scheduler avoids the draining node while alternatives exist
        class Pinned:
            def where(self):
                return os.environ.get("RAY_TPU_TORCH_NODE_ID")

        handles = [core.create_actor(Pinned, (), {}, name=f"pin{i}",
                                     resources={"CPU": 1})
                   for i in range(2)]
        homes = [core.get(core.submit_actor_task(h, "where", (), {})[0],
                          timeout=60) for h in handles]
        assert all(h == n1.node_id for h in homes), homes

        core.control.call("report_draining",
                          {"node_id": n2.node_id, "cancel": True},
                          timeout=10.0)
        nodes = core.control.call("get_nodes", timeout=10.0)
        rec = [n for n in nodes if n["node_id"] == n2.node_id][0]
        assert not rec["draining"]
    finally:
        core.shutdown()


def test_raylet_file_source_reports_drain(private_runtime,
                                          multi_node_cluster, monkeypatch,
                                          tmp_path):
    """The whole raylet-side path: env-selected FilePreemptionSource ->
    PreemptionWatcher -> report_draining -> control view."""
    sentinel = tmp_path / "preempt"
    monkeypatch.setenv("RAY_TPU_TORCH_PREEMPTION_FILE", str(sentinel))
    monkeypatch.setenv("RAY_TPU_TORCH_PREEMPTION_POLL_S", "0.1")
    c = multi_node_cluster()
    node = c.add_node(resources={"CPU": 1})  # raylet inherits the env
    core = _driver(c, node)
    try:
        sentinel.write_text('{"reason": "spot-reclaim", "grace_s": 9}')
        deadline = time.monotonic() + 15
        rec = None
        while time.monotonic() < deadline:
            nodes = core.control.call("get_nodes", timeout=10.0)
            rec = [n for n in nodes if n["node_id"] == node.node_id][0]
            if rec["draining"]:
                break
            time.sleep(0.1)
        assert rec and rec["draining"], rec
        assert rec["draining_reason"] == "spot-reclaim"
        assert rec["draining_remaining_s"] <= 9.0
    finally:
        core.shutdown()


# ---------------------------------------------------------------------------
# The elastic train loop used by the recovery tests
# ---------------------------------------------------------------------------


def _elastic_loop(config):
    """Deterministic synthetic data-parallel training: each rank works
    its slice of the global batch, the sums sync through the backend's
    kv group, so the weight trajectory depends only on the global batch
    — identical at any width.  The state is a tensor."""
    import torch

    from ray_tpu_torch import collective, elastic
    from ray_tpu_torch import train as _train
    from ray_tpu_torch.elastic.emergency import EmergencyCheckpoint as _EC

    ctx = _train.get_context()
    G = ctx.extra["global_batch_size"]
    pb = ctx.extra["per_replica_batch"]
    off = ctx.extra["batch_offset"]
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]

    state = {"w": torch.tensor(1.0, dtype=torch.float64), "step": 0}
    ck = _train.get_checkpoint()
    if isinstance(ck, _EC):
        # all dp shards carry the same replicated scalar state
        state = dict(max(ck.load(), key=lambda s: s["step"]))

    while state["step"] < config["steps"]:
        t = state["step"]
        idx = torch.arange(off, off + pb, dtype=torch.float64)
        gsum = torch.sum(torch.sin(idx + t) * state["w"] + idx * 0.01)
        total = collective.allreduce(gsum.reshape(1), group_name=group)
        state = {"w": state["w"] - 0.1 * total[0] / G, "step": t + 1}
        elastic.snapshot(state, state["step"])
        # replication completes before the report boundary, so every
        # consumed round is a fully-covered quorum step
        assert elastic.wait_replicated(20.0)
        _train.report({"step": state["step"], "w": float(state["w"]),
                       "world_size": ctx.get_world_size(),
                       "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID")})


def test_a_round_with_a_dead_worker_reports_the_death(cluster):
    """A worker's death stalls its peers' collectives until they time
    out; when a peer's timeout comes first in the round's order, the
    executor still reports the death (TrainingWorkerError), which elastic
    recovery acts on, and not a failed run."""
    @rt.remote
    def peer_timed_out():
        raise TimeoutError("collective rendezvous timed out")

    @rt.remote
    class Worker:
        def next_result(self):
            return ("report", 1)

    w = Worker.remote()
    assert rt.get(w.next_result.remote(), timeout=60) == ("report", 1)
    rt.kill(w)
    deadline = time.monotonic() + 60
    while True:     # the kill lands asynchronously
        dead = w.next_result.remote()
        try:
            rt.get(dead, timeout=60)
        except rt.ActorDiedError:
            break
        assert time.monotonic() < deadline, "the killed actor still answers"
        time.sleep(0.05)
    executor = BackendExecutor(JaxConfig(mode="local"),
                               ScalingConfig(num_workers=2))
    with pytest.raises(TrainingWorkerError):
        executor._get_with_failure_handling([peer_timed_out.remote(), dead])
    with pytest.raises(TrainingFailedError):
        executor._get_with_failure_handling([peer_timed_out.remote()])


def _reference_w(steps, G, w0=1.0, lr=0.1):
    import numpy as np

    w = w0
    idx = np.arange(G, dtype=np.float64)
    for t in range(steps):
        w -= lr * float(np.sum(np.sin(idx + t) * w + idx * 0.01)) / G
    return w


# ---------------------------------------------------------------------------
# Worker death -> quorum recovery (shared cluster, executor level)
# ---------------------------------------------------------------------------


def test_executor_elastic_recovery_after_worker_death(cluster, tmp_path):
    """Kill one of three workers mid-training: elastic_recover rebuilds a
    2-wide gang from the freshest replicated quorum, and the resumed run
    finishes on the uninterrupted weight trajectory."""
    STEPS, G = 8, 12
    ec = ElasticConfig(min_workers=2, replication_factor=1,
                       global_batch_size=G, recover_timeout_s=5.0)
    executor = BackendExecutor(
        JaxConfig(mode="local", elastic=ec),
        ScalingConfig(num_workers=3))
    executor.start()
    try:
        executor.start_training(_elastic_loop, {"steps": STEPS}, "eexp",
                                "etrial", str(tmp_path / "trial"))
        for _ in range(3):
            assert executor.get_next_results() is not None
        # hard-kill worker 2's actor: simulates losing its host
        rt.kill(executor.worker_group.workers[2].actor)
        with pytest.raises(TrainingWorkerError):
            while executor.get_next_results() is not None:
                pass
        cks, step, new_n = executor.elastic_recover()
        assert new_n == 2
        assert step >= 3  # at least every consumed round was replicated
        assert sorted(s for c in cks for s in c.shard_ids()) == [0, 1, 2]
        executor.start_training(_elastic_loop, {"steps": STEPS}, "eexp",
                                "etrial", str(tmp_path / "trial"),
                                start_iteration=executor.rounds_consumed,
                                per_worker_checkpoints=cks)
        last = None
        while True:
            res = executor.get_next_results()
            if res is None:
                break
            last = res
        executor.finish_training()
        _, metrics, _ = last[0]
        assert metrics["step"] == STEPS
        assert metrics["world_size"] == 2
        assert abs(metrics["w"] - _reference_w(STEPS, G)) < 1e-6
    finally:
        executor.shutdown()


def test_destroy_collective_group_last_member_sweeps(cluster):
    """An early-leaving rank's destroy must not sweep the shared result
    key while slower ranks still poll it — only the last member sweeps
    (the elastic abort path leaves ranks at different times)."""
    from ray_tpu_torch.collective import collective as cmod

    kv = lambda key: cmod._kv().call("kv_get", {"ns": "collective",
                                                "key": key})
    cmod._kv_put("race/1/ar/-1", b"reduced")
    def member(rank):
        return cmod.GroupHandle("race", 2, rank, "kv", None,
                                torch.device("cpu"), False)

    cmod._groups["race"] = member(0)
    cmod.destroy_collective_group("race")      # rank 0 leaves first
    assert kv("race/1/ar/-1") == b"reduced"    # rank 1 can still read it
    cmod._groups["race"] = member(1)
    cmod.destroy_collective_group("race")      # last member: full sweep
    assert kv("race/1/ar/-1") is None
    assert kv("race/fin/0") is None


def test_emergency_checkpointer_replicates_ring_peers(cluster):
    from ray_tpu_torch.elastic import emergency

    emergency._clear_vault()
    cks = [emergency.EmergencyCheckpointer("unit-ring", r, 3,
                                           replication_factor=1,
                                           keep_steps=2)
           for r in range(3)]
    try:
        for step in (1, 2, 3):
            for r, ck in enumerate(cks):
                assert ck.snapshot({"rank": torch.tensor(r),
                                    "step": step}, step)
            for ck in cks:
                assert ck.wait_idle(20.0)
        inv = emergency._inventory()
        # keep_steps=2 pruned step 1; each retained step fully covered
        # (the three instances share this process's vault)
        assert [e["step"] for e in inv] == [2, 3]
        assert all(e["shards"] == [0, 1, 2] and e["world"] == 3
                   for e in inv)
        got = pickle.loads(emergency._fetch(3, 1))
        assert got["step"] == 3 and torch.equal(got["rank"],
                                                torch.tensor(1))
        # cadence: snapshot_every=2 skips odd steps
        ck = emergency.EmergencyCheckpointer("unit-cad", 0, 1,
                                             replication_factor=0,
                                             snapshot_every=2)
        assert ck.snapshot({"x": 1}, 4) and not ck.snapshot({"x": 1}, 5)
        ck.stop()
    finally:
        for ck in cks:
            ck.stop()
        emergency._clear_vault()


# ---------------------------------------------------------------------------
# Acceptance scenario: drain notice -> emergency ckpt -> shrink -> resume
# ---------------------------------------------------------------------------


class _DrainInjector:
    """RunConfig callback that posts a drain notice for rank 0's node
    once training is underway, then records when the shrunken gang's
    first report lands (the drain->resume latency)."""

    def __init__(self, total_workers):
        self.total = total_workers
        self.drained_node = None
        self.t_drain = None
        self.t_resumed = None
        self.widths = []

    def on_trial_result(self, trial, metrics):
        self.widths.append(metrics["world_size"])
        if self.t_drain is None and metrics["step"] >= 2:
            from ray_tpu_torch._private.api import current_core

            self.drained_node = metrics["node_id"]
            current_core().control.call("report_draining", {
                "node_id": self.drained_node, "grace_s": 30.0,
                "reason": "test-preemption"}, timeout=10.0)
            self.t_drain = time.monotonic()
        elif (self.t_drain is not None and self.t_resumed is None
                and metrics["world_size"] < self.total):
            self.t_resumed = time.monotonic()

    def on_trial_complete(self, trial):
        pass

    def on_trial_error(self, trial):
        pass


def test_trainer_drain_notice_elastic_resume(private_runtime,
                                             multi_node_cluster, tmp_path):
    """A preemption advisory against one host mid-training makes the
    trainer shrink 3->2 and resume from the peer-replicated quorum — no
    storage restart, the final weight that of the uninterrupted run, and
    drain -> first resumed report under the 10 s heartbeat-death
    interval."""
    STEPS, G = 8, 12
    c = multi_node_cluster()
    for _ in range(3):
        c.add_node(resources={"CPU": 1})
    host, port = c.control_addr
    rt.init(address=f"{host}:{port}")

    injector = _DrainInjector(total_workers=3)
    result = train.JaxTrainer(
        _elastic_loop, train_loop_config={"steps": STEPS},
        backend_config=JaxConfig(
            mode="local",
            elastic=ElasticConfig(min_workers=2, replication_factor=1,
                                  global_batch_size=G,
                                  recover_timeout_s=5.0)),
        scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(name="edrain", storage_path=str(tmp_path),
                             callbacks=[injector]),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == STEPS
    assert injector.widths[0] == 3
    assert result.metrics["world_size"] == 2
    assert injector.t_resumed is not None, injector.widths
    recovery_s = injector.t_resumed - injector.t_drain
    assert recovery_s < 10.0, f"drain->resume took {recovery_s:.1f}s"
    assert abs(result.metrics["w"] - _reference_w(STEPS, G)) < 1e-6
