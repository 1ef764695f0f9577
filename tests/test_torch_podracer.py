"""Podracer (Anakin/Sebulba) tests of the port — ray_tpu_torch/rl/
podracer.py: the cases of tests/test_podracer.py on the port's own
cluster, every entry point with ``device="cpu"``.

The Sebulba chaos e2e is the headline: a run with a hard actor-gang
kill, a sustained straggler (quarantined by the RemediationEngine), and
a preemption drain must complete with availability 1.0, exactly-once
sample accounting, bounded staleness, and — because batch content is a
pure function of (seed, slot, seq, params-history) — final learner
params bitwise-identical to a chaos-free run of the same config.  The
gangs are CPU workers here (each imports torch, ~3 s, so a respawn
costs more than in the reference's runs).
"""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.rl.podracer import (AnakinConfig, ChaosEvent,
                                       ChaosSchedule, SebulbaConfig,
                                       run_anakin, run_sebulba)

pytestmark = pytest.mark.rl


@pytest.fixture(scope="module")
def ray_cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_anakin_smoke_deterministic():
    """Anakin: the fused scan trains, and reruns bit-identically."""
    cfg = AnakinConfig(num_envs=8, rollout_len=8, num_updates=6,
                       hidden=(16,), seed=3, device="cpu")
    r1 = run_anakin(cfg)
    assert r1["env_steps"] == 6 * 8 * 8
    assert r1["env_steps_per_s"] > 0
    assert np.isfinite(r1["final_loss"])
    assert r1["metrics"]["loss"].shape == (6,)
    r2 = run_anakin(cfg)
    assert r2["params_digest"] == r1["params_digest"]
    # the run is one program of the port's ledger
    from ray_tpu_torch.telemetry import device as devtel

    assert "rl.anakin.train" in devtel.get_ledger().counts()


def test_chaos_schedule_sustained_deterministic():
    s1 = ChaosSchedule.sustained(100, 4, kills=2, stragglers=1,
                                 preemptions=1, seed=7)
    s2 = ChaosSchedule.sustained(100, 4, kills=2, stragglers=1,
                                 preemptions=1, seed=7)
    assert [(e.at_update, e.kind, e.slot) for e in s1.events] == \
           [(e.at_update, e.kind, e.slot) for e in s2.events]
    kinds = [e.kind for e in s1.events]
    assert sorted(kinds) == ["kill", "kill", "preempt", "straggle"]
    assert all(0 <= e.at_update < 100 for e in s1.events)
    assert all(0 <= e.slot < 4 for e in s1.events)
    # due() drains in order, exactly once
    fired = [ev for t in range(100) for ev in s1.due(t)]
    assert fired == s1.events and s1.due(99) == []


def _check_exactly_once(result, num_updates, num_gangs):
    """Every (slot, seq) consumed exactly once, contiguous per slot."""
    keys = [(slot, seq) for slot, _inc, seq, _v in result["consumed"]]
    assert len(keys) == num_updates
    assert len(set(keys)) == num_updates, "duplicate batches consumed"
    for slot in range(num_gangs):
        seqs = [seq for s, seq in keys if s == slot]
        assert seqs == list(range(len(seqs))), \
            f"slot {slot} seqs not contiguous: {seqs}"


def test_sebulba_clean_run(ray_cluster):
    cfg = SebulbaConfig(num_gangs=2, num_envs=4, rollout_len=8,
                        num_updates=8, hidden=(16,), seed=5,
                        trial="seb_clean", device="cpu")
    r = run_sebulba(cfg)
    _check_exactly_once(r, 8, 2)
    assert r["staleness"]["max"] <= r["staleness"]["bound"]
    assert r["availability"] == 1.0
    assert r["respawns"] == 0 and r["deaths"] == []
    assert r["learner_samples_per_s"] > 0 and r["env_steps_per_s"] > 0
    assert len(r["params_digest"]) == 64


def test_sebulba_batches_equal_an_in_process_replay(ray_cluster):
    """The gangs' batches are the ones this process makes for the same
    (slot, seq, version): the clean run's digest equals the in-process
    replay's (what chip_smoke's rl phase checks on the card, where the
    gangs are GPU workers)."""
    from ray_tpu_torch.rl.podracer import replay_sebulba

    cfg = SebulbaConfig(num_gangs=2, num_envs=4, rollout_len=8,
                        num_updates=6, hidden=(16,), seed=5,
                        trial="seb_replay", device="cpu")
    r = run_sebulba(cfg)
    replay = replay_sebulba(cfg)
    assert replay["params_digest"] == r["params_digest"]
    assert replay["final_metrics"] == r["final_metrics"]


@pytest.fixture(scope="module")
def seb_probe_run(ray_cluster):
    """A two-gang run whose chaos schedule names a slot the run does not
    have, started with another program's storm advisory in the process's
    ledger (an earlier test file in the same worker can leave one)."""
    from ray_tpu_torch.telemetry import device as devtel

    foreign = {"event": "device_advisory", "kind": "recompile_storm",
               "program": "some.other.program", "ts": 0.0}
    devtel.get_ledger().push_advisory(foreign, publish=False)
    chaos = ChaosSchedule([ChaosEvent(at_update=1, kind="straggle", slot=7,
                                      value=1.0)])
    cfg = SebulbaConfig(num_gangs=2, num_envs=4, rollout_len=8,
                        num_updates=4, hidden=(16,), seed=5,
                        trial="seb_probe", device="cpu")
    yield run_sebulba(cfg, chaos)
    devtel.reset_for_tests()


def test_sebulba_cpu_gangs_use_the_cpus_their_lease_grants(seb_probe_run):
    """A gang on the CPU holds one CPU and computes with one torch
    thread.  torch's default, a thread per core, made a gang's 2 ms
    rollout take 0.25-0.6 s beside six busy test workers: the healthy
    gangs' median rose past 1.4 s / 3 and hid the chaos run's straggler
    (test_sebulba_chaos_e2e, ROADMAP §C, Repaired)."""
    r = seb_probe_run
    assert r["gang_cpu_threads"] == {0: 1, 1: 1}
    # each round's view of the gangs' busy seconds, with its median, is
    # in the result
    assert [v["round"] for v in r["rounds"]] == [0, 1]
    for v in r["rounds"]:
        assert set(v["busy"]) == {0, 1}
        assert v["median"] == pytest.approx(np.median(list(
            v["busy"].values())))


def test_sebulba_records_a_failed_injection_and_does_not_count_it(
        seb_probe_run):
    r = seb_probe_run
    assert r["chaos_fired"] == []
    (out,) = r["chaos_outcomes"]
    assert out["kind"] == "straggle" and out["slot"] == 7
    assert out["ok"] is False and "KeyError" in out["error"]
    _check_exactly_once(r, 4, 2)


def test_sebulba_takes_no_other_programs_advisories(seb_probe_run):
    """Another program's storm advisory in the process's ledger is not a
    cause of this run (its learner update is eager, no program of the
    ledger): no record, and the advisory stays for its own readers."""
    from ray_tpu_torch.telemetry import device as devtel

    assert seb_probe_run["remediation_records"] == []
    assert any(a.get("program") == "some.other.program"
               for a in devtel.get_ledger().drain_advisories())


def test_sebulba_chaos_e2e(ray_cluster):
    """The acceptance scenario: one hard kill, one sustained straggler,
    one preemption drain — all while the learner keeps consuming.

    Asserts availability 1.0 (no learner stall beyond the bound),
    exactly one quarantine remediation record, the goodput dip visible
    to the autoscaler's GoodputPolicy at the moment of death, and the
    final params bitwise-equal to a chaos-free run (the chaos schedule
    — seeded via RAY_TPU_TORCH_CHAOS_SEED — can affect timing, never
    sample content)."""
    from ray_tpu_torch._private.core import current_core
    from ray_tpu_torch.autoscaler.autoscaler import LoadMetrics
    from ray_tpu_torch.autoscaler.v2 import GoodputPolicy

    G, N = 3, 24
    probes = []

    def probe(stage, info):
        lm = LoadMetrics(current_core().control)
        probes.append((stage, dict(info), lm._train_goodput()))

    def cfg(trial, with_probe):
        # min_produce_s floors every batch at 0.2s so host jitter (a
        # respawned gang compiling on a shared CPU) stays proportionally
        # small against the 3x straggler threshold and the 75% recover
        # tolerance; the injected 1.2s delay still trips detection
        return SebulbaConfig(
            num_gangs=G, num_envs=4, rollout_len=8, num_updates=N,
            hidden=(16,), seed=11, trial=trial, window=1,
            min_produce_s=0.2, straggler_multiple=3.0,
            straggler_sustain=2, remediation_max_episodes=1,
            remediation_effect_window=2,
            remediation_recover_tolerance=0.75, drain_grace_s=5.0,
            probe=probe if with_probe else None, device="cpu")

    # kill first (its respawn storm ends before the straggler decision's
    # effect window opens), straggle immediately after, preempt near the
    # end — three overlapping failure domains, never a quiet run
    chaos = ChaosSchedule([
        ChaosEvent(at_update=0, kind="kill", slot=0),
        ChaosEvent(at_update=1, kind="straggle", slot=1, value=1.2),
        ChaosEvent(at_update=21, kind="preempt", slot=2, value=5.0),
    ])
    r = run_sebulba(cfg("seb_chaos", True), chaos)

    # every update consumed exactly once, in order, staleness bounded
    _check_exactly_once(r, N, G)
    assert r["staleness"]["max"] <= r["staleness"]["bound"]
    assert r["staleness"]["p99"] <= r["staleness"]["bound"]
    # no learner stall beyond the bound
    assert r["availability"] == 1.0

    # the kill surfaced as a stream error (no consumer hang) + respawn
    assert len(r["chaos_fired"]) == 3
    kinds = {d["kind"] for d in r["deaths"]}
    assert "stream-error" in kinds, r["deaths"]
    # the preemption drained exactly once through the watcher
    assert r["notices"] == {"fired": 1, "suppressed": 0}
    assert len(r["drains"]) == 1 and r["drains"][0]["slot"] == 2
    assert "drain" in kinds
    assert r["respawns"] >= 2

    # exactly one quarantine remediation record, enforced, on the
    # straggling slot, with the replacement measured recovered
    recs = r["remediation_records"]
    assert len(recs) == 1, recs
    act = recs[0]["action"]
    assert act["kind"] == "quarantine_rebalance" and act["rank"] == 1
    assert not act["dry_run"] and act["node_id"]
    assert r["remediation"]["enforced"] == 1
    assert recs[0]["effect"] is not None and recs[0]["effect"]["recovered"]
    assert "quarantine" in kinds
    assert len(r["quarantined_nodes"]) == 1

    # every death published a goodput dip the GoodputPolicy would act
    # on; the KV-backed LoadMetrics snapshot saw it at probe time
    assert len(probes) == len(r["deaths"]) >= 3
    pol = GoodputPolicy()
    for stage, info, train_gp in probes:
        assert stage == "goodput_dip"
        assert info["goodput"] < pol.scale_up_below
        assert train_gp.get("seb_chaos") == pytest.approx((G - 1) / G)
    # ... and the fleet recovered to target width every time
    assert r["goodput_trace"][-1] == 1.0
    assert all(0 <= inc for inc in r["incarnations"].values())
    assert len(r["resume_widths"]) == r["respawns"]
    assert all(1 <= w <= G for w in r["resume_widths"])

    # bitwise reproducibility: chaos affected timing, never content
    clean = run_sebulba(cfg("seb_chaos_clean", False))
    assert clean["params_digest"] == r["params_digest"]
