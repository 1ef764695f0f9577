"""Autoscaler v2 on the port: the cases of tests/test_autoscaler_v2.py
against ``ray_tpu_torch.autoscaler.v2`` (reference:
python/ray/autoscaler/v2/tests — instance storage versioning, reconciler
lifecycle stepping)."""

import time

import pytest

from ray_tpu_torch.autoscaler.v2 import (ALLOCATED, QUEUED, RAY_RUNNING,
                                   RAY_STOPPING, REQUESTED, TERMINATED,
                                   TERMINATING, AutoscalerV2, Instance,
                                   InstanceManager, InstanceStorage,
                                   Reconciler)


def test_instance_storage_versioning():
    s = InstanceStorage()
    i1 = Instance("i1", "cpu2")
    ok, v1 = s.batch_upsert([i1])
    assert ok and v1 == 1
    # stale expected version conflicts
    i2 = Instance("i2", "cpu2")
    ok, v = s.batch_upsert([i2], expected_version=0)
    assert not ok and v == 1
    ok, v2 = s.batch_upsert([i2], expected_version=1)
    assert ok and v2 == 2
    assert set(s.get_instances()) == {"i1", "i2"}
    s.delete(["i1"])
    assert set(s.get_instances()) == {"i2"}


def test_instance_manager_updates():
    im = InstanceManager()
    insts = im.add_instances("cpu2", 3)
    assert len(insts) == 3
    assert all(i.status == QUEUED for i in im.storage.get_instances().values())
    iid = insts[0].instance_id
    assert im.update_status(iid, REQUESTED, cloud_instance_id="c-1")
    got = im.storage.get_instances([REQUESTED])
    assert list(got) == [iid]
    assert got[iid].cloud_instance_id == "c-1"
    assert not im.update_status("nope", REQUESTED)


class FakeProvider:
    """In-memory cloud: create/terminate manipulate a live-id set."""

    def __init__(self):
        self.alive = set()
        self.n = 0
        self.fail_next_create = False

    def non_terminated_nodes(self, tag_filters):
        return list(self.alive)

    def create_node(self, node_config, tags, count):
        if self.fail_next_create:
            self.fail_next_create = False
            raise RuntimeError("cloud hiccup")
        out = []
        for _ in range(count):
            self.n += 1
            cid = f"cloud-{self.n}"
            self.alive.add(cid)
            out.append(cid)
        return out

    def terminate_node(self, node_id):
        self.alive.discard(node_id)


class FakeLoad:
    def __init__(self):
        self.nodes = []
        self.demands = []
        self.idle_s = {}

    def snapshot(self):
        return {"nodes": self.nodes, "demands": self.demands,
                "idle_s": dict(self.idle_s)}


def _mk(idle_timeout_s=60.0):
    from ray_tpu_torch.autoscaler.autoscaler import ResourceDemandScheduler

    provider = FakeProvider()
    load = FakeLoad()
    sched = ResourceDemandScheduler(
        {"cpu2": {"resources": {"CPU": 2.0}, "min_workers": 0,
                  "max_workers": 5}}, max_workers=5)
    im = InstanceManager()
    rec = Reconciler(im, provider, sched, load,
                     idle_timeout_s=idle_timeout_s)
    return provider, load, im, rec


def test_reconciler_scales_up_for_demand():
    provider, load, im, rec = _mk()
    load.demands = [{"CPU": 2.0}, {"CPU": 2.0}]
    rec.reconcile()
    # declared + launched in one pass: QUEUED -> REQUESTED
    insts = im.storage.get_instances()
    assert len(insts) == 2
    assert all(i.status == REQUESTED for i in insts.values())
    assert len(provider.alive) == 2
    # cloud confirms -> ALLOCATED; then ray node appears -> RAY_RUNNING
    cid = next(iter(provider.alive))
    load.nodes = [{"node_id": cid, "available": {"CPU": 2.0},
                   "total": {"CPU": 2.0}, "labels": {}}]
    load.demands = []
    rec.reconcile()
    statuses = sorted(i.status for i in im.storage.get_instances().values())
    assert statuses == [ALLOCATED, RAY_RUNNING] or \
        statuses == sorted([RAY_RUNNING, ALLOCATED])


def test_reconciler_no_duplicate_launches():
    provider, load, im, rec = _mk()
    load.demands = [{"CPU": 2.0}]
    rec.reconcile()
    assert len(im.storage.get_instances()) == 1
    # same demand again while the instance is still coming up: no dupes
    rec.reconcile()
    assert len(im.storage.get_instances()) == 1


def test_reconciler_idle_scale_down():
    provider, load, im, rec = _mk(idle_timeout_s=0.1)
    load.demands = [{"CPU": 2.0}]
    rec.reconcile()
    cid = next(iter(provider.alive))
    load.nodes = [{"node_id": cid, "available": {"CPU": 2.0},
                   "total": {"CPU": 2.0}, "labels": {}}]
    load.demands = []
    rec.reconcile()  # -> RAY_RUNNING
    inst = next(iter(im.storage.get_instances().values()))
    assert inst.status == RAY_RUNNING
    load.idle_s = {cid: 999.0}
    rec.reconcile()  # idle -> RAY_STOPPING -> TERMINATING
    inst = next(iter(im.storage.get_instances().values()))
    assert inst.status == TERMINATING
    assert provider.alive == set()
    load.nodes = []
    rec.reconcile()  # cloud confirms gone -> TERMINATED -> GC'd
    assert im.storage.get_instances() == {}
    assert rec.num_terminated == 1


def test_reconciler_survives_cloud_failure():
    provider, load, im, rec = _mk()
    provider.fail_next_create = True
    load.demands = [{"CPU": 2.0}]
    rec.reconcile()
    # stays QUEUED after the failed launch; next pass retries
    inst = next(iter(im.storage.get_instances().values()))
    assert inst.status == QUEUED
    rec.reconcile()
    inst = next(iter(im.storage.get_instances().values()))
    assert inst.status == REQUESTED


def test_reconciler_detects_preempted_instance():
    provider, load, im, rec = _mk()
    load.demands = [{"CPU": 2.0}]
    rec.reconcile()
    cid = next(iter(provider.alive))
    load.demands = []
    rec.reconcile()  # ALLOCATED
    provider.alive.discard(cid)  # preemption
    rec.reconcile()
    # observed dead -> TERMINATED -> GC'd same pass
    assert im.storage.get_instances() == {}
