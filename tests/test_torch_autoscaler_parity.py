"""The port's autoscaler and ActorPool against the JAX package on the same
inputs: seeded demand lists and node types through both packages'
``ResourceDemandScheduler.get_nodes_to_launch`` give equal plans (the
reference's ``TPU`` key is the port's ``GPU``); both packages' v2
reconcilers, stepped over the same scripted snapshots, make the same
launches, terminations and policy holds; and the port's ``ActorPool.map``
over GPT-nano CPU actors (weights carried by ``models/convert.py``)
agrees with the reference's ``gpt.apply`` at tests/test_torch_gpt.py's
atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.autoscaler import autoscaler as ref_as
from ray_tpu.autoscaler import v2 as ref_v2
from ray_tpu.models import gpt as jgpt
from test_torch_collective import _fresh_device_ledger  # noqa: F401

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import autoscaler as port_as
from ray_tpu_torch.autoscaler import v2 as port_v2
from ray_tpu_torch.util import ActorPool

torch.set_num_threads(1)

CASES = 300


def _to_port(res):
    """The reference's resource dict with its accelerator key renamed."""
    return {("GPU" if k == "TPU" else k): v for k, v in res.items()}


def _random_case(rng):
    node_types = {}
    for i in range(rng.randint(1, 4)):
        res = {"CPU": float(rng.choice([2, 4, 8, 16]))}
        if rng.rand() < 0.6:
            res["TPU"] = float(rng.choice([1, 4, 8]))
        cfg = {"resources": res}
        if rng.rand() < 0.7:
            cfg["max_workers"] = int(rng.randint(0, 5))
        node_types[f"t{i}"] = cfg
    nodes = []
    for j in range(rng.randint(0, 4)):
        total = {"CPU": float(rng.choice([1, 4, 8]))}
        if rng.rand() < 0.5:
            total["TPU"] = float(rng.choice([1, 4]))
        avail = {k: float(rng.randint(0, int(v) + 1))
                 for k, v in total.items()}
        nodes.append({"node_id": f"n{j}", "available": avail,
                      "total": total})
    demands = []
    for _ in range(rng.randint(0, 12)):
        d = {"CPU": float(rng.choice([0.5, 1, 2, 4, 8]))}
        if rng.rand() < 0.5:
            d["TPU"] = float(rng.choice([0.5, 1, 4, 8, 16]))
        demands.append(d)
    current = {t: int(rng.randint(0, 3)) for t in node_types
               if rng.rand() < 0.5}
    return node_types, int(rng.randint(1, 10)), nodes, demands, current


def test_demand_plans_equal_the_reference():
    rng = np.random.RandomState(0)
    nonempty = 0
    for _ in range(CASES):
        node_types, max_workers, nodes, demands, current = \
            _random_case(rng)
        want = ref_as.ResourceDemandScheduler(
            node_types, max_workers).get_nodes_to_launch(
            {"nodes": nodes, "demands": demands, "idle_s": {}},
            dict(current))
        got = port_as.ResourceDemandScheduler(
            {t: {**c, "resources": _to_port(c["resources"])}
             for t, c in node_types.items()},
            max_workers).get_nodes_to_launch(
            {"nodes": [{**n, "available": _to_port(n["available"]),
                        "total": _to_port(n["total"])} for n in nodes],
             "demands": [_to_port(d) for d in demands], "idle_s": {}},
            dict(current))
        assert got == want, (node_types, nodes, demands, current)
        nonempty += bool(want)
    # the cases exercise launching, not only empty plans
    assert nonempty > CASES // 4


class _Provider:
    """In-memory cloud with deterministic ids (the same in both runs)."""

    def __init__(self):
        self.alive = []
        self.n = 0
        self.terminated = []

    def non_terminated_nodes(self, tag_filters):
        return list(self.alive)

    def create_node(self, node_config, tags, count):
        out = []
        for _ in range(count):
            self.n += 1
            self.alive.append(f"cloud-{self.n}")
            out.append(self.alive[-1])
        return out

    def terminate_node(self, node_id):
        if node_id in self.alive:
            self.alive.remove(node_id)
            self.terminated.append(node_id)


class _Load:
    def __init__(self):
        self.snap = {}

    def snapshot(self):
        return dict(self.snap)


def _scripted(v2, scheduler_cls, key):
    """Step one package's reconciler over 40 seeded snapshots; return the
    decisions of each step."""
    rng = np.random.RandomState(0)
    sched = scheduler_cls(
        {"small": {"resources": {"CPU": 2.0}, "max_workers": 3},
         "acc": {"resources": {"CPU": 8.0, key: 4.0}, "min_workers": 0,
                 "max_workers": 2}}, max_workers=4)
    provider, load = _Provider(), _Load()
    rec = v2.Reconciler(
        v2.InstanceManager(), provider, sched, load, idle_timeout_s=30.0,
        goodput_policy=v2.GoodputPolicy(max_extra=1),
        serve_policy=v2.ServeSLOPolicy(max_queue_per_replica=2.0))
    out = []
    for step in range(40):
        running = [c for c in provider.alive if rng.rand() < 0.8]
        demands = []
        for _ in range(rng.randint(0, 4)):
            d = {"CPU": float(rng.choice([1, 2, 4]))}
            if rng.rand() < 0.4:
                d[key] = float(rng.choice([1, 4]))
            demands.append(d)
        load.snap = {
            "nodes": [{"node_id": c, "available": {"CPU": 2.0},
                       "total": {"CPU": 2.0}, "labels": {},
                       "draining": rng.rand() < 0.1}
                      for c in running],
            "demands": demands,
            "idle_s": {c: float(rng.choice([0.0, 10.0, 60.0]))
                       for c in running},
            "train_goodput": ({"trial": float(rng.rand())}
                              if rng.rand() < 0.3 else {}),
            "serve_load": ({"app:llm": {"replicas": 1,
                                        "queue_depth": int(rng.randint(0, 5)),
                                        "accepting": 1}}
                           if rng.rand() < 0.3 else {}),
        }
        rec.reconcile()
        statuses = sorted((i.instance_type, i.status, i.cloud_instance_id
                           or "")
                          for i in rec.im.storage.get_instances().values())
        out.append({"alive": list(provider.alive),
                    "terminated": list(provider.terminated),
                    "statuses": statuses,
                    "counters": (rec.num_launched, rec.num_terminated,
                                 rec.num_goodput_launches,
                                 rec.num_goodput_holds,
                                 rec.num_serve_launches,
                                 rec.num_serve_holds)})
    return out


def test_v2_reconciler_decisions_equal_the_reference():
    want = _scripted(ref_v2, ref_as.ResourceDemandScheduler, "TPU")
    got = _scripted(port_v2, port_as.ResourceDemandScheduler, "GPU")
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, step
    last = want[-1]
    # the script launches, terminates and holds
    assert last["counters"][0] > 0 and last["terminated"]
    assert last["counters"][3] + last["counters"][5] > 0


@rt.remote
class _NanoActor:
    def __init__(self, np_params):
        torch.set_num_threads(1)
        from ray_tpu_torch.models import convert, gpt

        self.cfg = gpt.GPTConfig.nano(dtype=torch.float32)
        self.params = convert.from_jax_params(np_params, self.cfg,
                                              device="cpu")

    def last_logits(self, tokens):
        from ray_tpu_torch.models import gpt

        with torch.no_grad():
            logits = gpt.apply(self.params, tokens, self.cfg, device="cpu")
        return logits[:, -1].contiguous()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


def test_actor_pool_gpt_nano_matches_jax(cluster):
    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    ref = rt.put(np_params)
    actors = [_NanoActor.options(num_cpus=0).remote(ref) for _ in range(2)]
    pool = ActorPool(actors)
    batches = [np.random.RandomState(s).randint(0, 256, (2, 32))
               for s in range(6)]
    want = [np.asarray(jgpt.apply(jparams, jnp.asarray(t), jcfg))[:, -1]
            for t in batches]
    got = list(pool.map(lambda a, t: a.last_logits.remote(
        torch.from_numpy(t)), batches))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 256)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)
    unordered = list(pool.map_unordered(lambda a, t: a.last_logits.remote(
        torch.from_numpy(t)), batches))
    assert sorted(u.numpy().tobytes() for u in unordered) == \
        sorted(g.numpy().tobytes() for g in got)
    for a in actors:
        rt.kill(a)
