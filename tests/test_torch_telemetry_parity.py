"""The port's flight recorder against the JAX package's, on the CPU.

  * The same step, phase and clock inputs (injected clocks) go through
    both packages' ``StepTimer``, ``StepAggregator`` (straggler
    episodes), ``GoodputAccountant`` and ``chrome_trace``: the outputs
    are equal.
  * ``mesh_allreduce(profile=True, compression="int8")``, deterministic
    rounding: four gloo ranks of the port (spawned with
    ``torch.multiprocessing``, 120 s deadline) against the reference's
    ``xla_group`` on a CPU mesh of 4 devices, on seeded numpy shards.
    Bitwise equal to the reference's profiled result and to the port's
    own unprofiled calls (one chunk and the default chunking); each of
    the quantize / transfer / dequantize buckets is > 0 and their sum is
    at most the call's wall time; the current step's ``collective``
    phase carries them as ``collective.<stage>`` sub-phases.
  * The trainer with the recorder on (the default) at GPT nano against
    the reference's ``JaxTrainer`` (tests/test_torch_train_runtime.py's
    oracle pattern, weights through ``models/convert.py``, 2 workers, a
    ``data`` phase around each batch): losses within that file's
    LOSS_ATOL (1e-5), and the same phase names in every step record of
    every rank.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_collective import (_fresh_device_ledger, _global,  # noqa: F401
                                   _mesh, _rows, _same, _shard)
from test_torch_train_runtime import (LOSS_ATOL, ORACLE, _ref_env,
                                      _ref_init_params)

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.train import (JaxConfig, JaxTrainer, RunConfig,
                                 ScalingConfig)

SPAWN_DEADLINE_S = 120.0
WORLD = 4
PROF_SHAPE = (4, 2560)        # per rank: 10240 f32, 40 blocks of 256


# ---------------------------------------------------------------------------
# recorder, aggregator, goodput, Chrome trace: equal outputs
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _drive_timer(tel, rank, straggle):
    """Six steps of a scripted rank: data / collective (with sub-phases) /
    checkpoint, one rank slow in ``data`` for steps 2..5."""
    clk = _Clock(100.0)
    timer = tel.StepTimer(ring_size=4, rank=rank, incarnation=1,
                          trial="parity", clock=clk, wall=lambda: 5000.0)
    tel.set_current_timer(timer)
    try:
        for step in range(6):
            timer.step_start(step)
            with timer.phase("data"):
                clk.advance(0.25 if straggle and step >= 2 else 0.01)
            clk.advance(0.03)                       # the step's compute
            tel.record_collective(
                "allreduce", 0.02, payload_bytes=4096, wire_bytes=1100,
                breakdown={"quantize": 0.004, "transfer": 0.011,
                           "dequantize": 0.003})
            clk.advance(0.02)
            if step % 3 == 2:
                with timer.phase("checkpoint"):
                    clk.advance(0.05)
            timer.step_end()
        return timer.snapshot(), timer.aggregate()
    finally:
        tel.set_current_timer(None)


def _packages():
    import ray_tpu.telemetry as ref
    import ray_tpu_torch.telemetry as port

    return ref, port


def test_recorder_aggregator_goodput_and_trace_equal_across_packages():
    ref, port = _packages()
    out = {}
    for name, tel in (("ref", ref), ("port", port)):
        snaps = [dict(_drive_timer(tel, r, r == 1)[0], worker_id=f"w{r}")
                 for r in range(3)]
        aggs = [_drive_timer(tel, r, r == 1)[1] for r in range(3)]
        pubs = []
        agg = tel.StepAggregator(tel.TelemetryConfig(straggler_sustain=2),
                                 trial="parity", publish=pubs.append)
        for i in range(4):
            agg.ingest_round([s["steps"][i] for s in snaps])
        clk = _Clock(10.0)
        gp = tel.GoodputAccountant(clock=clk)
        for state, dt, meta in (("productive", 4.0, {"incarnation": 0}),
                                ("draining", 1.5, {"node": "n1"}),
                                ("recovering", 2.0, {}),
                                ("productive", 6.0, {"incarnation": 1}),
                                ("idle", 0.0, {})):
            gp.transition(state, **meta)
            clk.advance(dt)
        gp.note_incarnation(1)
        rems = [{"id": "r1", "trial": "parity", "ts": 5000.1,
                 "mode": "advisory",
                 "cause": {"event": "straggler_detected", "rank": 1,
                           "ts": 5000.1},
                 "action": {"kind": "recommend_quarantine", "rank": 1,
                            "dry_run": True, "ts": 5000.2},
                 "effect": None}]
        trace = tel.chrome_trace(snaps, remediations=rems)
        assert tel.validate_chrome_trace(trace)
        out[name] = {"snaps": snaps, "aggs": aggs, "pubs": pubs,
                     "summary": agg.summary(), "view": agg.last_view(),
                     "goodput": gp.report(), "trace": trace}
    ref_o, port_o = out["ref"], out["port"]
    for key in ("snaps", "aggs", "summary", "view", "goodput", "trace"):
        assert json.loads(json.dumps(port_o[key], sort_keys=True)) == \
            json.loads(json.dumps(ref_o[key], sort_keys=True)), key
    # one straggler episode, for rank 1, in both
    assert [p["rank"] for p in ref_o["pubs"]] == [1]
    assert port_o["pubs"] == ref_o["pubs"]
    assert port_o["snaps"][0]["steps"][0]["phases"]["collective.transfer"] \
        == pytest.approx(0.011)


# ---------------------------------------------------------------------------
# the profiled int8 allreduce: bitwise across packages and paths
# ---------------------------------------------------------------------------


def _rank_main(rank, world, init_file, out_path):
    torch.set_num_threads(1)
    try:
        from ray_tpu_torch.collective import collective as col
        from ray_tpu_torch.collective import nccl_group as ng
        from ray_tpu_torch.telemetry import recorder

        col.init_collective_group(world, rank, backend="gloo",
                                  group_name="p",
                                  init_method=f"file://{init_file}")
        pg = col.get_group_handle("p").pg
        x = torch.from_numpy(_shard("prof", rank, PROF_SHAPE))
        res = {}
        try:
            for op in ("sum", "mean"):
                timer = recorder.StepTimer(rank=rank)
                recorder.set_current_timer(timer)
                timer.step_start(0)
                t0 = time.perf_counter()
                prof = ng.mesh_allreduce(x, pg, op=op, compression="int8",
                                         profile=True)
                wall = time.perf_counter() - t0
                rec = timer.step_end(0)
                recorder.set_current_timer(None)
                _, bd = ng._q_allreduce_profiled(x, 0, pg, op,
                                                 ng.parse_compression(
                                                     "int8"))
                res[op] = {
                    "prof": prof.numpy().copy(),
                    "c1": ng.mesh_allreduce(
                        x, pg, op=op,
                        compression="int8:chunks=1").numpy().copy(),
                    "auto": ng.mesh_allreduce(
                        x, pg, op=op, compression="int8").numpy().copy(),
                    "c3": ng.mesh_allreduce(
                        x, pg, op=op,
                        compression="int8:chunks=3").numpy().copy(),
                    "phases": rec["phases"], "wall": wall, "bd": bd}
        finally:
            col.destroy_collective_group("p")
        np.save(out_path, res, allow_pickle=True)
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def prof_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    ctx = mp.get_context("spawn")
    outs = [str(d / f"rank{r}.npy") for r in range(WORLD)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, WORLD, str(d / "store"), outs[r]))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung:
        pytest.fail(f"ranks {hung} still running after "
                    f"{SPAWN_DEADLINE_S:.0f} s; killed")
    errs = [open(o + ".err").read() for o in outs
            if os.path.exists(o + ".err")]
    assert not errs and all(p.exitcode == 0 for p in procs), errs
    return [np.load(o, allow_pickle=True).item() for o in outs]


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_profiled_int8_allreduce_bitwise_reference_and_unprofiled(
        prof_ranks, op):
    from ray_tpu.collective import xla_group

    mesh = _mesh(WORLD)
    arr = _global(mesh, [_shard("prof", r, PROF_SHAPE)
                         for r in range(WORLD)])
    want = _rows(xla_group.mesh_allreduce(arr, mesh, "dp", op=op,
                                          compression="int8", profile=True),
                 WORLD)
    unprof = _rows(xla_group.mesh_allreduce(arr, mesh, "dp", op=op,
                                            compression="int8:chunks=1"),
                   WORLD)
    for r in range(WORLD):
        got = prof_ranks[r][op]
        _same(want[r], unprof[r])              # the reference's own claim
        _same(got["prof"], want[r])            # port profiled == reference
        for path in ("c1", "auto", "c3"):      # == the port unprofiled
            _same(got["prof"], got[path])
        bd = got["bd"]
        assert set(bd) == {"quantize", "transfer", "dequantize"}
        assert all(v > 0 for v in bd.values()), bd
        ph = got["phases"]
        stages = [ph[f"collective.{s}"]
                  for s in ("quantize", "transfer", "dequantize")]
        assert all(v > 0 for v in stages), ph
        assert sum(stages) <= got["wall"] + 1e-9
        assert sum(stages) <= ph["collective"] + 1e-9


# ---------------------------------------------------------------------------
# the trainer with the recorder on against the reference's oracle
# ---------------------------------------------------------------------------


_REF_TEL = r"""
import json, os, sys
import numpy as np
import ray_tpu
from ray_tpu import train
from ray_tpu.train import JaxConfig, JaxTrainer, RunConfig, ScalingConfig

B, S, SEED, STEPS = (int(a) for a in sys.argv[3:7])
LR = float(sys.argv[7])


def loop(config):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ray_tpu import collective, telemetry, train
    from ray_tpu.models import gpt

    rank = train.get_context().get_world_rank()
    group = os.environ["RAY_TPU_TRAIN_COLLECTIVE_GROUP"]
    cfg = gpt.GPTConfig.nano(dtype=jnp.float32,
                             attention_impl="pallas_interpret")
    tree = {}
    for key, v in np.load(config["params"]).items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    params = tree
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t: gpt.loss_fn(p, {"tokens": t}, cfg)))
    losses = []
    for step in range(STEPS):
        with telemetry.phase("data"):
            tokens = np.random.RandomState(SEED + 10 * step + rank).randint(
                0, 256, (B, S + 1))
        loss, grads = grad_fn(params, tokens)
        leaves, treedef = jax.tree.flatten(grads)
        flat = np.concatenate([np.asarray(g, np.float32).ravel()
                               for g in leaves])
        mean = collective.allreduce(flat, group_name=group, op="mean",
                                    compression="off")
        out, off = [], 0
        for g in leaves:
            out.append(jnp.asarray(mean[off:off + g.size].reshape(g.shape)))
            off += g.size
        params = jax.tree.map(lambda p, g: p - LR * g, params,
                              jax.tree.unflatten(treedef, out))
        losses.append(float(loss))
        train.report({"loss": float(loss)})
    if rank == 0:
        with open(config["losses"], "w") as f:
            json.dump(losses, f)


ray_tpu.init(num_cpus=3)
try:
    result = JaxTrainer(
        loop, train_loop_config={"params": sys.argv[1],
                                 "losses": sys.argv[2] + ".losses"},
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="local"),
        run_config=RunConfig(name="teloracle",
                             storage_path=os.path.dirname(sys.argv[2])),
    ).fit()
    assert result.error is None, result.error
    from ray_tpu._private.api import current_core
    from ray_tpu.telemetry import collect_snapshots

    snaps = collect_snapshots(current_core().control,
                              trial="teloracle_00000")
    steps = {s["rank"]: [[r["step"], sorted(r["phases"])]
                         for r in s["steps"]] for s in snaps}
    with open(sys.argv[2], "w") as f:
        json.dump({"steps": steps,
                   "losses": json.load(open(sys.argv[2] + ".losses")),
                   "tel_keys": sorted(result.metrics["telemetry"])}, f)
finally:
    ray_tpu.shutdown()
print("done")
"""


def _batch(rank, step):
    o = ORACLE
    return np.random.RandomState(o["seed"] + 10 * step + rank).randint(
        0, 256, (o["batch"], o["seq"] + 1))


def _port_state(np_params):
    """GPT nano on the CPU from the reference's flat numpy params."""
    from ray_tpu_torch.models import convert, gpt, training

    tree = {}
    for key, v in np_params.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    cfg = gpt.GPTConfig.nano(dtype=torch.float32)
    init_state, _ = training.make_train_step(cfg, device="cpu")
    return cfg, init_state(params=convert.from_jax_params(tree, cfg,
                                                          device="cpu"))


def _sgd_step(state, cfg, tokens, group):
    """One step of the oracle's loop: loss and grads, the flat grads'
    mean over the kv group, p - lr * g."""
    from ray_tpu_torch import collective
    from ray_tpu_torch.models import gpt, training

    leaves = [t for _, t in training.param_leaves(state["params"])]
    state["opt_state"].zero_grad(set_to_none=True)
    loss = gpt.loss_fn(state["params"], {"tokens": tokens}, cfg,
                       device="cpu")
    loss.backward()
    flat = torch.cat([t.grad.reshape(-1) for t in leaves])
    mean = collective.allreduce(flat, group, op="mean", compression="off")
    off = 0
    with torch.no_grad():
        for t in leaves:
            t.copy_(t - ORACLE["lr"] * mean[off:off + t.numel()].view_as(t))
            off += t.numel()
    return float(loss.detach())


def _loop_port(config):
    import numpy as np
    import torch

    from ray_tpu_torch import telemetry

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]
    cfg, state = _port_state(dict(np.load(config["params"])))
    losses = []
    for step in range(config["steps"]):
        with telemetry.phase("data"):
            tokens = _batch(rank, step)
        losses.append(_sgd_step(state, cfg, tokens, group))
        train.report({"loss": losses[-1]})
    if rank == 0:
        np.save(config["losses"], np.array(losses))


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_trainer_recorder_matches_the_reference_trainer(cluster, tmp_path):
    from ray_tpu_torch._private.api import current_core
    from ray_tpu_torch.telemetry import collect_snapshots

    init = tmp_path / "init.npz"
    np.savez(init, **_ref_init_params())
    env = _ref_env()
    for k in ("RAY_TPU_ADDRESS", "RAY_TPU_COLLECTIVE_COMPRESSION"):
        env.pop(k, None)
    o = ORACLE
    ref_out = tmp_path / "ref.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_TEL, str(init), str(ref_out),
         str(o["batch"]), str(o["seq"]), str(o["seed"]), str(o["steps"]),
         str(o["lr"])],
        cwd="/", env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        result = JaxTrainer(
            _loop_port, train_loop_config={
                "params": str(init), "steps": o["steps"],
                "losses": str(tmp_path / "port_losses.npy")},
            scaling_config=ScalingConfig(num_workers=2),
            backend_config=JaxConfig(mode="local"),
            run_config=RunConfig(name="teloracle",
                                 storage_path=str(tmp_path)),
        ).fit()
        assert result.error is None, result.error
        snaps = collect_snapshots(current_core().control,
                                  trial="teloracle_00000")
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(ref_out.read_text())
    port_steps = {str(s["rank"]): [[r["step"], sorted(r["phases"])]
                                   for r in s["steps"]] for s in snaps}
    assert port_steps == ref["steps"]
    assert sorted(port_steps) == ["0", "1"]
    assert all(names == ["collective", "compute", "data"]
               for steps in port_steps.values() for _, names in steps)
    np.testing.assert_allclose(np.load(tmp_path / "port_losses.npy"),
                               ref["losses"], atol=LOSS_ATOL, rtol=0)
    assert len(ref["losses"]) == o["steps"]
    assert sorted(result.metrics["telemetry"]) == ref["tel_keys"]
