"""The port's Train layer on its own runtime, on the CPU: the cases of
tests/test_train.py, test_train_torch.py and test_train_spmd_gang.py run
through ``ray_tpu_torch.train`` (one cluster of the port's runtime for
the module), plus what the port's backend adds, and the oracle:

  * the reference's ``JaxTrainer`` runs in a subprocess (JAX on the CPU,
    its attention kernels in Pallas's interpret mode, a local ``kv``
    group) at GPT nano with 2 workers: 3 SGD steps, each rank's grads
    averaged by a ``kv`` mean allreduce without compression.  The port's
    trainer runs the same loop on the same seeded batches, from the same
    weights (``models/convert.py``).  Losses and final params agree
    within tests/test_torch_train.py's LOSS_ATOL and PARAM_ATOL (1e-5);
  * the port's trainer equals the same steps run in this process,
    bitwise, with SGD and with AdamW(3e-4, weight_decay=0.1);
  * a two-worker "spmd" gang (a gloo group on CPU workers) takes a synced
    step that equals one process on the joined batch;
  * ``datasets=`` reaches each worker as its equal shard, on a node whose
    CPUs the gang holds too, and GPT nano trained on Data-fed batches
    (chip_smoke's data-train at nano size, on gloo CPU workers) is
    bitwise the same loop on the sliced array.

No int8 and no AdamW in the oracle: across the two packages the grads
differ by ulps, one ulp can flip an int8 code, and AdamW turns a flipped
code into a step of about the learning rate.  AdamW alone does the same
to an element whose ranks' grads cancel: at these batches layers.wv
[1, 37, 1, 1] gets +0.00119268 and -0.00119268 from the two ranks, a
mean of about 1e-9 that the ulps decide, and AdamW's update g / (|g| +
1e-8) then differs by 5% of a step (1.5e-5 after three).  AdamW itself
is held against optax on one rank (tests/test_torch_train.py) and here
port against port; the int8 path port against port (chip_smoke's
train-app phase, bitwise against dp-train).
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch._private.protocol import free_port
from ray_tpu_torch.train import (Checkpoint, CheckpointConfig,
                                 CheckpointManager, FailureConfig, JaxConfig,
                                 JaxTrainer, RunConfig, ScalingConfig)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-5     # tests/test_torch_train.py's
ORACLE = {"steps": 3, "batch": 2, "seq": 32, "seed": 70, "lr": 0.1}


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


# -- CheckpointManager (no cluster; test_train.py) ---------------------------


def _mk_ckpt(tmp_path, i):
    d = tmp_path / f"src_{i}"
    d.mkdir()
    (d / "w.txt").write_text(str(i))
    return Checkpoint(str(d))


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(
        num_to_keep=2, checkpoint_score_attribute="acc"))
    cks = [_mk_ckpt(tmp_path, i) for i in range(4)]
    for c, acc in zip(cks, [0.1, 0.9, 0.5, 0.2]):
        mgr.register_checkpoint(c, {"acc": acc})
    kept = [c for c, _ in mgr.best_checkpoints()]
    assert len(kept) == 2
    assert mgr.best_checkpoint == cks[1]          # acc=0.9
    assert mgr.latest_checkpoint == cks[3]        # newest survives retention
    assert not os.path.exists(cks[0].path)        # worst was deleted


def test_checkpoint_metadata(tmp_path):
    c = _mk_ckpt(tmp_path, 0)
    c.set_metadata({"step": 3})
    c.update_metadata({"loss": 1.5})
    assert c.get_metadata() == {"step": 3, "loss": 1.5}
    c.to_directory(str(tmp_path / "out"))
    assert (tmp_path / "out" / "w.txt").read_text() == "0"


def test_scaling_config_asks_for_gpus():
    assert ScalingConfig(num_workers=2).bundle() == {"CPU": 1.0}
    assert ScalingConfig(use_gpu=True).bundle() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(use_gpu=True, gpus_per_worker=0.5,
                         num_workers=2).as_placement_group_bundles() == [
        {"CPU": 1.0, "GPU": 0.5}] * 2


# -- what is not ported yet raises, naming its item; telemetry is on ---------


@pytest.mark.parametrize("kw,item", [
    ({"mesh_shape": {"dp": -1}}, None),
    ({"pipeline": "stages=2"}, None),
    ({"telemetry": True}, None),
    ({"telemetry": {"ring_size": 8}}, None),
])
def test_unported_backend_options_raise(kw, item):
    """A pipeline spec is taken, checked on the driver and published in
    its full form; a mesh shape is taken (the trainer installs the mesh,
    tests/test_torch_mesh_parity.py); every ``telemetry=`` value the
    reference takes is accepted, and None (unset) means on, as in the
    reference."""
    from ray_tpu_torch.telemetry import resolve_telemetry
    from ray_tpu_torch.train import backend

    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            JaxConfig(mode="local", **kw)
    elif "mesh_shape" in kw:
        assert JaxConfig(mode="local", **kw).mesh_shape == kw["mesh_shape"]
    elif "pipeline" in kw:
        cfg = JaxConfig(mode="local", **kw)
        assert cfg.pipeline == kw["pipeline"]
        assert backend._pipeline_spec(cfg.pipeline) == (
            "stages=2,schedule=1f1b,microbatches=2,transport=threads")
        with pytest.raises(ValueError, match="unknown schedule"):
            JaxConfig(mode="local", pipeline="stages=2,schedule=gpipe")
    else:
        cfg = JaxConfig(mode="local", **kw)
        tc = resolve_telemetry(cfg.telemetry)
        assert tc.enabled
        assert tc.ring_size == kw["telemetry"].get("ring_size", 512) \
            if isinstance(kw["telemetry"], dict) else tc.ring_size == 512
    assert resolve_telemetry(JaxConfig(telemetry=False).telemetry).enabled \
        is False
    assert JaxConfig().telemetry is None
    assert resolve_telemetry(JaxConfig().telemetry).enabled


# -- end-to-end runs (test_train.py) -----------------------------------------


def _loop_basic(config):
    ctx = train.get_context()
    for step in range(config["steps"]):
        train.report({"step": step, "rank": ctx.get_world_rank(),
                      "world_size": ctx.get_world_size()})


def test_trainer_two_workers(cluster, tmp_path):
    result = JaxTrainer(
        _loop_basic, train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t2w", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["world_size"] == 2
    assert os.path.isdir(result.path)


def _loop_pipeline(config):
    """Each worker builds its PipelineConfig from the env the backend
    published, and its stage of GPT nano from it (rank = stage)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import PipelineConfig

    pcfg = PipelineConfig.from_env()
    rank = train.get_context().get_world_rank()
    cfg = gpt.GPTConfig.nano(dtype=torch.float32)
    stage = gpt.partition_stage_params(gpt.init(cfg, seed=0, device="cpu"),
                                       cfg, pcfg.stages)[rank]
    train.report({"spec": os.environ["RAY_TPU_TORCH_TRAIN_PIPELINE"],
                  "stages": pcfg.stages, "schedule": pcfg.schedule,
                  "microbatches": pcfg.num_microbatches,
                  "stage_layers": stage["layers"]["wq"].shape[0],
                  "stage_keys": sorted(stage)})


def test_trainer_publishes_the_pipeline_spec(cluster, tmp_path):
    from ray_tpu_torch.parallel import PipelineConfig

    pcfg = PipelineConfig(stages=2, schedule="zb", microbatches=4)
    result = JaxTrainer(
        _loop_pipeline,
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="local", pipeline=pcfg),
        run_config=RunConfig(name="pipe", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["spec"] == pcfg.to_spec()
    assert (m["stages"], m["schedule"], m["microbatches"]) == (2, "zb", 4)
    # rank 0 holds stage 0: half the layers, the table and the positions
    assert m["stage_layers"] == 2
    assert m["stage_keys"] == ["embed", "layers", "pos_embed"]
    # a bad spec string raises on the driver, before any worker starts
    with pytest.raises(ValueError, match="bad pipeline spec item"):
        JaxConfig(mode="local", pipeline="stages")


def _read_step(restored, rank):
    with restored.as_directory() as d:
        sub = os.path.join(d, f"rank_{rank}")
        src = sub if os.path.isdir(sub) else d
        return int(open(os.path.join(src, "step.txt")).read())


def _loop_ckpt(config):
    ctx = train.get_context()
    restored = train.get_checkpoint()
    start = _read_step(restored, ctx.get_world_rank()) + 1 if restored else 0
    for step in range(start, config["steps"]):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "step.txt"), "w") as f:
                f.write(str(step))
            train.report({"step": step}, checkpoint=Checkpoint(d))


def test_trainer_checkpoints_and_resume(cluster, tmp_path):
    result = JaxTrainer(
        _loop_ckpt, train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ck", storage_path=str(tmp_path),
                             checkpoint_config=CheckpointConfig(num_to_keep=2)),
    ).fit()
    assert result.checkpoint is not None
    # multi-worker checkpoints land as rank_k subdirs of one checkpoint dir
    with result.checkpoint.as_directory() as d:
        assert open(os.path.join(d, "rank_0", "step.txt")).read() == "2"
        assert open(os.path.join(d, "rank_1", "step.txt")).read() == "2"
    # resume from it: the loop starts at step 3 -> reports only 3, 4
    r2 = JaxTrainer(
        _loop_ckpt, train_loop_config={"steps": 5},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ck2", storage_path=str(tmp_path)),
        resume_from_checkpoint=result.checkpoint,
    ).fit()
    assert r2.metrics["step"] == 4


def _loop_crash_once(config):
    ctx = train.get_context()
    restored = train.get_checkpoint()
    start = _read_step(restored, ctx.get_world_rank()) + 1 if restored else 0
    for step in range(start, config["steps"]):
        if (step == 1 and ctx.get_world_rank() == 0
                and not os.path.exists(config["flag"])):
            open(config["flag"], "w").close()
            os._exit(1)  # hard-kill this worker: simulates host failure
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "step.txt"), "w") as f:
                f.write(str(step))
            train.report({"step": step, "pid": os.getpid()},
                         checkpoint=Checkpoint(d))


def test_trainer_elastic_restart(cluster, tmp_path):
    flag = str(tmp_path / "crashed")
    seen = []
    result = JaxTrainer(
        _loop_crash_once,
        train_loop_config={"steps": 3, "flag": flag},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="el", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2),
                             callbacks=[_Recorder(seen)]),
    ).fit()
    assert result.error is None
    assert os.path.exists(flag)
    assert result.metrics["step"] == 2
    # step 0 from the first gang, then 1 and 2 from a new one, resumed
    # from step 0's checkpoint
    assert [m["step"] for m in seen] == [0, 1, 2]
    assert seen[0]["pid"] != seen[1]["pid"] == seen[2]["pid"]


class _Recorder:
    """RunConfig callback keeping every rank-0 result."""

    def __init__(self, out):
        self.out = out

    def on_trial_result(self, trial, metrics):
        self.out.append(dict(metrics))

    def on_trial_complete(self, trial):
        pass

    def on_trial_error(self, trial):
        pass


def _loop_user_error(config):
    train.report({"step": 0})
    raise ValueError("boom")


def test_trainer_user_error_not_retried(cluster, tmp_path):
    trainer = JaxTrainer(
        _loop_user_error,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="err", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=3)),
    )
    with pytest.raises(train.TrainingFailedError, match="boom"):
        trainer.fit()


def _loop_collective(config):
    import torch

    from ray_tpu_torch import collective

    ctx = train.get_context()
    # the reference's default backend is "kv"; the port's is "nccl"
    collective.init_collective_group(ctx.get_world_size(),
                                     ctx.get_world_rank(), backend="kv",
                                     group_name="test-train-cg")
    out = collective.allreduce(
        torch.tensor([float(ctx.get_world_rank() + 1)]),
        group_name="test-train-cg")
    collective.destroy_collective_group("test-train-cg")
    train.report({"sum": float(out[0]),
                   "group": os.environ.get(
                       "RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP")})


def test_workers_can_allreduce(cluster, tmp_path):
    result = JaxTrainer(
        _loop_collective,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="coll", storage_path=str(tmp_path)),
    ).fit()
    assert result.metrics["sum"] == 3.0
    # auto mode on CPU workers: the backend's own group is a kv group
    assert result.metrics["group"].startswith("train-")


# -- TorchTrainer (test_train_torch.py) --------------------------------------


def test_torch_trainer_ddp_two_workers(cluster):
    """2-worker gloo group: allreduce works and DDP averages gradients."""
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train.session import report
        from ray_tpu_torch.train.torch import (get_device, get_world_rank,
                                               get_world_size, prepare_model)

        rank = get_world_rank()
        assert get_world_size() == 2
        assert dist.is_initialized()
        assert get_device() == torch.device("cpu")
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        model = prepare_model(torch.nn.Linear(4, 1, bias=False))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        x = torch.full((8, 4), float(rank + 1))
        loss = model(x).square().mean()
        loss.backward()
        g0 = [p.grad.clone() for p in model.parameters()]
        opt.step()
        report({"allreduce": float(t.item()), "rank": rank,
                "ddp": type(model).__name__,
                "grad_sum": float(sum(g.abs().sum() for g in g0))})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.metrics["allreduce"] == 3.0  # (0+1) + (1+1)
    assert result.metrics["ddp"] == "DistributedDataParallel"
    assert result.metrics["grad_sum"] > 0


def test_torch_trainer_single_worker_no_group(cluster):
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train.session import report
        from ray_tpu_torch.train.torch import prepare_model

        assert not dist.is_initialized()
        model = prepare_model(torch.nn.Linear(2, 1))
        assert isinstance(model, torch.nn.Linear)  # no DDP wrap
        report({"ok": 1})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1)).fit()
    assert result.metrics["ok"] == 1


def test_prepare_data_loader_shards(cluster):
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        import torch
        from torch.utils.data import DataLoader, TensorDataset

        from ray_tpu_torch.train.session import report
        from ray_tpu_torch.train.torch import prepare_data_loader

        ds = TensorDataset(torch.arange(20, dtype=torch.float32))
        loader = prepare_data_loader(DataLoader(ds, batch_size=5))
        report({"seen": sum(len(b[0]) for b in loader)})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2)).fit()
    # DistributedSampler gives each of 2 ranks half the 20 samples
    assert result.metrics["seen"] == 10


def _loop_nccl_without_card(config):
    train.report({"ok": 1})


def test_nccl_on_cpu_workers_raises_and_stays_nccl(cluster, tmp_path):
    """A backend "nccl" request on workers without a card raises; it does
    not turn into gloo."""
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    trainer = TorchTrainer(
        _loop_nccl_without_card, torch_config=TorchConfig(backend="nccl"),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="nccl", storage_path=str(tmp_path)))
    with pytest.raises(Exception, match="CUDA device"):
        trainer.fit()


# -- the spmd gang (test_train_spmd_gang.py) ---------------------------------


class _PlacedWorker:
    def __init__(self, node_ip):
        self.metadata = {"node_ip": node_ip, "has_gpu": True}


def test_spmd_nccl_group_binds_the_card_get_device_gives(monkeypatch):
    """A SPREAD gang over two nodes of two cards each lands its world ranks
    on nodes A, B, A, B.  Each rank's NCCL group binds the card that
    get_device() gives its loop (cuda:<local rank>), not cuda:<world rank
    modulo the cards>; the card calls are stubbed, the rank arithmetic is
    the backend's."""
    from types import SimpleNamespace

    import torch.distributed as dist

    from ray_tpu_torch.collective import collective as coll
    from ray_tpu_torch.collective import peer_memory
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.backend import _setup_spmd_group, local_ranks
    from ray_tpu_torch.train.backend_executor import BackendExecutor
    from ray_tpu_torch.train.torch import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(peer_memory.PeerBuffers, "for_group",
                        staticmethod(lambda pg, device: None))
    monkeypatch.setattr(coll, "_groups", {})
    monkeypatch.setenv("RAY_TPU_TORCH_WORKER_GPU", "1")

    workers = [_PlacedWorker(ip) for ip in
               ("10.0.0.1", "10.0.0.2", "10.0.0.1", "10.0.0.2")]
    executor = object.__new__(BackendExecutor)
    executor.worker_group = SimpleNamespace(workers=workers, num_workers=4)
    executor._elastic = None
    ctxs = executor._contexts("e", "t", str(Path(tempfile.gettempdir())))
    local = local_ranks(workers)
    assert local == [0, 0, 1, 1]
    assert [c.local_rank for c in ctxs] == local
    assert [c.local_world_size for c in ctxs] == [2, 2, 2, 2]
    assert [c.node_rank for c in ctxs] == [0, 1, 0, 1]

    for i, ctx in enumerate(ctxs):
        info = _setup_spmd_group(f"g{i}", 4, i, "nccl", "tcp://x:1", "",
                                 local[i])
        monkeypatch.setattr(session, "_get_session",
                            lambda ctx=ctx: SimpleNamespace(ctx=ctx))
        assert info["device"] == str(get_device()) == f"cuda:{local[i]}", i


def _loop_spmd(config):
    import torch.distributed as dist

    from ray_tpu_torch.collective import get_group_handle

    g = get_group_handle(os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"])
    train.report({"procs": dist.get_world_size(), "rank": dist.get_rank(),
                  "backend": g.backend, "device": str(g.device)})


def test_two_process_spmd_gang(cluster, tmp_path):
    result = JaxTrainer(
        _loop_spmd,
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="spmd", coordinator_port=free_port()),
        run_config=RunConfig(name="spmd-gang", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    # the flight recorder (on by default) attaches rank 0's step record
    tel = result.metrics.pop("telemetry")
    assert tel["rank"] == 0 and tel["step"] == 0
    # the reporting worker joined a 2-process gloo group (no cards here)
    assert result.metrics == {"procs": 2, "rank": 0, "backend": "gloo",
                              "device": "cpu"}


_SPMD_TOKENS = np.random.RandomState(0).randint(0, 256, (8, 33))


def _loop_spmd_train_step(config):
    """Two SGD steps of GPT nano over the gang: each rank takes its half
    of the batch, the grads and the loss are averaged over the gang's
    group (``GradientSynchronizer`` finds it by the published name)."""
    import torch

    from ray_tpu_torch import collective
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel import GradientSynchronizer

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank, n = ctx.get_world_rank(), ctx.get_world_size()
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]
    cfg = gpt.GPTConfig.nano(dtype=torch.float32)
    params = gpt.init(cfg, seed=0, device="cpu")
    leaves = [t.requires_grad_() for _, t in training.param_leaves(params)]
    tokens = config["tokens"]
    per = tokens.shape[0] // n
    batch = {"tokens": tokens[rank * per:(rank + 1) * per]}
    sync = GradientSynchronizer(group)
    losses = []
    for _ in range(2):
        loss = gpt.loss_fn(params, batch, cfg, device="cpu")
        loss.backward()
        synced = sync([t.grad for t in leaves])
        losses.append(float(collective.allreduce(
            loss.detach().reshape(1), group, op="mean")[0]))
        with torch.no_grad():
            for t, g in zip(leaves, synced):
                t.sub_(0.1 * g)
                t.grad = None
    train.report({"loss0": losses[0], "loss1": losses[1], "procs": n})


def test_two_process_spmd_train_step_matches_single(cluster, tmp_path):
    """The gang's synced step over a gloo group equals the same two SGD
    steps in one process on the joined batch (the reference's
    tolerance: the sums run in another order)."""
    from ray_tpu_torch.models import gpt, training

    result = JaxTrainer(
        _loop_spmd_train_step, train_loop_config={"tokens": _SPMD_TOKENS},
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="spmd", coordinator_port=free_port()),
        run_config=RunConfig(name="spmd-step", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["procs"] == 2

    cfg = gpt.GPTConfig.nano(dtype=torch.float32)
    params = gpt.init(cfg, seed=0, device="cpu")
    leaves = [t.requires_grad_() for _, t in training.param_leaves(params)]
    want = []
    for _ in range(2):
        loss = gpt.loss_fn(params, {"tokens": _SPMD_TOKENS}, cfg,
                           device="cpu")
        loss.backward()
        want.append(float(loss.detach()))
        with torch.no_grad():
            for t in leaves:
                t.sub_(0.1 * t.grad)
                t.grad = None
    assert abs(result.metrics["loss0"] - want[0]) < 1e-4, (result.metrics,
                                                           want)
    assert abs(result.metrics["loss1"] - want[1]) < 1e-4, (result.metrics,
                                                           want)


# -- datasets= (test_train.py) -----------------------------------------------


def _loop_data(config):
    shard = train.get_dataset_shard("train")
    total = rows = 0
    for batch in shard.iter_batches(batch_size=8, batch_format="numpy"):
        total += int(batch["id"].sum())
        rows += len(batch["id"])
    train.report({"rows": rows, "sum": total})


def test_trainer_dataset_streaming_shards(cluster, tmp_path):
    """datasets= flows through streaming_split into per-worker
    DataIterators (reference: get_dataset_shard -> DataIterator)."""
    from ray_tpu_torch import data as rd

    trainer = JaxTrainer(
        _loop_data,
        datasets={"train": rd.range(64, override_num_blocks=4)},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="tds", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    # equal=True: each worker saw exactly half the rows; rank 0 the first
    assert result.metrics["rows"] == 32
    assert result.metrics["sum"] == sum(range(32))


def test_data_fed_gpt_fit_is_bitwise_the_array_fed_fit(cluster, tmp_path):
    """The CPU rehearsal of chip_smoke's data-train phase, through its own
    functions: GPT nano on 2 gloo CPU workers ("spmd", int8 sync), 6
    steps on batches that Data wrote to parquet, read back, split over the
    gang (streaming_split(2, equal=True)) and staged by iter_jax_batches,
    against the same loop on the same rows sliced from the seeded array
    in the worker.  Every batch equals its slice, the losses and final
    params are bitwise the array-fed fit's."""
    import chip_smoke

    fits = chip_smoke.data_train_fits(
        str(tmp_path), 2, use_gpu=False,
        loop={"preset": "nano", "batch": (2, 32)})
    losses = chip_smoke.check_data_train(fits, 2, on_card=False)
    assert len(losses["dataset"]) == chip_smoke.TRAIN_APP_STEPS
    assert all(np.isfinite(losses["dataset"]))
    for r in fits["dataset"][3]:
        assert r["device"] == "cpu"
        assert r["staging"]["bytes"] == chip_smoke.TRAIN_APP_STEPS * 2 * 33 * 8


def _loop_data_gang(config):
    """Each rank stages its shard with iter_jax_batches; the sums meet in
    the gang's gloo group."""
    from ray_tpu_torch import collective
    from ray_tpu_torch.train.torch import get_device

    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]
    shard = train.get_dataset_shard("train")
    total = torch.zeros(1, dtype=torch.int64)
    rows = 0
    for batch in shard.iter_jax_batches(batch_size=8,
                                        device=get_device()):
        total += batch["id"].sum()
        rows += batch["id"].shape[0]
    train.report({"rows": rows,
                  "total": int(collective.allreduce(total, group)[0])})


@pytest.fixture
def reserved_node(cluster):
    """A node of 2 CPUs in place of the module's cluster (which comes back
    after the test)."""
    rt.shutdown()
    rt.init(num_cpus=2)
    yield
    rt.shutdown()
    rt.init(num_cpus=4)


def test_dataset_shards_on_a_fully_reserved_node(reserved_node, tmp_path):
    """A gang of 2 gloo workers holds both CPUs of the node, and Data's
    split coordinator and read tasks still run beside it: the workers'
    blocking gets lend their CPUs (the reference's note at
    ray_tpu/data/iterator.py:111-114)."""
    from ray_tpu_torch import data as rd

    ds = rd.range(64, override_num_blocks=4).map_batches(
        lambda b: {"id": b["id"] * 2})
    result = JaxTrainer(
        _loop_data_gang, datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="spmd", coordinator_port=free_port()),
        run_config=RunConfig(name="reserved", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    # the flight recorder (on by default) attaches rank 0's step record
    assert result.metrics.pop("telemetry")["rank"] == 0
    assert result.metrics == {"rows": 32, "total": sum(range(0, 128, 2))}


# -- the oracle: the reference's JaxTrainer on the same loop -----------------


def _batch(rank, step):
    o = ORACLE
    return np.random.RandomState(o["seed"] + 10 * step + rank).randint(
        0, 256, (o["batch"], o["seq"] + 1))


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _port_state(np_params):
    from ray_tpu_torch.models import convert, gpt, training

    cfg = gpt.GPTConfig.nano(dtype=torch.float32)
    init_state, _ = training.make_train_step(cfg, device="cpu")
    return cfg, init_state(params=convert.from_jax_params(
        _unflatten(np_params), cfg, device="cpu"))


def _port_grads(state, cfg, tokens):
    from ray_tpu_torch.models import gpt, training

    leaves = [t for _, t in training.param_leaves(state["params"])]
    state["opt_state"].zero_grad(set_to_none=True)
    loss = gpt.loss_fn(state["params"], {"tokens": tokens}, cfg,
                       device="cpu")
    loss.backward()
    return float(loss.detach()), torch.cat([t.grad.reshape(-1)
                                            for t in leaves])


def _port_apply(state, mean, opt):
    """SGD (p - lr * g, the reference loop's form) or the state's AdamW
    on the averaged flat grads."""
    from ray_tpu_torch.models import training

    off = 0
    for _, t in training.param_leaves(state["params"]):
        g = mean[off:off + t.numel()].view_as(t)
        off += t.numel()
        if opt == "sgd":
            with torch.no_grad():
                t.copy_(t - ORACLE["lr"] * g)
        else:
            t.grad = g.clone()
    if opt == "adamw":
        state["opt_state"].step()


def _loop_oracle_port(config):
    """The oracle's loop on the port: SGD or AdamW(3e-4, wd 0.1) on GPT
    nano, each rank's flattened grads averaged over the backend's kv
    group."""
    import numpy as np
    import torch

    from ray_tpu_torch import collective
    from ray_tpu_torch.models import training

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank = ctx.get_world_rank()
    group = os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"]
    cfg, state = _port_state(dict(np.load(config["params"])))
    losses = []
    for step in range(config["steps"]):
        loss, flat = _port_grads(state, cfg, _batch(rank, step))
        _port_apply(state, collective.allreduce(flat, group, op="mean",
                                                compression="off"),
                    config["opt"])
        losses.append(loss)
        train.report({"loss": loss})
    if rank == 0:
        np.savez(config["out"], losses=np.array(losses),
                 **{k: t.detach().numpy() for k, t in
                    training.param_leaves(state["params"])})


_REF_TRAIN = r"""
import os, sys
import numpy as np
import ray_tpu
from ray_tpu import train
from ray_tpu.train import JaxConfig, JaxTrainer, RunConfig, ScalingConfig

B, S, SEED, STEPS = (int(a) for a in sys.argv[3:7])
LR = float(sys.argv[7])
CLUSTER_START_FAILED = int(sys.argv[8])


def loop(config):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ray_tpu import collective, train
    from ray_tpu.models import gpt

    rank = train.get_context().get_world_rank()
    group = os.environ["RAY_TPU_TRAIN_COLLECTIVE_GROUP"]
    # the Pallas kernels K1-K3 in interpret mode, as the reference's own
    # CPU tests run them (tests/test_torch_train.py does the same)
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
        flat_params = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat_params[f"{prefix}{k}"] = np.asarray(v)
        walk(params, "")
        np.savez(config["out"], losses=np.array(losses), **flat_params)


try:
    ray_tpu.init(num_cpus=3)
except Exception as e:
    # stop what the failed start left running
    import traceback

    from ray_tpu._private import bootstrap

    tb = e.__traceback__
    while tb is not None:
        for v in list(tb.tb_frame.f_locals.values()):
            if isinstance(v, bootstrap.Cluster):
                v.shutdown()
        tb = tb.tb_next
    # the reference's raylet did not register within its cluster's fixed
    # 30 s wait: say so by the exit code, apart from any other failure of
    # the start or of the run, which is raised
    if not (isinstance(e, RuntimeError)
            and "never appeared in control get_nodes" in str(e)):
        raise
    traceback.print_exc()
    sys.exit(CLUSTER_START_FAILED)
try:
    result = JaxTrainer(
        loop, train_loop_config={"params": sys.argv[1], "out": sys.argv[2]},
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=JaxConfig(mode="local"),
        run_config=RunConfig(name="oracle",
                             storage_path=os.path.dirname(sys.argv[2])),
    ).fit()
    assert result.error is None, result.error
finally:
    ray_tpu.shutdown()
print("done")
"""


def _ref_env():
    """The reference's subprocesses (and its cluster's workers, which
    inherit it) run JAX on the CPU with one compute thread each, so they
    do not crowd the other test files' timing-sensitive runs."""
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1",
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1")


# the oracle's exit code when the reference's raylet missed its
# registration wait (no training ran); the fixture then starts the oracle
# again, at most
# ORACLE_CLUSTER_ATTEMPTS times in all
ORACLE_CLUSTER_START_FAILED = 75
ORACLE_CLUSTER_ATTEMPTS = 3


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's JaxTrainer in a subprocess (started first, so it
    runs while the port's trainer does), the params it started from, and
    a join() for its result.

    Under load the reference's raylet can miss its cluster's fixed 30 s
    registration wait (``ray_tpu/_private/bootstrap.py``), before any
    training: the oracle then exits with ``ORACLE_CLUSTER_START_FAILED``
    and join() starts it again, by then alone beside the finished port
    run.  Any other failure, of the cluster's start, of the run or of its
    result, fails at once;
    every attempt's exit code and stderr are in the assertion message."""
    d = tmp_path_factory.mktemp("oracle")
    init = d / "init.npz"
    flat = _ref_init_params()
    np.savez(init, **flat)
    env = _ref_env()
    for k in ("RAY_TPU_ADDRESS", "RAY_TPU_COLLECTIVE_COMPRESSION"):
        env.pop(k, None)
    o = ORACLE

    def start():
        return subprocess.Popen(
            [sys.executable, "-c", _REF_TRAIN, str(init),
             str(d / "ref.npz"), str(o["batch"]), str(o["seq"]),
             str(o["seed"]), str(o["steps"]), str(o["lr"]),
             str(ORACLE_CLUSTER_START_FAILED)],
            cwd="/", env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    procs = [start()]
    attempts = []

    def join():
        while True:
            proc = procs[-1]
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            attempts.append((proc.returncode, err[-3000:]))
            if proc.returncode != ORACLE_CLUSTER_START_FAILED \
                    or len(attempts) >= ORACLE_CLUSTER_ATTEMPTS:
                break
            procs.append(start())
        report = "\n".join(
            f"-- oracle attempt {i + 1}: rc={rc}\n{err}"
            for i, (rc, err) in enumerate(attempts))
        assert procs[-1].returncode == 0, report
        return dict(np.load(d / "ref.npz"))

    yield {"init": init, "dir": d, "join": join, "flat": flat,
           "attempts": attempts}
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _ref_init_params():
    """GPT nano's params from the reference's init, seed 0, as numpy
    leaves under dotted keys, computed in a subprocess so that this
    process runs no JAX program."""
    code = (
        "import sys, numpy as np, jax, jax.numpy as jnp\n"
        "from ray_tpu.models import gpt\n"
        "p = gpt.init(jax.random.PRNGKey(0), "
        "gpt.GPTConfig.nano(dtype=jnp.float32))\n"
        "flat = {}\n"
        "def walk(n, pre):\n"
        "    for k, v in n.items():\n"
        "        if isinstance(v, dict): walk(v, f'{pre}{k}.')\n"
        "        else: flat[f'{pre}{k}'] = np.asarray(v, np.float32)\n"
        "walk(p, '')\n"
        "np.savez(sys.argv[1], **flat)\n")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.npz")
        subprocess.run([sys.executable, "-c", code, path], cwd="/",
                       env=_ref_env(), check=True, timeout=120)
        return dict(np.load(path))


@pytest.fixture(scope="module")
def port_runs(cluster, oracle):
    """The port's trainer on the oracle's loop, by optimizer (each run
    once per module)."""
    runs = {}

    def run(opt):
        if opt not in runs:
            out = oracle["dir"] / f"port-{opt}.npz"
            result = JaxTrainer(
                _loop_oracle_port,
                train_loop_config={"params": str(oracle["init"]),
                                   "out": str(out), "opt": opt,
                                   "steps": ORACLE["steps"]},
                scaling_config=ScalingConfig(num_workers=2),
                backend_config=JaxConfig(mode="local"),
                run_config=RunConfig(name=f"oracle-port-{opt}",
                                     storage_path=str(oracle["dir"])),
            ).fit()
            assert result.error is None, result.error
            runs[opt] = dict(np.load(out))
        return runs[opt]

    return run


def test_trainer_matches_the_reference_trainer(oracle, port_runs):
    got = port_runs("sgd")
    ref = oracle["join"]()
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               atol=LOSS_ATOL, rtol=0)
    keys = set(ref) - {"losses"}
    assert keys == set(got) - {"losses"}
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], ref[k], atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
        # and every leaf moved
        assert np.abs(ref[k] - oracle["flat"][k]).max() > 1e-4, k


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_trainer_equals_the_same_steps_in_process(oracle, port_runs, opt):
    """The trainer adds nothing to the bits: the same steps run here,
    each rank's grads averaged the way the kv group averages them (the
    backend's reduce over the numpy views, in rank order)."""
    from ray_tpu_torch.collective.collective import _kv_reduce
    from ray_tpu_torch.models import training

    got = port_runs(opt)
    cfg, state = _port_state(oracle["flat"])
    losses = []
    for step in range(ORACLE["steps"]):
        grads = [_port_grads(state, cfg, _batch(rank, step))
                 for rank in range(2)]
        losses.append(grads[0][0])
        mean = _kv_reduce("mean", [g.numpy() for _, g in grads], 2)
        _port_apply(state, torch.from_numpy(mean), opt)
    np.testing.assert_array_equal(got["losses"], np.array(losses))
    for k, t in training.param_leaves(state["params"]):
        np.testing.assert_array_equal(got[k], t.detach().numpy(),
                                      err_msg=k)
