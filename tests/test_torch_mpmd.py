"""MPMD pipeline parallelism on the port (parallel/mpmd.py): per-stage
programs on separate gangs, activations and gradients over the DAG's
shared-memory channels.

The mirror of tests/test_mpmd.py, case by case (its two slow cases
included), on the port with device="cpu": partitioning the model across
gangs is a layout choice, not a math choice, so the same batch gives the
same loss and gradients as the unpipelined ``loss_fn`` and its autograd
gradients (the reference's tolerances).  The weights are the JAX
package's ``gpt.init`` carried over by ``models/convert.py``, so the
JAX parity cases run both packages on the same weights and batch:

  * each stage's ``stage_hidden`` / ``stage_loss`` against the JAX
    package's (f32, 1e-5), stage after stage on the JAX package's
    hidden;
  * ``MPMDPipeline.forward_backward`` against the JAX package's
    ``MPMDPipeline.forward_backward`` for every schedule at 2 and 4
    stages;
  * the schedules' op streams, ``replay_bubble`` and the chrome trace
    against the JAX package's on the same inputs;
  * the MPMD loss against the JAX package's SPMD pp-mesh loss.

The optimizer is the port's (``models.training.adamw``) in place of
optax's; its multistep case holds the pipeline to the port's unpipelined
train step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.elastic import emergency
from ray_tpu_torch.models import convert, gpt, training
from ray_tpu_torch.parallel.mpmd import (SCHEDULES, FillDrain, MPMDPipeline,
                                         OneFOneB, PipelineConfig,
                                         PipelineSchedule, ZeroBubble,
                                         get_schedule, mean_op_events,
                                         replay_bubble,
                                         schedule_chrome_trace)
from ray_tpu_torch.parallel.pipeline import (merge_microbatches,
                                             split_microbatches)

torch.set_num_threads(1)

# tiny-but-real: 4 layers so stages in {2, 4} both divide; f32 and no
# remat, as the reference's MICRO
MICRO = gpt.GPTConfig(vocab_size=64, n_layers=4, d_model=16, n_heads=2,
                      d_head=8, d_ff=32, max_seq=32, dtype=torch.float32,
                      param_dtype=torch.float32, remat=False)
TOKS = np.random.RandomState(7).randint(0, 64, (8, 17))
BATCH = {"inputs": TOKS[:, :-1], "targets": TOKS[:, 1:]}
NANO = gpt.GPTConfig.nano(pos="rope", norm="rms", act="swiglu",
                          dtype=torch.float32)
NANO_TOKS = np.random.RandomState(0).randint(0, 256, (8, 33))
STAGE_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _fresh_device_ledger():
    """The JAX package's stage programs below go through its process-wide
    compilation ledger; leave later modules in this process a fresh one
    (tests/test_torch_collective.py's rule)."""
    yield
    from ray_tpu.telemetry import device as devtel

    devtel.reset_for_tests()


@pytest.fixture(autouse=True)
def _device_channel(monkeypatch):
    # the raw-buffer tensor path for CPU tensors too, so the pipeline's
    # edges exercise the no-pickle transport
    monkeypatch.setenv("RAY_TPU_TORCH_DAG_DEVICE_CHANNEL", "1")


def _jcfg(cfg):
    """The JAX package's GPTConfig of a port config."""
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    fields = {f.name for f in dataclasses.fields(jgpt.GPTConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg).items()
          if k in fields and k not in ("dtype", "param_dtype")}
    return jgpt.GPTConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)


def _jax_params(cfg=MICRO):
    import jax

    from ray_tpu.models import gpt as jgpt

    return jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0),
                                              _jcfg(cfg)))


def _params(cfg=MICRO):
    return convert.from_jax_params(_jax_params(cfg), cfg, device="cpu")


def _mpmd(cfg, pcfg, params, **kw):
    return MPMDPipeline(cfg, pcfg, params=params, device="cpu", **kw)


def _ref_loss_grads(params, cfg=MICRO, batch=BATCH):
    leaves = training._as_leaves(params, cfg, torch.device("cpu"))
    loss = gpt.loss_fn(leaves, batch, cfg, device="cpu")
    loss.backward()
    return float(loss.detach()), {k: t.grad for k, t in
                         training.param_leaves(leaves)}


def _flat(tree):
    return {k: np.asarray(v.detach().numpy() if torch.is_tensor(v) else v)
            for k, v in training.param_leaves(tree)}


def _assert_tree_close(ref, got, rtol=1e-4, atol=1e-5):
    ref = ref if all(not isinstance(v, dict) for v in ref.values()) \
        else _flat(ref)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = _flat(got)
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {k}")


# ---------------------------------------------------------------------------
# Schedule library (pure python)


def test_fill_drain_ops():
    ops = FillDrain().ops(stage=1, stages=4, microbatches=3)
    assert ops == [("F", 0), ("F", 1), ("F", 2),
                   ("B", 2), ("B", 1), ("B", 0)]  # LIFO backwards


def test_1f1b_warmup_depth():
    for s in range(4):
        ops = OneFOneB().ops(stage=s, stages=4, microbatches=8)
        fs = [mb for k, mb in ops if k == "F"]
        bs = [mb for k, mb in ops if k == "B"]
        assert fs == list(range(8)) and bs == list(range(8))
        # warmup = pipeline depth remaining below this stage
        warm = min(8, 4 - 1 - s)
        assert [k for k, _ in ops[:warm]] == ["F"] * warm
        if warm < 8:
            assert ops[warm:warm + 2] == [("F", warm), ("B", 0)]


def test_zb_splits_backward():
    ops = ZeroBubble().ops(stage=0, stages=2, microbatches=4)
    kinds = [k for k, _ in ops]
    assert kinds.count("F") == 4 and kinds.count("Bx") == 4
    assert kinds.count("W") == 4 and "B" not in kinds
    assert get_schedule("zb").split_backward


def test_cross_stage_send_recv_order_consistent():
    """Stage s's send order equals stage s+1's recv order (F mbs), and
    s+1's grad sends equal s's grad recvs; every op stream is the JAX
    package's."""
    from ray_tpu.parallel import mpmd as jmpmd

    for name in SCHEDULES:
        sched = get_schedule(name)
        for n, M in ((2, 2), (4, 8), (3, 5)):
            streams = [sched.ops(s, n, M) for s in range(n)]
            assert streams == [jmpmd.get_schedule(name).ops(s, n, M)
                               for s in range(n)]
            f = [[mb for k, mb in ops if k == "F"] for ops in streams]
            b = [[mb for k, mb in ops if k in ("B", "Bx")]
                 for ops in streams]
            for s in range(n - 1):
                assert f[s] == f[s + 1], (name, n, M, s)
                assert b[s] == b[s + 1], (name, n, M, s)


def test_theoretical_fill_drain_bubble():
    th = PipelineSchedule.theoretical_fill_drain_bubble
    assert th(1, 8) == 0.0
    assert th(4, 4) == pytest.approx(3 / 7)
    assert th(2, 8) == pytest.approx(1 / 9)


def test_get_schedule_unknown():
    with pytest.raises(ValueError, match="unknown schedule"):
        get_schedule("gpipe-deluxe")


# ---------------------------------------------------------------------------
# PipelineConfig spec / env plumbing


def test_pipeline_config_spec_roundtrip():
    from ray_tpu.parallel import mpmd as jmpmd

    pcfg = PipelineConfig(stages=4, schedule="zb", microbatches=8,
                          grad_sync_group="train", snapshot_every=5)
    again = PipelineConfig.from_spec(pcfg.to_spec())
    assert again == dataclasses.replace(pcfg, microbatches=8)
    # the same spec as the JAX package's, read back by it
    spec = jmpmd.PipelineConfig(**dataclasses.asdict(pcfg)).to_spec()
    assert pcfg.to_spec() == spec
    assert jmpmd.PipelineConfig.from_spec(spec).stages == 4


def test_pipeline_config_from_env(monkeypatch):
    monkeypatch.delenv("RAY_TPU_TORCH_TRAIN_PIPELINE", raising=False)
    assert PipelineConfig.from_env() is None
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_PIPELINE",
                       "stages=2,schedule=1f1b,microbatches=4")
    pcfg = PipelineConfig.from_env()
    assert (pcfg.stages, pcfg.schedule, pcfg.num_microbatches) == \
        (2, "1f1b", 4)


def test_pipeline_config_validation():
    with pytest.raises(ValueError, match="unknown schedule"):
        PipelineConfig(schedule="bogus")
    with pytest.raises(ValueError, match="stages"):
        PipelineConfig(stages=0)
    with pytest.raises(ValueError, match="spec"):
        PipelineConfig.from_spec("stages")


def test_jax_config_carries_pipeline():
    from ray_tpu_torch.train.backend import JaxConfig

    pcfg = PipelineConfig(stages=2, schedule="1f1b")
    assert JaxConfig(pipeline=pcfg).pipeline is pcfg
    # spec-string form is what on_start publishes to worker env
    assert PipelineConfig.from_spec(pcfg.to_spec()).schedule == "1f1b"
    # a bad spec raises on the driver
    with pytest.raises(ValueError, match="unknown pipeline spec key"):
        JaxConfig(pipeline="stages=2,depth=3")


# ---------------------------------------------------------------------------
# split/merge microbatches


def test_split_merge_pytree_roundtrip():
    tree = {"inputs": np.arange(48).reshape(8, 6),
            "aux": {"w": np.ones((8, 2, 3), np.float32)}}
    split = split_microbatches(tree, 4)
    assert split["inputs"].shape == (4, 2, 6)
    assert split["aux"]["w"].shape == (4, 2, 2, 3)
    merged = merge_microbatches(split)
    np.testing.assert_array_equal(np.asarray(merged["inputs"]),
                                  tree["inputs"])


def test_split_error_names_offending_leaf():
    tree = {"ok": np.zeros((8, 2)), "bad": np.zeros((7, 2))}
    with pytest.raises(ValueError) as ei:
        split_microbatches(tree, 4)
    msg = str(ei.value)
    assert "bad" in msg and "(7, 2)" in msg and "4" in msg


# ---------------------------------------------------------------------------
# Stage partitioning


def _assert_same(ref, got):
    _assert_tree_close(ref, got, rtol=0, atol=0)


@pytest.mark.parametrize("stages", [2, 4])
def test_partition_merge_roundtrip(stages):
    params = _params()
    parts = gpt.partition_stage_params(params, MICRO, stages)
    merged = gpt.merge_stage_trees(parts, MICRO)
    _assert_same(params, merged)
    # layer slices are contiguous: stage s holds layers [s*per, (s+1)*per)
    per = MICRO.n_layers // stages
    for s, st in enumerate(parts):
        lead = next(iter(st["layers"].values()))
        assert lead.shape[0] == per
    # the same keys per stage as the JAX package's partition
    from ray_tpu.models import gpt as jgpt

    jparts = jgpt.partition_stage_params(_jax_params(), _jcfg(MICRO),
                                         stages)
    assert [sorted(p) for p in parts] == [sorted(p) for p in jparts]


def test_partition_untied_unembed():
    cfg = dataclasses.replace(MICRO, tie_embeddings=False)
    params = _params(cfg)
    parts = gpt.partition_stage_params(params, cfg, 2)
    assert "unembed" in parts[-1] and "embed" not in parts[-1]
    merged = gpt.merge_stage_trees(parts, cfg)
    _assert_same(params, merged)


def test_partition_rejects_indivisible():
    with pytest.raises(ValueError, match="divisible"):
        gpt.partition_stage_params(_params(), MICRO, 3)


def test_mpmd_depth_exceeds_spmd_mesh():
    """Stage count is not bounded by a mesh: a pp=16 mesh cannot exist in
    this one-rank process, but a 16-stage MPMD partition is just 16
    param trees."""
    from ray_tpu_torch.parallel import make_mesh

    with pytest.raises(Exception):
        make_mesh(pp=16, device_type="cpu")
    cfg = dataclasses.replace(MICRO, n_layers=16)
    params = gpt.init(cfg, seed=0, device="cpu")
    parts = gpt.partition_stage_params(params, cfg, 16)
    assert len(parts) == 16
    _assert_same(params, gpt.merge_stage_trees(parts, cfg))


# ---------------------------------------------------------------------------
# Unpipelined <-> MPMD parity


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_parity_pp2(schedule):
    """Loss and reassembled grads match loss_fn + autograd at 2 stages
    with M > stages, for every schedule."""
    params = _params()
    ref_loss, ref_grads = _ref_loss_grads(params)
    pcfg = PipelineConfig(stages=2, schedule=schedule, microbatches=4)
    with _mpmd(MICRO, pcfg, params) as pipe:
        loss, grads = pipe.forward_backward(BATCH)
    assert loss == pytest.approx(ref_loss, abs=1e-5)
    _assert_tree_close(ref_grads, grads)


@pytest.mark.parametrize("stages,microbatches", [(2, 2), (4, 4), (4, 8)])
def test_parity_1f1b_shapes(stages, microbatches):
    """M == stages and M > stages at 2 and 4 stages."""
    params = _params()
    ref_loss, ref_grads = _ref_loss_grads(params)
    pcfg = PipelineConfig(stages=stages, schedule="1f1b",
                          microbatches=microbatches)
    with _mpmd(MICRO, pcfg, params) as pipe:
        loss, grads = pipe.forward_backward(BATCH)
    assert loss == pytest.approx(ref_loss, abs=1e-5)
    _assert_tree_close(ref_grads, grads)


def test_parity_untied_embeddings():
    cfg = dataclasses.replace(MICRO, tie_embeddings=False)
    params = _params(cfg)
    ref_loss, ref_grads = _ref_loss_grads(params, cfg)
    pcfg = PipelineConfig(stages=2, schedule="1f1b", microbatches=4)
    with _mpmd(cfg, pcfg, params) as pipe:
        loss, grads = pipe.forward_backward(BATCH)
    assert loss == pytest.approx(ref_loss, abs=1e-5)
    _assert_tree_close(ref_grads, grads)


def test_parity_nano_tokens_batch():
    """The rope/rms/swiglu recipe and the {"tokens"} batch form through
    MPMD match the unpipelined loss."""
    params = _params(NANO)
    ref, _ = _ref_loss_grads(params, NANO, {"tokens": NANO_TOKS})
    pcfg = PipelineConfig(stages=2, schedule="1f1b", microbatches=4)
    with _mpmd(NANO, pcfg, params) as pipe:
        loss, _ = pipe.forward_backward({"tokens": NANO_TOKS})
    assert loss == pytest.approx(ref, abs=1e-5)


def test_parity_vs_spmd_pipeline_apply():
    """The port's MPMD loss matches the JAX package's SPMD pp-mesh loss
    on the same batch and weights: both are layouts of the same math."""
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import make_mesh

    jcfg = _jcfg(NANO)
    mesh = make_mesh(pp=2, dp=4)
    spmd = jax.jit(lambda p, t: jgpt.loss_fn(p, {"tokens": t}, jcfg, mesh))
    spmd_loss = float(spmd(jgpt.init(jax.random.PRNGKey(0), jcfg),
                           NANO_TOKS))
    pcfg = PipelineConfig(stages=2, schedule="1f1b", microbatches=4)
    with _mpmd(NANO, pcfg, _params(NANO)) as pipe:
        loss, _ = pipe.forward_backward({"tokens": NANO_TOKS})
    assert abs(loss - spmd_loss) < 1e-5, (loss, spmd_loss)


# ---------------------------------------------------------------------------
# JAX parity: the stage functions and the pipeline


@pytest.mark.parametrize("stages", [2, 4])
def test_stage_functions_match_jax(stages):
    """Each stage's forward (and the last stage's loss) on the JAX
    package's weights: stage s takes the JAX package's stage s-1
    hidden, so each comparison is one stage's own."""
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt

    jcfg = _jcfg(MICRO)
    jparts = jgpt.partition_stage_params(_jax_params(), jcfg, stages)
    parts = gpt.partition_stage_params(_params(), MICRO, stages)
    jx = jnp.asarray(BATCH["inputs"])
    for s in range(stages):
        want = np.asarray(jgpt.stage_hidden(jparts[s], jx, jcfg, s, stages))
        x = torch.from_numpy(np.array(jx))
        got = gpt.stage_hidden(parts[s], x, MICRO, s, stages)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=STAGE_ATOL, err_msg=f"stage {s}")
        if s == stages - 1:
            tgt = BATCH["targets"]
            jl = float(jgpt.stage_loss(jparts[s], jx, jnp.asarray(tgt),
                                       jcfg, s, stages))
            pl = float(gpt.stage_loss(parts[s], x, torch.from_numpy(tgt),
                                      MICRO, s, stages))
            assert abs(pl - jl) <= STAGE_ATOL, (pl, jl)
        jx = jnp.asarray(want)


@pytest.fixture(scope="module")
def jax_mpmd():
    """(schedule, stages) -> the JAX package's MPMDPipeline
    forward_backward (loss, flattened numpy grads), memoized."""
    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import mpmd as jmpmd

    import jax

    cache = {}

    def run(schedule, stages):
        if (schedule, stages) not in cache:
            jcfg = _jcfg(MICRO)
            pcfg = jmpmd.PipelineConfig(stages=stages, schedule=schedule,
                                        microbatches=4)
            with jmpmd.MPMDPipeline(jcfg, pcfg, params=jgpt.init(
                    jax.random.PRNGKey(0), jcfg)) as pipe:
                loss, grads = pipe.forward_backward(BATCH)
            flat = {jax.tree_util.keystr(p).replace("']['", ".")
                    .strip("[']"): np.asarray(v) for p, v in
                    jax.tree_util.tree_flatten_with_path(grads)[0]}
            cache[schedule, stages] = (loss, flat)
        return cache[schedule, stages]

    return run


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_forward_backward_matches_jax(jax_mpmd, schedule, stages):
    want_loss, want_grads = jax_mpmd(schedule, stages)
    pcfg = PipelineConfig(stages=stages, schedule=schedule, microbatches=4)
    with _mpmd(MICRO, pcfg, _params()) as pipe:
        loss, grads = pipe.forward_backward(BATCH)
    assert abs(loss - want_loss) <= STAGE_ATOL, (loss, want_loss)
    _assert_tree_close(want_grads, grads)


# ---------------------------------------------------------------------------
# Multi-step training + telemetry


def test_multistep_training_matches_reference():
    """3 AdamW steps through the pipeline track the port's unpipelined
    train step on the same data (the tied-table exchange keeps both
    copies identical under the deterministic update)."""
    params = _params()
    tx = training.adamw(1e-2, weight_decay=0.0)
    init, step = training.make_train_step(MICRO, tx=tx, device="cpu")
    state = init(params=params)
    ref_losses = [float(step(state, BATCH)[1]["loss"]) for _ in range(3)]

    pcfg = PipelineConfig(stages=2, schedule="1f1b", microbatches=4)
    with _mpmd(MICRO, pcfg, params, tx=tx, telemetry=True) as pipe:
        losses = [pipe.step(BATCH)["loss"] for _ in range(3)]
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-4,
                                   atol=1e-4)
        assert losses[2] < losses[0]  # it actually learns

        # flight-recorder dotted sub-phases: the bubble observability
        snaps = pipe.telemetry_snapshots()
        assert len(snaps) == 2
        phases = snaps[0]["steps"][-1]["phases"]
        for key in ("pipeline", "pipeline.fwd", "pipeline.bwd",
                    "pipeline.bwd_w", "pipeline.p2p", "pipeline.idle"):
            assert key in phases, phases
        assert phases["pipeline"] >= phases["pipeline.fwd"]

        trace = pipe.chrome_trace()
        names = {e["name"] for e in trace if e.get("ph") == "X"}
        assert {"pipeline.fwd", "pipeline.bwd", "pipeline.p2p"} <= names
        assert {e["pid"] for e in trace} == {0, 1}  # one row per stage

        rep = pipe.bubble_report()
        assert 0.0 <= rep["mean"] <= 1.0
        assert len(rep["per_stage"]) == 2


def test_phase_order_has_pipeline_keys():
    from ray_tpu_torch.telemetry.recorder import PHASE_ORDER

    for key in ("pipeline", "pipeline.fwd", "pipeline.bwd",
                "pipeline.bwd_w", "pipeline.p2p", "pipeline.idle"):
        assert key in PHASE_ORDER


# ---------------------------------------------------------------------------
# Bubble replay (virtual time)


def _ev(kind, mb, t0, dur):
    return {"kind": kind, "mb": mb, "t0": t0, "dur": dur}


def _jax_replay(events):
    from ray_tpu.parallel import mpmd as jmpmd

    return jmpmd.replay_bubble(events)


def test_replay_bubble_synthetic():
    """Hand-built 2-stage fill-drain, unit op costs, free edges: stage 0
    idles (n-1)(tf+tb)/span = 2/6, stage 1 runs packed."""
    s0 = [_ev("F", 0, 0, 1), _ev("F", 1, 1, 1),
          _ev("B", 0, 2, 1), _ev("B", 1, 3, 1)]
    s1 = [_ev("F", 0, 0, 1), _ev("B", 0, 1, 1),
          _ev("F", 1, 2, 1), _ev("B", 1, 3, 1)]
    rep = replay_bubble([s0, s1])
    assert rep["per_stage"][0] == pytest.approx(1 / 3)
    assert rep["per_stage"][1] == pytest.approx(0.0)
    assert rep["mean"] == pytest.approx(1 / 6)
    assert rep["span_s"] == pytest.approx(6.0)
    assert rep == _jax_replay([s0, s1])


def test_replay_bubble_edge_costs_delay_dependents():
    """A 1-unit p2p edge pushes stage 1's F back and shows up as its
    bubble; a zb stream with W ops replays as the JAX package's."""
    s0 = [_ev("F", 0, 0, 1), _ev("send_f", 0, 1, 1)]
    s1 = [_ev("recv_f", 0, 1, 0), _ev("F", 0, 2, 1), _ev("B", 0, 3, 1)]
    rep = replay_bubble([s0, s1])
    # stage1: F starts at 1 (F end) + 1 (edge) = 2, runs [2,3], B [3,4]
    assert rep["span_s"] == pytest.approx(4.0)
    assert rep["per_stage"][1] == pytest.approx(0.0)  # packed after start
    assert rep == _jax_replay([s0, s1])
    zb0 = [_ev("F", 0, 0, 1), _ev("send_f", 0, 1, .5), _ev("F", 1, 2, 1),
           _ev("send_f", 1, 3, .5), _ev("recv_b", 0, 4, .25),
           _ev("Bx", 0, 4, 1), _ev("W", 0, 5, 1), _ev("recv_b", 1, 6, .25),
           _ev("Bx", 1, 6, 1), _ev("W", 1, 7, 1)]
    zb1 = [_ev("recv_f", 0, 1, .5), _ev("F", 0, 2, 1),
           _ev("Bx", 0, 3, 1), _ev("send_b", 0, 4, .25),
           _ev("recv_f", 1, 4, .5), _ev("F", 1, 5, 1), _ev("Bx", 1, 6, 1),
           _ev("send_b", 1, 7, .25), _ev("W", 0, 8, 1), _ev("W", 1, 9, 1)]
    assert replay_bubble([zb0, zb1]) == _jax_replay([zb0, zb1])


def test_mean_op_events_replays_without_per_op_spread():
    """Two steps of the fill-drain above whose op costs spread around 1
    in mirror image: at their stage-and-kind means they replay as the
    unit-cost step, in the last step's order and start times."""
    def step(d):
        s0 = [_ev("F", 0, 0, d[0]), _ev("F", 1, 1, d[1]),
              _ev("send_f", 0, 1, d[2]), _ev("B", 0, 2, 1),
              _ev("B", 1, 3, 1)]
        s1 = [_ev("F", 0, 0, d[1]), _ev("B", 0, 1, 1),
              _ev("F", 1, 2, d[0]), _ev("B", 1, 3, 1)]
        return [s0, s1]

    steps = [step((1.5, 0.5, 0.1)), step((0.5, 1.5, 0.3))]
    assert replay_bubble(steps[0])["mean"] > 1 / 6
    got = mean_op_events(steps)
    assert [[(e["kind"], e["mb"], e["t0"]) for e in evs] for evs in got] \
        == [[(e["kind"], e["mb"], e["t0"]) for e in evs]
            for evs in steps[-1]]
    assert {e["dur"] for evs in got for e in evs if e["kind"] != "send_f"} \
        == {1.0}
    assert [e["dur"] for e in got[0] if e["kind"] == "send_f"] \
        == [pytest.approx(0.2)]
    unit = step((1, 1, 0.2))
    assert replay_bubble(got) == pytest.approx(replay_bubble(unit))


def test_replay_bubble_deadlock_detection():
    s0 = [_ev("B", 0, 0, 1)]   # depends on stage 1's B that never runs
    s1 = [_ev("F", 1, 0, 1)]   # depends on stage 0's F that never runs
    with pytest.raises(RuntimeError, match="deadlock"):
        replay_bubble([s0, s1])


def test_chrome_trace_names():
    from ray_tpu.parallel import mpmd as jmpmd

    s0 = [_ev("F", 0, 0.0, 1e-3), _ev("wait", 0, 1e-3, 5e-4),
          _ev("send_f", 0, 2e-3, 1e-4), _ev("W", 0, 3e-3, 1e-4)]
    trace = schedule_chrome_trace([s0])
    xs = {e["name"] for e in trace if e["ph"] == "X"}
    assert xs == {"pipeline.fwd", "pipeline.idle", "pipeline.p2p",
                  "pipeline.bwd_w"}
    meta = [e for e in trace if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == "pipeline stage 0"
    assert trace == jmpmd.schedule_chrome_trace([s0])


# ---------------------------------------------------------------------------
# Elastic: gang death folds back from emergency checkpoints


def test_stage_failure_recovers_and_matches():
    """Kill stage 1 mid-step; the pipeline respawns it from its vault
    shard, the survivor rolls back to its commit (copies: the optimizer
    updates in place), the step retries, and the losses equal an
    uninterrupted run's bitwise."""
    emergency._clear_vault()
    params = _params()
    pcfg = PipelineConfig(stages=2, schedule="1f1b", microbatches=4)
    tx = training.adamw(1e-2, weight_decay=0.0)

    with _mpmd(MICRO, pcfg, params, tx=tx) as ref_pipe:
        ref_losses = [ref_pipe.step(BATCH)["loss"] for _ in range(3)]

    emergency._clear_vault()
    with _mpmd(MICRO, pcfg, params, tx=tx) as pipe:
        losses = [pipe.step(BATCH)["loss"]]
        pipe.inject_failure(stage=1, op_index=2)
        res = pipe.step(BATCH)
        assert res["recovered"]
        losses.append(res["loss"])
        losses.append(pipe.step(BATCH)["loss"])
    assert losses == ref_losses
    emergency._clear_vault()


def test_failure_before_any_commit_restarts_from_init():
    """Death on the FIRST step (no vault shard yet): the gang respawns
    from its initial partition and the step still completes."""
    emergency._clear_vault()
    params = _params()
    ref_loss, _ = _ref_loss_grads(params)
    pcfg = PipelineConfig(stages=2, schedule="fill_drain", microbatches=4)
    with _mpmd(MICRO, pcfg, params) as pipe:
        pipe.inject_failure(stage=0, op_index=1)
        res = pipe.step(BATCH, apply_update=False)
        assert res["recovered"]
        assert res["loss"] == pytest.approx(ref_loss, abs=1e-5)
    emergency._clear_vault()


def test_abort_restores_copies_not_the_updated_tensors():
    """The commit holds copies: tensors the optimizer went on updating in
    place after it (a half-done update) are put back to the committed
    params and AdamW moments by a rollback."""
    from ray_tpu_torch.parallel.mpmd import StageRuntime

    pcfg = PipelineConfig(stages=1, schedule="1f1b", microbatches=2)
    rt = StageRuntime(MICRO, pcfg, 0,
                      gpt.partition_stage_params(_params(), MICRO, 1)[0],
                      tx=training.adamw(1e-2, weight_decay=0.0),
                      device="cpu")
    res = rt.run_step(0, list(split_microbatches(BATCH["inputs"], 2)),
                      list(split_microbatches(BATCH["targets"], 2)))
    assert res["loss"] is not None and rt.committed_step() == 0
    want = [t.detach().clone() for t in rt._leaves]
    want_m = [{k: v.clone() for k, v in rt._opt.state[t].items()}
              for t in rt._leaves]
    with torch.no_grad():
        for t in rt._leaves:
            t.add_(1.0)
            rt._opt.state[t]["exp_avg"].add_(1.0)
    rt.abort_step()
    for t, w, m in zip(rt._leaves, want, want_m):
        assert torch.equal(t, w)
        for k, v in m.items():
            assert torch.equal(rt._opt.state[t][k], v), k
    rt.close()


# ---------------------------------------------------------------------------
# Actors transport (the per-gang scheduler actor)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_actor_transport_parity(cluster):
    """2 stage gangs as runtime actors, channels over /dev/shm: the same
    loss and grads as the unpipelined step, and the threads transport's
    bitwise."""
    emergency._clear_vault()
    params = _params()
    ref_loss, ref_grads = _ref_loss_grads(params)
    pcfg = PipelineConfig(stages=2, schedule="1f1b", microbatches=4)
    with _mpmd(MICRO, pcfg, params) as pipe:
        want_loss, want_grads = pipe.forward_backward(BATCH)
    apcfg = dataclasses.replace(pcfg, transport="actors")
    with _mpmd(MICRO, apcfg, params) as pipe:
        loss, grads = pipe.forward_backward(BATCH)
        assert loss == pytest.approx(ref_loss, abs=1e-5)
        _assert_tree_close(ref_grads, grads)
        assert loss == want_loss
        _assert_same(want_grads, grads)
        assert pipe.step(BATCH, apply_update=False)["p2p_bytes"] > 0


# ---------------------------------------------------------------------------
# Step accounting


def test_step_reports_p2p_and_stash():
    params = _params()
    pcfg = PipelineConfig(stages=2, schedule="fill_drain", microbatches=4)
    with _mpmd(MICRO, pcfg, params) as pipe:
        res = pipe.step(BATCH, apply_update=False)
    # 4 activation + 4 grad hops of [2, 16, 16] f32 + the tie exchange
    assert res["p2p_bytes"] > 4 * 2 * 16 * 16 * 4
    # fill-drain stashes every in-flight microbatch on stage 0
    assert res["peak_stash"][0] == 4
    assert res["step"] == 0 and not res["recovered"]
    # every op kind's launches are reported per stage (none on the CPU)
    assert set(res["launches"][0]) == {"F", "B"}
    assert all(n == 0 for kinds in res["launches"] for per in kinds.values()
               for n in per.values())
