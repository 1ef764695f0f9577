"""Connector pipelines of the port (reference:
rllib/connectors/connector_v2.py, env_to_module/, module_to_env/) — the
cases of tests/test_rl_connectors.py: standalone unit tests plus runner
integration, the runners with ``device="cpu"``; the obs connectors also
on torch tensors, which the device rollout feeds them."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl.connectors import (ClipActions, ClipObs, ConnectorPipeline,
                                   ConnectorV2, FlattenObs, NormalizeObs,
                                   ObsToFloat32, ToNumpy, UnbatchToInt,
                                   default_env_to_module)


def test_pipeline_composes_in_order():
    trace = []

    class A(ConnectorV2):
        def __call__(self, data, ctx=None):
            trace.append("A")
            return data + 1

    class B(ConnectorV2):
        def __call__(self, data, ctx=None):
            trace.append("B")
            return data * 10

    p = ConnectorPipeline(A(), B())
    assert p(1) == 20 and trace == ["A", "B"]


def test_pipeline_splicing():
    p = ConnectorPipeline(ObsToFloat32(), FlattenObs())
    p.insert_after(ObsToFloat32, ClipObs(-1, 1))
    assert [type(c).__name__ for c in p.connectors] == \
        ["ObsToFloat32", "ClipObs", "FlattenObs"]
    p.insert_before(ObsToFloat32, ClipObs(-5, 5))
    assert type(p.connectors[0]).__name__ == "ClipObs"
    p.remove(FlattenObs)
    assert all(type(c).__name__ != "FlattenObs" for c in p.connectors)
    with pytest.raises(ValueError):
        p.remove(FlattenObs)


def test_obs_connectors():
    obs = np.arange(12, dtype=np.int32).reshape(2, 2, 3)
    out = ObsToFloat32()(obs)
    assert out.dtype == np.float32
    flat = FlattenObs()(out)
    assert flat.shape == (2, 6)
    clipped = ClipObs(0.0, 4.0)(flat)
    assert clipped.max() == 4.0
    # the same pipeline on a tensor, as the device rollout runs it
    t = ObsToFloat32()(torch.from_numpy(obs))
    assert t.dtype == torch.float32
    tflat = ClipObs(0.0, 4.0)(FlattenObs()(t))
    np.testing.assert_array_equal(tflat.numpy(), clipped)


def test_normalize_obs_welford():
    rng = np.random.RandomState(0)
    conn = NormalizeObs()
    data = rng.normal(5.0, 2.0, size=(500, 3)).astype(np.float32)
    for i in range(0, 500, 50):
        out = conn(data[i:i + 50])
    # after enough samples the output is ~standardized
    assert abs(out.mean()) < 0.5
    assert 0.5 < out.std() < 2.0
    st = conn.state()
    np.testing.assert_allclose(st["mean"], data.mean(0), atol=0.2)
    # frozen filter: stats stop updating
    conn.update = False
    c0 = st["count"]
    conn(data[:10])
    assert conn.state()["count"] == c0


def test_action_connectors():
    a = np.array([-2.0, 0.3, 7.0])
    assert ClipActions(-1, 1)(a).tolist() == [-1.0, 0.3, 1.0]
    assert UnbatchToInt()(np.array([1.9, 0.2])).dtype == np.int64
    assert isinstance(ToNumpy()(a), np.ndarray)
    assert isinstance(ToNumpy()(torch.tensor([1, 0])), np.ndarray)
    assert UnbatchToInt()(torch.tensor([1.0, 0.0])).dtype == np.int64
    assert ClipActions(-1, 1)(torch.tensor(a)).tolist() == [-1.0, 0.3, 1.0]


def test_pipeline_traceability_flag():
    p = ConnectorPipeline(ObsToFloat32(), FlattenObs())
    assert p.traceable
    p.append(NormalizeObs())
    assert not p.traceable


def test_jax_runner_rejects_stateful_connector():
    from ray_tpu_torch.rl.env.env_runner import JaxEnvRunner

    with pytest.raises(ValueError, match="traceable"):
        JaxEnvRunner("CartPole-v1", {"kind": "policy"},
                     num_envs=2,
                     env_to_module=ConnectorPipeline(NormalizeObs()),
                     device="cpu")


def test_jax_runner_traceable_connector_in_scan():
    """A traceable pipeline runs INSIDE the device rollout loop."""
    from ray_tpu_torch.rl.env.env_runner import JaxEnvRunner

    runner = JaxEnvRunner(
        "CartPole-v1", {"kind": "policy"}, num_envs=4,
        env_to_module=ConnectorPipeline(ObsToFloat32(), ClipObs(-3, 3)),
        device="cpu")
    out = runner.sample(8)
    assert out["batch"]["obs"].shape[:2] == (8, 4)
    assert np.isfinite(out["batch"]["reward"]).all()


def test_gym_runner_uses_connector_pipelines():
    pytest.importorskip("gymnasium")
    from ray_tpu_torch.rl.env.env_runner import GymEnvRunner

    norm = ConnectorPipeline(ObsToFloat32(), NormalizeObs())
    runner = GymEnvRunner("CartPole-v1", {"kind": "policy"}, num_envs=2,
                          env_to_module=norm,
                          module_to_env=ConnectorPipeline(ToNumpy(),
                                                          UnbatchToInt()),
                          device="cpu")
    out = runner.sample(10)
    assert out["batch"]["obs"].shape[:2] == (10, 2)
    # the stateful filter accumulated samples during the rollout
    assert norm.connectors[1].state()["count"] >= 20


def test_default_pipeline_repr_and_contents():
    p = default_env_to_module()
    assert "ObsToFloat32" in repr(p)
