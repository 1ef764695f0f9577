"""File-backed offline RL on the port (reference:
rllib/offline/offline_data.py:22 — OfflineData feeds datasets into
learners; offline_env_runner records rollouts to parquet): the cases of
tests/test_rl_offline.py on the port's own cluster and Data, every entry
point with ``device="cpu"``.  Done-criteria flow: record rollouts to
parquet under pytest's ``tmp_path``, train CQL straight from the files,
loss decreases."""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch.rl import BCConfig, CQLConfig, MARWILConfig, PPOConfig
from ray_tpu_torch.rl.offline import OfflineData, record_rollouts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.fixture(scope="module")
def rollout_files(tmp_path_factory, ray_cluster):
    """Sample CartPole rollouts once, write parquet shards once."""
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=8)
           .training(rollout_len=64)
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        batches = []
        for _ in range(2):
            results = algo.runners.sample(64)
            batch, _ = algo._merge_runner_results(results)
            batches.append({k: np.asarray(v) for k, v in batch.items()})
    finally:
        algo.stop()
    out = str(tmp_path_factory.mktemp("offline") / "rollouts")
    files = record_rollouts(batches, out, gamma=0.99)
    assert files and all(f.endswith(".parquet") for f in files)
    return out


def test_offline_data_reads_transitions(rollout_files):
    od = OfflineData(rollout_files)
    batches = od.materialize(batch_size=128)
    assert batches
    b = batches[0]
    for col in ("obs", "action", "reward", "done", "next_obs", "return"):
        assert col in b, sorted(b)
    assert b["obs"].shape[0] <= 128
    assert b["obs"].shape == b["next_obs"].shape
    assert b["obs"].ndim == 2          # [N, obs_dim] tensors round-trip


def test_recorded_batches_read_back_in_recording_order(tmp_path,
                                                       ray_cluster):
    """Data names the files it writes at random; record_rollouts puts
    each batch's index in front, so reading the directory (in name
    order) gives the batches in recording order, whatever the names."""
    flats = [{"obs": np.full((4, 2), i, np.float32),
              "next_obs": np.full((4, 2), i, np.float32),
              "action": np.full(4, i, np.int64),
              "reward": np.full(4, i, np.float32),
              "done": np.zeros(4, bool)} for i in range(12)]
    files = record_rollouts(flats, str(tmp_path / "ordered"), gamma=None)
    assert [f.rsplit("/", 1)[1][:6] for f in files] == [
        f"{i:06d}" for i in range(12)]
    rows = np.concatenate([b["action"] for b in OfflineData(
        str(tmp_path / "ordered")).materialize(batch_size=8)])
    np.testing.assert_array_equal(rows, np.repeat(np.arange(12), 4))


def test_cql_trains_from_parquet_files(rollout_files):
    cfg = (CQLConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=2)
           .training(cql_alpha=1.0, num_epochs=1, minibatch_size=128)
           .offline(rollout_files)            # a PATH, not an iterable
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        losses, bellman = [], []
        for _ in range(6):
            r = algo.train()
            losses.append(float(r["loss"]))
            bellman.append(float(r["bellman_loss"]))
        assert all(np.isfinite(x) for x in losses)
        # the TD term must improve on the fixed dataset (total loss can
        # wiggle: the conservative regularizer fights the fit)
        assert min(bellman[2:]) < bellman[0], bellman
        assert r["cql_loss"] >= 0.0
    finally:
        algo.stop()


def test_bc_trains_from_dataset_object(rollout_files):
    ds = rd.read_parquet(rollout_files)
    cfg = (BCConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=2)
           .training(num_epochs=1, minibatch_size=128)
           .offline(ds)                        # a Dataset object
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        losses = [float(algo.train()["loss"]) for _ in range(4)]
        assert losses[-1] < losses[0], losses
    finally:
        algo.stop()


def test_marwil_requires_return_column(tmp_path, ray_cluster):
    """Transitions recorded WITHOUT gamma have no 'return' column;
    MARWIL must reject them loudly, not train on garbage."""
    flat = {"obs": np.zeros((10, 4), np.float32),
            "next_obs": np.zeros((10, 4), np.float32),
            "action": np.zeros(10, np.int64),
            "reward": np.ones(10, np.float32),
            "done": np.zeros(10, bool)}
    files = record_rollouts([flat], str(tmp_path / "noret"), gamma=None)
    cfg = (MARWILConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=2)
           .offline(files)
           .resources(device="cpu"))
    with pytest.raises(ValueError, match="return"):
        cfg.build()


def test_legacy_in_memory_iterable_still_works():
    rng = np.random.default_rng(0)
    rollout = {"obs": rng.random((8, 4, 4)).astype(np.float32),
               "action": rng.integers(0, 2, (8, 4)),
               "reward": np.ones((8, 4), np.float32),
               "done": np.zeros((8, 4), bool)}
    cfg = (CQLConfig().environment("CartPole-v1")
           .env_runners(0, num_envs_per_runner=2)
           .training(num_epochs=1)
           .offline([rollout])
           .resources(device="cpu"))
    algo = cfg.build()
    try:
        assert np.isfinite(algo.train()["loss"])
    finally:
        algo.stop()
