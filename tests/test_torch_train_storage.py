"""The port's remote checkpoint/experiment storage: the cases of
tests/test_train_storage.py through ``ray_tpu_torch.train.storage`` and
``ray_tpu_torch.train.JaxTrainer`` on the port's runtime (one cluster for
the module), less the Tuner case, which waits for the port's Tune
(ROADMAP A.10).  Tests route through the registered `mock-remote://`
fsspec scheme: every byte crosses the fsspec API (the path any real
remote scheme takes) while persisting under a tmp dir the test can
inspect out-of-band.
"""

import json
import os

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.train import (Checkpoint, JaxTrainer, RunConfig,
                                 ScalingConfig)
from ray_tpu_torch.train import storage


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _uri(tmp_path, *parts):
    return "mock-remote://" + str(tmp_path.joinpath(*parts))


# ---------------------------------------------------------------------------
# storage primitives
# ---------------------------------------------------------------------------

def test_storage_primitives_roundtrip(tmp_path):
    root = _uri(tmp_path, "bucket")
    assert storage.is_uri(root) and not storage.is_uri(str(tmp_path))
    d = storage.join(root, "a", "b")
    assert d == root + "/a/b"
    storage.makedirs(d)
    assert storage.exists(d)
    storage.write_text(storage.join(d, "x.txt"), "hello")
    assert storage.read_text(storage.join(d, "x.txt")) == "hello"
    storage.append_text(storage.join(d, "x.txt"), "!")
    assert storage.read_text(storage.join(d, "x.txt")) == "hello!"
    assert "x.txt" in storage.listdir(d)
    # the backing dir really holds the bytes (out-of-band check)
    assert (tmp_path / "bucket" / "a" / "b" / "x.txt").read_text() == "hello!"
    storage.rmtree(d)
    assert not storage.exists(d)


def test_storage_upload_download_dir(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "w.bin").write_bytes(b"\x00\x01")
    (src / "sub" / "n.txt").write_text("nested")
    dest = _uri(tmp_path, "store", "ck0")
    storage.upload_dir(str(src), dest)
    assert set(storage.listdir(dest)) >= {"w.bin", "sub"}
    back = tmp_path / "back"
    storage.download_dir(dest, str(back))
    assert (back / "w.bin").read_bytes() == b"\x00\x01"
    assert (back / "sub" / "n.txt").read_text() == "nested"


def test_storage_context_async_upload(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_text("1")
    ctx = storage.StorageContext(_uri(tmp_path, "b"))
    done = []
    ctx.upload_dir_async(str(src), _uri(tmp_path, "b", "up"),
                         on_complete=lambda: done.append(1))
    ctx.wait()
    assert done == [1]
    assert storage.read_text(_uri(tmp_path, "b", "up", "a.txt")) == "1"


def test_storage_context_upload_error_surfaces(tmp_path):
    ctx = storage.StorageContext(_uri(tmp_path, "b"))
    ctx.upload_dir_async(str(tmp_path / "does_not_exist"),
                         _uri(tmp_path, "b", "up"))
    with pytest.raises(Exception):
        ctx.wait()


# ---------------------------------------------------------------------------
# remote Checkpoint
# ---------------------------------------------------------------------------

def test_remote_checkpoint_materialize(tmp_path):
    dest = _uri(tmp_path, "ckpts", "checkpoint_000000")
    src = tmp_path / "local"
    src.mkdir()
    (src / "state.msgpack").write_bytes(b"params")
    storage.upload_dir(str(src), dest)
    ck = Checkpoint(dest)
    assert ck.is_remote
    ck.set_metadata({"step": 7})
    assert ck.get_metadata() == {"step": 7}
    with ck.as_directory() as d:
        assert open(os.path.join(d, "state.msgpack"), "rb").read() == \
            b"params"
    assert not os.path.exists(d)  # temp view cleaned up


# ---------------------------------------------------------------------------
# end-to-end: JaxTrainer.fit persists to remote; resume reads it back
# ---------------------------------------------------------------------------

def _loop_ckpt_remote(config):
    import tempfile

    restored = train.get_checkpoint()
    start = 0
    if restored:
        with restored.as_directory() as d:
            start = json.load(open(os.path.join(d, "s.json")))["step"] + 1
    for step in range(start, config["steps"]):
        d = tempfile.mkdtemp()
        json.dump({"step": step}, open(os.path.join(d, "s.json"), "w"))
        train.report({"step": step}, checkpoint=Checkpoint(d))


def test_trainer_fit_remote_storage(cluster, tmp_path):
    trainer = JaxTrainer(
        _loop_ckpt_remote, train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="remote_run",
                             storage_path=_uri(tmp_path, "bucket")),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None and result.checkpoint.is_remote
    # workers uploaded rank shards + completion markers
    names = storage.listdir(result.checkpoint.path)
    assert {"rank_0", "rank_1"} <= set(names)
    assert any(n.startswith(".complete_rank_") for n in names)
    # a fresh run resumes from the remote checkpoint
    from ray_tpu_torch.train.trainer import _find_latest_checkpoint

    trial_dir = _uri(tmp_path, "bucket", "remote_run", "remote_run_00000")
    latest = _find_latest_checkpoint(trial_dir, world_size=2)
    assert latest is not None
    assert latest.path == result.checkpoint.path
    # rank-filtered download: a host fetches only its own shard
    with latest.as_directory(subdir="rank_0") as d:
        got = json.load(open(os.path.join(d, "s.json")))
        assert got["step"] == 2
    # a missing rank marker makes the checkpoint incomplete for that size
    assert _find_latest_checkpoint(trial_dir, world_size=3) is None


def test_trainer_local_paths_unchanged(cluster, tmp_path):
    """Plain local storage_path keeps the exact pre-existing layout."""
    trainer = JaxTrainer(
        _loop_ckpt_remote, train_loop_config={"steps": 2},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="local_run",
                             storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None
    assert not result.checkpoint.is_remote
    assert os.path.isdir(result.checkpoint.path)
