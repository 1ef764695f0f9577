"""The port's Data held against the JAX package's, bitwise.

One user script runs under ``ray_tpu`` and under ``ray_tpu_torch``, each
in its own subprocess, on the same seeded parquet files:
``read_parquet`` → ``map_batches`` (a numpy UDF) → ``filter`` →
``groupby().aggregate(Sum, Mean, Std)`` → ``random_shuffle(seed=...)`` →
``sort`` → ``split(2, equal=True)`` → ``iter_batches(batch_format=
"numpy")``, and the rows themselves through a seeded shuffle and a sort.
Every batch's dtype, shape and bytes agree.  The same script then feeds
``iter_jax_batches(dtypes=...)``: the reference's on its default device
(JAX on the CPU), the port's on ``device="cpu"``; the cast columns agree
in values and dtypes, and an uncast int64 column in values.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, json, sys
import numpy as np
package, path = sys.argv[1], sys.argv[2]
if package == "ray_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
rt = importlib.import_module(package)
rd = importlib.import_module(package + ".data")
rt.init(num_cpus=2)


def enc(batch):
    return {k: [str(np.asarray(v).dtype), list(np.asarray(v).shape),
                np.ascontiguousarray(np.asarray(v)).tobytes().hex()]
            for k, v in sorted(batch.items())}


out = {}
ds = rd.read_parquet(path).map_batches(
    lambda b: {"k": b["k"], "x": b["x"] * 1.5 + b["y"], "y": b["y"]})
ds = ds.filter(lambda r: r["y"] % 3 != 0)
groups = (ds.groupby("k").aggregate(rd.Sum("x"), rd.Mean("x"), rd.Std("x"))
          .random_shuffle(seed=7).sort("k"))
out["groups"] = [[enc(b) for b in part.iter_batches(batch_format="numpy")]
                 for part in groups.split(2, equal=True)]
rows = ds.random_shuffle(seed=3)
out["shuffled"] = [enc(b) for b in rows.iter_batches(batch_size=50,
                                                     batch_format="numpy")]
out["sorted"] = [enc(b) for b in rows.sort("x").iter_batches(
    batch_size=64, batch_format="numpy")]
kw = {} if package == "ray_tpu" else {"device": "cpu"}
out["device_batches"] = [
    enc(b) for b in rd.read_parquet(path).iter_jax_batches(
        batch_size=64, dtypes={"x": np.float32, "y": np.float16}, **kw)]
rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
"""


def _run(package: str, path: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("RAY_TPU_ADDRESS", None)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    out = subprocess.run([sys.executable, "-c", _SCRIPT, package, path],
                         cwd="/", env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """The script's output under each package, on three seeded parquet
    files of 200 rows (k: 10 keys, x: float64, y: int32)."""
    root = tmp_path_factory.mktemp("parity") / "tables"
    root.mkdir()
    rng = np.random.RandomState(12)
    for i in range(3):
        pq.write_table(pa.table({
            "k": rng.randint(0, 10, 200).astype(np.int64),
            "x": rng.standard_normal(200),
            "y": rng.randint(-50, 50, 200).astype(np.int32)}),
            str(root / f"part-{i}.parquet"))
    return _run("ray_tpu", str(root)), _run("ray_tpu_torch", str(root))


def test_pipeline_is_bitwise_the_reference(outputs):
    ref, port = outputs
    for key in ("groups", "shuffled", "sorted"):
        assert port[key] == ref[key], key
    # the pipeline did its work: ten groups split five and five, every
    # filtered row shuffled and sorted
    n_groups = [sum(b["k"][1][0] for b in p) for p in ref["groups"]]
    assert n_groups == [5, 5]
    n_rows = sum(b["x"][1][0] for b in ref["sorted"])
    assert n_rows == sum(b["x"][1][0] for b in ref["shuffled"]) > 300
    assert set(ref["groups"][0][0]) == {"k", "sum(x)", "mean(x)", "std(x)"}


def test_iter_jax_batches_values_and_dtypes_match_the_reference(outputs):
    """The cast columns agree bitwise.  The uncast int64 column agrees in
    value; JAX without x64 narrows it to int32 on its device, and torch
    keeps it int64 (ROADMAP §C)."""
    ref, port = outputs
    assert len(port["device_batches"]) == len(ref["device_batches"]) \
        == 600 // 64
    for r, p in zip(ref["device_batches"], port["device_batches"]):
        assert {k: p[k] for k in ("x", "y")} == {k: r[k] for k in ("x", "y")}
        assert (r["x"][0], r["y"][0]) == ("float32", "float16")
        assert (r["k"][0], p["k"][0]) == ("int32", "int64")
        ref_k = np.frombuffer(bytes.fromhex(r["k"][2]), np.int32)
        port_k = np.frombuffer(bytes.fromhex(p["k"][2]), np.int64)
        assert np.array_equal(ref_k.astype(np.int64), port_k)
