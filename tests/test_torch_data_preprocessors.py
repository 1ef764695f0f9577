"""Preprocessor tests (reference: python/ray/data/tests/
test_preprocessors*.py).

The port's mirror of tests/test_data_preprocessors.py, case by case, on
one cluster of the port's runtime for the module.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data import (BatchMapper, Chain, Concatenator,
                                LabelEncoder, MinMaxScaler, OneHotEncoder,
                                OrdinalEncoder, SimpleImputer, StandardScaler)


@pytest.fixture(scope="module")
def ray_cluster():
    """One cluster of the port's runtime for the module, under the name of
    the reference's session fixture (tests/conftest.py)."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _ds(ray_cluster):
    rows = [{"a": float(i), "b": i % 3, "cat": ["x", "y", "z"][i % 3]}
            for i in range(12)]
    return rd.from_items(rows)


def test_standard_scaler(ray_cluster):
    ds = _ds(ray_cluster)
    sc = StandardScaler(columns=["a"])
    out = sc.fit_transform(ds).take_all()
    vals = np.asarray([r["a"] for r in out])
    assert abs(vals.mean()) < 1e-9
    assert vals.std() == pytest.approx(1.0, rel=1e-6)
    # stateless batch transform matches
    b = sc.transform_batch({"a": np.asarray([5.5])})
    assert b["a"][0] == pytest.approx(0.0, abs=1e-9)


def test_min_max_scaler(ray_cluster):
    ds = _ds(ray_cluster)
    out = MinMaxScaler(columns=["a"]).fit_transform(ds).take_all()
    vals = [r["a"] for r in out]
    assert min(vals) == 0.0 and max(vals) == 1.0


def test_label_and_ordinal_encoders(ray_cluster):
    ds = _ds(ray_cluster)
    le = LabelEncoder(label_column="cat")
    out = le.fit_transform(ds).take_all()
    assert sorted({r["cat"] for r in out}) == [0, 1, 2]
    inv = le.inverse_transform_batch(
        {"cat": np.asarray([0, 1, 2])})
    assert list(inv["cat"]) == ["x", "y", "z"]

    oe = OrdinalEncoder(columns=["cat"])
    out2 = oe.fit_transform(_ds(ray_cluster)).take_all()
    assert sorted({r["cat"] for r in out2}) == [0, 1, 2]


def test_one_hot_encoder(ray_cluster):
    ds = _ds(ray_cluster)
    out = OneHotEncoder(columns=["cat"]).fit_transform(ds).take_all()
    assert "cat" not in out[0]
    assert {"cat_x", "cat_y", "cat_z"} <= set(out[0])
    for r in out:
        assert r["cat_x"] + r["cat_y"] + r["cat_z"] == 1


def test_simple_imputer_mean(ray_cluster):
    rows = [{"v": 1.0}, {"v": float("nan")}, {"v": 3.0}]
    ds = rd.from_items(rows)
    out = SimpleImputer(columns=["v"], strategy="mean") \
        .fit_transform(ds).take_all()
    vals = sorted(r["v"] for r in out)
    assert vals == [1.0, 2.0, 3.0]


def test_concatenator_and_chain(ray_cluster):
    ds = _ds(ray_cluster)
    chain = Chain(
        StandardScaler(columns=["a"]),
        BatchMapper(lambda b: {**b, "b2": b["b"] * 2}),
        Concatenator(columns=["a", "b2"], output_column_name="features"),
    )
    out = chain.fit_transform(ds).take_all()
    assert out[0]["features"].shape == (2,)
    assert "a" not in out[0] and "b2" not in out[0]
    # transform_batch end-to-end
    b = chain.transform_batch({"a": np.asarray([5.5]),
                               "b": np.asarray([1]),
                               "cat": np.asarray(["x"])})
    assert b["features"].shape == (1, 2)


def test_unfitted_raises(ray_cluster):
    with pytest.raises(RuntimeError, match="not fitted"):
        StandardScaler(columns=["a"]).transform(_ds(ray_cluster))
