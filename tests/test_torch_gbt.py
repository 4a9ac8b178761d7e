"""The port's gradient-boosted trees against the JAX package's
(``raydp_tpu/train/gbt.py``), and ``MLDataset.shard_global_indices``
against the JAX dataset's.

Both fit the same numpy rows on the CPU. The JAX side runs with
``data_parallel=False``: on the test session's 8 CPU devices it would
shard the rows and sum the histograms in another order. The port sums in
row order on the CPU, so the fitted trees are the same: ``feature`` and
``bin`` arrays equal, leaves, histories and predictions within rtol 1e-5.
The cases mirror the JAX package's own (``tests/test_gbt.py``): both
losses, an eval set, ``reg_lambda=0``, NaN features, ``num_epochs=0``,
``predict_on_ds`` over shards that do not divide the rows, and a model
the JAX package saved, restored by the port.
"""
import numpy as np
import pyarrow as pa
import pytest

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.train.gbt import GBTEstimator as JaxGBT
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.train import GBTEstimator

TREE_RTOL = dict(rtol=1e-5, atol=1e-6)
FEATURES = ["a", "b", "c"]


def _reg_columns(n, seed, nan_share=0.0):
    rng = np.random.RandomState(seed)
    a, b = rng.randn(n), rng.randn(n)
    c = rng.randint(0, 5, n).astype(float)
    y = np.where(a > 0, 3.0, -1.0) + b * c + 0.1 * rng.randn(n)
    if nan_share:
        a[rng.rand(n) < nan_share] = np.nan
    return {"a": a, "b": b, "c": c, "y": y}


def _logistic_columns(n, seed):
    rng = np.random.RandomState(seed)
    a, b = rng.randn(n), rng.randn(n)
    return {"a": a, "b": b, "c": rng.randn(n),
            "y": ((a * b) > 0).astype(float)}


def _datasets(cols, blocks=2, shards=2):
    """The same rows as JAX and port datasets, cut into ``blocks``."""
    cuts = np.array_split(np.arange(len(cols["y"])), blocks)
    parts = [{k: v[idx] for k, v in cols.items()} for idx in cuts]
    return (JaxMLDataset([pa.table(p) for p in parts], shards),
            MLDataset(parts, shards))


def _fit_both(cols, eval_cols=None, num_epochs=None, **kw):
    kw = dict(feature_columns=FEATURES, label_column="y", **kw)
    jest = JaxGBT(data_parallel=False, **kw)
    test = GBTEstimator(device="cpu", **kw)
    jds, tds = _datasets(cols)
    jev, tev = _datasets(eval_cols) if eval_cols else (None, None)
    jhist = jest.fit(jds, evaluate_ds=jev, num_epochs=num_epochs)
    thist = test.fit(tds, evaluate_ds=tev, num_epochs=num_epochs)
    return jest, test, jhist, thist


def _assert_same_model(jest, test, jhist, thist):
    np.testing.assert_array_equal(test._trees["feature"],
                                  jest._trees["feature"])
    np.testing.assert_array_equal(test._trees["bin"], jest._trees["bin"])
    np.testing.assert_allclose(test._trees["leaf"], jest._trees["leaf"],
                               **TREE_RTOL)
    for a, b in zip(test._edges, jest._edges):
        np.testing.assert_array_equal(a, b)
    assert test._base_score == jest._base_score
    assert len(thist) == len(jhist)
    for t, j in zip(thist, jhist):
        assert t.keys() == j.keys() and t["round"] == j["round"]
        for k in t.keys() - {"round"}:
            np.testing.assert_allclose(t[k], j[k], err_msg=k, **TREE_RTOL)


CASES = {
    "squared": dict(cols=lambda: _reg_columns(1500, 3),
                    kw=dict(n_trees=12, max_depth=4)),
    "squared_eval": dict(cols=lambda: _reg_columns(1200, 5),
                         eval_cols=lambda: _reg_columns(300, 6),
                         kw=dict(n_trees=20, max_depth=3), num_epochs=8),
    "logistic": dict(cols=lambda: _logistic_columns(1500, 1),
                     kw=dict(n_trees=10, max_depth=4, loss="logistic")),
    "reg_lambda_zero": dict(cols=lambda: _reg_columns(1200, 11),
                            kw=dict(n_trees=8, max_depth=3,
                                    reg_lambda=0.0)),
    "nan_feature": dict(cols=lambda: _reg_columns(1500, 2, nan_share=0.05),
                        kw=dict(n_trees=8, max_depth=3)),
    "min_split_gain": dict(cols=lambda: _reg_columns(1000, 7),
                           kw=dict(n_trees=6, max_depth=4,
                                   min_split_gain=50.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gbt_builds_the_jax_trees(case):
    spec = CASES[case]
    cols = spec["cols"]()
    eval_cols = spec["eval_cols"]() if "eval_cols" in spec else None
    jest, test, jhist, thist = _fit_both(cols, eval_cols,
                                         spec.get("num_epochs"), **spec["kw"])
    _assert_same_model(jest, test, jhist, thist)
    if case != "reg_lambda_zero":
        assert thist[-1]["train_loss"] < thist[0]["train_loss"]
    x = np.stack([cols[f] for f in FEATURES], axis=1)
    np.testing.assert_allclose(test.predict(x), jest.predict(x), **TREE_RTOL)
    jds, tds = _datasets(cols)
    want, got = jest.evaluate(jds), test.evaluate(tds)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if case == "nan_feature":
        assert np.isfinite(test._edges[0]).all()
        assert (test._trees["feature"] == 0).any()
    if case == "reg_lambda_zero":
        # Both packages split here, and both fit a model that does not
        # improve: at lam 0 an empty side whose gradient sum is rounding
        # noise scores g² / 1e-12, so a split that sends every row one
        # way wins, and its empty leaf is -0/0 (a fault of the reference,
        # reproduced; ROADMAP Queue C).
        assert (test._trees["feature"] >= 0).any()


def test_gbt_num_epochs_zero_trains_nothing():
    cols = _reg_columns(500, 13)
    jest, test, jhist, thist = _fit_both(cols, num_epochs=0, n_trees=5)
    assert thist == jhist == []
    x = np.stack([cols[f] for f in FEATURES], axis=1)
    np.testing.assert_allclose(test.predict(x), test._base_score)
    np.testing.assert_allclose(test.predict(x), jest.predict(x), rtol=1e-6)


def test_gbt_predict_on_ds_non_divisible_rows():
    """100 rows in 4 ragged blocks over 3 shards: each shard pads to 34
    rows, yet predict_on_ds returns the 100 rows in dataset order."""
    cols = _reg_columns(100, 0)
    test = GBTEstimator(n_trees=10, max_depth=3, feature_columns=FEATURES,
                        label_column="y", device="cpu")
    test.fit(_datasets(cols)[1])
    cuts = np.split(np.arange(100), [10, 45, 47])
    ds = MLDataset([{k: v[idx] for k, v in cols.items()} for idx in cuts],
                   num_shards=3)
    assert ds.rows_per_shard == 34
    preds = test.predict_on_ds(ds)
    x = np.stack([cols[f] for f in FEATURES], axis=1).astype(np.float32)
    assert preds.shape == (100,)
    np.testing.assert_allclose(preds, test.predict(x), rtol=1e-6)


def test_model_saved_by_jax_restores_in_the_port(tmp_path):
    cols = _reg_columns(800, 7)
    jest = JaxGBT(n_trees=10, max_depth=3, feature_columns=FEATURES,
                  label_column="y", data_parallel=False)
    jest.fit(_datasets(cols)[0])
    path = jest.save(str(tmp_path / "gbt"))
    port = GBTEstimator.restore(path, device="cpu")
    x = np.stack([cols[f] for f in FEATURES], axis=1)
    np.testing.assert_allclose(port.predict(x), jest.predict(x), **TREE_RTOL)
    # ...and what the port saves, the JAX package restores.
    again = JaxGBT.restore(port.save(str(tmp_path / "port")))
    np.testing.assert_allclose(again.predict(x), jest.predict(x), rtol=1e-6)


def test_gbt_requires_config_and_a_fit():
    with pytest.raises(ValueError):
        GBTEstimator(loss="hinge", device="cpu")
    with pytest.raises(ValueError, match="feature_columns"):
        GBTEstimator(device="cpu").fit(None)
    with pytest.raises(ValueError, match="unfitted"):
        GBTEstimator(device="cpu").save("/nonexistent")
    # fit_on_df reaches fit through the DataFrame engine's handoff.
    df = torch_rdf.from_items([{"a": 1.0, "y": 0.0}, {"a": 2.0, "y": 1.0}])
    with pytest.raises(ValueError, match="feature_columns"):
        GBTEstimator(device="cpu").fit_on_df(df, num_shards=1)


@pytest.mark.parametrize("sizes,num_shards", [
    ((100,), 1), ((10, 35, 2, 53), 1), ((10, 35, 2, 53), 2),
    ((10, 35, 2, 53), 3), ((7, 7, 7), 2), ((7, 7, 7), 3), ((1, 50, 3), 2),
    ((1, 50, 3), 3)])
def test_shard_global_indices_match_jax(sizes, num_shards):
    start = np.cumsum((0,) + sizes)
    blocks = [{"v": np.arange(a, b, dtype=np.int64)}
              for a, b in zip(start[:-1], start[1:])]
    jds = JaxMLDataset([pa.table(b) for b in blocks], num_shards)
    tds = MLDataset(blocks, num_shards)
    for rank in range(num_shards):
        got = tds.shard_global_indices(rank)
        np.testing.assert_array_equal(got, jds.shard_global_indices(rank))
        # The indices name each sample's row: here its value.
        np.testing.assert_array_equal(got, tds.shard_columns(rank)["v"])
    with pytest.raises(IndexError):
        tds.shard_global_indices(num_shards)


def test_gbt_needs_a_card_unless_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GBTEstimator()
