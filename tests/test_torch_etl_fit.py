"""The ETL half into training: the examples' DataFrame pipelines and
``fit_on_df`` on the port against the JAX package, on the CPU.

* The rows: ``chip_smoke``'s numpy rebuilds of the examples' generators
  (``synthetic_taxi``, ``synthetic_glue``, ``synthetic_criteo``) equal
  the examples' own; ``chip_smoke``'s copy of the rare-id remap (a dict
  lookup in its udf) equals ``examples/dlrm_criteo.py``'s (``pd.Series
  .map``) on the same ids, its vocab sizes those of ``np.unique``.
* The taxi ETL on 8,000 rows: ``nyc_taxi_preprocess`` then
  ``random_split([0.9, 0.1], seed=42)`` through both engines: the same
  partitions, so the same rows in train and test, and the features
  equal to ``chip_smoke.taxi_features_numpy``'s.
* ``MLDataset.from_df``: block sizes, shard plans and shard columns equal
  to the JAX package's for 1, 2 and 3 shards, shuffled and not.
* ``fit_on_df`` on both packages from converted weights, the stream path
  pinned: the taxi MLP (``Estimator``; histories within the north
  star's f32 rtol 2e-4), ``predict_on_df``'s column (rtol 2e-4 / atol
  1e-5), ``GBTEstimator`` (the same trees, leaves within rtol 1e-5 as
  ``tests/test_torch_gbt.py``) and ``TFEstimator`` (rtol 2e-4).
* The epoch-0 prefix streamer: a loader over partitions still being
  produced serves its first batch before the last block lands, and the
  same batches as the JAX loader.
"""
import os
import sys
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import optax
import pandas as pd
import pyarrow as pa
import pytest
import torch

import raydp_tpu.dataframe as jax_rdf
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.models import mlp as jmlp
from raydp_tpu.train import tf_estimator as jtf
from raydp_tpu.train.estimator import JAXEstimator
from raydp_tpu.train.gbt import GBTEstimator as JaxGBT
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.dataframe.scheduler import PendingPartition
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.mlp import taxi_fare_regressor
from raydp_tpu_torch.train import Estimator, GBTEstimator, TFEstimator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
import chip_smoke  # noqa: E402
from bert_glue import synthetic_glue  # noqa: E402
from data_process import nyc_taxi_preprocess, synthetic_taxi  # noqa: E402
from dlrm_criteo import remap_rare_ids, synthetic_criteo  # noqa: E402

# The north star's f32 bound (ROADMAP): losses of two f32 fits apart by
# summation order, over fares up to ~100; predictions as
# tests/test_torch_train.py.
RTOL = 2e-4
TREE_RTOL = dict(rtol=1e-5, atol=1e-6)
N_TAXI = 8_000
FEATURES = chip_smoke.TAXI_FEATURES


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(tree))


@pytest.fixture(scope="module")
def taxi():
    """(port frames, JAX frames): the preprocessed taxi rows and their
    90/10 split, 4 partitions, each engine from its own constructor."""
    table = chip_smoke.synthetic_taxi_table(np, N_TAXI)
    ours = chip_smoke.nyc_taxi_preprocess(
        torch_rdf, torch_rdf.from_arrow(table, num_partitions=4)).persist()
    theirs = nyc_taxi_preprocess(
        jax_rdf.from_pandas(synthetic_taxi(N_TAXI), num_partitions=4)
    ).persist()
    return ((ours, *ours.random_split([0.9, 0.1], seed=42)),
            (theirs, *theirs.random_split([0.9, 0.1], seed=42)), table)


# -- the rows -----------------------------------------------------------

def test_numpy_generators_equal_the_examples():
    table = chip_smoke.synthetic_taxi_table(np, 3000)
    want = pa.Table.from_pandas(synthetic_taxi(3000), preserve_index=False)
    for name in table.column_names:
        got, ref = table.column(name), want.column(name)
        if pa.types.is_timestamp(ref.type):
            got = got.cast(pa.int64()).to_numpy()
            ref = ref.cast(pa.timestamp("ns")).cast(pa.int64()).to_numpy()
            # pandas rounds float minutes to nanoseconds its own way
            tol = 0 if name == "pickup_datetime" else 1000
            assert np.abs(got - ref).max() <= tol, name
        else:
            np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    glue = chip_smoke.synthetic_glue(np, 300, 16, 1000)
    ref = synthetic_glue(300, 16, 1000)
    assert list(glue) == list(ref.columns)
    for name in glue:
        np.testing.assert_array_equal(glue[name], ref[name].to_numpy())
    criteo = chip_smoke.synthetic_criteo(np, 2000)
    ref = synthetic_criteo(2000)
    assert list(criteo) == list(ref.columns)
    for name in criteo:
        np.testing.assert_array_equal(criteo[name], ref[name].to_numpy())


def test_remap_rare_ids_equals_the_example():
    # The example's udf builds a pandas Series for every row: ~2 ms a
    # row here, so few rows and two of the six id columns.
    pdf = synthetic_criteo(400)
    cat = ["C0", "C3"]
    ours, vocab = chip_smoke.remap_rare_ids(
        torch_rdf, torch_rdf.from_pandas(pdf, num_partitions=4), cat, 3)
    theirs, jvocab = remap_rare_ids(
        jax_rdf.from_pandas(pdf, num_partitions=4), cat, 3)
    assert vocab == jvocab == tuple(
        int((np.unique(pdf[c], return_counts=True)[1] >= 3).sum()) + 1
        for c in cat)
    got, want = ours.to_pandas(), theirs.to_pandas()
    for c in cat:
        np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy())


# -- the taxi ETL --------------------------------------------------------

def test_taxi_etl_and_split_match_jax(taxi):
    ours, theirs, table = taxi
    for o, t in zip(ours, theirs):
        assert o.num_partitions == t.num_partitions
        po, pt = o.collect_partitions(), t.collect_partitions()
        assert [p.num_rows for p in po] == [p.num_rows for p in pt]
        for a, b in zip(po, pt):
            assert a.equals(b)
    assert chip_smoke.taxi_etl_mismatch(
        np, ours[0].to_arrow(), chip_smoke.taxi_features_numpy(np, table)
    ) is None
    assert ours[1].count() + ours[2].count() == ours[0].count()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_plans_match_jax(taxi, num_shards, shuffle):
    (_, train, _), (_, jtrain, _), _ = taxi
    ds = MLDataset.from_df(train, num_shards, shuffle=shuffle,
                           shuffle_seed=5)
    jds = JaxMLDataset.from_df(jtrain, num_shards, shuffle=shuffle,
                               shuffle_seed=5)
    assert ds.block_sizes == jds.block_sizes

    def plan(d):
        return {r: [(s.block_index, s.offset, s.num_samples) for s in v]
                for r, v in d.shard_plan.items()}

    assert plan(ds) == plan(jds)
    for rank in range(num_shards):
        got, want = ds.shard_columns(rank), jds.shard_columns(rank)
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(ds.shard_global_indices(rank),
                                      jds.shard_global_indices(rank))


# -- fit_on_df on both packages ------------------------------------------

def test_taxi_mlp_fit_on_df_and_predict_on_df_match_jax(taxi):
    (_, train, test), (_, jtrain, jtest), _ = taxi
    jmodel = jmlp.taxi_fare_regressor()
    x0 = np.zeros((1, len(FEATURES)), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x0))["params"]
    tmodel = taxi_fare_regressor(len(FEATURES), device="cpu")
    tmodel.load_state_dict(params_from_flax(_numpy_tree(params)))
    kw = dict(loss="smooth_l1", metrics=["mae"], num_epochs=2,
              batch_size=512, feature_columns=FEATURES,
              label_column="fare_amount", seed=0, epoch_mode="stream")
    jest = JAXEstimator(model=jmodel, optimizer=optax.adam(1e-3), **kw)
    test_ = Estimator(model=tmodel, device="cpu",
                      optimizer=lambda p: torch.optim.Adam(p, lr=1e-3), **kw)
    jhist = jest.fit_on_df(jtrain, jtest, num_shards=2)
    thist = test_.fit_on_df(train, test, num_shards=2)
    assert len(thist) == len(jhist)
    for t, j in zip(thist, jhist):
        assert t["samples"] == j["samples"]
        for k in ("train_loss", "eval_loss", "eval_mae"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
    assert thist[-1]["train_loss"] < thist[0]["train_loss"]
    got = test_.predict_on_df(test, num_shards=2)
    want = jest.predict_on_df(jtest, num_shards=2)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == test.count()
    pd.testing.assert_frame_equal(got[FEATURES], want[FEATURES])
    np.testing.assert_allclose(got["prediction"], want["prediction"],
                               rtol=RTOL, atol=1e-5)
    # one prediction per row, in row order
    x = got[FEATURES].to_numpy(np.float32)
    np.testing.assert_allclose(got["prediction"], test_.predict(x)[:, 0],
                               rtol=1e-6, atol=1e-6)


def test_predict_on_ds_collapses_padding():
    rows = [{"a": float(i), "y": 0.0} for i in range(10)]
    df = torch_rdf.from_items(rows, num_partitions=3)
    est = Estimator(model=torch.nn.Linear(1, 1), feature_columns=["a"],
                    label_column="y", batch_size=4, device="cpu")
    ds = MLDataset.from_df(df, num_shards=3)  # 4 rows a shard: 2 padded
    got = est.predict_on_ds(ds)
    assert got.shape == (10, 1)
    np.testing.assert_allclose(got, est.predict(np.arange(10.0)[:, None]),
                               rtol=1e-6)


def test_gbt_fit_on_df_builds_the_jax_trees(taxi):
    (_, train, test), (_, jtrain, jtest), _ = taxi
    kw = dict(n_trees=6, max_depth=4, max_bins=32, feature_columns=FEATURES,
              label_column="fare_amount")
    jest = JaxGBT(data_parallel=False, **kw)
    test_ = GBTEstimator(device="cpu", **kw)
    jhist = jest.fit_on_df(jtrain, jtest)
    thist = test_.fit_on_df(train, test)
    np.testing.assert_array_equal(test_._trees["feature"],
                                  jest._trees["feature"])
    np.testing.assert_array_equal(test_._trees["bin"], jest._trees["bin"])
    np.testing.assert_allclose(test_._trees["leaf"], jest._trees["leaf"],
                               **TREE_RTOL)
    for t, j in zip(thist, jhist):
        for k in t.keys() - {"round"}:
            np.testing.assert_allclose(t[k], j[k], err_msg=k, **TREE_RTOL)
    assert thist[-1]["train_loss"] < thist[0]["train_loss"]


def test_tf_estimator_fit_on_df_matches_jax(taxi):
    (_, train, test), (_, jtrain, jtest), _ = taxi
    layers = [{"class_name": "Dense",
               "config": {"units": 16, "activation": "relu"}},
              {"class_name": "BatchNormalization", "config": {}},
              {"class_name": "Dense",
               "config": {"units": 1, "activation": "linear"}}]
    kw = dict(model=layers, feature_columns=FEATURES,
              label_column="fare_amount", seed=0, epoch_mode="stream",
              optimizer={"class_name": "Adam",
                         "config": {"learning_rate": 1e-2}},
              loss="mean_squared_error", metrics=["mae"], batch_size=256,
              num_epochs=2)
    jest = jtf.TFEstimator(**kw)
    test_ = TFEstimator(device="cpu", **kw)
    x0 = np.zeros((1, len(FEATURES)), np.float32)
    params = jtf.KerasSequential(layer_configs=jest.layer_configs).init(
        jax.random.PRNGKey(0), jnp.asarray(x0))["params"]
    test_.get_model().load_state_dict(params_from_flax(_numpy_tree(params)),
                                      strict=True)
    jhist = jest.fit_on_df(jtrain, jtest)
    thist = test_.fit_on_df(train, test)
    assert len(thist) == len(jhist)
    for t, j in zip(thist, jhist):
        assert t["samples"] == j["samples"]
        for k in ("train_loss", "eval_loss", "eval_mae"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)


def test_fit_on_df_takes_pandas_and_needs_a_card_unless_cpu():
    pdf = pd.DataFrame({"a": np.arange(64.0), "y": np.arange(64.0) * 2})
    est = Estimator(model=torch.nn.Linear(1, 1), feature_columns=["a"],
                    label_column="y", batch_size=16, device="cpu",
                    optimizer=lambda p: torch.optim.SGD(p, lr=1e-3))
    hist = est.fit_on_df(pdf, evaluate_df=pdf.iloc[:16], num_epochs=2)
    assert [h["samples"] for h in hist] == [64, 64]
    assert "eval_loss" in hist[-1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Estimator(model=torch.nn.Linear(1, 1))


# -- the epoch-0 prefix streamer ------------------------------------------

def _block(lo, hi):
    idx = np.arange(lo, hi, dtype=np.float64)
    return pa.table({"a": idx, "b": idx * 2, "y": idx % 2})


def _pending(spans, delay):
    futs = [Future() for _ in spans]

    def produce():
        for f, (lo, hi) in zip(futs, spans):
            time.sleep(delay)
            f.set_result(_block(lo, hi))

    threading.Thread(target=produce, daemon=True).start()
    return [PendingPartition(f, i, "etl") for i, f in enumerate(futs)]


@pytest.mark.parametrize("drop_last", [False, True])
def test_prefix_streamer_matches_the_jax_loader(drop_last):
    spans = [(i * 25, (i + 1) * 25) for i in range(8)] + [(200, 203)]
    kw = dict(batch_size=16, rank=0, shuffle=False, prefetch=2,
              drop_last=drop_last)
    ref = list(JaxMLDataset([_block(lo, hi) for lo, hi in spans],
                            num_shards=2).to_jax(["a", "b"], "y",
                                                 device=None, **kw))
    ds = MLDataset(_pending(spans, delay=0.05), num_shards=2)
    assert ds.has_pending_blocks()
    loader = ds.to_torch(["a", "b"], "y", device="cpu",
                         transfer_coalesce=1, **kw)
    t0 = time.perf_counter()
    got, first_at = [], None
    for batch in loader:
        first_at = first_at or time.perf_counter() - t0
        got.append(batch)
    assert ds.known_rows() == (203, True)
    # the first batch came while later blocks were still being produced
    assert first_at < 0.35
    assert len(got) == len(ref)
    for (x, y), (jx, jy) in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    again = list(loader)  # epoch 1 from the staged shard
    assert len(again) == len(ref)


def test_from_df_hands_over_partitions_in_order():
    df = torch_rdf.range(1000, num_partitions=4).withColumn(
        "y", torch_rdf.col("id") * 2)
    ds = MLDataset.from_df(df, num_shards=2)
    assert ds.block_sizes == [250] * 4
    cols = ds.shard_columns(0)
    np.testing.assert_array_equal(cols["id"], np.arange(500))
    np.testing.assert_array_equal(cols["y"], np.arange(500) * 2)
    back = ds.to_df()
    assert back.num_partitions == 4 and back.count() == 1000
