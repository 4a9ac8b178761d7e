"""The port's window functions (``raydp_tpu_torch/dataframe/window.py``
and the window branch of ``DataFrame._apply_expr_stage``) against the
JAX package's.

* Every case of ``tests/test_window.py`` runs against the port: the
  module is loaded again with its engine imports pointed at the port
  (``test_reference_case_on_port``). Its cluster case,
  ``test_window_on_cluster_executor``, is mirrored on a port session of
  2 workers, last in this file (while a session is live every frame of
  the port runs on its workers), with one change: its column 1 holds
  two values of equal count, whose order the reference case takes from
  arrow's multithreaded group-by (it varies under load, in either
  engine), so the mirror breaks the tie by the value, as Spark users
  must.
* The same window pipelines over the same pandas frame, made from a
  numpy seed, run through both engines (``test_engines_agree``): ids,
  ranks, lags, leads and integer aggregates must be equal exactly,
  float aggregates within rtol 1e-12. Rows are compared in the order of
  a unique row id.
* The DLRM id assignment of the reference notebook on the port's
  session against the JAX engine on its local executor.
"""
import numpy as np
import pandas as pd
import pytest

import raydp_tpu.dataframe as jax_rdf
import raydp_tpu_torch
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu_torch.dataframe.executor import ClusterExecutor
from raydp_tpu_torch.store import shm
from torch_port_cases import cases, load_port_module, run_case

PORT_REFERENCE = load_port_module("test_window.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [
    n for n in vars(PORT_REFERENCE)
    if n.startswith("test_") and n != "test_window_on_cluster_executor"])

FLOAT_RTOL = 1e-12


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    run_case(PORT_REFERENCE, name, params, request)


# -- the same pipelines through both engines --------------------------------

def _frame(seed=5, n=3000):
    """Window keys with skew (``g``), a string key, an order key with
    ties and nulls, a float with nulls and NaN, big int64 values and a
    unique row id."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.05] = np.nan
    o = rng.integers(0, 40, n).astype(float)
    o[rng.random(n) < 0.03] = np.nan
    return pd.DataFrame({
        "rid": np.arange(n, dtype=np.int64),
        "g": np.minimum(rng.zipf(1.6, n), 12).astype(np.int64),
        "s": rng.choice(["u", "v", "w"], n),
        "o": o,
        "v": v,
        "i": rng.integers(-(1 << 60), 1 << 60, n, dtype=np.int64) >> 3,
        "c": rng.integers(0, 5, n).astype(np.int64),
    })


def _ids(rdf, df):
    """The reference notebook's id assignment over two categorical
    columns, with a secondary key so ties are deterministic."""
    melted = df.posexplode(["s", "c"], pos_name="column_id",
                           value_name="data")
    counts = melted.groupBy("column_id", "data").count()
    w = rdf.Window.partitionBy("column_id").orderBy(rdf.desc("count"),
                                                    "data")
    return counts.withColumn("id", rdf.row_number().over(w) - 1)


def _ranks(rdf, df):
    w = rdf.Window.partitionBy("g").orderBy(rdf.desc("o"))
    return (df.withColumn("rank", rdf.rank().over(w))
            .withColumn("dense", rdf.dense_rank().over(w))
            .withColumn("rn", rdf.row_number().over(
                rdf.Window.partitionBy("g").orderBy("o", "rid"))))


def _lags(rdf, df):
    w = rdf.Window.partitionBy("g", "s").orderBy("rid")
    return (df.withColumn("prev", rdf.lag("v").over(w))
            .withColumn("prev2", rdf.lag("c", 2, -1).over(w))
            .withColumn("next", rdf.lead("i", 1).over(w))
            .withColumn("next3", rdf.lead("c", 3, 99).over(w)))


def _running(rdf, df):
    w = rdf.Window.partitionBy("g").orderBy("o")
    return (df.withColumn("sum_i", rdf.window_sum("i").over(w))
            .withColumn("sum_v", rdf.window_sum("v").over(w))
            .withColumn("min_v", rdf.window_min("v").over(w))
            .withColumn("max_c", rdf.window_max("c").over(w))
            .withColumn("mean_v", rdf.window_mean("v").over(w))
            .withColumn("cnt_v", rdf.window_count("v").over(w)))


def _whole(rdf, df):
    w = rdf.Window.partitionBy("s")
    return (df.withColumn("sum_i", rdf.window_sum("i").over(w))
            .withColumn("sum_v", rdf.window_sum("v").over(w))
            .withColumn("min_i", rdf.window_min("i").over(w))
            .withColumn("max_v", rdf.window_max("v").over(w))
            .withColumn("mean_v", rdf.window_mean("v").over(w))
            .withColumn("cnt_o", rdf.window_count("o").over(w)))


def _dedup(rdf, df):
    w = rdf.Window.partitionBy("g", "c").orderBy(rdf.desc("i"))
    return df.filter(rdf.row_number().over(w) == 1)


def _select(rdf, df):
    w = rdf.Window.partitionBy("c").orderBy("rid")
    return df.select("rid", "c", (rdf.row_number().over(w) * 10)
                     .alias("r10"), rdf.lag("s").over(w).alias("ps"))


def _chained(rdf, df):
    w = rdf.Window.partitionBy("g").orderBy("rid")
    first = df.withColumn("run", rdf.window_sum("c").over(w))
    return first.withColumn("prev_run", rdf.lag("run").over(w)).withColumn(
        "g", rdf.col("c")).withColumn(
        "tot", rdf.window_sum("run").over(rdf.Window.partitionBy("g")))


PIPELINES = {"ids": _ids, "ranks": _ranks, "lags": _lags,
             "running": _running, "whole": _whole, "dedup": _dedup,
             "select": _select, "chained": _chained}


def _by_row(pdf: pd.DataFrame) -> pd.DataFrame:
    keys = ["rid"] if "rid" in pdf.columns else ["column_id", "data"]
    return pdf.sort_values(keys).reset_index(drop=True)


def _assert_equal_frames(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        a, b = got[c].to_numpy(), want[c].to_numpy()
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, atol=0,
                                       equal_nan=True, err_msg=c)
        else:
            assert got[c].isna().tolist() == want[c].isna().tolist(), c
            assert got[c].dtype == want[c].dtype, c
            assert (got[c].fillna(0) == want[c].fillna(0)).all(), c


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_engines_agree(pipeline, parts):
    pdf = _frame()
    got = PIPELINES[pipeline](
        torch_rdf, torch_rdf.from_pandas(pdf, num_partitions=parts))
    want = PIPELINES[pipeline](
        jax_rdf, jax_rdf.from_pandas(pdf, num_partitions=parts))
    assert got._exchange_keys == want._exchange_keys
    assert got.num_partitions == want.num_partitions
    _assert_equal_frames(_by_row(got.to_pandas()), _by_row(want.to_pandas()))


def test_window_exports_match_reference():
    names = ["Window", "WindowSpec", "asc", "desc", "row_number", "rank",
             "dense_rank", "lag", "lead", "window_sum", "window_min",
             "window_max", "window_mean", "window_count"]
    for name in names:
        assert name in torch_rdf.__all__ and name in jax_rdf.__all__, name
        assert getattr(torch_rdf, name).__module__ == (
            "raydp_tpu_torch.dataframe.window")
    from raydp_tpu_torch.dataframe import dataframe as dfmod
    from raydp_tpu_torch.dataframe import window

    assert dfmod.keys_cover is window.keys_cover


# -- on the port's session (last: a live session routes every frame) --------

@pytest.fixture(scope="module")
def port_session():
    s = raydp_tpu_torch.init(app_name="port-window", num_workers=2,
                             memory_per_worker="256MB")
    namespace = s.cluster.namespace
    yield s
    raydp_tpu_torch.stop()
    assert shm.list_segments(f"rdp-{namespace}-") == []


def test_window_on_cluster_executor(port_session):
    """``tests/test_window.py::test_window_on_cluster_executor`` on the
    port's workers and shm store, the tie in column 1 (w and u, 3 each)
    broken by the value."""
    pdf = pd.DataFrame(
        {"c0": ["u"] * 4 + ["v"] * 2, "c1": ["w"] * 3 + ["u"] * 3})
    df = torch_rdf.from_pandas(pdf, num_partitions=2)
    assert isinstance(df._executor, ClusterExecutor)
    melted = df.posexplode(["c0", "c1"], pos_name="column_id",
                           value_name="data")
    counts = melted.groupBy("column_id", "data").count()
    w = torch_rdf.Window.partitionBy("column_id").orderBy(
        torch_rdf.desc("count"), "data")
    out = counts.withColumn("id", torch_rdf.row_number().over(w) - 1
                            ).to_pandas()
    got = {(r.column_id, r.data): r.id for r in out.itertuples()}
    assert got == {(0, "u"): 0, (0, "v"): 1, (1, "u"): 0, (1, "w"): 1}


def test_dlrm_ids_on_port_session_agree(port_session):
    pdf = _frame(seed=9, n=4000)
    df = torch_rdf.from_pandas(pdf, num_partitions=4)
    assert isinstance(df._executor, ClusterExecutor)
    got = _ids(torch_rdf, df).to_pandas()
    want = _ids(jax_rdf, jax_rdf.from_pandas(pdf, num_partitions=4)
                ).to_pandas()
    _assert_equal_frames(_by_row(got), _by_row(want))
