"""The port's DataFrame engine (``raydp_tpu_torch/dataframe``) against the
JAX package's (``raydp_tpu/dataframe``), both on their local executors.

* Every case of ``tests/test_dataframe.py`` runs against the port: the
  module is loaded again with its engine imports pointed at the port, so
  each case holds the port to the expectations it holds the JAX engine
  to (``test_reference_case_on_port``).
* The same pipelines over the same pandas input, made from a seed, run
  through both engines (``test_engines_agree``): nulls (NaN in a float
  column as null, Kleene ``&``/``|``, aggregates and ``dropna``/
  ``fillna`` on nulls only, nulls last in sorts, a null group, null
  join keys that never match), types (integer division, int and float
  arithmetic, ``posexplode``'s promotion), the date parts of
  ``timestamp[ns]`` around 1 January, hash and range exchanges, AQE
  coalescing, ``repartition``, ``random_split`` with a timestamp and a
  float first column, udfs, string functions and
  ``monotonically_increasing_id``. The partition counts and each
  partition's row count must be equal, and each partition equal as an
  Arrow table (schema and values, exactly), except after a group-by:
  arrow's multithreaded hash aggregation orders groups, list elements
  and float additions differently from run to run in either engine, so
  there rows are compared sorted by their keys, lists as sorted lists
  and floats within rtol 1e-9 (as ``tests/test_aqe.py``).
* Bucket ids of the hash exchange, numeric keys with nulls: bit-exact.
* ``first``/``last``/``count_distinct``: the JAX engine raises under the
  installed pyarrow (``ArrowNotImplementedError``: ordered aggregators
  in multithreaded execution), so the port is held against pandas'
  ``groupby().first()/last()/nunique()`` on the same frame.
"""
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import raydp_tpu.dataframe as jax_rdf
import raydp_tpu.dataframe.dataframe as jax_dfmod
import raydp_tpu_torch.dataframe as torch_rdf
import raydp_tpu_torch.dataframe.dataframe as torch_dfmod
from torch_port_cases import cases, load_port_module, run_case

PORT_REFERENCE = load_port_module("test_dataframe.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [
    n for n in vars(PORT_REFERENCE) if n.startswith("test_")])


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    run_case(PORT_REFERENCE, name, params, request)


# -- the same pipeline through both engines ---------------------------------

def _people():
    return pd.DataFrame({
        "name": ["ann", "bob", "cat", "dan", "eve", "fay", None],
        "age": [34, 21, 45, 21, 60, 17, 33],
        "city": ["nyc", "sf", "nyc", None, "sf", "nyc", "la"],
        "income": [90.0, 70.0, None, 50.0, 120.0, np.nan, 10.0],
        "flag": [True, None, False, True, None, False, True],
    })


def _numbers(seed=0, n=600):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 9, n),
        "a": rng.integers(-50, 50, n),
        "b": rng.integers(1, 7, n),
        "x": np.where(rng.random(n) < 0.1, np.nan, rng.standard_normal(n)),
        "s": rng.choice(["Ab", "cD", "ef", "GhI"], n),
    })


def _stamps():
    # timestamp[ns] around the turn of the year, where ISO weeks,
    # quarters and Spark's Sunday=1 day of week all change.
    ts = pd.to_datetime([
        "2020-12-27 23:59:59", "2020-12-31 00:00:01", "2021-01-01 12:00:00",
        "2021-01-03 06:30:00", "2021-01-04 00:00:00", "2019-12-30 13:00:00",
        "2024-02-29 23:00:00", "2021-03-31 18:15:00", "2021-04-01 01:01:00",
        "2022-01-02 07:00:00",
    ]).astype("datetime64[ns]")
    return pd.DataFrame({"ts": ts, "v": np.arange(len(ts), dtype=np.float64)})


def _kleene(R, parts):
    df = R.from_pandas(_people(), num_partitions=parts)
    c = R.col
    return df.select(
        "name",
        ((c("income") > 60) & c("flag")).alias("and_"),
        ((c("income") > 60) | c("flag")).alias("or_"),
        (~c("flag")).alias("not_"),
        c("income").is_null().alias("null_income"),
    )


def _null_aggs(R, parts):
    return (R.from_pandas(_people(), num_partitions=parts)
            .groupBy("city")
            .agg(("income", "sum"), ("income", "count"), ("*", "count"),
                 ("income", "mean"), ("income", "min"), ("age", "max"))
            .orderBy("city"))


def _dropna_fillna(R, parts):
    df = R.from_pandas(_people(), num_partitions=parts)
    return df.dropna(["income"]).union(
        df.fillna(0.0, ["income"]).fillna("?", ["city", "name"]))


def _sort_nulls_last(R, parts):
    return R.from_pandas(_people(), num_partitions=parts).orderBy(
        "income", "name", ascending=[False, True])


def _join_null_keys(R, parts, how):
    left = R.from_pandas(_people(), num_partitions=parts)
    right = R.from_pandas(pd.DataFrame({
        "city": ["nyc", "sf", None, "bos"], "pop": [8.4, 0.9, 1.0, 0.7]}))
    return left.join(right, on="city", how=how).orderBy("name", "city")


def _types(R, parts):
    df = R.from_pandas(_numbers(), num_partitions=parts)
    c = R.col
    return df.select(
        (c("a") / c("b")).alias("int_div"), (c("a") % c("b")).alias("mod"),
        (c("a") + c("x")).alias("int_plus_float"),
        (c("a") * 2.5).alias("int_times_float"),
        (c("b") - 1).alias("int_minus_int"), c("a").cast("double"),
        R.when(c("a") > 0, 1).when(c("a") < -20, -1).otherwise(0)
        .alias("sign"))


def _posexplode(R, parts):
    df = R.from_pandas(_numbers(n=40), num_partitions=parts)
    return df.posexplode(["a", "x"], keep=["k"])


def _explode(R, parts):
    pdf = pd.DataFrame({"id": [1, 2, 3, 4],
                        "xs": [[1, 2], [], None, [3, 4, 5]]})
    return R.from_pandas(pdf, num_partitions=parts).explode("xs", pos="p")


def _date_parts(R, parts):
    df = R.from_pandas(_stamps(), num_partitions=parts)
    c = R.col
    return df.select(
        "v", R.year("ts").alias("y"), R.month("ts").alias("m"),
        R.dayofmonth("ts").alias("d"), R.hour("ts").alias("h"),
        R.minute("ts").alias("mi"), R.second("ts").alias("s"),
        R.quarter("ts").alias("q"), R.weekofyear("ts").alias("w"),
        R.dayofweek(c("ts")).alias("dow"))


def _groupby_exchange(R, parts):
    return (R.from_pandas(_numbers(1, 3000), num_partitions=parts)
            .groupBy("k", "b").agg(("x", "sum"), ("a", "count_distinct"),
                                   ("x", "stddev"), ("a", "collect_set")))


def _distinct(R, parts):
    return R.from_pandas(_numbers(2), num_partitions=parts).select(
        "k", "b").distinct()


def _orderby_range(R, parts):
    return R.from_pandas(_numbers(3, 2000), num_partitions=parts).orderBy(
        "x", "a", ascending=[True, False])


def _repartition_union_limit(R, parts):
    df = R.from_pandas(_numbers(4, 1000), num_partitions=parts)
    return df.repartition(5).union(df.limit(17)).repartition(3)


def _random_split_stamp_first(R, parts):
    df = R.from_pandas(pd.concat([_stamps()] * 40, ignore_index=True),
                       num_partitions=parts)
    return df.random_split([0.7, 0.3], seed=11)


def _random_split_float_first(R, parts):
    pdf = _numbers(5, 1500)[["x", "a", "k"]]
    return R.from_pandas(pdf, num_partitions=parts).random_split(
        [0.9, 0.1], seed=42)


def _sample(R, parts):
    return R.from_pandas(_numbers(6, 1500), num_partitions=parts).sample(
        0.25, seed=3)


def _udf_strings_ids(R, parts):
    df = R.from_pandas(_numbers(7, 300), num_partitions=parts)

    @R.udf("double")  # row at a time, as the JAX engine's udf
    def scaled(a, x):
        return float(a) if np.isnan(x) else a * x

    c = R.col
    return df.select(
        scaled(c("a"), c("x")).alias("u"), R.lower("s").alias("lo"),
        R.upper("s").alias("up"), R.length("s").alias("n"),
        R.sqrt(c("b")).alias("r"), R.floor(c("x")).alias("f"),
        c("s").isin(["Ab", "ef"]).alias("in_"),
        R.monotonically_increasing_id().alias("id"))


def _broadcast_and_zip_joins(R, parts):
    left = R.from_pandas(_numbers(8, 800), num_partitions=parts)
    dim = R.from_pandas(pd.DataFrame({"k": np.arange(9),
                                      "w": np.arange(9) * 1.5}))
    right = left.groupBy("k").agg(("a", "sum"))
    return left.join(dim, on="k").join(right, on="k", how="left")


CASES = {
    "kleene": _kleene, "null_aggs": _null_aggs,
    "dropna_fillna": _dropna_fillna, "sort_nulls_last": _sort_nulls_last,
    "join_null_keys_inner": lambda R, p: _join_null_keys(R, p, "inner"),
    "join_null_keys_outer": lambda R, p: _join_null_keys(R, p, "outer"),
    "join_null_keys_left_anti":
        lambda R, p: _join_null_keys(R, p, "left_anti"),
    "types": _types, "posexplode": _posexplode, "explode": _explode,
    "date_parts": _date_parts, "groupby_exchange": _groupby_exchange,
    "distinct": _distinct, "orderby_range": _orderby_range,
    "repartition_union_limit": _repartition_union_limit,
    "random_split_stamp_first": _random_split_stamp_first,
    "random_split_float_first": _random_split_float_first,
    "sample": _sample, "udf_strings_ids": _udf_strings_ids,
    "broadcast_and_zip_joins": _broadcast_and_zip_joins,
}


# The keys a case's output is sorted by before comparing (group-bys).
GROUP_KEYS = {"null_aggs": ["city"], "groupby_exchange": ["k", "b"]}


def _frames(out):
    return out if isinstance(out, list) else [out]


def _same_table(a: pa.Table, b: pa.Table, keys) -> None:
    assert a.schema == b.schema
    assert a.num_rows == b.num_rows
    if keys is None:
        assert a.equals(b), (a.to_pandas(), b.to_pandas())
        return
    da, db = (t.to_pandas().sort_values(keys, kind="stable",
                                        na_position="last")
              .reset_index(drop=True) for t in (a, b))
    for name in da.columns:
        kind = a.schema.field(name).type
        if pa.types.is_floating(kind):
            np.testing.assert_allclose(da[name], db[name], rtol=1e-9,
                                       equal_nan=True)
        elif pa.types.is_list(kind):
            assert ([sorted(v) for v in da[name]]
                    == [sorted(v) for v in db[name]]), name
        else:
            assert da[name].equals(db[name]), name


def _assert_same_partitions(ours, theirs, keys=None):
    ours, theirs = _frames(ours), _frames(theirs)
    assert len(ours) == len(theirs)
    for i, (o, t) in enumerate(zip(ours, theirs)):
        assert o.num_partitions == t.num_partitions
        po, pt = o.collect_partitions(), t.collect_partitions()
        assert [p.num_rows for p in po] == [p.num_rows for p in pt]
        # ``keys``: one list of sort keys for every frame, or a list of
        # such lists, one a frame.
        frame_keys = keys[i] if keys and isinstance(keys[0], list) else keys
        for a, b in zip(po, pt):
            _same_table(a, b, frame_keys)


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engines_agree(case, parts):
    _assert_same_partitions(CASES[case](torch_rdf, parts),
                            CASES[case](jax_rdf, parts),
                            GROUP_KEYS.get(case))


@pytest.mark.parametrize("tier", ["direct", "coalesced_combine", "exchange"])
def test_engines_agree_on_agg_tiers_and_exchange_layout(monkeypatch, tier):
    """The agg plans and the AQE's coalesced exchange layout: the same
    partitions (row counts included) through both engines."""
    for mod in (jax_dfmod, torch_dfmod):
        if tier == "direct":
            monkeypatch.setattr(mod, "_AGG_COALESCE_BYTES", 1 << 40)
        else:
            monkeypatch.setattr(mod, "_AGG_COALESCE_BYTES", 0)
            monkeypatch.setattr(mod, "_COMBINE_COALESCE_BYTES",
                                1 << 40 if tier == "coalesced_combine" else 0)
        monkeypatch.setattr(mod, "_EXCHANGE_COALESCE_BYTES", 0)
    monkeypatch.setenv("RAYDP_TPU_AQE_MIN_EXCHANGE_MB", "0.0001")

    def run(R):
        df = R.from_pandas(_numbers(9, 4000), num_partitions=6)
        return [df.groupBy("k").agg(("x", "sum"), ("a", "max"),
                                    ("a", "collect_list")),
                df.distinct(["k", "b"])]

    _assert_same_partitions(run(torch_rdf), run(jax_rdf),
                            [["k"], ["k", "b"]])


@pytest.mark.parametrize("dtypes", [("int64",), ("float64",),
                                    ("int64", "float64"),
                                    ("int32", "float32", "int16"),
                                    ("uint8", "int64")])
def test_hash_buckets_bit_exact(dtypes):
    rng = np.random.default_rng(len(dtypes))
    n = 5000
    cols = {}
    for i, dt in enumerate(dtypes):
        vals = rng.integers(-100, 100, n) if "int" in dt else \
            rng.standard_normal(n)
        if dt == "uint8":
            vals = np.abs(vals)
        arr = pa.array(vals.astype(dt), mask=rng.random(n) < 0.1)
        cols[f"c{i}"] = arr
    table = pa.table(cols)
    keys = list(cols)
    for n_out in (2, 7, 64):
        np.testing.assert_array_equal(
            torch_dfmod._hash_bucket(table, keys, n_out),
            jax_dfmod._hash_bucket(table, keys, n_out))


def test_string_keys_hash_as_the_jax_engine():
    table = pa.table({"s": pa.array(["a", None, "bc", "a", "zz"] * 40),
                      "k": np.arange(200)})
    np.testing.assert_array_equal(
        torch_dfmod._hash_bucket(table, ["s", "k"], 5),
        jax_dfmod._hash_bucket(table, ["s", "k"], 5))


@pytest.mark.parametrize("first", ["timestamp", "float", "string"])
def test_table_fingerprint_as_the_jax_engine(first):
    col = {"timestamp": _stamps()["ts"], "float": [0.1, 2.5, -3.25],
           "string": ["x", "y", None]}[first]
    table = pa.Table.from_pandas(pd.DataFrame({"c": col}),
                                 preserve_index=False)
    assert (torch_dfmod._table_fingerprint(table)
            == jax_dfmod._table_fingerprint(table))


def test_first_last_count_distinct_against_pandas():
    rng = np.random.default_rng(12)
    pdf = pd.DataFrame({"k": rng.integers(0, 20, 2000),
                        "v": rng.integers(0, 50, 2000)})
    for parts in (1, 4):
        out = (torch_rdf.from_pandas(pdf, num_partitions=parts)
               .groupBy("k")
               .agg(("v", "first"), ("v", "last"), ("v", "count_distinct"))
               .to_pandas().sort_values("k").reset_index(drop=True))
        g = pdf.groupby("k")["v"]
        assert out["k"].tolist() == sorted(pdf["k"].unique())
        assert out["count_distinct(v)"].tolist() == g.nunique().tolist()
        if parts == 1:  # one partition: row order is the frame's
            assert out["first(v)"].tolist() == g.first().tolist()
            assert out["last(v)"].tolist() == g.last().tolist()
        else:  # the first/last of some partition's rows of the group
            assert out["first(v)"].isin(pdf["v"]).all()
